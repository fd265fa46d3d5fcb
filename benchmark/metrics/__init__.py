"""Per-layer metric readers, one file per quantity, found by the metric's
name (`harness.metric_reader`)."""
