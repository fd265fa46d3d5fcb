"""The frozen arithmetic the benchmark measures with."""
