"""Metrics logging, config dumps, checkpoints and self-triggered
intervals."""
