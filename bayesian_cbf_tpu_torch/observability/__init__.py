"""Metrics logging, config dumps and checkpoints."""
