"""Metrics logging (JSONL, binary, tensorboard), config dumps, replay,
checkpoints, self-triggered intervals, profiling and figures."""
