"""The benchmark of the PyTorch/CUDA port (`bayesian_cbf_tpu_torch`): the
harness (`run.py`), its cells' configurations and traffic mixes, the
per-layer metric readers, the yardstick (rooflines, trace arithmetic)
and the plain reference that decides `correct`."""
