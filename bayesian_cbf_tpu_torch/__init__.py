"""PyTorch + CUDA port of `bayesian_cbf_tpu`, for NVIDIA Hopper (H100).

Same subpackage and module names as the JAX package.  Everything is
batch-first: an explicit leading batch axis takes the place of `vmap`.
The hand-written kernels (`csrc/`) are built at first use, never at
import; a wrapper picks the kernel or its plain PyTorch version by the
device of the tensor it is given.
"""

__version__ = "0.2.0"
