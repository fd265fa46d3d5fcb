"""ipm_roofline: kernel 3's bound at the cell's shape over its mean
device time a launch, %; nothing where it did not run."""
from benchmark.yardstick import roofline
from benchmark.yardstick.trace import mean_kernel_s


def read(s):
    t = mean_kernel_s(s, ("ipm_kernel",))
    if t is None:
        return None
    B, nx, dims = s["shapes"]["ipm"]
    return 100.0 * roofline.ipm_bound(B, nx, tuple(dims))[0] / t
