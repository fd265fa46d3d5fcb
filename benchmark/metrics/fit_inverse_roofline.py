"""fit_inverse_roofline: the fit inverse's bound (K^-1 and logdet at the
cell's (B, K)) over the mean device time of a launch of whichever kernel
computes it, kernel 1 (`kinv_logdet_kernel`) or kernel 5's sweeps
(`sweep_*`), %; nothing where neither ran."""
from benchmark.yardstick import roofline
from benchmark.yardstick.trace import mean_kernel_s


def read(s):
    t = mean_kernel_s(s, ("kinv_logdet", "sweep"))
    if t is None:
        return None
    B, K = s["shapes"]["kinv_logdet"]
    return 100.0 * roofline.kinv_logdet_bound(B, K)[0] / t
