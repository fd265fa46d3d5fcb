"""fit_ms_per_iter: the `fit` spans' total over the Adam iterations the
refit schedule runs, ms; nothing where the schedule runs none."""


def read(s):
    if not s["adam_iterations"]:
        return None
    return s["region_ns"] / 1e6 / s["adam_iterations"]
