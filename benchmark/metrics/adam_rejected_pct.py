"""adam_rejected_pct: the refits' Adam steps rejected for a non-finite
loss, gradient or update, over the episode-iterations run, % (the
program's `adam.rejected` / `adam.episode_iters`)."""
from benchmark.yardstick.spans import counter_pct


def read(s):
    return counter_pct("adam.rejected", "adam.episode_iters")
