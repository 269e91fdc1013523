"""The whole step's share of the card's peak: the least time the counted
work of every sample in the window could take (the configuration's
`counted` kernels' bounds, from quantities the estimator and the seed
fix, whichever kernels do that work) over the traced window's length."""

from pb import roofline, spec

LAYER = "device"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(ctx):
    if ctx["trace"] is None or not ctx["window_s"]:
        return None
    total = sum(roofline.bound_s(*spec.counts(k).work(ctx["q"],
                                                      ctx["config"]))[0]
                for k in ctx["config"]["counted"])
    return total / ctx["window_s"] * 100.0
