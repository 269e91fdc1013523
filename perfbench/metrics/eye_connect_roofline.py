"""The share of its roofline that the traced window's eye_connect launches reach:
the least time the work they must do could take (counts/eye_connect.py, from
quantities the estimator and the seed fix) over their device time.
Nothing to read where the window ran none of its kernels."""

from pb import roofline, spec, trace

LAYER = "VCM eye passes"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(ctx):
    if ctx["trace"] is None:
        return None
    c = spec.counts("eye_connect")
    busy = trace.device_seconds(ctx["trace"]["kernel_s"], c.KERNELS)
    if busy <= 0:
        return None
    return roofline.bound_s(*c.work(ctx["q"], ctx["config"]))[0] / busy * 100.0
