"""The share of the traced window in which no operation ran on the card:
1 - busy / window, from torch.profiler's device events."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["window_s"]:
        return None
    return (1.0 - t["busy_s"] / ctx["window_s"]) * 100.0
