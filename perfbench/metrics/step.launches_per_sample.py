"""The program's kernel launches a sample over the window, from its
launch counters (kernels.launches). A counter that only sums others (an
eye pass or a splat counted once beside its stages, and the threaded
engine's count beside its host's) is left out, so each launch counts
once."""

LAYER = "per-sample step"
UNIT = "launches/sample"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "msamples_per_s"

BESIDE = ("threaded_engine",)


def read(ctx):
    counts = {k: v for k, v in ctx["launches"].items() if v}
    if not counts or not ctx["samples"]:
        return None
    leaves = [k for k in counts if k not in BESIDE
              and not any(o.startswith(k + "_") for o in counts)]
    return sum(counts[k] for k in leaves) / ctx["samples"]
