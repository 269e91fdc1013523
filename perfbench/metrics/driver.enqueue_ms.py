"""Host milliseconds inside the program's Renderer.render_batch a
dispatch, the mean over the window: the benchmark's span around the call,
which returns once the dispatch's launches are queued."""

LAYER = "driver and batching"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "msamples_per_s"


def read(ctx):
    spans = ctx["enqueue_s"]
    return sum(spans) / len(spans) * 1e3 if spans else None
