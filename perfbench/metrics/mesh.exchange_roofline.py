"""The share of its roofline that the traced window's mesh exchange
reaches: the bytes its card-to-card copies move (counts/mesh_exchange.py,
from the settings) over those copies' device seconds, summed over the
cards, at one card's NVLink peak. Nothing to read where the window made
no peer copy."""

from pb import spec, trace

LAYER = "mesh"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "msamples_per_s"
# NVIDIA H100 SXM5 datasheet: fourth-generation NVLink, 900 GB/s a GPU in
# both directions together, so 450 GB/s in each
PEAK_LINK_BYTES_S = 450e9


def read(ctx):
    if ctx["trace"] is None:
        return None
    c = spec.counts("mesh_exchange")
    busy = trace.device_seconds(ctx["trace"]["kernel_s"], c.KERNELS)
    if busy <= 0:
        return None
    q = dict(ctx["q"], pixels=ctx["pixels"], k=ctx["k"])
    nbytes, _ = c.work(q, ctx["config"])
    return nbytes / PEAK_LINK_BYTES_S / busy * 100.0
