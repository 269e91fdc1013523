"""Host milliseconds a rank's thread waits at the mesh's collectives in a
dispatch (the barrier where a tile group's members meet): RenderMetrics'
`mesh_wait` phase, summed over the ranks by the program, over the
dispatches it covers (the window's and the one warm-up dispatch) and the
ranks of the configuration's `Mesh Shape`. Nothing to read without a
mesh."""

from pb import spec

LAYER = "mesh"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "msamples_per_s"
WARM_UP = 1   # the dispatches pb/cell.py runs before its window


def read(ctx):
    waited = ctx["phases"].get("mesh_wait")
    if waited is None:
        return None
    c = spec.counts("mesh_exchange")
    n_tile, n_spp = c.mesh_shape(ctx["config"])
    return waited / (ctx["q"]["dispatches"] + WARM_UP) / (n_tile * n_spp) \
        * 1e3
