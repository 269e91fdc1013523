"""Seconds the program's Renderer spent building the scene's tables (its
SAH/SBVH build, the BVH8 collapse and the upload): RenderMetrics'
`bvh_build` phase, on the host's clock. Part of set-up."""

LAYER = "scene build"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    return ctx["phases"].get("bvh_build")
