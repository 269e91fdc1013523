"""Seconds the program's Renderer waited for its mesh of ranks after its
scene build: what is left of the cards' contexts, which the ranks'
threads make while the scene is built, then each rank's stream and one
card-to-card copy within each tile group (no communicator is built), and
the scene's replication: RenderMetrics' `mesh_build` phase, on the
host's clock. Part of set-up; nothing to read without a mesh. What the
contexts cost the scene build itself shows in scene.build_s, not here."""

LAYER = "mesh"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    return ctx["phases"].get("mesh_build")
