"""K12, the light walk (kernels/csrc/bdpt_walk.cu, its prologue and its
persistent lanes): the work of its launches in a window, from quantities
the estimator and the seed fix.

Bytes: the scene tables once a launch and every light vertex written.
Operations: its rays at the configuration's frozen BVH8 rows a ray, a
walk vertex a stored light vertex, and a path's start (a light point and
direction: 5 draws) a pixel-sample.
"""

from pb import roofline as rf

KERNELS = ("bdpt_walk_kernel", "bdpt_walk_start_kernel")


def work(q: dict, cfg: dict) -> tuple:
    w = cfg["work"]
    nbytes = (q["dispatches"] * w["scene_bytes"]
              + q["light_vertices"] * rf.VERTEX_BYTES)
    ops = (q["light_rays"] * w["rows_per_light_ray"] * rf.OPS_PER_ROW
           + q["light_vertices"] * rf.OPS_PER_WALK_VERTEX
           + q["pixel_samples"] * 5 * rf.OPS_PER_DRAW)
    return nbytes, ops
