"""The classic VCM eye pass's connections (kernels/csrc/eye_connect.cu):
the work of its launches in a window, from quantities the estimator and
the seed fix.

Bytes: the scene tables once a launch, the eye records and light vertices
read once, a connection's 12-byte contribution written. Operations: each
connection's shadow ray at the configuration's frozen BVH8 rows a ray and
the decode of its light vertex.
"""

from pb import roofline as rf

KERNELS = ("eye_connect_kernel",)


def work(q: dict, cfg: dict) -> tuple:
    w = cfg["work"]
    nbytes = (q["dispatches"] * w["scene_bytes"]
              + q["eye_records"] * 84 + q["light_vertices"] * rf.VERTEX_BYTES
              + q["connect_rays"] * 12)
    ops = q["connect_rays"] * (w["rows_per_connect_ray"] * rf.OPS_PER_ROW
                               + rf.OPS_PER_DECODE)
    return nbytes, ops
