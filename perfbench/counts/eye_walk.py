"""The classic VCM eye pass's walk (kernels/csrc/eye_walk.cu): the work of
its launches in a window, from quantities the estimator and the seed fix.

Bytes: the scene tables once a launch, a pixel in, and every eye record
written (RECORD_BYTES). Operations: its rays at the configuration's
frozen BVH8 rows a ray, a camera ray a pixel-sample and a walk vertex a
record.
"""

from pb import roofline as rf

KERNELS = ("eye_walk_kernel",)


def work(q: dict, cfg: dict) -> tuple:
    w = cfg["work"]
    nbytes = (q["dispatches"] * w["scene_bytes"] + q["pixel_samples"] * 16
              + q["eye_records"] * rf.RECORD_BYTES)
    ops = (q["eye_walk_rays"] * w["rows_per_eye_walk_ray"] * rf.OPS_PER_ROW
           + q["pixel_samples"] * rf.OPS_PER_CAMERA_RAY
           + q["eye_records"] * rf.OPS_PER_WALK_VERTEX)
    return nbytes, ops
