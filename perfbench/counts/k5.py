"""K5, the unidirectional megakernel (kernels/csrc/uni_mega.cu): the work
its launches in a window must do, from quantities the estimator and the
seed fix.

Bytes: the scene tables once a launch, and a pixel's id in and radiance
and ray count out once a pixel-sample. Operations: every ray traced
(closest and shadow; the count the check holds) visits the
configuration's frozen BVH8 rows a ray, and every pixel-sample draws its
camera ray. The shading arithmetic is not counted, so the bound is low.
"""

from pb import roofline as rf

KERNELS = ("uni_mega_kernel",)


def work(q: dict, cfg: dict) -> tuple:
    w = cfg["work"]
    nbytes = q["dispatches"] * w["scene_bytes"] + q["pixel_samples"] * 24
    ops = (q["rays"] * w["rows_per_ray"] * rf.OPS_PER_ROW
           + q["pixel_samples"] * rf.OPS_PER_CAMERA_RAY)
    return nbytes, ops
