"""Camera: pinhole / thin lens and primary ray generation (kernel K7).

Counterpart of cudapathtracer_tpu/scene/camera.py: Euler-XYZ rotated
basis (local forward (0,0,-1)), fov_scale = tan(fov/2), +-0.5*aa_jitter
pixel jitter, lens disk r = aperture*sqrt(u), focal plane at focal_dist.
The pinhole factory keeps the reference's defaults (aperture 1e-6,
focal_dist 1/fov in degrees) so images match.

`Camera` holds float32-rounded Python numbers and no tensors, so one camera
serves any device. `generate_rays` launches kernels/csrc/camera.cu for
CUDA tensors and runs `generate_rays_plain` for CPU tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from reference.tpt.utils import rng
from reference.tpt.utils.math import dot, normalize, true_div

_TWO_PI = 2.0 * math.pi


def _rotate_xyz(v, xr, yr, zr):
    """Rotate a float32 3-vector about X, then Y, then Z (radians), with
    float32 cos/sin of the float32 angle as the JAX package computes it."""
    def rot(v, a, i, j):
        c, s = np.cos(np.float32(a)), np.sin(np.float32(a))
        out = v.copy()
        out[i] = c * v[i] - s * v[j]
        out[j] = s * v[i] + c * v[j]
        return out
    v = np.asarray(v, np.float32)
    v = rot(v, xr, 1, 2)     # x: (y, z) -> (c y - s z, s y + c z)
    v = rot(v, yr, 2, 0)     # y: (z, x) -> (c z - s x, s z + c x)
    return rot(v, zr, 0, 1)  # z: (x, y) -> (c x - s y, s x + c y)


def _unit(v):
    v = np.asarray(v, np.float32)
    inv = np.float32(1.0) / np.sqrt(np.maximum(np.float32(
        v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), np.float32(1e-20)))
    return tuple(float(x) for x in v * inv)


def _f32(x) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class Camera:
    origin: tuple
    forward: tuple
    right: tuple
    up: tuple
    fov_scale: float
    aperture: float
    focal_dist: float
    width: int = 0
    height: int = 0
    aa_jitter: float = 2.0

    @staticmethod
    def _make(origin, w, h, xr_deg, yr_deg, zr_deg, fov_deg, aperture,
              focal_dist, aa_jitter=2.0) -> "Camera":
        d2r = math.pi / 180.0
        xr, yr, zr = xr_deg * d2r, yr_deg * d2r, zr_deg * d2r
        fwd = _rotate_xyz([0.0, 0.0, -1.0], xr, yr, zr)
        rgt = _rotate_xyz([1.0, 0.0, 0.0], xr, yr, zr)
        up = _rotate_xyz([0.0, 1.0, 0.0], xr, yr, zr)
        return Camera(
            origin=tuple(_f32(x) for x in origin),
            forward=_unit(fwd), right=_unit(rgt), up=_unit(up),
            fov_scale=_f32(math.tan(fov_deg * 0.5 * d2r)),
            aperture=_f32(aperture), focal_dist=_f32(focal_dist),
            width=w, height=h, aa_jitter=aa_jitter)

    @staticmethod
    def pinhole(origin, w, h, xr_deg, yr_deg, zr_deg, fov_deg,
                aa_jitter=2.0) -> "Camera":
        """The reference's pinhole: aperture 1e-6, focal_dist 1/fov."""
        return Camera._make(origin, w, h, xr_deg, yr_deg, zr_deg, fov_deg,
                            1e-6, 1.0 / fov_deg, aa_jitter)

    @staticmethod
    def thin_lens(origin, w, h, xr_deg, yr_deg, zr_deg, fov_deg, aperture,
                  focal_dist, aa_jitter=2.0) -> "Camera":
        return Camera._make(origin, w, h, xr_deg, yr_deg, zr_deg, fov_deg,
                            aperture, focal_dist, aa_jitter)

    @staticmethod
    def from_config(cfg) -> "Camera":
        if cfg.pinhole_camera:
            return Camera.pinhole(cfg.cam_pos, cfg.width, cfg.height,
                                  *cfg.cam_rot, cfg.cam_fov)
        return Camera.thin_lens(cfg.cam_pos, cfg.width, cfg.height,
                                *cfg.cam_rot, cfg.cam_fov, cfg.cam_aperture,
                                cfg.cam_focal_dist)

    @property
    def aspect(self) -> float:
        return _f32(self.width / self.height)

    def plane_area(self) -> float:
        """Area of the image plane at unit distance, 4 aspect fov_scale^2,
        rounded to float32 after each product as the JAX package does."""
        f32 = np.float32
        return float(f32(f32(4.0 * self.aspect) * f32(self.fov_scale))
                     * f32(self.fov_scale))

    def world_to_raster(self, p: torch.Tensor):
        """Project world points [N,3] to pixel coordinates, the light
        tracer's sensor. Returns (px [N], py [N], on_screen [N] bool)."""
        vec = lambda v: torch.tensor(v, dtype=torch.float32, device=p.device)
        d = p - vec(self.origin)
        dist_z = dot(d, vec(self.forward))
        ok = dist_z > 0.001
        safe_z = torch.where(ok, dist_z, 1.0)
        slope_x = dot(d, vec(self.right)) / safe_z
        slope_y = dot(d, vec(self.up)) / safe_z
        ndc_x = true_div(slope_x, _f32(np.float32(self.aspect)
                                       * np.float32(self.fov_scale)))
        ndc_y = true_div(slope_y, self.fov_scale)
        ok = ok & (torch.abs(ndc_x) <= 1.0) & (torch.abs(ndc_y) <= 1.0)
        px = (ndc_x + 1.0) * 0.5 * float(self.width)
        py = (ndc_y + 1.0) * 0.5 * float(self.height)
        return px, py, ok

    def importance(self, d_world: torch.Tensor):
        """Pinhole importance We and direction pdf for unit directions from
        the lens: pdf_dir = 1 / (A cos^3), We = pdf_dir / cos, A the image
        plane area at unit distance, cos clamped to >= 1e-6. Returns
        (we [N], pdf_dir [N])."""
        fwd = torch.tensor(self.forward, dtype=torch.float32,
                           device=d_world.device)
        cos_t = torch.clamp(dot(d_world, fwd), min=1e-6)
        cos3 = cos_t * cos_t * cos_t
        pdf_dir = 1.0 / (self.plane_area() * cos3)
        return pdf_dir / cos_t, pdf_dir

    def kernel_params(self) -> list:
        """The 19 floats camera.cu takes, in its order."""
        return [*self.origin, *self.right, *self.up, *self.forward,
                self.fov_scale, self.aperture, self.focal_dist, self.aspect,
                float(self.width), float(self.height), self.aa_jitter]

    def generate_rays(self, key, px: torch.Tensor, py: torch.Tensor,
                      ids: torch.Tensor):
        """K7: primary rays for pixels (px, py) [N] (float32), draws keyed
        by the stable ids [N] (int32) under `key`. Returns (o, d) [N,3]."""
        return self.generate_rays_plain(key, px, py, ids)

    def generate_rays_plain(self, key, px, py, ids):
        """Plain version of K7 (any device), operation for operation the
        JAX function."""
        dev = px.device
        vec = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        origin, right, up, forward = (vec(self.origin), vec(self.right),
                                      vec(self.up), vec(self.forward))
        draw = lambda dr: rng.uniform_draw_key_plain(
            *rng.draw_key(key, dr), ids)
        jx = draw(0) - 0.5
        jy = draw(1) - 0.5
        u = ((true_div(2.0 * (px + jx * self.aa_jitter), self.width) - 1.0)
             * self.aspect * self.fov_scale)
        v = (true_div(2.0 * (py + jy * self.aa_jitter), self.height)
             - 1.0) * self.fov_scale
        focal = (origin + right * (u * self.focal_dist)[:, None]
                 + up * (v * self.focal_dist)[:, None]
                 + forward * self.focal_dist)
        radius = self.aperture * torch.sqrt(draw(2))
        theta = _TWO_PI * draw(3)
        lens = (right * (radius * torch.cos(theta))[:, None]
                + up * (radius * torch.sin(theta))[:, None])
        if not self.aperture > 0.0:
            lens = torch.zeros_like(lens)
        o = origin + lens
        return o, normalize(focal - o)
