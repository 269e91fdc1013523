"""The naive unidirectional path tracer ("Integrator:
NAIVE_UNIDIRECTIONAL").

Counterpart of cudapathtracer_tpu/models/naive.py:render_sample: BSDF
sampling only (no NEE, MIS or Russian roulette), eta_i = 1, emission
added on every hit after the sampling-validity break (pdf <= 0 or
|f|^2 < EPSILON ends the path), at most max_depth bounces. Bounce `depth`
draws 0-3 under bounce_key(skey, depth) with the pixel id; the primary
ray under fold_in(skey, 2^20); the next ray is the unnormalized
to_world(wo) offset to the side of wo.z. On CUDA tensors a sample is one
launch of K5 in its naive schedule (uni_mega.cu, counted as "naive"); on
CPU tensors the plain per-bounce loop below.
"""

from __future__ import annotations

import torch

from cudapathtracer_tpu_torch.models import common
from cudapathtracer_tpu_torch.models.unidirectional import render_batch_kernel
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.math import (EPSILON, RAY_EPSILON,
                                                 length_sq, to_local,
                                                 to_world)
from cudapathtracer_tpu_torch.utils.metrics import span

_D_BSDF = 0   # ..3


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  max_depth: int, sample_environment: bool = False):
    """One sample for pixels (px, py) [N] -> (radiance [N,3] float32, rays
    traced: a Python int on the CPU, a 0-d int64 tensor on the card)."""
    fn = render_plain if px.device.type == "cpu" else render_kernel
    return fn(scene, camera, base_key, sample_idx, px, py,
              max_depth=max_depth, sample_environment=sample_environment)


def render_kernel(scene, camera, base_key, sample_idx, px, py, *,
                  max_depth: int, sample_environment: bool = False):
    """One launch of K5's naive schedule at k = 1 on CUDA tensors; the rays
    as a 0-d int64 tensor."""
    return render_batch(scene, camera, base_key, sample_idx, px, py, 1,
                        max_depth=max_depth,
                        sample_environment=sample_environment)


def render_batch(scene, camera, base_key, s0: int, px, py, k: int, *,
                 max_depth: int, sample_environment: bool = False):
    """Samples s0 .. s0+k-1 in one launch of K5 in its naive schedule
    (CUDA tensors; models/batch.py)."""
    return render_batch_kernel(scene, camera, base_key, s0, px, py, k,
                               max_depth=max_depth, use_mis=False,
                               sample_environment=sample_environment,
                               schedule="naive")


def render_plain(scene, camera, base_key, sample_idx, px, py, *,
                 max_depth: int, sample_environment: bool = False):
    """Plain version of the naive schedule (any device): a per-bounce loop
    over all lanes, dead ones masked."""
    n, dev = px.shape[0], px.device
    skey = rng.sample_key(base_key, sample_idx)
    pid = rng.pixel_ids(px, py)
    with span("tpt.step.naive.camera"):
        o, d = camera.generate_rays_plain(rng.fold_in(skey, 2 ** 20),
                                          px.to(torch.float32),
                                          py.to(torch.float32), pid)
    with span("tpt.step.naive.paths"):
        beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
        li = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        eta_i = torch.ones(n, dtype=torch.float32, device=dev)
        rays = 0
        for depth in range(max_depth):
            if not bool(alive.any()):
                break
            bkey = rng.bounce_key(skey, depth)
            rays += int(alive.sum())
            hit = traverse.closest_hit(scene, o, d, active=alive)
            info, mat = traverse.shade_data(scene, o, d, hit)
            miss = alive & ~hit.valid
            li = li + torch.where(
                miss[:, None],
                beta * common.sample_sky(d, sample_environment), 0.0)
            alive = alive & hit.valid
            normal = info["normal"]
            wi_local = to_local(d, normal)
            albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
            trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])
            wo_local, f_val, pdf = bsdf_ops.bsdf_sample(
                bkey, _D_BSDF, mat, albedo, -wi_local, info["backface"],
                eta_i, ids=pid, transmission=trans)
            alive = alive & ~((pdf <= 0.0) | (length_sq(f_val) < EPSILON))
            up = alive[:, None]
            # emission after the sampling-validity break
            li = li + torch.where(up, info["emission"] * beta, 0.0)
            beta = torch.where(up, beta * f_val * (
                torch.abs(wo_local[..., 2])
                / torch.clamp(pdf, min=1e-20))[:, None], beta)
            side = torch.where(wo_local[..., 2] > 0.0, 1.0, -1.0)
            o = torch.where(up, info["point"] + normal
                            * (side * RAY_EPSILON)[:, None], o)
            d = torch.where(up, to_world(wo_local, normal), d)
        return li, rays
