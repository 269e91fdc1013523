"""The default unidirectional engine ("Engine: mega"), one path per thread.

Counterpart of cudapathtracer_tpu/models/unidirectional_mega.py:
render_sample. The JAX engine is a persistent lane machine (a refill queue,
mini/full transitions, retirement slots, lane-major state) that keeps TPU
lanes busy; its image does not depend on that schedule, because every draw
is keyed by the path's position in the pixel list and its event counter
(id = index * 191 + lit, keys draw_key(skey, d)) and primary rays by pixel
id. So the port runs the same estimator one path per thread, in program
order: on CUDA tensors a sample is one launch of the per-path megakernel
(K5, kernels/csrc/uni_mega.cu), on CPU tensors the plain version
(models/unidirectional.render_plain with the mega draw schedule), which is
the kernel's oracle and is never called on the card's main path. Each
path's radiance retires through RGB9E5 (utils/packing.py), as the JAX
engine's retirement slots hold it (its default TPT_MEGA_RETIRE=slots).

One deliberate difference from the JAX engine: every path starts from the
initial medium stack (the ambient medium in slot 0, top 1). The JAX lane
machine gives that stack to the paths of its first wave only; a lane it
refills starts from an all-zero stack with top 0 (unidirectional_mega.py:
629-631), so in scenes with dielectric boundaries its image depends on the
lane width (ROADMAP Queue 3). On scenes without boundaries, the goldens and
the main path among them, the two agree.

`shade_eval_plain` is the plain counterpart of the kernel library's test
entry (kernels.shade_eval): the K2-K4 functions once per hit.
"""

from __future__ import annotations

import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import common
from cudapathtracer_tpu_torch.models.unidirectional import (
    _D_BSDF, _D_NEE, render_batch_kernel, render_kernel, render_plain)
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.math import EPSILON, length_sq, to_local


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  max_depth: int, use_mis: bool = True,
                  sample_environment: bool = False):
    """One sample over pixels (px, py) [P] (int) -> (radiance [P,3]
    float32, rays traced: a Python int on the CPU, a 0-d int64 tensor on
    the card)."""
    fn = render_plain if px.device.type == "cpu" else render_kernel
    return fn(scene, camera, base_key, sample_idx, px, py,
              max_depth=max_depth, use_mis=use_mis,
              sample_environment=sample_environment, schedule="mega")


def render_batch(scene, camera, base_key, s0: int, px, py, k: int, *,
                 max_depth: int, use_mis: bool = True,
                 sample_environment: bool = False):
    """Samples s0 .. s0+k-1 in one launch of K5 in the mega schedule (CUDA
    tensors; models/batch.py)."""
    return render_batch_kernel(scene, camera, base_key, s0, px, py, k,
                               max_depth=max_depth, use_mis=use_mis,
                               sample_environment=sample_environment,
                               schedule="mega")


def _mega_keys(skey) -> list:
    """The 18 words of draw_key(skey, d), d = 0..8."""
    return [w for dr in range(9) for w in rng.draw_key(skey, dr)]


def shade_eval(scene, o, d, hit, ids, eta_i, skey):
    """K2-K4 once per hit: kernels.shade_eval on CUDA tensors,
    shade_eval_plain on CPU tensors. -> [N, 38] (columns below)."""
    if o.device.type == "cpu":
        return shade_eval_plain(scene, o, d, hit, ids, eta_i, skey)
    c = lambda x: x.contiguous()
    return kernels.shade_eval(scene, c(o), c(d), c(hit.t), c(hit.tri),
                              c(hit.u), c(hit.v), c(ids), c(eta_i),
                              _mega_keys(skey))


def shade_eval_plain(scene, o, d, hit, ids, eta_i, skey):
    """Plain K2-K4 for hits (o, d [N,3], hit: traverse.Hit) with draws
    keyed by draw_key(skey, d) and ids [N]. Columns: point 0:3, normal 3:6,
    uv 6:8, backface 8, albedo 9:12, transmission 12, NEE contrib 13:16,
    light_pdf 16, NEE wo_local 17:20, shadow origin 20:23, dir 23:26,
    max_t 26, active 27, BSDF pdf of the NEE direction 28, BSDF sample wo
    29:32, f 32:35, pdf 35, mat_id 36, emissive 37. NEE is active on hits
    that are neither emissive nor specular."""
    info, mat = traverse.shade_data(scene, o, d, hit)
    normal = info["normal"]
    wi_local = to_local(d, normal)
    albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
    trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])
    emissive = length_sq(info["emission"]) > EPSILON
    active = hit.valid & ~emissive & ~mat.is_specular
    ns = common.nee_sample(scene, skey, _D_NEE, info["point"], normal,
                           wi_local, mat, albedo, eta_i, active, ids=ids,
                           transmission=trans)
    bpdf = bsdf_ops.bsdf_pdf(mat, -wi_local, ns.wo_local, eta_i,
                             transmission=trans)
    wo, f, pdf = bsdf_ops.bsdf_sample(skey, _D_BSDF, mat, albedo, -wi_local,
                                      info["backface"], eta_i, ids=ids,
                                      transmission=trans)
    col = lambda x: x.to(torch.float32)[:, None]
    return torch.cat([
        info["point"], normal, info["uv"], col(info["backface"]), albedo,
        col(trans), ns.contrib, col(ns.light_pdf), ns.wo_local, ns.origin,
        ns.dir, col(ns.max_t), col(ns.active), col(bpdf), wo, f, col(pdf),
        col(info["mat_id"]), col(emissive)], dim=1)
