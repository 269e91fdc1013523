"""BIDIRECTIONAL with the default engine ("Integrator: BIDIRECTIONAL", no
Engine line or "Engine: mega").

Counterpart of cudapathtracer_tpu/models/bdpt_mega.py: the BDPT estimator
of models/bdpt.py with the eye pass of the mega engine in its "bdpt"
flavour (models/vcm_mega.py: no eta_vcm or d_vm, NEE's linear pdf ratio,
the camera-trace pdf for s=0 at depth 0, the firefly clamp only on deeper
s=0 hits, no merge). Per chunk of the JAX partition (vcm_mega.mega_chunks)
and sample: the BDPT light walk of the chunk's c_pix paths (K12; light
vertices 1 .. light_depth-1 stored, pad paths walked and masked), the t=1
splat of its live paths (K11), the mega eye pass of its live pixels (K14);
then the splats are added, unrounded. On CUDA tensors that is three
launches per chunk; on CPU tensors the plain versions.
"""

from __future__ import annotations

import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import bdpt, paths
from cudapathtracer_tpu_torch.models.vcm import VCMConfig, sample_keys
from cudapathtracer_tpu_torch.models.vcm_mega import (chunk_pixels_of,
                                                      eye_keys, eye_pass_plain,
                                                      mask_pads, mega_chunks)


def as_machine_cfg(cfg: bdpt.BDPTConfig) -> VCMConfig:
    """The BDPT settings on the mega eye pass's config surface (no merge)."""
    return VCMConfig(
        eye_depth=cfg.eye_depth, light_depth=cfg.light_depth,
        light_trace=cfg.light_trace, nee=cfg.nee, naive=cfg.naive,
        connection=cfg.connection, do_mis=cfg.do_mis, do_merge=False,
        do_sppm=False, paint_weight=cfg.paint_weight,
        sample_environment=cfg.sample_environment)


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: bdpt.BDPTConfig, width: int = 0,
                  chunk_pixels: int = 0):
    """One BDPT sample of the mega engine over the whole frame (px, py [P]
    in raster order) -> (radiance [P,3] with the splat added, rays traced
    as a Python int)."""
    fn = render_plain if px.device.type == "cpu" else render_kernel
    return fn(scene, camera, base_key, sample_idx, px, py, cfg=cfg,
              width=width, chunk_pixels=chunk_pixels)


def render_plain(scene, camera, base_key, sample_idx, px, py, *,
                 cfg: bdpt.BDPTConfig, width: int = 0,
                 chunk_pixels: int = 0):
    """Plain versions of K12, K11 and K14 per chunk; any device."""
    key_l, key_e = sample_keys(base_key, sample_idx)
    p_total, dev = px.shape[0], px.device
    ch = mega_chunks(p_total, chunk_pixels, width)
    mcfg = as_machine_cfg(cfg)
    out = torch.empty((p_total, 3), dtype=torch.float32, device=dev)
    fb = torch.zeros((p_total, 3), dtype=torch.float32, device=dev)
    rays = 0
    for ci in range(ch.n_chunks):
        pxc, pyc, cnt = chunk_pixels_of(px, py, ci, ch.c_pix)
        lbufs, lv0, r = paths.generate_light_path(scene, key_l, pxc, pyc,
                                                  cfg.light_depth)
        lbufs = mask_pads(lbufs, cnt)
        rays += r
        if cfg.light_trace:
            live = torch.arange(ch.c_pix, device=dev) < cnt
            fb, r = bdpt.light_trace_splat(scene, camera, lbufs, lv0, cfg,
                                           fb, active=live)
            rays += r
        g0 = ci * ch.c_pix
        li, r, _ = eye_pass_plain(scene, camera, key_e, lbufs, None, mcfg,
                                  pxc[:cnt], pyc[:cnt], g0, flavor="bdpt")
        out[g0:g0 + cnt] = li
        rays += r
    return out + fb, rays


def render_kernel(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: bdpt.BDPTConfig, width: int = 0,
                  chunk_pixels: int = 0):
    """Per chunk: K12 (light), bdpt_splat, K14 (mega_eye, bdpt flavour);
    one ray-count accumulator per chunk and one host sync for the sum."""
    key_l, key_e = sample_keys(base_key, sample_idx)
    p_total, dev = px.shape[0], px.device
    ch = mega_chunks(p_total, chunk_pixels, width)
    mcfg = as_machine_cfg(cfg)
    px = px.to(torch.int32).contiguous()
    py = py.to(torch.int32).contiguous()
    out = torch.empty((p_total, 3), dtype=torch.float32, device=dev)
    fb = torch.zeros((p_total, 3), dtype=torch.float32, device=dev)
    lkeys, ekeys = paths.walk_keys(key_l, "light"), eye_keys(key_e)
    sums = []
    for ci in range(ch.n_chunks):
        pxc, pyc, cnt = chunk_pixels_of(px, py, ci, ch.c_pix)
        rays = torch.zeros(ch.c_pix, dtype=torch.int32, device=dev)
        lw = kernels.bdpt_walk(scene, pxc, pyc, lkeys, mode="light",
                               max_depth=cfg.light_depth, rays=rays)
        lbufs = mask_pads(lw["bufs"], cnt)
        if cfg.light_trace:
            kernels.bdpt_splat(scene, camera, lbufs, lw["v0"], fb, rays, cfg,
                               n_live=cnt)
        kernels.mega_eye(scene, camera, ekeys, lbufs, None, out, rays, mcfg,
                         px=pxc, py=pyc, cnt=cnt, gbase=ci * ch.c_pix,
                         flavor="bdpt")
        sums.append(rays.sum())
    return out + fb, int(torch.stack(sums).sum())
