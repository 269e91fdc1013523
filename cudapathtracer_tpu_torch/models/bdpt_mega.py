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

TPT_MEGA_LIGHT (read on every call under the JAX package's name, as the
JAX engine reads it) walks the light paths with models/light_mega.py's
keyed walk instead (K12's table mode on the card). JAX computes vertex 0
from the endpoint math alone; here it is the endpoint the keyed walk
computed from the same draws (on the card, written by the same launch).
"""

from __future__ import annotations

import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import bdpt, light_mega, paths
from cudapathtracer_tpu_torch.models.vcm import VCMConfig, sample_keys
from cudapathtracer_tpu_torch.models.vcm_mega import (chunk_pixels_of,
                                                      eye_keys, eye_pass_plain,
                                                      mask_pads, mega_chunks)
from cudapathtracer_tpu_torch.scene.materials import TRANSPORT_IMPORTANCE
from cudapathtracer_tpu_torch.utils.metrics import span


def as_machine_cfg(cfg: bdpt.BDPTConfig) -> VCMConfig:
    """The BDPT settings on the mega eye pass's config surface (no merge)."""
    return VCMConfig(
        eye_depth=cfg.eye_depth, light_depth=cfg.light_depth,
        light_trace=cfg.light_trace, nee=cfg.nee, naive=cfg.naive,
        connection=cfg.connection, do_mis=cfg.do_mis, do_merge=False,
        do_sppm=False, paint_weight=cfg.paint_weight,
        sample_environment=cfg.sample_environment)


def light_pass(scene, key_l, pxc, pyc, light_depth: int):
    """The TPT_MEGA_LIGHT light pass of a chunk: (light buffers [L-1,
    c_pix], vertex 0, rays)."""
    return light_mega.walk_with_endpoint(
        scene, key_l, pxc.shape[0], light_depth, TRANSPORT_IMPORTANCE,
        eta_vcm=None, pxc=pxc, pyc=pyc)


# a chunk's stages, each a program span when tracing (utils/metrics.py)
STAGES = {st: f"tpt.step.bdpt_mega.{st}"
          for st in ("light_walk", "splat", "eye_pass")}


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: bdpt.BDPTConfig, width: int = 0,
                  chunk_pixels: int = 0):
    """One BDPT sample of the mega engine over the whole frame (px, py [P]
    in raster order) -> (radiance [P,3] with the splat added, rays traced:
    a Python int on the CPU, a 0-d int64 tensor on the card)."""
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
    keyed = light_mega.enabled()
    for ci in range(ch.n_chunks):
        pxc, pyc, cnt = chunk_pixels_of(px, py, ci, ch.c_pix)
        with span(STAGES["light_walk"]):
            if keyed:
                lbufs, lv0, r = light_pass(scene, key_l, pxc, pyc,
                                           cfg.light_depth)
            else:
                lbufs, lv0, r = paths.generate_light_path(
                    scene, key_l, pxc, pyc, cfg.light_depth)
            lbufs = mask_pads(lbufs, cnt)
        rays += r
        if cfg.light_trace:
            live = torch.arange(ch.c_pix, device=dev) < cnt
            with span(STAGES["splat"]):
                fb, r = bdpt.light_trace_splat(scene, camera, lbufs, lv0,
                                               cfg, fb, active=live)
            rays += r
        g0 = ci * ch.c_pix
        with span(STAGES["eye_pass"]):
            li, r, _ = eye_pass_plain(scene, camera, key_e, lbufs, None,
                                      mcfg, pxc[:cnt], pyc[:cnt], g0,
                                      flavor="bdpt")
        out[g0:g0 + cnt] = li
        rays += r
    return out + fb, rays


def render_kernel(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: bdpt.BDPTConfig, width: int = 0,
                  chunk_pixels: int = 0):
    """Per chunk: K12 (light; its table mode under TPT_MEGA_LIGHT),
    bdpt_splat, K14 (mega_eye, bdpt flavour); one ray-count accumulator
    per chunk, summed on the card into a 0-d int64 tensor (no host
    sync)."""
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
    keyed = light_mega.enabled()
    for ci in range(ch.n_chunks):
        pxc, pyc, cnt = chunk_pixels_of(px, py, ci, ch.c_pix)
        rays = torch.zeros(ch.c_pix, dtype=torch.int32, device=dev)
        with span(STAGES["light_walk"]):
            if keyed:
                lbufs, lv0, lrays = light_pass(scene, key_l, pxc, pyc,
                                               cfg.light_depth)
                sums.append(lrays)
            else:
                lw = kernels.bdpt_walk(scene, pxc, pyc, lkeys, mode="light",
                                       max_depth=cfg.light_depth, rays=rays)
                lbufs, lv0 = lw["bufs"], lw["v0"]
            lbufs = mask_pads(lbufs, cnt)
        if cfg.light_trace:
            with span(STAGES["splat"]):
                kernels.bdpt_splat(scene, camera, lbufs, lv0, fb, rays, cfg,
                                   n_live=cnt)
        with span(STAGES["eye_pass"]):
            kernels.mega_eye(scene, camera, ekeys, lbufs, None, out, rays,
                             mcfg, px=pxc, py=pyc, cnt=cnt,
                             gbase=ci * ch.c_pix, flavor="bdpt")
        sums.append(rays.sum())
    return out + fb, torch.stack(sums).sum()
