#!/usr/bin/env python3
"""Where the staged kernels spend their time, and A/B runs of two trees,
on one GPU.

Times one 1920x1080 sample's eye pass of the PyTorch port by CUDA events,
on fixed light buffers and photon grids (sample 0 of the ~82k-triangle
Cornell + bunny scene at configs/cornell.rendertron's depths: eye 8,
light 6), with the pass's strategy switches turned off in turn
(--toggles, the default when no other part is asked for):

  * the classic VCM pass (kernels.vcm_eye): everything on; no
    connections; no merge; no NEE; connections and merge off together
    (the bare walk with s=0 and NEE);
  * the classic SPPM pass: as shipped; without the merge (which also
    lifts SPPM's end after the first non-delta surface, so that walk is
    longer);
  * the mega eye pass (kernels.mega_eye, both chunks) in its VCM flavour
    with the classic VCM toggles, and in its BDPT flavour: everything on,
    no connections (its bare walk), no NEE;
  * the classic VCM pass on the same scene built with
    traversal="threaded" (the threaded instantiation), same toggles.

A toggled run changes the estimator: it is timed, never compared. It
prints ptxas' registers, stack frame and spill bytes of every eye-pass,
K5 and K11-K13 instantiation of the build (the library is rebuilt with
-Xptxas=-v). The other parts:

  * --bit-equal prints K14's bit-equal pixel share against its plain
    version (the tree's chip_smoke.compare_mega, 1080p, three flavours);
  * --renders times the cells (renders(); --cells REGEX keeps those whose
    name it matches): Mrays/s over a render, one sample's device ms by
    CUDA events (a batch's over its samples at more than one a dispatch)
    and the peak memory rise, through driver.Renderer for bdpt-, mega-,
    classic-, naive-, vcm-, sppm-, vcm-mega-, sppm-mega- and
    bdpt-mega-1080p (4 spp), keyed-1080p (VCM-mega under
    TPT_MEGA_LIGHT=1), uni-mega-256 and naive-256 on cornell_blocks
    at 1 and 8 samples a dispatch (--spp-256 samples),
    configs/vcm_caustics.rendertron as shipped with either engine, and
    through render_sample on the threaded scene (no config key selects
    it) for BDPT, K5 classic, VCM and SPPM; and K13 (kernels.bdpt_connect)
    and one K5 mega sample alone at 1080p, and the launches of one
    bdpt-, vcm- and sppm-1080p sample by CUDA events, on each scene
    ("1080p alone");
  * --dump DIR writes the outputs whose bits a redesign of K5, K12 or K13
    must not move (--dump-cases REGEX keeps the cases whose name it
    matches): K12's light walk (with and without VCM's d_vm chain) and
    eye walk of sample 0 at light 6 and eye 8 on both scenes, and its
    table mode's light walk on BVH8, every output (the buffers' dead rows
    included, v0, the escape record, rays, rows) kept as a SHA-256; K5's
    radiance, rays and rows for the mega, classic and naive schedules on
    the 1080p bunny scene built for BVH8 and for the threaded engine,
    with k = 1 and k = 8 samples a launch (sample 0 on), and K13's
    radiance, rays and rows on the tree's K12 walks of sample 0 at eye 8
    and light 6, without a frame buffer and with a fixed one; K15's batch
    entries on the threaded scene (k15_case: closest hits of the primary
    rays, shadow factors of their NEE rays, rows) and K8's grid of the
    1080p VCM sample (k8_case: sorted rows and (start, end) table);
    --compare A B then prints, case by case, whether two dumps are
    bit-equal;
  * --per P [P ...] times K13's pair stage with P pairs a thread
    (kernels.bdpt_pairs(per=P)) on both scenes, and checks that the
    terms, rays and rows do not depend on P;
  * --walks times K12's 1080p walks (light, light with eta_vcm, eye; with
    a digest of every output, so that two trees' walks compare) and K11's
    BDPT form whole and stage by stage, its first stage's kernels and
    the light walk's (its prologue) by the profiler (walks_and_splat);
  * --k1 times K1 (the BVH8 traversal) in its two batch entries and in
    each kernel it runs in, one 1080p sample's launch each on the BVH8
    scene (trace_hosts): K5's mega and classic schedules, K12's light and
    eye walks, K11's trace stage, K13's pair stage, the classic VCM eye
    pass's walk and connection stages; tools/k1_attribution.py runs it on
    copies of a tree with one change to K1 or its hosts each, in turns;
  * --k15 times K15 (the threaded traversal) the same way on the threaded
    scene (K5's classic schedule only: its mega schedule traces BVH8), and
    --sort times K8's sort against torch.sort on the 1080p VCM keys with
    its launches and a digest of its outputs (sort_times);
    tools/k8_k15_attribution.py runs both on copies of a tree, in turns;
  * --shade times the shading transition (K2-K4) in its test entry and in
    every kernel it runs in, and --merge the merge query (K9) in its entry
    and its two hosts, the classic and K14 gathers (shade_hosts);
    tools/shade_attribution.py runs them on copies of a tree, in turns;
    tools/rng_attribution.py runs --shade with --rng, which times K6's
    entries and K7's on the reference pinhole (aperture 1e-6), a camera of
    aperture 0 and a thin lens (rng_entries); --aperture0 renders
    everything through a camera of aperture 0 (the reference pinhole's
    geometry, no lens) in place of the reference pinhole.
  * --dump also writes, per engine, the eye passes' walk, connection and
    gather stages (the classic VCM pass; the classic VCM pass at the
    upstream's deployment, 800x800 at eye 16 and light 10, vcm-upstream-
    800's; the classic SPPM pass; on BVH8 also K14's VCM and BDPT
    flavours, chunk 0): their records and contributions (filled with NaN
    and -1 before the stages, so entries left unwritten compare, and an
    unwritten flag word shows), the gather's radiance and merge-dropped
    counts, rays and rows; and K11's queue (both forms): the tile
    offsets, each tile's entries in ascending order (the queue has no
    order inside a tile), the rays, and the trace stage's rows
    (eye_k11_cases).
  * --eye-walks times the eye walk stage alone (kernels.eye_walk on a
    set-up pass) in each of its instantiations, with the walk's lane
    counters where the tree's walk takes them (eye_walks): the classic VCM
    pass at the upstream's deployment (800x800, eye 16, light 10) on
    BVH8, and at 1080p at configs/cornell.rendertron's depths the classic
    VCM pass on both scenes, the classic SPPM pass and K14's VCM and BDPT
    flavours (chunk 0).

It uses only entry points whose signatures both designs of a redesigned
kernel share (or tells them apart), so --root may name another checkout
of the repository (its package is imported and its kernels built there),
which lets one call time two trees in turns (parent, change, change,
parent). Every line names the card and its power limit. Run from the
repository root:

    python3 tools/eye_attribution.py [--root DIR] [--toggles] [--reps 2]
        [--bit-equal] [--renders [--cells REGEX] [--spp-256 N]]
        [--dump DIR [--dump-cases REGEX]] [--per 1 6 42] [--walks] [--k1]
        [--k15] [--sort] [--shade] [--merge] [--rng] [--aperture0]
        [--eye-walks]
        [--reuse-build] [--json FILE]
    python3 tools/eye_attribution.py --compare DUMP_A DUMP_B
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, SPP, DEPTH = 1920, 1080, 4, 8
UPSTREAM_SIZE = 800   # the upstream's VCM deployment's frame (800x800)
VCM_ETA = 5.1471854   # eta_vcm of a VCM light walk (chip_smoke's)
CLASSIC_TOGGLES = {"all on": {}, "no connections": dict(connection=False),
                   "no merge": dict(do_merge=False), "no NEE": dict(nee=False),
                   "bare walk": dict(connection=False, do_merge=False)}
SPPM_TOGGLES = {"as shipped": {}, "no merge": dict(do_merge=False)}
BDPT_TOGGLES = {"all on": {}, "no connections (bare walk)":
                dict(connection=False), "no NEE": dict(nee=False)}


def _events_ms(fn, reps: int = 3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def ptxas_eye(log: str) -> dict:
    """{entry: (registers, stack bytes, spill stores, spill loads, shared
    bytes)} of the eye-pass, K1, K5, K11-K13, K15, K8-sort, K2-K4 entry and
    K9 entry kernels in a
    ptxas -v report (a kernel that calls a function that is not inlined
    reports that function's stack frame first: its first numbers are the
    callee's)."""
    out = {}
    for m in re.finditer(r"Compiling entry function "
                         r"'([^']*(?:eye|uni_mega|bdpt_|splat_|traverse8|"
                         r"traverse_bin|radix_|shade_eval|slots_kernel)"
                         r"[^']*)'"
                         r".*?(\d+) bytes stack frame, (\d+) bytes spill "
                         r"stores, (\d+) bytes spill loads.*?Used (\d+) "
                         r"registers([^\n]*)", log, re.S):
        name, stack, st, ld, regs, rest = m.groups()
        smem = re.search(r"(\d+) bytes smem", rest)
        out[name] = (int(regs), int(stack), int(st), int(ld),
                     int(smem.group(1)) if smem else 0)
    return out


def pass_cfg(cfg0, integ: str, engine: str):
    """The eye pass configuration of cfg0 under another integrator and
    engine: VCMConfig, or K14's BDPT machine config for BIDIRECTIONAL."""
    from cudapathtracer_tpu_torch.models import bdpt, bdpt_mega, vcm
    c = dataclasses.replace(cfg0, integrator=integ, engine=engine)
    c = c.normalized()
    if integ == "BIDIRECTIONAL":
        return bdpt_mega.as_machine_cfg(bdpt.BDPTConfig.from_config(c))
    return vcm.VCMConfig.from_config(c)


def classic_inputs(scene, px, py, cfg):
    """Sample 0's VCM light walk (K12, eta_vcm) and photon grid (K8)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    n = px.shape[0]
    key_l, key_e = vcm.sample_keys(rng.base_key(), 0)
    mr, eta, norm = vcm.sample_scalars(scene, cfg, 0, n)
    lb = kernels.bdpt_walk(
        scene, px, py, paths.walk_keys(key_l, "light"), mode="light",
        max_depth=cfg.light_depth + 1,
        rays=torch.zeros(n, dtype=torch.int32, device=px.device),
        eta_vcm=eta)["bufs"]
    grid = hashgrid.build_grid_kernel(lb, scene.scene_min, mr,
                                      hashgrid.photon_salt(0))
    return dict(lb=lb, grid=grid, mr=mr, eta=eta, norm=norm,
                keys=paths.walk_keys(key_e, "eye"))


def classic_eye_pass(scene, cam, px, py, cfg, with_rows: bool = False):
    """Sample 0's classic eye pass over px, py on classic_inputs, set up
    for its stage launches (its rays zero): (the pass, the inputs)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.ops import hashgrid
    inp = classic_inputs(scene, px, py, cfg)
    ep = kernels.vcm_eye_pass(
        scene, cam, inp["keys"], inp["lb"], inp["grid"], None,
        torch.zeros(px.shape[0], dtype=torch.int32, device=px.device), cfg,
        px=px, py=py, merge_radius=inp["mr"], eta_vcm=inp["eta"],
        merge_norm=inp["norm"], with_rows=with_rows,
        **hashgrid.merge_switches(cfg.max_per_cell))
    return ep, inp


def classic_pass(scene, cam, px, py, cfg, inp):
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.ops import hashgrid
    rays = torch.zeros(px.shape[0], dtype=torch.int32, device=px.device)
    kernels.vcm_eye(scene, cam, inp["keys"], inp["lb"], inp["grid"], None,
                    rays, cfg, px=px, py=py, merge_radius=inp["mr"],
                    eta_vcm=inp["eta"], merge_norm=inp["norm"],
                    **hashgrid.merge_switches(cfg.max_per_cell))


def mega_inputs(scene, px, py, cfg, flavor: str):
    """Per chunk of sample 0: the light walk (pads masked) and, under VCM,
    the photon grid."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm, vcm_mega
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    key_l, key_e = vcm.sample_keys(rng.base_key(), 0)
    ch = vcm_mega.mega_chunks(px.shape[0])
    out = []
    for ci in range(ch.n_chunks):
        pxc, pyc, cnt = vcm_mega.chunk_pixels_of(px, py, ci, ch.c_pix)
        rays = torch.zeros(ch.c_pix, dtype=torch.int32, device=px.device)
        mr = eta = norm = 0.0
        if flavor == "vcm":
            mr, eta, norm = vcm_mega.chunk_scalars(scene, cfg, 0, cnt)
        lw = kernels.bdpt_walk(
            scene, pxc, pyc, paths.walk_keys(key_l, "light"), mode="light",
            max_depth=cfg.light_depth + (flavor == "vcm"), rays=rays,
            eta_vcm=eta if flavor == "vcm" else None)
        lb = vcm_mega.mask_pads(lw["bufs"], cnt)
        grid = (hashgrid.build_grid_kernel(lb, scene.scene_min, mr,
                                           hashgrid.photon_salt(0))
                if flavor == "vcm" else None)
        out.append(dict(pxc=pxc, pyc=pyc, cnt=cnt, gbase=ci * ch.c_pix,
                        lb=lb, grid=grid, mr=mr, eta=eta, norm=norm,
                        keys=vcm_mega.eye_keys(key_e)))
    return out


def mega_pass(scene, cam, cfg, flavor: str, chunks, out):
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.ops import hashgrid
    sw = (hashgrid.merge_switches(cfg.max_per_cell) if flavor == "vcm"
          else {})
    for ch in chunks:
        rays = torch.zeros(ch["pxc"].shape[0], dtype=torch.int32,
                           device=out.device)
        kernels.mega_eye(scene, cam, ch["keys"], ch["lb"], ch["grid"], out,
                         rays, cfg, px=ch["pxc"], py=ch["pyc"],
                         cnt=ch["cnt"], gbase=ch["gbase"], flavor=flavor,
                         merge_radius=ch["mr"], eta_vcm=ch["eta"],
                         merge_norm=ch["norm"], **sw)


def attribution(scene, tsc, cam, px, py, cfg0, reps: int = 2,
                log=print) -> dict:
    """The toggle table: {pass: {toggle: ms}} for one 1080p sample: the
    classic and mega passes on scene (BVH8) and the classic VCM pass on
    tsc (threaded), each where it is not None."""
    import torch
    res = {}


    def run(name, toggles, base, fn):
        res[name] = {}
        for tog, over in toggles.items():
            c = dataclasses.replace(base, **over)
            res[name][tog] = _events_ms(lambda: fn(c), reps)
        log(f"[attribution] {name}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in res[name].items()))

    cv = pass_cfg(cfg0, "VCM", "classic")
    if scene is not None:
        inp = classic_inputs(scene, px, py, cv)
        run("classic VCM", CLASSIC_TOGGLES, cv,
            lambda c: classic_pass(scene, cam, px, py, c, inp))
        run("classic SPPM", SPPM_TOGGLES, pass_cfg(cfg0, "SPPM", "classic"),
            lambda c: classic_pass(scene, cam, px, py, c, inp))
        del inp
        out = torch.zeros((px.shape[0], 3), device=px.device)
        mv = pass_cfg(cfg0, "VCM", "mega")
        chunks = mega_inputs(scene, px, py, mv, "vcm")
        run("K14 VCM (2 chunks)", CLASSIC_TOGGLES, mv,
            lambda c: mega_pass(scene, cam, c, "vcm", chunks, out))
        mb = pass_cfg(cfg0, "BIDIRECTIONAL", "mega")
        chunks = mega_inputs(scene, px, py, mb, "bdpt")
        run("K14 BDPT (2 chunks)", BDPT_TOGGLES, mb,
            lambda c: mega_pass(scene, cam, c, "bdpt", chunks, out))
        del chunks, out
    if tsc is not None:
        inp = classic_inputs(tsc, px, py, cv)
        run("classic VCM, threaded scene", CLASSIC_TOGGLES, cv,
            lambda c: classic_pass(tsc, cam, px, py, c, inp))
        del inp
    return res


def bit_equal_shares(root: str, scene, cam, px, py, cfg0, log=print):
    """K14 against its plain version on both chunks of the 1080p sample in
    the VCM, SPPM and BDPT flavours, through the tree's own
    chip_smoke.compare_mega (rays and dropped photons equal, >= 99.9% of
    the pixels within rtol 1e-3): {integrator: bit-equal pixel share}."""
    from cudapathtracer_tpu_torch.models import bdpt, bdpt_mega, vcm
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = {}
    for integ in ("VCM", "SPPM", "BIDIRECTIONAL"):
        c = dataclasses.replace(cfg0, integrator=integ,
                                engine="mega").normalized()
        if integ == "BIDIRECTIONAL":
            cfg = bdpt_mega.as_machine_cfg(bdpt.BDPTConfig.from_config(c))
        else:
            cfg = vcm.VCMConfig.from_config(c)
        res = smoke.compare_mega(scene, cam, px, py, cfg,
                                 "bdpt" if integ == "BIDIRECTIONAL"
                                 else "vcm", 0, f"{integ} 1080p")
        out[integ] = res["same"]
        del res
    log("[attribution] K14 bit-equal pixel share against its plain "
        "version: " + ", ".join(f"{k} {v:.6f}" for k, v in out.items()))
    return out


def k5(scene, cam, px, py, schedule: str, s0: int, k: int):
    """K5 over samples s0..s0+k-1: (li, rays, rows) through the tree's own
    entry (one entry for any k that derives the keys on the card, or the
    older single and k-sample entries that take host key words)."""
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.utils import rng
    kw = dict(max_depth=DEPTH, use_mis=schedule != "naive",
              sample_environment=False, schedule=schedule,
              air_priority=scene.air_priority, with_rows=True)
    if hasattr(kernels, "render_unidirectional_batch"):   # older design
        from cudapathtracer_tpu_torch.models import unidirectional
        keys = [unidirectional.kernel_keys(rng.base_key(), s)
                for s in range(s0, s0 + k)]
        if k == 1:
            return kernels.render_unidirectional(
                scene, px, py, cam.kernel_params(), keys[0], **kw)
        return kernels.render_unidirectional_batch(
            scene, px, py, cam.kernel_params(),
            kernels.upload_words(keys, px.device), **kw)
    return kernels.render_unidirectional(scene, px, py, cam.kernel_params(),
                                         rng.base_key(), s0, k, **kw)


def k13_inputs(scene, cam, px, py, bcfg):
    """Sample 0's K12 walks (light and eye) and the connection key."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import bdpt, paths
    from cudapathtracer_tpu_torch.utils import rng
    key_l, key_e, key_c = bdpt.sample_keys(rng.base_key(), 0)
    n = px.shape[0]
    zero = lambda: torch.zeros(n, dtype=torch.int32, device=px.device)
    lw = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_l, "light"),
                           mode="light", max_depth=bcfg.light_depth,
                           rays=zero())
    ew = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_e, "eye"),
                           mode="eye", max_depth=bcfg.eye_depth, rays=zero(),
                           camera=cam)
    return lw, ew, key_c


def k12_cases(scene, cam, px, py, bcfg, table: bool):
    """Sample 0's K12 walks of the 1080p frame, every output on the host:
    {case: {name: tensor}}. The light walk (light depth), the same with
    VCM's d_vm chain (eta_vcm) and the eye walk (eye depth); with table,
    the table mode's light walk (the keys of light_mega.key_tables) with
    and without eta_vcm, BVH8 on every scene."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import light_mega, paths
    key_l, key_e, _ = bdpt_keys()
    n = px.shape[0]
    runs = {"light": dict(mode="light", max_depth=bcfg.light_depth),
            "light_vm": dict(mode="light", max_depth=bcfg.light_depth,
                             eta_vcm=VCM_ETA),
            "eye": dict(mode="eye", max_depth=bcfg.eye_depth, camera=cam)}
    if table:
        tab = light_mega.device_table(
            *light_mega.key_tables(key_l, bcfg.light_depth), px.device)
        runs = {"table": dict(runs["light"], key_table=tab),
                "table_vm": dict(runs["light_vm"], key_table=tab)}
    out = {}
    for case, kw in runs.items():
        rays = torch.zeros(n, dtype=torch.int32, device=px.device)
        keys = paths.walk_keys(key_e if kw["mode"] == "eye" else key_l,
                               kw["mode"])
        w = kernels.bdpt_walk(scene, px, py, keys, rays=rays,
                              with_rows=True, **kw)
        t = {f"bufs.{f}": getattr(w["bufs"], f)
             for f in paths.PathBuffers._fields}
        t.update({f"v0.{k}": v for k, v in w["v0"].items()})
        if w["escape"] is not None:
            t.update({f"escape.{f}": getattr(w["escape"], f)
                      for f in ("valid", "d", "beta")})
        t.update(rays=rays, rows=w["rows"])
        out[case] = {k: v.contiguous().cpu() for k, v in t.items()}
    return out


def digests(t: dict) -> dict:
    """A K12 case as {output: SHA-256 of its bytes}, with the ray and row
    totals (the buffers are too large to keep)."""
    out = {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
           for k, v in t.items()}
    out.update(rays_sum=int(t["rays"].sum()) if "rays" in t else 0,
               rows_sum=int(t["rows"].sum()) if "rows" in t else 0)
    return out


def bdpt_keys():
    from cudapathtracer_tpu_torch.models import bdpt
    from cudapathtracer_tpu_torch.utils import rng
    return bdpt.sample_keys(rng.base_key(), 0)


def dump(path: str, scenes: dict, cam, px, py, bcfg, cfg0, log,
         cases: str = "") -> None:
    """Write the bit-equality cases of K5, K12, K13, the eye passes' walk
    and connection stages and K11's queue (torch.save, one file a case)
    whose name matches the regular expression `cases`."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    os.makedirs(path, exist_ok=True)
    n = px.shape[0]
    for eng, sc in scenes.items():
        for table in (False, True):
            if table and eng != "bvh8":
                continue   # the table mode runs BVH8 on every scene
            if not re.search(cases, "k12_table" if table else f"k12_{eng}"):
                continue
            for case, t in k12_cases(sc, cam, px, py, bcfg, table).items():
                name = f"k12_{case}" if table else f"k12_{eng}_{case}"
                d = digests(t)
                torch.save(d, os.path.join(path, f"{name}.pt"))
                log(f"[ab] dumped K12 {name}: {d['rays_sum']} rays")
        for sched in ("mega", "classic", "naive"):
            for k in (1, 8):
                if not re.search(cases, f"k5_{eng}_{sched}_k{k}"):
                    continue
                li, rays, rows = k5(sc, cam, px, py, sched, 0, k)
                torch.save(dict(li=li.cpu(), rays=rays.cpu(),
                                rows=rows.cpu()),
                           os.path.join(path, f"k5_{eng}_{sched}_k{k}.pt"))
                log(f"[ab] dumped K5 {eng} {sched} k={k}: "
                    f"{int(rays.sum())} rays")
        if re.search(cases, f"eye_{eng}") or re.search(cases,
                                                        f"k11_{eng}"):
            for case, t in eye_k11_cases(sc, cam, px, py, bcfg, cfg0,
                                         eng).items():
                name = f"{case.split('_')[0]}_{eng}_{case.split('_', 1)[1]}"
                if not re.search(cases, name):
                    continue
                d = digests(t)
                torch.save(d, os.path.join(path, f"{name}.pt"))
                log(f"[ab] dumped {name}: {d['rays_sum']} rays")
        if re.search(cases, f"k15_{eng}") and eng == "threaded":
            d = digests(k15_case(sc, cam, px, py))
            torch.save(d, os.path.join(path, "k15_threaded_entries.pt"))
            log(f"[ab] dumped k15_threaded_entries: {d['rows_sum']} rows")
        if re.search(cases, f"k8_{eng}") and eng == "bvh8":
            d = digests(k8_case(sc, px, py, cfg0))
            torch.save(d, os.path.join(path, "k8_bvh8_grid.pt"))
            log("[ab] dumped k8_bvh8_grid")
        if not re.search(cases, f"k13_{eng}"):
            continue
        lw, ew, key_c = k13_inputs(sc, cam, px, py, bcfg)
        gen = torch.Generator().manual_seed(7)
        fixed = torch.rand((n, 3), generator=gen).to(px.device)
        for tag, fb in (("nofb", None), ("fb", fixed)):
            rays = torch.zeros(n, dtype=torch.int32, device=px.device)
            out, rows = kernels.bdpt_connect(sc, cam, key_c, ew, lw, fb, rays,
                                             bcfg, px=px, py=py,
                                             with_rows=True)
            torch.save(dict(li=out.cpu(), rays=rays.cpu(), rows=rows.cpu()),
                       os.path.join(path, f"k13_{eng}_{tag}.pt"))
            log(f"[ab] dumped K13 {eng} {tag}: {int(rays.sum())} rays")
        del lw, ew


def k15_case(scene, cam, px, py) -> dict:
    """K15's batch entries on the threaded 1080p scene: the closest hits of
    sample 0's primary rays and the shadow factors of the NEE rays from
    them (chip_smoke.nee_rays), with each ray's rows."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.ops import traverse
    from cudapathtracer_tpu_torch.utils import rng
    spec = importlib.util.spec_from_file_location(
        "tool_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ids = rng.pixel_ids(px, py).contiguous()
    ckey = rng.fold_in(rng.sample_key(rng.base_key(), 0), 2 ** 20)
    o, d = cam.generate_rays(ckey, px.float(), py.float(), ids)
    hit = traverse.closest_hit(scene, o, d)
    so, sd, smt = chip_smoke.nee_rays(scene, o, d, hit, ids)
    n, m = o.shape[0], so.shape[0]
    dev = o.device
    if getattr(scene, "bin_table", None) is not None:
        tables = (scene.bin_table, scene.node_packed.shape[0])
    else:   # an earlier tree: the entries walk node_packed
        tables = (scene.node_packed, scene.max_leaf_size)
    rows = kernels.closest_hit_bin(
        *tables, o, d, torch.full((n,), 999999.0, device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev), None,
        with_rows=True)[4]
    srows = kernels.shadow_factor_bin(
        *tables, scene.tri_f32, so, sd, smt,
        torch.full((m,), -1, dtype=torch.int32, device=dev), None,
        with_rows=True)[1]
    t = {"t": hit.t, "tri": hit.tri, "u": hit.u, "v": hit.v,
         "scale": traverse.shadow_factor(scene, so, sd, smt),
         "rows": torch.cat([rows, srows])}
    return {k: v.contiguous().cpu() for k, v in t.items()}


def k8_case(scene, px, py, cfg0) -> dict:
    """K8's grid of the 1080p VCM sample 0 (classic_inputs: its light
    walk, a table above 2^24 buckets): the sorted rows and the (start,
    end) table, with the walk's stored vertices a lane."""
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import vcm
    cv = vcm.VCMConfig.from_config(dataclasses.replace(
        cfg0, integrator="VCM", engine="classic").normalized())
    kernels.reset_launches()
    inp = classic_inputs(scene, px, py, cv)
    g = inp["grid"]
    return {"grid_rows": g.rows.contiguous().cpu(),
            "cell_se": g.cell_se.contiguous().cpu(),
            "stored": inp["lb"].valid.sum(dim=0).cpu()}


def _filled_pass(ep):
    """An eye pass whose records and contributions start as NaN (integer
    fields -1), so that the entries its stages leave unwritten compare
    too, and a flag word the walk should write and does not shows."""
    import torch
    for t in ep.rec:
        t.fill_(float("nan") if t.dtype == torch.float32 else -1)
    if ep.conn is not None:
        ep.conn.fill_(float("nan"))
    return ep


def frame(width: int, height: int, dev):
    """The reference pinhole camera of a width x height frame and its
    pixels in raster order: (camera, px, py)."""
    import torch
    from cudapathtracer_tpu_torch.scene.camera import Camera
    cam = Camera.pinhole((0.0, 0.0, 1.0), width, height, 0.0, 0.0, 0.0, 60.0)
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.int32,
                                         device=dev),
                            torch.arange(width, dtype=torch.int32,
                                         device=dev), indexing="ij")
    return cam, gx.reshape(-1).contiguous(), gy.reshape(-1).contiguous()


def eye_k11_cases(scene, cam, px, py, bcfg, cfg0, eng: str) -> dict:
    """The deterministic outputs of the eye passes' walk and connection
    stages and of K11's queue, sample 0 at 1080p: {case: {name: tensor}}
    (the module's docstring lists them; every case has rays and rows)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    n, dev = px.shape[0], px.device
    out = {}

    def stages(case, ep):
        _filled_pass(ep)
        kernels.eye_walk(ep)
        t = {f"rec.{f}": getattr(ep.rec, f) for f in ep.rec._fields}
        t["walk_rays"] = ep.rays.clone()
        if ep.conn is not None:
            kernels.eye_connect(ep)
            t["conn"] = ep.conn
        # the merge and the ordered sums (K9 in the gather)
        ep.out.zero_()
        kernels.eye_gather(ep)
        t.update(gather_out=ep.out, gather_dropped=ep.dropped)
        t.update(rays=ep.rays, rows=ep.rows)
        out[case] = {k: v.contiguous().cpu() for k, v in t.items()}

    z = lambda m: torch.zeros(m, dtype=torch.int32, device=dev)

    def classic(case, c, cam_, px_, py_):
        ep, inp = classic_eye_pass(scene, cam_, px_, py_, c, with_rows=True)
        stages(case, ep)
        return inp
    cv = pass_cfg(cfg0, "VCM", "classic")
    classic("eye_vcm16", vcm.VCMConfig(),
            *frame(UPSTREAM_SIZE, UPSTREAM_SIZE, dev))
    classic("eye_sppm", pass_cfg(cfg0, "SPPM", "classic"), cam, px, py)
    inp = classic("eye_vcm", cv, cam, px, py)
    if eng == "bvh8":   # K14 traces BVH8 on every scene
        for flavor, integ in (("vcm", "VCM"), ("bdpt", "BIDIRECTIONAL")):
            mc = pass_cfg(cfg0, integ, "mega")
            ch = mega_inputs(scene, px, py, mc, flavor)[0]
            sw = (hashgrid.merge_switches(mc.max_per_cell)
                  if flavor == "vcm" else {})
            stages(f"eye_mega_{flavor}", kernels.mega_eye_pass(
                scene, cam, ch["keys"], ch["lb"], ch["grid"],
                torch.zeros((n, 3), device=dev), z(ch["pxc"].shape[0]), mc,
                px=ch["pxc"], py=ch["pyc"], cnt=ch["cnt"],
                gbase=ch["gbase"], flavor=flavor, merge_radius=ch["mr"],
                eta_vcm=ch["eta"], merge_norm=ch["norm"], with_rows=True,
                **sw))
            del ch

    def queue(case, sp, rays):
        sp.bin()
        torch.cuda.synchronize()
        off = sp.offsets.to(torch.int64)
        q = sp.queue[:int(off[-1])].to(torch.int64)
        tile = torch.repeat_interleave(
            torch.arange(off.shape[0] - 1, device=dev), off[1:] - off[:-1])
        t = {"offsets": sp.offsets.clone(),
             "queue": torch.sort(tile * 2 ** 32 + q).values,
             "bin_rays": rays.clone()}
        sp.trace()
        t.update(rays=rays, rows=sp.rows)
        out[case] = {k: v.contiguous().cpu() for k, v in t.items()}
    lw, _, _ = k13_inputs(scene, cam, px, py, bcfg)
    fb, rays = torch.zeros((n, 3), device=dev), z(n)
    queue("k11_bdpt", kernels.splat_pass(scene, cam, lw["bufs"], lw["v0"],
                                         fb, rays, bcfg, with_rows=True),
          rays)
    rays = z(n)
    queue("k11_vcm", kernels.splat_pass(scene, cam, inp["lb"], None, fb,
                                        rays, cv, eta_vcm=inp["eta"],
                                        with_rows=True), rays)
    return out


def trace_hosts(root: str, scene, cam, px, py, bcfg, cfg0, reps: int,
                log=print) -> dict:
    """The traversal's time in its batch entries and in each kernel it
    runs in, on the scene's engine (K1 on a BVH8 scene, K15 on a threaded
    one) at 1080p, sample 0, by CUDA events: {name: ms} (the module's
    docstring lists them; K5's mega schedule traces BVH8 on every scene
    and is timed on the BVH8 scene only). The batch entries trace the
    1080p primary rays and the NEE rays from their hits (the tree's
    chip_smoke.nee_rays)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths
    from cudapathtracer_tpu_torch.ops import traverse
    from cudapathtracer_tpu_torch.utils import rng
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n, dev = px.shape[0], px.device
    tag = "K1" if scene.traversal == "bvh8" else "K15"
    res = {}

    def timed(name, fn):
        res[name] = _events_ms(fn, reps)
        log(f"[{tag.lower()}] {name}: {res[name]:.3f} ms")
    ids = rng.pixel_ids(px, py).contiguous()
    ckey = rng.fold_in(rng.sample_key(rng.base_key(), 0), 2 ** 20)
    o, d = cam.generate_rays(ckey, px.float(), py.float(), ids)
    hit = traverse.closest_hit(scene, o, d)
    so, sd, smt = smoke.nee_rays(scene, o, d, hit, ids)
    timed(f"{tag} closest entry", lambda: traverse.closest_hit(scene, o, d))
    timed(f"{tag} shadow entry",
          lambda: traverse.shadow_factor(scene, so, sd, smt))
    del o, d, hit, so, sd, smt
    for sched in ("mega", "classic") if tag == "K1" else ("classic",):
        timed(f"K5 {sched}", lambda: k5(scene, cam, px, py, sched, 0, 1))
    key_l, key_e, key_c = bdpt_keys()
    z = lambda: torch.zeros(n, dtype=torch.int32, device=dev)
    rays = z()
    timed("K12 light walk", lambda: kernels.bdpt_walk(
        scene, px, py, paths.walk_keys(key_l, "light"), mode="light",
        max_depth=bcfg.light_depth, rays=rays))
    timed("K12 eye walk", lambda: kernels.bdpt_walk(
        scene, px, py, paths.walk_keys(key_e, "eye"), mode="eye",
        max_depth=bcfg.eye_depth, rays=rays, camera=cam))
    lw, ew, _ = k13_inputs(scene, cam, px, py, bcfg)
    fb = torch.zeros((n, 3), device=dev)
    sp = kernels.splat_pass(scene, cam, lw["bufs"], lw["v0"], fb, rays, bcfg)
    sp.bin()
    timed("K11 trace", sp.trace)
    timed("K13 pairs", lambda: kernels.bdpt_pairs(
        scene, cam, key_c, ew, lw, rays, bcfg, px=px, py=py))
    del sp, lw, ew
    ep, _ = classic_eye_pass(scene, cam, px, py,
                             pass_cfg(cfg0, "VCM", "classic"))
    timed("eye walk", lambda: kernels.eye_walk(ep))
    timed("eye connect", lambda: kernels.eye_connect(ep))
    return res


def shade_inputs(scene, cam, px, py):
    """chip_smoke's phase-6 hits on the 1080p bunny scene: the first 2^19
    primary hits of sample 0, then a random ray from each of them (seed
    11), ~1M rays with their closest hits, ids and eta_i: the K2-K4
    entry's arguments (o, d, hit, ids, eta_i, skey)."""
    import numpy as np
    import torch
    from cudapathtracer_tpu_torch.ops import traverse8
    from cudapathtracer_tpu_torch.utils import rng
    dev = px.device
    ids = rng.pixel_ids(px, py).contiguous()
    ckey = rng.fold_in(rng.sample_key(rng.base_key(), 0), 2 ** 20)
    o, d = cam.generate_rays(ckey, px.float(), py.float(), ids)
    gen = np.random.default_rng(11)
    h0 = traverse8.closest_hit8(scene, o, d)
    sel = torch.nonzero(h0.valid)[:, 0][: 1 << 19]
    p0 = o[sel] + d[sel] * h0.t[sel, None]
    rd = torch.as_tensor(gen.normal(size=(sel.numel(), 3)),
                         dtype=torch.float32, device=dev)
    rd = rd / rd.norm(dim=1, keepdim=True)
    eo = torch.cat([o[sel], (p0 - d[sel] * 1e-4)]).contiguous()
    ed = torch.cat([d[sel], rd]).contiguous()
    eh = traverse8.closest_hit8(scene, eo, ed)
    ne = eo.shape[0]
    lit = torch.as_tensor(gen.integers(0, 12, ne), dtype=torch.int32,
                          device=dev)
    eids = (torch.cat([sel, sel]).to(torch.int32) * 191 + lit)
    eta = torch.as_tensor(gen.choice([1e-5, 1.0, 1.333, 1.5], ne),
                          dtype=torch.float32, device=dev)
    return eo, ed, eh, eids, eta, rng.sample_key(rng.base_key(), 3)


def shade_hosts(root: str, scenes: dict, cam, px, py, bcfg, cfg0,
                reps: int, merge_only: bool = False, log=print) -> dict:
    """Every kernel the shading transition (K2-K4) runs in, and the merge
    query (K9), one 1080p sample's launch each by CUDA events on the
    bunny scene (sample 0): {name: ms}. With merge_only, the merge's
    hosts and entry alone: the classic VCM eye pass's gather, K14's gather
    (VCM flavour, chunk 0) and K9's neighbor_slots entry (slots mode on
    chunk 0's grid, the chunk's first hits as queries, the tree's
    chip_smoke.first_hits). Otherwise also the K2-K4 entry (shade_eval on
    shade_inputs' hits), K5's mega, classic and naive schedules on the
    BVH8 scene and its classic schedule on the threaded one, K12's light
    and eye walks, K11's trace stage, K13's pair stage, the classic VCM
    eye pass's walk and connections, and K14's walk and connections."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, unidirectional_mega
    from cudapathtracer_tpu_torch.ops import hashgrid
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scene = scenes["bvh8"]
    n, dev = px.shape[0], px.device
    res = {}

    def timed(name, fn):
        res[name] = _events_ms(fn, reps)
        log(f"[shade] {name}: {res[name]:.3f} ms")

    z = lambda m: torch.zeros(m, dtype=torch.int32, device=dev)
    if not merge_only:
        args = shade_inputs(scene, cam, px, py)
        timed("K2-K4 entry (shade_eval)",
              lambda: unidirectional_mega.shade_eval(scene, *args))
        del args
        for sched in ("mega", "classic", "naive"):
            timed(f"K5 {sched}", lambda: k5(scene, cam, px, py, sched, 0, 1))
        if "threaded" in scenes:
            timed("K5 classic threaded", lambda: k5(
                scenes["threaded"], cam, px, py, "classic", 0, 1))
        key_l, key_e, key_c = bdpt_keys()
        rays = z(n)
        timed("K12 light walk", lambda: kernels.bdpt_walk(
            scene, px, py, paths.walk_keys(key_l, "light"), mode="light",
            max_depth=bcfg.light_depth, rays=rays))
        timed("K12 eye walk", lambda: kernels.bdpt_walk(
            scene, px, py, paths.walk_keys(key_e, "eye"), mode="eye",
            max_depth=bcfg.eye_depth, rays=rays, camera=cam))
        lw, ew, _ = k13_inputs(scene, cam, px, py, bcfg)
        fb = torch.zeros((n, 3), device=dev)
        sp = kernels.splat_pass(scene, cam, lw["bufs"], lw["v0"], fb, rays,
                                bcfg)
        sp.bin()
        timed("K11 trace", sp.trace)
        timed("K13 pairs", lambda: kernels.bdpt_pairs(
            scene, cam, key_c, ew, lw, rays, bcfg, px=px, py=py))
        del sp, lw, ew, fb
    ep, inp = classic_eye_pass(scene, cam, px, py,
                               pass_cfg(cfg0, "VCM", "classic"))
    kernels.eye_walk(ep)
    kernels.eye_connect(ep)
    if not merge_only:
        timed("eye walk", lambda: kernels.eye_walk(ep))
        timed("eye connect", lambda: kernels.eye_connect(ep))
    timed("eye gather", lambda: kernels.eye_gather(ep))
    del ep, inp
    mc = pass_cfg(cfg0, "VCM", "mega")
    ch = mega_inputs(scene, px, py, mc, "vcm")[0]
    ep = kernels.mega_eye_pass(
        scene, cam, ch["keys"], ch["lb"], ch["grid"],
        torch.zeros((n, 3), device=dev), z(ch["pxc"].shape[0]), mc,
        px=ch["pxc"], py=ch["pyc"], cnt=ch["cnt"], gbase=ch["gbase"],
        flavor="vcm", merge_radius=ch["mr"], eta_vcm=ch["eta"],
        merge_norm=ch["norm"], **hashgrid.merge_switches(mc.max_per_cell))
    kernels.eye_walk(ep)
    kernels.eye_connect(ep)
    if not merge_only:
        timed("K14 walk (chunk 0)", lambda: kernels.eye_walk(ep))
        timed("K14 connect (chunk 0)", lambda: kernels.eye_connect(ep))
    timed("K14 gather (chunk 0)", lambda: kernels.eye_gather(ep))
    del ep
    q, hit = smoke.first_hits(scene, cam, ch["pxc"], ch["pyc"], 0)
    sw = hashgrid.merge_switches(mc.max_per_cell)
    timed("K9 entry (neighbor_slots)", lambda: kernels.neighbor_slots(
        ch["grid"], q, ch["mr"], mc.max_per_cell, mode="slots", active=hit,
        **sw))
    return res


def eye_walks(scenes: dict, cam, px, py, cfg0, reps: int,
              log=print) -> dict:
    """The eye walk stage alone, kernels.eye_walk on a set-up pass, by
    CUDA events (the module's docstring lists the instantiations): {case:
    {"ms": ..., "lane_use": ..., "event_balance": ...}}, the lane counters
    where the tree's walk takes them."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    dev = px.device
    lanes_ok = "lanes" in inspect.signature(kernels.eye_walk).parameters
    z = lambda m: torch.zeros(m, dtype=torch.int32, device=dev)
    res = {}

    def timed(case, ep):
        row = res[case] = {"ms": _events_ms(lambda: kernels.eye_walk(ep),
                                            reps)}
        if lanes_ok:
            lanes = torch.zeros(3, dtype=torch.int64, device=dev)
            kernels.eye_walk(ep, lanes=lanes)
            ev, busy, calls = lanes.tolist()
            row.update(lane_use=ev / (32 * calls),
                       event_balance=ev / (32 * busy))
        log(f"[eye-walks] {case}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()))


    timed(f"classic VCM {UPSTREAM_SIZE}x{UPSTREAM_SIZE} eye 16",
          classic_eye_pass(scenes["bvh8"],
                           *frame(UPSTREAM_SIZE, UPSTREAM_SIZE, dev),
                           vcm.VCMConfig())[0])
    cv = pass_cfg(cfg0, "VCM", "classic")
    for eng, scene in scenes.items():
        timed(f"classic VCM 1080p {eng}",
              classic_eye_pass(scene, cam, px, py, cv)[0])
    timed("classic SPPM 1080p", classic_eye_pass(
        scenes["bvh8"], cam, px, py, pass_cfg(cfg0, "SPPM", "classic"))[0])
    scene = scenes["bvh8"]
    for flavor, integ in (("vcm", "VCM"), ("bdpt", "BIDIRECTIONAL")):
        mc = pass_cfg(cfg0, integ, "mega")
        ch = mega_inputs(scene, px, py, mc, flavor)[0]
        sw = (hashgrid.merge_switches(mc.max_per_cell) if flavor == "vcm"
              else {})
        timed(f"K14 {flavor} 1080p (chunk 0)", kernels.mega_eye_pass(
            scene, cam, ch["keys"], ch["lb"], ch["grid"],
            torch.zeros((px.shape[0], 3), device=dev),
            z(ch["pxc"].shape[0]), mc, px=ch["pxc"], py=ch["pyc"],
            cnt=ch["cnt"], gbase=ch["gbase"], flavor=flavor,
            merge_radius=ch["mr"], eta_vcm=ch["eta"], merge_norm=ch["norm"],
            **sw))
        del ch
    return res


def _graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call: reps calls captured in one CUDA graph and
    replayed between CUDA events (chip_smoke.graph_ms)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rng_entries(px, py, reps: int, log=print) -> dict:
    """K6's entries (uniform_id, its keyed mode on per-lane pairs) on the
    1080p pixel ids and K7's (generate_rays) at 1080p on the reference
    pinhole (aperture 1e-6), a camera of aperture 0 and a thin lens:
    {name: device ms by CUDA graph replay, name + " call": ms of a call
    from the host by CUDA events}."""
    import numpy as np
    import torch
    from cudapathtracer_tpu_torch.scene.camera import Camera
    from cudapathtracer_tpu_torch.utils import rng
    ids = rng.pixel_ids(px, py).contiguous()
    n, dev = ids.shape[0], ids.device
    res = {}

    def timed(name, fn):
        res[name] = _graph_ms(fn)
        res[name + " call"] = _events_ms(fn, max(reps, 20))
        log(f"[rng] {name}: {res[name]:.4f} ms (a call from the host "
            f"{res[name + ' call']:.4f} ms)")
    k0, k1 = rng.draw_key(rng.bounce_key(rng.sample_key(rng.base_key(), 5),
                                         3), 4)
    timed("K6 uniform_id", lambda: rng.uniform_draw_key(k0, k1, ids))
    gen = np.random.default_rng(23)
    kw = [torch.as_tensor(gen.integers(0, 2 ** 32, n, dtype=np.uint64)
                          .astype(np.uint32).view(np.int32), device=dev)
          for _ in range(2)]
    timed("K6 keyed", lambda: rng.uniform_keyed(kw[0], kw[1], ids))
    ckey = rng.fold_in(rng.sample_key(rng.base_key(), 0), 2 ** 20)
    fx, fy = px.float(), py.float()
    for tag, cam in (
            ("K7 reference pinhole", Camera.pinhole(
                (0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0, 60.0)),
            ("K7 aperture 0", aperture0_camera()),
            ("K7 thin lens", Camera.thin_lens(
                (0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0, 60.0, 0.05,
                1.5))):
        timed(tag, lambda: cam.generate_rays(ckey, fx, fy, ids))
    return res


def aperture0_camera():
    """The reference pinhole's geometry (focal_dist 1 / fov) at aperture 0:
    no lens."""
    from cudapathtracer_tpu_torch.scene.camera import Camera
    return Camera.thin_lens((0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0,
                            60.0, 0.0, 1.0 / 60.0)


def sort_times(scene, px, py, cfg0, reps: int, log=print) -> dict:
    """K8's sort on the 1080p VCM sample's photons (sample 0's light walk,
    12,441,600 candidates): the tree's photon_sort (on the buckets, or on
    the keys photon_pack wrote) and torch.sort (stable) on the same keys
    as int32, each timed by CUDA events (mean of reps calls), the sort's
    launches by the profiler, the order held equal to torch.sort's and a
    SHA-256 of the order and the sorted buckets: {name: value}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    n = px.shape[0]
    cv = vcm.VCMConfig.from_config(dataclasses.replace(
        cfg0, integrator="VCM", engine="classic").normalized())
    key_l, _ = vcm.sample_keys(rng.base_key(), 0)
    mr, eta, _ = vcm.sample_scalars(scene, cv, 0, n)
    lb = kernels.bdpt_walk(
        scene, px, py, paths.walk_keys(key_l, "light"), mode="light",
        max_depth=cv.light_depth + 1,
        rays=torch.zeros(n, dtype=torch.int32, device=px.device),
        eta_vcm=eta)["bufs"]
    tsize = hashgrid.photon_table_size(cv.light_depth * n)
    salt = hashgrid.photon_salt(0) if hashgrid.REWEIGHT else None
    bits = hashgrid.key_bits(tsize, salt is not None)
    args = (lb, scene.scene_min, 2.0 * mr, tsize)
    if "salt" in inspect.signature(kernels.photon_pack).parameters:
        _, h, key, _ = kernels.photon_pack(*args, salt)
        run = lambda: kernels.photon_sort(key, bits, h)
    else:
        _, h, _ = kernels.photon_pack(*args)
        run = lambda: kernels.photon_sort(h, bits, salt)
    k64 = hashgrid.sort_keys(h.to(torch.int64), salt)
    k32 = (k64 - 2 ** 31).to(torch.int32)
    order, sorted_h = run()
    want = torch.sort(k64, stable=True).indices
    ok = (torch.equal(order.to(torch.int64), want)
          and torch.equal(sorted_h, h[want]))
    digest = hashlib.sha256(order.cpu().numpy().tobytes()
                            + sorted_h.cpu().numpy().tobytes()).hexdigest()
    res = {"photons": n * cv.light_depth, "bits": bits, "equal": ok,
           "digest": digest,
           "sort": _events_ms(run, reps),
           "torch.sort int32": _events_ms(
               lambda: torch.sort(k32, stable=True), reps)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    res["launches"] = [
        (e.name.split("::")[-1].split("(")[0], e.device_time)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"[sort] {res['photons']} keys of {bits} bits: sort "
        f"{res['sort']:.4f} ms, torch.sort int32 "
        f"{res['torch.sort int32']:.4f} ms, order equal to torch.sort's: "
        f"{ok}, digest {digest[:16]}; launches (us): " + ", ".join(
            f"{name} {us:.1f}" for name, us in res["launches"]))
    return res


def compare(a: str, b: str) -> int:
    """Case by case: bit-equal li, rays and rows (K5, K13) or every output
    (K12), or how far apart; the number of cases that differ."""
    import torch
    bad, names = 0, sorted(os.listdir(a))
    if not names:
        print(f"[ab] no cases in {a}")
        return 1
    for name in names:
        x = torch.load(os.path.join(a, name))
        if not os.path.exists(os.path.join(b, name)):
            bad += 1
            print(f"[ab] {name[:-3]}: MISSING in {b}", flush=True)
            continue
        y = torch.load(os.path.join(b, name))
        if "li" not in x:   # every output's digest (K12: dead rows too)
            diff = [k for k in x if x[k] != y.get(k)]
            bad += bool(diff)
            print(f"[ab] {name[:-3]}: "
                  f"{'DIFFERS in ' + ', '.join(diff) if diff else 'bit-equal'}"
                  f" ({len(x) - 2} outputs, rays {x['rays_sum']} / "
                  f"{y['rays_sum']}, rows {x['rows_sum']} / {y['rows_sum']})",
                  flush=True)
            continue
        li_eq = (x["li"].view(torch.int32) == y["li"].view(torch.int32))
        pix = li_eq.all(dim=1).float().mean().item()
        same = (bool(li_eq.all()) and torch.equal(x["rays"], y["rays"])
                and torch.equal(x["rows"], y["rows"]))
        bad += not same
        print(f"[ab] {name[:-3]}: {'bit-equal' if same else 'DIFFERS'} "
              f"(pixels bit-equal {pix:.6f}, rays {int(x['rays'].sum())} / "
              f"{int(y['rays'].sum())}, rows {int(x['rows'].sum())} / "
              f"{int(y['rows'].sum())}, max |dli| "
              f"{(x['li'] - y['li']).abs().max().item():.3g})", flush=True)
    print(f"[ab] {bad} case(s) differ")
    return bad


def renders(cfg0, scenes: dict, cam, px, py, bcfg, log=print,
            cells: str = "", spp_256: int = 256) -> dict:
    """Mrays/s (rays over the render phase), one sample's device ms and
    the peak memory rise of the cells whose name matches the regular
    expression `cells` (the module's docstring lists them)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.driver import Renderer
    from cudapathtracer_tpu_torch.models import bdpt, unidirectional, vcm
    from cudapathtracer_tpu_torch.utils import rng
    from cudapathtracer_tpu_torch.utils.config import MeshConfig, load_config
    from cudapathtracer_tpu_torch.utils.metrics import RenderMetrics
    res = {}

    def note(tag, how, rays, secs, ms, rise):
        res[tag] = dict(rays=rays, seconds=secs, mrays=rays / secs / 1e6,
                        sample_ms=ms, peak_rise_gib=rise)
        log(f"[ab] {tag}: {how}, {rays} rays in {secs:.3f} s = "
            f"{rays / secs / 1e6:.3f} Mrays/s; one sample {ms:.3f} ms; "
            f"peak rise {rise:.3f} GiB")

    def through_renderer(tag, cfg):
        if not re.search(cells, tag):
            return
        r = Renderer(cfg, device="cuda")
        k = r.cfg.samples_per_dispatch or 1
        one = ((lambda: r.render_batch(0, k)) if k > 1
               else (lambda: r.render_sample(0)))
        ms = _events_ms(one) / k
        r.accum.zero_()
        r.sample_count, r.metrics = 0, RenderMetrics()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r.render(progressive=False, verbose=False)
        torch.cuda.synchronize()
        rise = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        note(tag, f"{r.cfg.sample_count} spp at {k} a dispatch",
             r.metrics.rays_traced, r.metrics.render_seconds, ms, rise)
        del r

    def through_render_sample(tag, fn):
        if not re.search(cells, tag):
            return
        ms = _events_ms(lambda: fn(0))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rays = 0
        for s in range(SPP):
            rays = rays + fn(s)[1]
        rays = int(rays)
        secs = time.perf_counter() - t0
        rise = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        note(tag, f"{SPP} spp through render_sample", rays, secs, ms, rise)

    bunny = [MeshConfig("builtin:cornell_bunny", 1.0, (0.0, 0.0, 0.0), 2)]
    c1080 = dataclasses.replace(cfg0, width=WIDTH, height=HEIGHT,
                                sample_count=SPP, meshes=bunny,
                                max_depth=DEPTH, samples_per_dispatch=1)
    for tag, integ, engine in (
            ("bdpt-1080p", "BIDIRECTIONAL", "classic"),
            ("mega-1080p", "UNIDIRECTIONAL", "mega"),
            ("classic-1080p", "UNIDIRECTIONAL", "classic"),
            ("naive-1080p", "NAIVE_UNIDIRECTIONAL", "mega"),
            ("vcm-1080p", "VCM", "classic"), ("sppm-1080p", "SPPM", "classic"),
            ("vcm-mega-1080p", "VCM", "mega"),
            ("sppm-mega-1080p", "SPPM", "mega"),
            ("bdpt-mega-1080p", "BIDIRECTIONAL", "mega")):
        through_renderer(tag, dataclasses.replace(
            c1080, integrator=integ, engine=engine))
    blocks = [MeshConfig("builtin:cornell_blocks", 1.0, (0.0, 0.0, 0.0), 2)]
    for integ, name in (("UNIDIRECTIONAL", "uni-mega-256"),
                        ("NAIVE_UNIDIRECTIONAL", "naive-256")):
        for spd in (1, 8):
            through_renderer(f"{name} spd{spd}", dataclasses.replace(
                cfg0, integrator=integ, engine="mega", width=256,
                height=256, sample_count=spp_256, max_depth=DEPTH,
                meshes=blocks, samples_per_dispatch=spd))
    caustics = load_config(os.path.join(ROOT, "configs",
                                        "vcm_caustics.rendertron"))
    for tag, engine in (("caustics-512", "classic"),
                        ("caustics-mega-512", "mega")):
        through_renderer(tag, dataclasses.replace(caustics, engine=engine))
    if re.search(cells, "keyed-1080p"):
        # TPT_MEGA_LIGHT=1: VCM-mega's light walk in K12's table mode
        os.environ["TPT_MEGA_LIGHT"] = "1"
        try:
            through_renderer("keyed-1080p", dataclasses.replace(
                c1080, integrator="VCM", engine="mega"))
        finally:
            del os.environ["TPT_MEGA_LIGHT"]
    tsc = scenes["threaded"]
    vcfg = {integ: vcm.VCMConfig.from_config(dataclasses.replace(
        cfg0, integrator=integ, engine="classic").normalized())
        for integ in ("VCM", "SPPM")}
    for tag, fn in (
            ("bdpt-threaded-1080p", lambda s: bdpt.render_sample(
                tsc, cam, rng.base_key(), s, px, py, cfg=bcfg)),
            ("classic-threaded-1080p", lambda s: unidirectional.render_sample(
                tsc, cam, rng.base_key(), s, px, py, max_depth=DEPTH)),
            ("vcm-threaded-1080p", lambda s: vcm.render_sample(
                tsc, cam, rng.base_key(), s, px, py, cfg=vcfg["VCM"])),
            ("sppm-threaded-1080p", lambda s: vcm.render_sample(
                tsc, cam, rng.base_key(), s, px, py, cfg=vcfg["SPPM"]))):
        through_render_sample(tag, fn)
    if not re.search(cells, "1080p alone"):
        return res
    s8 = scenes["bvh8"]
    lw, ew, key_c = k13_inputs(s8, cam, px, py, bcfg)
    rays = torch.zeros(px.shape[0], dtype=torch.int32, device=px.device)
    res["K13 ms"] = _events_ms(lambda: kernels.bdpt_connect(
        s8, cam, key_c, ew, lw, None, rays, bcfg, px=px, py=py))
    res["K5 mega ms"] = _events_ms(lambda: k5(s8, cam, px, py, "mega", 0, 1))
    log(f"[ab] 1080p alone: K13 {res['K13 ms']:.3f} ms, K5 mega sample "
        f"{res['K5 mega ms']:.3f} ms")
    res["launches"] = sample_launches(s8, cam, px, py, bcfg, vcfg)
    res["launches"].update({
        f"{tag} (threaded scene)": ms for tag, ms in sample_launches(
            tsc, cam, px, py, bcfg, vcfg).items()})
    for tag, ms in res["launches"].items():
        log(f"[ab] one {tag} sample by launch: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ms.items()))
    return res


def _timed_in_turn(steps, reps: int = 2) -> dict:
    """{name: ms} of steps [(name, fn)] run in order, each between two
    CUDA events; the last of reps passes (the first warms up)."""
    import torch
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(steps) + 1)]
        ev[0].record()
        for k, (_, fn) in enumerate(steps):
            fn()
            ev[k + 1].record()
        torch.cuda.synchronize()
    return {name: ev[k].elapsed_time(ev[k + 1])
            for k, (name, _) in enumerate(steps)}


def sample_launches(scene, cam, px, py, bcfg, vcfgs: dict) -> dict:
    """The launches of one 1080p bdpt sample (K12 light, K11, K12 eye,
    K13) and of a vcm and an sppm sample (K12 with eta_vcm, K11's VCM form
    (not SPPM), K8's photon_pack, sort (the tree's photon_sort, on the
    keys photon_pack wrote or on the buckets, or torch.sort where it has
    none) and photon_table, the eye pass's walk,
    connections (not SPPM) and gather), sample 0, by CUDA events:
    {cell: {launch: ms}}."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    n = px.shape[0]
    key_l, key_e, key_c = bdpt_keys()
    rays = torch.zeros(n, dtype=torch.int32, device=px.device)
    fb = torch.zeros((n, 3), device=px.device)
    st = {}
    steps = [
        ("light walk", lambda: st.update(lw=kernels.bdpt_walk(
            scene, px, py, paths.walk_keys(key_l, "light"), mode="light",
            max_depth=bcfg.light_depth, rays=rays))),
        ("splat", lambda: kernels.bdpt_splat(
            scene, cam, st["lw"]["bufs"], st["lw"]["v0"], fb, rays, bcfg)),
        ("eye walk", lambda: st.update(ew=kernels.bdpt_walk(
            scene, px, py, paths.walk_keys(key_e, "eye"), mode="eye",
            max_depth=bcfg.eye_depth, rays=rays, camera=cam))),
        ("K13", lambda: kernels.bdpt_connect(
            scene, cam, key_c, st["ew"], st["lw"], fb, rays, bcfg, px=px,
            py=py))]
    out = {"bdpt-1080p": _timed_in_turn(steps)}
    vkey_l, vkey_e = vcm.sample_keys(rng.base_key(), 0)
    salt = hashgrid.photon_salt(0)
    # an earlier tree's photon_pack writes the keys it salts
    keyed = "salt" in inspect.signature(kernels.photon_pack).parameters
    for cell, vcfg in (("vcm-1080p", vcfgs["VCM"]),
                       ("sppm-1080p", vcfgs["SPPM"])):
        mr, eta, norm = vcm.sample_scalars(scene, vcfg, 0, n)
        tsize = hashgrid.photon_table_size(vcfg.light_depth * n)

        def pack():
            args = (st["vw"]["bufs"], scene.scene_min, 2.0 * mr, tsize)
            if keyed:   # (rows, bucket, key, cell_se)
                st["pack"] = kernels.photon_pack(*args, salt)
            else:
                rows, h, cse = kernels.photon_pack(*args)
                st["pack"] = (rows, h, None, cse)

        def sort():
            h, key = st["pack"][1], st["pack"][2]
            bits = hashgrid.key_bits(tsize, hashgrid.REWEIGHT)
            if not keyed:
                st["order"] = kernels.photon_sort(h, bits, salt)
            elif hasattr(kernels, "photon_sort"):
                st["order"] = kernels.photon_sort(key, bits, h)
            else:   # an earlier tree: torch.sort, photon_table gathers h
                st["order"] = (torch.sort(key, stable=True).indices, h)

        def eye_pass():
            st["ep"] = kernels.vcm_eye_pass(
                scene, cam, paths.walk_keys(vkey_e, "eye"), st["vw"]["bufs"],
                hashgrid.PhotonGrid(st["rows"], st["pack"][3],
                                    scene.scene_min, 2.0 * mr, tsize),
                fb, rays, vcfg, px=px, py=py, merge_radius=mr, eta_vcm=eta,
                merge_norm=norm, **hashgrid.merge_switches(vcfg.max_per_cell))
            kernels.eye_walk(st["ep"])
        steps = [
            ("light walk", lambda: st.update(vw=kernels.bdpt_walk(
                scene, px, py, paths.walk_keys(vkey_l, "light"),
                mode="light", max_depth=vcfg.light_depth + 1, rays=rays,
                eta_vcm=eta))),
            ("vcm_splat", lambda: kernels.vcm_splat(
                scene, cam, st["vw"]["bufs"], fb, rays, vcfg, eta)),
            ("photon_pack", pack),
            ("sort", sort),
            ("photon_table", lambda: st.update(rows=kernels.photon_table(
                st["pack"][0], st["order"][1], st["order"][0],
                st["pack"][3]))),
            ("eye walk", eye_pass),
            ("eye connect", lambda: kernels.eye_connect(st["ep"])),
            ("eye gather", lambda: kernels.eye_gather(st["ep"]))]
        if not vcfg.light_trace:
            steps = [x for x in steps if x[0] not in ("vcm_splat",
                                                       "eye connect")]
        out[cell] = _timed_in_turn(steps)
    return out


def walks_and_splat(scene, cam, px, py, bcfg, log, reps: int = 5) -> dict:
    """K12's light walk (with and without VCM's d_vm chain) and eye walk of
    sample 0 at 1080p (their outputs' SHA-256, so that two trees' walks can
    be held equal), and K11's BDPT form on the light walk, whole and stage
    by stage, by CUDA events; on a tree whose K11 has stages, the first
    stage's kernels and the light walk's by the profiler. -> {name:
    ms}."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths
    key_l, key_e, _ = bdpt_keys()
    n = px.shape[0]
    rays = torch.zeros(n, dtype=torch.int32, device=px.device)
    res = {}
    for case, t in k12_cases(scene, cam, px, py, bcfg, False).items():
        kw = dict(mode="eye", max_depth=bcfg.eye_depth, camera=cam) \
            if case == "eye" else dict(mode="light",
                                       max_depth=bcfg.light_depth,
                                       eta_vcm=VCM_ETA if case == "light_vm"
                                       else None)
        keys = paths.walk_keys(key_e if case == "eye" else key_l, kw["mode"])
        res[f"walk {case}"] = _events_ms(lambda: kernels.bdpt_walk(
            scene, px, py, keys, rays=rays, **kw), reps)
        digest = hashlib.sha256("".join(
            v for k, v in sorted(digests(t).items())
            if isinstance(v, str)).encode()).hexdigest()[:16]
        log(f"[walks] K12 {case} walk: {res[f'walk {case}']:.3f} ms, "
            f"outputs' digest {digest}")
    lw = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_l, "light"),
                           mode="light", max_depth=bcfg.light_depth,
                           rays=rays)
    fb = torch.zeros((n, 3), device=px.device)
    res["splat"] = _events_ms(lambda: kernels.bdpt_splat(
        scene, cam, lw["bufs"], lw["v0"], fb, rays, bcfg), reps)
    line = f"[walks] K11 bdpt_splat {res['splat']:.3f} ms"
    if hasattr(kernels, "splat_pass"):
        from torch.profiler import ProfilerActivity, profile
        sp = kernels.splat_pass(scene, cam, lw["bufs"], lw["v0"], fb, rays,
                                bcfg)
        res["bin"] = _events_ms(sp.bin, reps)
        res["trace"] = _events_ms(sp.trace, reps)
        line += (f" (classify and bin {res['bin']:.3f} ms, trace and splat "
                 f"{res['trace']:.3f} ms)")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                sp.bin()
                kernels.bdpt_walk(scene, px, py,
                                  paths.walk_keys(key_l, "light"),
                                  mode="light", max_depth=bcfg.light_depth,
                                  rays=rays)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0:
                m = re.search(r"(\w+)\(", e.key)
                name = m.group(1) if m else e.key
                res[name] = e.device_time_total / e.count / 1e3
                line += f"; {name} {res[name]:.4f} ms"
    log(line)
    return res


def per_pairs(scenes: dict, cam, px, py, bcfg, pers: list, log) -> dict:
    """K13's pair stage at each per, both scenes: {engine: {per: ms}}."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    res = {}
    n = px.shape[0]
    for eng, sc in scenes.items():
        lw, ew, key_c = k13_inputs(sc, cam, px, py, bcfg)
        res[eng], ref = {}, None
        for per in pers:
            rays = torch.zeros(n, dtype=torch.int32, device=px.device)
            rows = torch.zeros_like(rays)
            terms = kernels.bdpt_pairs(sc, cam, key_c, ew, lw, rays, bcfg,
                                       px=px, py=py, rows=rows, per=per)
            out = (terms.view(torch.int32), rays, rows)
            if ref is None:
                ref = out
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            scratch = torch.zeros_like(rays)
            res[eng][per] = _events_ms(lambda: kernels.bdpt_pairs(
                sc, cam, key_c, ew, lw, scratch, bcfg, px=px, py=py,
                per=per))
            log(f"[ab] K13 pairs, {eng}, {per} pair(s) a thread: "
                f"{res[eng][per]:.3f} ms; terms, rays and rows "
                f"{'equal to' if same else 'DIFFER from'} per {pers[0]}'s")
            if not same:
                raise SystemExit(1)
            del terms, out
        del lw, ew, ref
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=ROOT, help="the checkout whose "
                    "package is imported and whose kernels are built")
    ap.add_argument("--toggles", action="store_true", help="time the eye "
                    "passes with each strategy off in turn (the default "
                    "when no other part is asked for)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--json", default=None)
    ap.add_argument("--renders", action="store_true", help="also time the "
                    "cells (renders())")
    ap.add_argument("--cells", default="", help="with --renders: the cells "
                    "whose name this regular expression matches")
    ap.add_argument("--spp-256", type=int, default=256)
    ap.add_argument("--bit-equal", action="store_true", help="also print "
                    "K14's bit-equal share through the tree's chip_smoke")
    ap.add_argument("--dump", default=None, help="write K5's, K12's and "
                    "K13's bit-equality cases into this directory")
    ap.add_argument("--dump-cases", default="", help="with --dump: the "
                    "cases whose name this regular expression matches")
    ap.add_argument("--compare", nargs=2, default=None, help="compare two "
                    "dumps case by case (needs no GPU)")
    ap.add_argument("--per", type=int, nargs="+", default=None)
    ap.add_argument("--walks", action="store_true", help="time K12's walks "
                    "and K11's stages at 1080p (walks_and_splat)")
    ap.add_argument("--k1", action="store_true", help="time K1 in its batch "
                    "entries and in each kernel it runs in (trace_hosts)")
    ap.add_argument("--k15", action="store_true", help="time K15 in its "
                    "batch entries and in each kernel it runs in on the "
                    "threaded scene (trace_hosts)")
    ap.add_argument("--sort", action="store_true", help="time K8's sort "
                    "against torch.sort on the 1080p VCM keys (sort_times)")
    ap.add_argument("--shade", action="store_true", help="time every kernel "
                    "the shading transition K2-K4 runs in, its entry and "
                    "the merge's hosts (shade_hosts)")
    ap.add_argument("--merge", action="store_true", help="time the merge "
                    "query K9's hosts (the gathers) and entry alone")
    ap.add_argument("--rng", action="store_true", help="time K6's and K7's "
                    "entries (rng_entries)")
    ap.add_argument("--aperture0", action="store_true", help="a camera of "
                    "aperture 0 in place of the reference pinhole")
    ap.add_argument("--eye-walks", action="store_true", help="time the eye "
                    "walk stage alone in each of its instantiations")
    ap.add_argument("--reuse-build", action="store_true", help="keep the "
                    "tree's kernel library and ptxas report if they are up "
                    "to date (a later turn of tools/k1_attribution.py)")
    args = ap.parse_args()
    if args.compare:
        return 1 if compare(*args.compare) else 0
    toggles = args.toggles or not (args.renders or args.bit_equal
                                   or args.dump or args.per or args.walks
                                   or args.k1 or args.k15 or args.sort
                                   or args.shade or args.merge or args.rng
                                   or args.eye_walks)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU")
        return 2
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import bdpt
    from cudapathtracer_tpu_torch.scene import builtin
    from cudapathtracer_tpu_torch.scene.materials import builtin_materials
    from cudapathtracer_tpu_torch.scene.scene import build_scene
    from cudapathtracer_tpu_torch.utils.config import load_config
    check = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(kernels.__file__))))
    if os.path.abspath(check) != root:
        print(f"FAIL: imported the package from {check}, not {root}")
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log = lambda m: print(f"{m} ({card})", flush=True)
    t0 = time.perf_counter()
    lib = kernels.LIBRARY
    fresh = (args.reuse_build and os.path.exists(lib + ".ptxas.txt")
             and kernels.build() == lib and os.path.getmtime(lib + ".ptxas.txt")
             >= os.path.getmtime(lib))
    if not fresh:
        kernels.build(verbose=True)
    with open(lib + ".ptxas.txt") as f:
        regs = ptxas_eye(f.read())
    print(f"[attribution] {card}; tree {root}: kernels ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (r, st, ss, sl, sm) in sorted(regs.items()):
        print(f"[attribution] ptxas {name}: {r} registers, {st} bytes stack "
              f"frame, {ss} bytes spill stores, {sl} bytes spill loads, "
              f"{sm} bytes smem")
    dev = torch.device("cuda", 0)
    cam, px, py = frame(WIDTH, HEIGHT, dev)
    if args.aperture0:
        cam = aperture0_camera()
    mesh = builtin.cornell_with_bunny(subdivisions=6)
    bvh8_only = not (toggles or args.bit_equal or args.dump or args.renders
                     or args.per or args.k15 or args.shade
                     or args.eye_walks)
    scenes = {t: build_scene(mesh, builtin_materials(), traversal=t,
                             device=dev)[0]
              for t in (("bvh8",) if bvh8_only else ("bvh8", "threaded"))}
    cfg0 = load_config(os.path.join(ROOT, "configs", "cornell.rendertron"))
    bcfg = bdpt.BDPTConfig.from_config(cfg0)
    out = dict(card=card, tree=root, ptxas=regs)
    if toggles:
        out["ms"] = attribution(scenes["bvh8"], scenes["threaded"], cam, px,
                                py, cfg0, args.reps)
    if args.bit_equal:
        out["bit_equal"] = bit_equal_shares(root, scenes["bvh8"], cam, px,
                                            py, cfg0)
    if args.dump:
        dump(args.dump, scenes, cam, px, py, bcfg, cfg0, log,
             args.dump_cases)
    if args.renders:
        out["renders"] = renders(cfg0, scenes, cam, px, py, bcfg, log,
                                 args.cells, args.spp_256)
    if args.per:
        out["per"] = per_pairs(scenes, cam, px, py, bcfg, args.per, log)
    if args.walks:
        out["walks"] = walks_and_splat(scenes["bvh8"], cam, px, py, bcfg, log)
    if args.k1:
        out["k1"] = trace_hosts(root, scenes["bvh8"], cam, px, py, bcfg,
                                cfg0, args.reps, log)
    if args.k15:
        out["k15"] = trace_hosts(root, scenes["threaded"], cam, px, py, bcfg,
                                 cfg0, args.reps, log)
    if args.shade or args.merge:
        out["shade"] = shade_hosts(root, scenes, cam, px, py, bcfg, cfg0,
                                   args.reps, not args.shade, log)
    if args.sort:
        out["sort"] = sort_times(scenes["bvh8"], px, py, cfg0, args.reps, log)
    if args.rng:
        out["rng"] = rng_entries(px, py, args.reps, log)
    if args.eye_walks:
        out["eye_walks"] = eye_walks(scenes, cam, px, py, cfg0, args.reps,
                                     log)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
