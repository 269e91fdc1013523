#!/usr/bin/env python3
"""Where the VCM eye passes spend their time, on one GPU.

Times one 1920x1080 sample's eye pass of the PyTorch port by CUDA events,
on fixed light buffers and photon grids (sample 0 of the ~82k-triangle
Cornell + bunny scene at configs/cornell.rendertron's depths: eye 8,
light 6), with the pass's strategy switches turned off in turn:

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
prints ptxas' registers, stack frame and spill bytes of every eye-pass
instantiation of the build (the library is rebuilt with -Xptxas=-v).
--bit-equal prints K14's bit-equal pixel share against its plain version
(the tree's chip_smoke.compare_mega, 1080p, three flavours); --renders
times the eye-pass paths through driver.Renderer (Mrays/s and the peak
memory rise: renders()).
The wrappers' signatures are the same on either design of the passes, so
--root may name another checkout of the repository (its package is
imported and its kernels built there), which lets one call time two trees
in turns. Run from the repository root:

    python3 tools/eye_attribution.py [--root DIR] [--reps 2]
        [--bit-equal] [--renders] [--json chiprun_out/eye_attribution.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT = 1920, 1080
CLASSIC_TOGGLES = {"all on": {}, "no connections": dict(connection=False),
                   "no merge": dict(do_merge=False), "no NEE": dict(nee=False),
                   "bare walk": dict(connection=False, do_merge=False)}
SPPM_TOGGLES = {"as shipped": {}, "no merge": dict(do_merge=False)}
BDPT_TOGGLES = {"all on": {}, "no connections (bare walk)":
                dict(connection=False), "no NEE": dict(nee=False)}


def _events_ms(fn, reps: int) -> float:
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
    """{entry: (registers, stack bytes, spill stores, spill loads)} of the
    eye-pass kernels in a ptxas -v report."""
    out = {}
    for m in re.finditer(r"Compiling entry function '([^']*eye[^']*)'"
                         r".*?(\d+) bytes stack frame, (\d+) bytes spill "
                         r"stores, (\d+) bytes spill loads.*?Used (\d+) "
                         r"registers", log, re.S):
        name, stack, st, ld, regs = m.groups()
        out[name] = (int(regs), int(stack), int(st), int(ld))
    return out


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
    from cudapathtracer_tpu_torch.models import bdpt, bdpt_mega, vcm
    res = {}

    def cfg_of(integ, engine):
        c = dataclasses.replace(cfg0, integrator=integ, engine=engine)
        c = c.normalized()
        if integ == "BIDIRECTIONAL":
            return bdpt_mega.as_machine_cfg(bdpt.BDPTConfig.from_config(c))
        return vcm.VCMConfig.from_config(c)

    def run(name, toggles, base, fn):
        res[name] = {}
        for tog, over in toggles.items():
            c = dataclasses.replace(base, **over)
            res[name][tog] = _events_ms(lambda: fn(c), reps)
        log(f"[attribution] {name}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in res[name].items()))

    cv = cfg_of("VCM", "classic")
    if scene is not None:
        inp = classic_inputs(scene, px, py, cv)
        run("classic VCM", CLASSIC_TOGGLES, cv,
            lambda c: classic_pass(scene, cam, px, py, c, inp))
        run("classic SPPM", SPPM_TOGGLES, cfg_of("SPPM", "classic"),
            lambda c: classic_pass(scene, cam, px, py, c, inp))
        del inp
        out = torch.zeros((px.shape[0], 3), device=px.device)
        mv = cfg_of("VCM", "mega")
        chunks = mega_inputs(scene, px, py, mv, "vcm")
        run("K14 VCM (2 chunks)", CLASSIC_TOGGLES, mv,
            lambda c: mega_pass(scene, cam, c, "vcm", chunks, out))
        mb = cfg_of("BIDIRECTIONAL", "mega")
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
    import importlib.util
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


def renders(cfg0, tsc, cam, px, py, spp: int = 4, log=print) -> dict:
    """Mrays/s (rays over the render phase) and the peak memory rise of
    the eye-pass paths through driver.Renderer: VCM and SPPM with Engine
    classic and with the mega engine and BIDIRECTIONAL's mega engine on
    the 1080p bunny scene at spp samples, configs/vcm_caustics.rendertron
    as shipped with either engine (its own samples and dispatch), and
    classic VCM and SPPM on the threaded scene tsc through render_sample
    (no config key selects it). Each path renders one sample first (not
    counted)."""
    import time
    import torch
    from cudapathtracer_tpu_torch.driver import Renderer
    from cudapathtracer_tpu_torch.models import vcm
    from cudapathtracer_tpu_torch.utils.config import MeshConfig, load_config
    from cudapathtracer_tpu_torch.utils.metrics import RenderMetrics
    from cudapathtracer_tpu_torch.utils import rng
    res = {}

    def measure(tag, r, cfg):
        r.cfg = cfg.normalized()
        r.render_sample(0)
        torch.cuda.synchronize()
        r.accum.zero_()
        r.sample_count, r.metrics = 0, RenderMetrics()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r.render(progressive=False, verbose=False)
        torch.cuda.synchronize()
        rays, secs = r.metrics.rays_traced, r.metrics.render_seconds
        rise = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        res[tag] = dict(rays=rays, seconds=secs, mrays=rays / secs / 1e6,
                        peak_rise_gib=rise)
        log(f"[attribution] {tag}: {r.cfg.sample_count} spp, {rays} rays in "
            f"{secs:.3f} s = {rays / secs / 1e6:.3f} Mrays/s, peak rise "
            f"{rise:.3f} GiB")

    bunny = [MeshConfig("builtin:cornell_bunny", 1.0, (0.0, 0.0, 0.0), 2)]
    c1080 = dataclasses.replace(cfg0, width=WIDTH, height=HEIGHT,
                                sample_count=spp, meshes=bunny)
    r = Renderer(c1080, device="cuda")
    for tag, integ, engine in (
            ("vcm-1080p", "VCM", "classic"), ("sppm-1080p", "SPPM", "classic"),
            ("vcm-mega-1080p", "VCM", "mega"),
            ("sppm-mega-1080p", "SPPM", "mega"),
            ("bdpt-mega-1080p", "BIDIRECTIONAL", "mega")):
        measure(tag, r, dataclasses.replace(c1080, integrator=integ,
                                            engine=engine))
    del r
    caustics = load_config(os.path.join(ROOT, "configs",
                                        "vcm_caustics.rendertron"))
    r = Renderer(caustics, device="cuda")
    for tag, engine in (("caustics-512", "classic"),
                        ("caustics-mega-512", "mega")):
        measure(tag, r, dataclasses.replace(caustics, engine=engine))
    del r
    if tsc is not None:
        for integ in ("VCM", "SPPM"):
            cfg = vcm.VCMConfig.from_config(dataclasses.replace(
                cfg0, integrator=integ, engine="classic").normalized())
            vcm.render_sample(tsc, cam, rng.base_key(), 0, px, py, cfg=cfg)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rays = 0
            for s in range(spp):
                rays = rays + vcm.render_sample(tsc, cam, rng.base_key(), s,
                                                px, py, cfg=cfg)[1]
            rays = int(rays)
            secs = time.perf_counter() - t0
            rise = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            tag = f"{integ.lower()}-threaded-1080p"
            res[tag] = dict(rays=rays, seconds=secs, mrays=rays / secs / 1e6,
                            peak_rise_gib=rise)
            log(f"[attribution] {tag}: {spp} spp through render_sample, "
                f"{rays} rays in {secs:.3f} s = {rays / secs / 1e6:.3f} "
                f"Mrays/s, peak rise {rise:.3f} GiB")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=ROOT, help="the checkout whose "
                    "package is imported and whose kernels are built")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--json", default=None)
    ap.add_argument("--renders", action="store_true", help="also time the "
                    "eye-pass paths through driver.Renderer (renders())")
    ap.add_argument("--bit-equal", action="store_true", help="also print "
                    "K14's bit-equal share through the tree's chip_smoke")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU")
        return 2
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.scene import builtin
    from cudapathtracer_tpu_torch.scene.camera import Camera
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
    print(f"[attribution] {card}; tree {root}", flush=True)
    with open(kernels.build(verbose=True) + ".ptxas.txt") as f:
        regs = ptxas_eye(f.read())
    for name, (r, st, ss, sl) in sorted(regs.items()):
        print(f"[attribution] ptxas {name}: {r} registers, {st} bytes stack "
              f"frame, {ss} bytes spill stores, {sl} bytes spill loads")
    dev = torch.device("cuda", 0)
    cam = Camera.pinhole((0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0, 60.0)
    gy, gx = torch.meshgrid(torch.arange(HEIGHT, dtype=torch.int32,
                                         device=dev),
                            torch.arange(WIDTH, dtype=torch.int32,
                                         device=dev), indexing="ij")
    px, py = gx.reshape(-1).contiguous(), gy.reshape(-1).contiguous()
    mesh = builtin.cornell_with_bunny(subdivisions=6)
    scene, _ = build_scene(mesh, builtin_materials(), device=dev)
    tsc, _ = build_scene(mesh, builtin_materials(), traversal="threaded",
                         device=dev)
    cfg0 = load_config(os.path.join(ROOT, "configs", "cornell.rendertron"))
    out = dict(card=card, tree=root, ptxas=regs,
               ms=attribution(scene, tsc, cam, px, py, cfg0, args.reps))
    if args.bit_equal:
        out["bit_equal"] = bit_equal_shares(root, scene, cam, px, py, cfg0)
    if args.renders:
        out["renders"] = renders(cfg0, tsc, cam, px, py)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
