#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (cudapathtracer_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the result line):
  1. a CUDA card is required; print nvidia-smi's name and power limit;
  2. build the kernels from kernels/csrc into build/torch_ext;
  3. K6 (rng.cu) against its plain version on 2,073,600 ids: bit-equal;
  4. K7 (camera.cu) against its plain version at 1920x1080: max abs <= 1e-6;
  5. K1 (traverse8.cu) against its plain version on the ~82k-triangle
     Cornell + bunny scene: closest hits of the 1080p primary rays and of
     random secondary rays (ids equal on >= 99.99% of rays, every mismatch
     an edge tie with |dt| <= 1e-5 t; t/u/v within 1e-5 where ids match),
     shadow factors of NEE-like rays on that scene and on its MAT_LEAF
     variant (within 1e-5); restart counts equal the plain version's, and
     a 7-entry-stack build of traverse8.cu must overflow and restart on
     grazing rays and still match the plain version at that depth;
  6. the unidirectional golden (16x16, 8 spp) rendered on the card:
     rmse < 1e-3 against tests/golden/cornell_uni_16x16_8spp.npy, or, if
     float rounding flipped a discrete decision, |mean ratio - 1| < 1e-2;
  7. the main path: driver.Renderer on configs/cornell.rendertron with
     Engine classic, the bunny scene, 1920x1080, depth 8, 4 spp; the image
     must be finite, free of NaN/Inf/negative pixels and > 90% non-black,
     and every kernel of the path must have launched during it.
Then one JSON line with each kernel's launches, error and times against
its plain version, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
WIDTH, HEIGHT, SPP, DEPTH = 1920, 1080, 4, 8
KERNELS = (  # name, source, the JAX function it replaces
    ("uniform_id", "cudapathtracer_tpu_torch/kernels/csrc/rng.cu",
     "cudapathtracer_tpu/utils/rng.py:106"),
    ("generate_rays", "cudapathtracer_tpu_torch/kernels/csrc/camera.cu",
     "cudapathtracer_tpu/scene/camera.py:81"),
    ("closest_hit8", "cudapathtracer_tpu_torch/kernels/csrc/traverse8.cu",
     "cudapathtracer_tpu/ops/traverse8.py:288"),
    ("shadow_factor8", "cudapathtracer_tpu_torch/kernels/csrc/traverse8.cu",
     "cudapathtracer_tpu/ops/traverse8.py:354"),
)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_hits(k, p, what: str) -> float:
    """K1 closest criterion; returns max |dt| where the ids match."""
    import torch
    ids_eq = k.tri == p.tri
    frac = ids_eq.float().mean().item()
    check(frac >= 0.9999, f"{what}: ids equal on only {frac:.6f} of rays")
    bad = ~ids_eq
    if bool(bad.any()):
        dt = torch.abs(k.t[bad] - p.t[bad])
        tie = dt <= 1e-5 * torch.minimum(k.t[bad], p.t[bad])
        check(bool(tie.all()), f"{what}: {int((~tie).sum())} id mismatches "
              "are not edge ties")
    m = ids_eq & (k.tri >= 0)
    errs = [torch.abs(a[m] - b[m]).max().item() if bool(m.any()) else 0.0
            for a, b in ((k.t, p.t), (k.u, p.u), (k.v, p.v))]
    check(max(errs) <= 1e-5, f"{what}: t/u/v differ by {max(errs):.3g}")
    say("K1", f"{what}: {k.tri.numel()} rays, ids equal on {frac:.6f}, "
        f"{int(bad.sum())} edge ties, max |dt| {errs[0]:.3g} "
        f"|du| {errs[1]:.3g} |dv| {errs[2]:.3g}")
    return errs[0]


def grazing_rays(n=2000, seed=3):
    """Rays near the floor and nearly parallel to it (the rays of
    tests/test_torch_traverse8.py::test_stack_overflow_restart, whose plain
    version at a 7-entry stack matches the JAX traversal's)."""
    import numpy as np
    gen = np.random.default_rng(seed)
    o = gen.uniform(-0.49, 0.49, (n, 3))
    o[:, 1] = gen.uniform(-0.5, -0.2, n)
    d = gen.normal(size=(n, 3))
    d[:, 1] *= 0.05
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def nee_rays(scene, hit_o, hit_d, hit, ids):
    """Shadow rays from the hit points to light samples (as NEE makes)."""
    import torch
    from cudapathtracer_tpu_torch.models import common
    from cudapathtracer_tpu_torch.utils import rng
    from cudapathtracer_tpu_torch.utils.math import (EPSILON, length_sq,
                                                     normalize)
    sel = torch.nonzero(hit.valid)[:, 0]
    p = hit_o[sel] + hit_d[sel] * hit.t[sel, None]
    ls = common.sample_light_point(scene, rng.base_key(11), 0, sel.numel(),
                                   ids[sel])
    stl = ls.point - p
    wi = normalize(stl)
    dist = torch.sqrt(torch.clamp(length_sq(stl), min=0.0))
    return (p + wi * EPSILON).contiguous(), wi.contiguous(), \
        ((dist - EPSILON) * (1.0 - EPSILON)).contiguous()


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "cudapathtracer_tpu_torch")):
        print("FAIL: run chip_smoke.py from a checkout of the repository "
              "(cudapathtracer_tpu_torch/ not found beside it)")
        return 3
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU")
        return 2
    sys.path.insert(0, ROOT)
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.utils.config import MeshConfig, load_config
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.driver import Renderer
    from cudapathtracer_tpu_torch.models import unidirectional
    from cudapathtracer_tpu_torch.ops import traverse8
    from cudapathtracer_tpu_torch.scene.camera import Camera
    from cudapathtracer_tpu_torch.scene.materials import builtin_materials
    from cudapathtracer_tpu_torch.scene.scene import build_scene
    from cudapathtracer_tpu_torch.utils import rng
    from cudapathtracer_tpu_torch.utils.image import rmse

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    say("card", card)
    say("card", f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    stats = {name: {} for name, _, _ in KERNELS}

    # --- 2. build
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    say("build", f"{kernels.LIBRARY} built in "
        f"{time.perf_counter() - t0:.1f} s")

    # --- 3. K6
    n = WIDTH * HEIGHT
    gy, gx = torch.meshgrid(torch.arange(HEIGHT, dtype=torch.int32,
                                         device=dev),
                            torch.arange(WIDTH, dtype=torch.int32,
                                         device=dev), indexing="ij")
    px, py = gx.reshape(-1).contiguous(), gy.reshape(-1).contiguous()
    ids = rng.pixel_ids(px, py).contiguous()
    k0, k1 = rng.draw_key(rng.bounce_key(rng.sample_key(rng.base_key(), 5),
                                         3), 4)
    ku0, ku1 = rng.uniform_draw_key(k0, k1, ids, two=True)
    pu0, pu1 = rng.uniform_draw_key_plain(k0, k1, ids, two=True)
    check(torch.equal(ku0.view(torch.int32), pu0.view(torch.int32))
          and torch.equal(ku1.view(torch.int32), pu1.view(torch.int32)),
          "K6: kernel draws are not bit-equal to the plain version")
    stats["uniform_id"].update(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: rng.uniform_draw_key(k0, k1, ids), 50),
        plain_ms=cuda_ms(lambda: rng.uniform_draw_key_plain(k0, k1, ids), 10))
    say("K6", f"{n} ids bit-equal (both words); kernel "
        f"{stats['uniform_id']['ms']:.4f} ms, plain "
        f"{stats['uniform_id']['plain_ms']:.4f} ms")

    # --- 4. K7
    cam = Camera.pinhole((0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0, 60.0)
    lens = Camera.thin_lens((0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0,
                            60.0, 0.05, 1.5)
    ckey = rng.fold_in(rng.sample_key(rng.base_key(), 0), 2 ** 20)
    fx, fy = px.float(), py.float()
    err7 = 0.0
    for c in (cam, lens):
        ko, kd = c.generate_rays(ckey, fx, fy, ids)
        po, pd = c.generate_rays_plain(ckey, fx, fy, ids)
        err7 = max(err7, (ko - po).abs().max().item(),
                   (kd - pd).abs().max().item())
    check(err7 <= 1e-6, f"K7: max abs error {err7:.3g} > 1e-6")
    stats["generate_rays"].update(
        max_abs_err=err7,
        ms=cuda_ms(lambda: cam.generate_rays(ckey, fx, fy, ids), 50),
        plain_ms=cuda_ms(lambda: cam.generate_rays_plain(ckey, fx, fy, ids),
                         10))
    say("K7", f"{WIDTH}x{HEIGHT} pinhole + thin lens, max abs err "
        f"{err7:.3g}; kernel {stats['generate_rays']['ms']:.4f} ms, plain "
        f"{stats['generate_rays']['plain_ms']:.4f} ms")

    # --- 5. K1
    t0 = time.perf_counter()
    scene, _ = build_scene(builtin.cornell_with_bunny(subdivisions=6),
                           builtin_materials(), device=dev)
    say("scene", f"cornell_with_bunny(6): {scene.num_triangles} triangles, "
        f"{scene.bvh8_table.shape[0]} BVH8 rows, built in "
        f"{time.perf_counter() - t0:.1f} s")
    o, d = cam.generate_rays(ckey, fx, fy, ids)
    tbl, nomax = scene.bvh8_table, torch.full((n,), 999999.0, device=dev)
    noskip = torch.full((n,), -1, dtype=torch.int32, device=dev)
    kh = traverse8.closest_hit8(scene, o, d)
    ph = traverse8.closest_hit8_plain(tbl, o, d, nomax, noskip, None,
                                      with_restarts=True)
    err1 = compare_hits(kh, traverse8.Hit(*ph[:4]), "primary 1080p")
    kr = kernels.closest_hit8(tbl, o, d, nomax, noskip, None,
                              with_restarts=True)[4]
    check(torch.equal(kr, ph[4]), "K1: restart counts differ from the "
          "plain version on the primary rays")
    stats["closest_hit8"].update(
        ms=cuda_ms(lambda: traverse8.closest_hit8(scene, o, d), 10),
        plain_ms=cuda_ms(lambda: traverse8.closest_hit8_plain(
            tbl, o, d, nomax, noskip, None), 1, warmup=0))
    # random secondary rays leaving the primary hit points
    gen = np.random.default_rng(7)
    sel = torch.nonzero(kh.valid)[:, 0]
    p = o[sel] + d[sel] * kh.t[sel, None]
    rd = torch.as_tensor(gen.normal(size=(sel.numel(), 3)),
                         dtype=torch.float32, device=dev)
    rd = rd / rd.norm(dim=1, keepdim=True)
    so = (p - d[sel] * 1e-4).contiguous()
    mt = torch.as_tensor(gen.uniform(0.05, 3.0, sel.numel()),
                         dtype=torch.float32, device=dev)
    skip = kh.tri[sel].contiguous()
    kh2 = traverse8.closest_hit8(scene, so, rd, mt, skip)
    ph2 = traverse8.closest_hit8_plain(tbl, so, rd.contiguous(), mt, skip,
                                       None, with_restarts=True)
    err1 = max(err1, compare_hits(kh2, traverse8.Hit(*ph2[:4]),
                                  "secondary (max_t, skip_tri)"))
    kr2 = kernels.closest_hit8(tbl, so, rd.contiguous(), mt, skip, None,
                               with_restarts=True)[4]
    check(torch.equal(kr2, ph2[4]), "K1: restart counts differ from the "
          "plain version on the secondary rays")
    say("K1", f"16-entry stack: {int((kr > 0).sum())} primary and "
        f"{int((kr2 > 0).sum())} secondary rays restarted (counts equal "
        "the plain version's)")

    # the ring and the restart from the root, on a 7-entry build
    t0 = time.perf_counter()
    kernels.build(stack_d=7)
    bsc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=4),
                         builtin_materials(), device=dev)
    go, gd = (torch.as_tensor(a, device=dev) for a in grazing_rays())
    gn = go.shape[0]
    gmt = torch.full((gn,), 999999.0, device=dev)
    gsk = torch.full((gn,), -1, dtype=torch.int32, device=dev)
    g16 = kernels.closest_hit8(bsc.bvh8_table, go, gd, gmt, gsk, None)
    g7 = kernels.closest_hit8(bsc.bvh8_table, go, gd, gmt, gsk, None,
                              stack_d=7, with_restarts=True)
    traverse8.STACK_D = 7
    try:
        p7 = traverse8.closest_hit8_plain(bsc.bvh8_table, go, gd, gmt, gsk,
                                          None, with_restarts=True)
        smt = torch.as_tensor(gen.uniform(0.1, 2.0, gn), dtype=torch.float32,
                              device=dev)
        ks7 = kernels.shadow_factor8(bsc.bvh8_table, bsc.tri_f32, go, gd,
                                     smt, gsk, None, stack_d=7)
        ps7 = traverse8.shadow_factor8_plain(bsc.bvh8_table, bsc.tri_f32, go,
                                             gd, smt, gsk, None)
    finally:
        traverse8.STACK_D = kernels.STACK_D
    restarted = int((g7[4] > 0).sum())
    check(restarted > 0, "K1 overflow: no grazing ray overflowed the "
          "7-entry stack")
    check(torch.equal(g7[4], p7[4]), "K1 overflow: restart counts differ "
          "from the plain version at 7 entries")
    check(torch.equal(g7[1], p7[1]) and torch.equal(g7[1], g16[1]),
          "K1 overflow: ids differ from the plain version at 7 entries or "
          "from the 16-entry kernel")
    m7 = g7[1] >= 0
    e7 = (g7[0][m7] - p7[0][m7]).abs().max().item()
    es7 = (ks7 - ps7).abs().max().item()
    check(e7 <= 1e-5 and es7 <= 1e-5, f"K1 overflow: t differs by {e7:.3g}, "
          f"shadow by {es7:.3g}")
    say("K1", f"7-entry stack (built in {time.perf_counter() - t0:.1f} s "
        f"with the scene): {restarted} of {gn} grazing rays restarted, "
        f"{int(g7[4].max())} restarts at most; ids and restart counts equal "
        f"the plain version's, ids equal the 16-entry kernel's; max |dt| "
        f"{e7:.3g}, shadow max abs err {es7:.3g}")
    err1 = max(err1, e7)
    stats["closest_hit8"]["max_abs_err"] = err1

    err_s = 0.0
    for label, sc in (("bunny", scene), ("bunny MAT_LEAF", None)):
        if sc is None:
            sc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=6,
                                                           bunny_mat=13),
                                builtin_materials(), device=dev)
        h = traverse8.closest_hit8(sc, o, d)
        so, sd, smt = nee_rays(sc, o, d, h, ids)
        m = so.shape[0]
        sk = torch.full((m,), -1, dtype=torch.int32, device=dev)
        ks = traverse8.shadow_factor8(sc, so, sd, smt)
        ps = traverse8.shadow_factor8_plain(sc.bvh8_table, sc.tri_f32, so,
                                            sd, smt, sk, None)
        e = (ks - ps).abs().max().item()
        partial = ((ks > 0) & (ks < 1)).any(dim=1).float().mean().item()
        check(e <= 1e-5, f"K1 shadow ({label}): max abs error {e:.3g}")
        err_s = max(err_s, e)
        say("K1", f"shadow {label}: {m} rays, max abs err {e:.3g}, "
            f"occluded {(ks.amax(1) == 0).float().mean().item():.4f}, "
            f"partly transmitted {partial:.4f}")
        if label == "bunny":
            stats["shadow_factor8"].update(
                ms=cuda_ms(lambda: traverse8.shadow_factor8(sc, so, sd, smt),
                           10),
                plain_ms=cuda_ms(lambda: traverse8.shadow_factor8_plain(
                    sc.bvh8_table, sc.tri_f32, so, sd, smt, sk, None), 1,
                    warmup=0))
        else:
            check(partial > 0.0, "K1 shadow: no ray crossed a MAT_LEAF "
                  "surface, transmission untested")
    stats["shadow_factor8"]["max_abs_err"] = max(err_s, es7)
    say("K1", f"closest kernel {stats['closest_hit8']['ms']:.3f} ms, plain "
        f"{stats['closest_hit8']['plain_ms']:.3f} ms; shadow kernel "
        f"{stats['shadow_factor8']['ms']:.3f} ms, plain "
        f"{stats['shadow_factor8']['plain_ms']:.3f} ms")
    del scene

    # --- 6. golden on the card
    gscene, _ = build_scene(builtin.cornell_with_blocks(),
                            builtin_materials(), device=dev)
    gcam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    gyy, gxx = torch.meshgrid(torch.arange(16, dtype=torch.int32,
                                           device=dev),
                              torch.arange(16, dtype=torch.int32,
                                           device=dev), indexing="ij")
    acc = torch.zeros((256, 3), device=dev)
    for s in range(8):
        li, _ = unidirectional.render_sample(
            gscene, gcam, rng.base_key(), s, gxx.reshape(-1),
            gyy.reshape(-1), max_depth=6)
        acc += li
    img = (acc / 8).cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  "cornell_uni_16x16_8spp.npy"))
    err = rmse(img, golden)
    ratio = float(img.mean() / golden.mean())
    say("golden", f"16x16 8 spp on the card: rmse {err:.3g} (bound 1e-3), "
        f"mean ratio {ratio:.6f}, max |dpixel| "
        f"{np.abs(img - golden).max():.3g}")
    check(err < 1e-3 or abs(ratio - 1.0) < 1e-2,
          f"golden: rmse {err:.3g} and mean ratio {ratio:.6f}")

    # --- 7. the main path through the Renderer
    cfg = load_config(os.path.join(ROOT, "configs", "cornell.rendertron"))
    cfg = dataclasses.replace(
        cfg, engine="classic", width=WIDTH, height=HEIGHT, max_depth=DEPTH,
        sample_count=SPP, name="smoke", output_dir=OUT_DIR,
        meshes=[MeshConfig("builtin:cornell_bunny", 1.0, (0.0, 0.0, 0.0),
                           2)])
    t0 = time.perf_counter()
    r = Renderer(cfg, device="cuda")
    say("main", f"Renderer ready in {time.perf_counter() - t0:.1f} s: "
        f"{r.scene.num_triangles} triangles, {WIDTH}x{HEIGHT}, depth "
        f"{DEPTH}, {SPP} spp")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    r.render(progressive=False, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    acc = r.accum
    bad = int((~torch.isfinite(acc)).any(dim=1).sum()
              + (acc < 0).any(dim=1).sum())
    fb = r.framebuffer()
    nonblack = float((fb.max(axis=-1) > 0.0).mean())
    rays = r.metrics.rays_traced
    say("main", f"{rays} rays in {secs:.3f} s = {rays / secs / 1e6:.3f} "
        f"Mrays/s ({card}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{launches}; non-black {nonblack:.4f}; bad pixels {bad}")
    check(fb.shape == (HEIGHT, WIDTH, 3), f"framebuffer shape {fb.shape}")
    check(bad == 0, f"{bad} NaN/Inf/negative pixels")
    check(nonblack > 0.9, f"only {nonblack:.3f} of pixels non-black")
    for name, _, _ in KERNELS:
        check(launches[name] > 0, f"main path never launched {name}")
    r.save_final(0)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, src, rep in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
