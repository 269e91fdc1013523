#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main paths, on one GPU.

Renders a main path through driver.Renderer: by default
configs/cornell.rendertron on the ~82k-triangle Cornell + bunny scene
at 1920x1080 (--config picks another config, which keeps its own size and
meshes unless --width, --height or --mesh say otherwise). --engine selects the integrator and engine: mega (the
config's default) or classic, the unidirectional path at --depth, one
launch per sample of the per-path megakernel K5; naive, the naive
integrator (K5's naive schedule); bdpt, vcm or sppm, Integrator
BIDIRECTIONAL / VCM / SPPM with Engine classic at the config's eye and
light depths (the walks K12, the splat K11, the connections K13 in two
launches; or K12,
vcm_splat (not SPPM), photon_pack, photon_sort, photon_table and the VCM
eye pass's three stages: walk, connections (not SPPM), gather);
bdpt-mega, vcm-mega or sppm-mega, the same integrators with the default
mega engine (per chunk K12, the splat, K8, the mega eye pass K14 in the
same three stages).
--samples-per-dispatch k renders k samples per dispatch (models/batch.py;
0 = the driver's auto rule), as the driver does. --traversal threaded
rebuilds the Renderer's scene with the threaded binary engine (the plain
SAH tree with per-octant links, kernel K15), which the classic kernels
then trace with; K5's mega schedule and K14 trace BVH8 on every scene.

One timed warm-up dispatch (it includes the kernel build), then --spp
timed samples in dispatches of k (host clock around the window, which ends
in one synchronize, and CUDA events around it), then --profile-spp samples
under torch.profiler. Prints per-kernel device time grouped by layer, the
device's busy time and idle share over the profiled window, and the
steady Mrays/s. Writes the profiler table and a Chrome trace under --out
(the trace gzipped). Run from the repository root:

    python3 tools/profile_torch_classic.py
        [--engine mega|classic|naive|bdpt|vcm|sppm|bdpt-mega|vcm-mega|
                  sppm-mega]
        [--config configs/cornell.rendertron] [--mesh builtin:NAME]
        [--width 1920 --height 1080 --spp 4] [--samples-per-dispatch K]
        [--traversal bvh8|threaded]
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (("K5 megakernel", "uni_mega_kernel"),
          ("K5 key table", "uni_mega_keys_kernel"),
          ("K12 BDPT walks", "bdpt_walk_kernel"),
          ("K12 prologue (endpoints, dead rows)", "bdpt_walk_start_kernel"),
          ("K11 stage 1: classify", "splat_classify_kernel"),
          ("K11 stage 1: scan", "splat_scan_kernel"),
          ("K11 stage 1: scatter", "splat_scatter_kernel"),
          ("K11 stage 2: trace and splat", "splat_trace_kernel"),
          ("K13 BDPT connection rays", "bdpt_pairs_kernel"),
          ("K13 BDPT gather", "bdpt_gather_kernel"),
          ("K8 photon_pack", "photon_pack_kernel"),
          ("K8 sort: digit histograms", "radix_hist_kernel"),
          ("K8 sort: scan", "radix_scan_kernel"),
          ("K8 sort: scatter", "radix_scatter_kernel"),
          ("K8 photon_table", "photon_table_kernel"),
          ("eye pass stage 1: the walk (classic VCM / K14)",
           "eye_walk_kernel"),
          ("eye pass stage 2: the connections", "eye_connect_kernel"),
          ("eye pass stage 3: the merge and gather (K9)",
           "eye_gather_kernel"),
          ("K1 traverse8", "traverse8_kernel"),
          ("K15 threaded traversal", "traverse_bin_kernel"),
          ("K6 rng (keyed mode)", "uniform_keyed_kernel"),
          ("K6 rng", "uniform_id_kernel"),
          ("K7 camera", "generate_rays_kernel"))
# --engine -> (integrator, engine)
ENGINES = {"mega": ("UNIDIRECTIONAL", "mega"),
           "classic": ("UNIDIRECTIONAL", "classic"),
           "naive": ("NAIVE_UNIDIRECTIONAL", "mega"),
           "bdpt": ("BIDIRECTIONAL", "classic"),
           "vcm": ("VCM", "classic"), "sppm": ("SPPM", "classic"),
           "bdpt-mega": ("BIDIRECTIONAL", "mega"),
           "vcm-mega": ("VCM", "mega"), "sppm-mega": ("SPPM", "mega")}
OTHER = "other device work (sums, copies, accumulation)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", choices=tuple(ENGINES), default="mega")
    ap.add_argument("--config", default=os.path.join(ROOT, "configs",
                                                     "cornell.rendertron"))
    ap.add_argument("--mesh", default=None,
                    help="builtin scene (default: the bunny for "
                         "cornell.rendertron, else the config's meshes)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--spp", type=int, default=4, help="timed samples")
    ap.add_argument("--profile-spp", type=int, default=None,
                    help="profiled samples (default: one dispatch)")
    ap.add_argument("--samples-per-dispatch", type=int, default=1,
                    help="samples per dispatch (0: the driver's auto rule)")
    ap.add_argument("--traversal", choices=("bvh8", "threaded"),
                    default="bvh8", help="the scene's traversal engine")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from cudapathtracer_tpu_torch.driver import (Renderer,
                                                 resolve_samples_per_dispatch)
    from cudapathtracer_tpu_torch.scene.materials import (
        apply_material_configs, builtin_materials)
    from cudapathtracer_tpu_torch.scene.scene import build_scene
    from cudapathtracer_tpu_torch.scene.textures import reference_atlas
    from cudapathtracer_tpu_torch.utils.config import MeshConfig, load_config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    integ, engine = ENGINES[args.engine]
    base = load_config(args.config)
    main_path = os.path.basename(args.config) == "cornell.rendertron"
    mesh = args.mesh or ("builtin:cornell_bunny" if main_path else None)
    over = dict(integrator=integ, engine=engine, max_depth=args.depth,
                samples_per_dispatch=args.samples_per_dispatch)
    if args.width or main_path:
        over.update(width=args.width or 1920)
    if args.height or main_path:
        over.update(height=args.height or 1080)
    if mesh:
        over.update(meshes=[MeshConfig(mesh, 1.0, (0.0, 0.0, 0.0), 2)])
    cfg = dataclasses.replace(base, **over)
    # the driver's materials and atlas, kept to rebuild the scene
    textures, wins = reference_atlas()
    materials = apply_material_configs(builtin_materials(wins),
                                       cfg.materials)
    r = Renderer(cfg, materials=materials, textures=textures, device="cuda")
    if args.traversal == "threaded":
        t0 = time.perf_counter()
        r.scene, r.bvh = build_scene(
            r.mesh, materials, textures,
            max_leaf_size=max(r.cfg.bvh_leaf_size, 1), traversal="threaded",
            device=r.device)
        print(f"threaded scene: {r.scene.node_packed.shape[0]} binary nodes, "
              f"built in {time.perf_counter() - t0:.1f} s")
    k = resolve_samples_per_dispatch(r.cfg, r.device)

    def window(s0: int, n: int):
        """n samples from s0 in dispatches of k, accumulated as the driver
        does; -> the rays as a device tensor (nothing waits)."""
        rays = torch.zeros((), dtype=torch.int64, device=r.device)
        s = s0
        while s < s0 + n:
            kk = min(k, s0 + n - s)
            out = r.render_batch(s, kk) if kk > 1 else r.render_sample(s)
            r.accum += out[0]
            rays = rays + out[1]
            s += kk
        return rays

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window(0, k)                                          # warm-up
    torch.cuda.synchronize()
    warmup_secs = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    rays = window(k, args.spp)
    end.record()
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / args.spp
    event_ms = start.elapsed_time(end) / args.spp
    rays = int(rays)

    n_prof = args.profile_spp or k
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        window(k + args.spp, n_prof)
        torch.cuda.synchronize()
        prof_secs = time.perf_counter() - t1
    os.makedirs(args.out, exist_ok=True)
    avg = prof.key_averages()
    table = avg.table(sort_by="self_cuda_time_total", row_limit=40)
    tag = (f"{args.engine}_{args.traversal}_{r.cfg.width}x{r.cfg.height}"
           f"_spd{k}")
    with open(os.path.join(args.out, f"kernels_{tag}.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(args.out, f"trace_{tag}.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as f, gzip.open(trace + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(trace)
    kernels_us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels_us[e.name] = kernels_us.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    busy = sum(kernels_us.values()) / 1e6
    layers = {name: 0.0 for name, _ in LAYERS}
    layers[OTHER] = 0.0
    for name, us in kernels_us.items():
        for layer, key in LAYERS:
            if key in name:
                layers[layer] += us / 1e3
                break
        else:
            layers[OTHER] += us / 1e3
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:12]
    print(table[:6000])
    summary = dict(
        card=card, kind=torch.cuda.get_device_name(0), engine=args.engine,
        traversal=args.traversal,
        config=os.path.basename(args.config), width=r.cfg.width,
        height=r.cfg.height, samples_per_dispatch=k,
        depth=((r.cfg.bdpt_eye_depth, r.cfg.bdpt_light_depth)
               if integ in ("BIDIRECTIONAL", "VCM", "SPPM") else args.depth),
        warmup_seconds=warmup_secs, sample_seconds=secs,
        sample_event_ms=event_ms,
        mrays_per_s=rays / args.spp / secs / 1e6,
        rays_per_sample=rays / args.spp,
        profiled_samples=n_prof, profiled_seconds=prof_secs,
        device_busy_seconds=busy, device_idle_share=1.0 - busy / prof_secs,
        layer_ms=layers,
        top_kernels_ms={kn[:60]: v / 1e3 for kn, v in top},
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps(summary))
    with open(os.path.join(args.out, f"summary_{tag}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0




if __name__ == "__main__":
    sys.exit(main())
