#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's classic main path, on one GPU.

Renders the main path (configs/cornell.rendertron with Engine classic, the
~82k-triangle Cornell + bunny scene, depth 8) through driver.Renderer:
one warm-up sample, then timed samples with the live path count of every
bounce recorded, then one sample under torch.profiler. Prints per-kernel
device time grouped by layer (K1 traversal, K6 RNG, K7 raygen, plain
PyTorch shading/NEE/BSDF), the device's idle share over the sample, and
the bounce tail. Writes the profiler table and a Chrome trace under
--out (the trace gzipped). Run from the repository root:

    python3 tools/profile_torch_classic.py [--width 1920 --height 1080]
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (("K1 traverse8", "traverse8_kernel"),
          ("K6 rng", "uniform_id_kernel"),
          ("K7 camera", "generate_rays_kernel"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--spp", type=int, default=2, help="timed samples")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from cudapathtracer_tpu.utils.config import MeshConfig, load_config
    from cudapathtracer_tpu_torch.driver import Renderer
    from cudapathtracer_tpu_torch.models import unidirectional as uni

    cfg = dataclasses.replace(
        load_config(os.path.join(ROOT, "configs", "cornell.rendertron")),
        engine="classic", width=args.width, height=args.height,
        max_depth=args.depth,
        meshes=[MeshConfig("builtin:cornell_bunny", 1.0, (0.0, 0.0, 0.0),
                           2)])
    r = Renderer(cfg, device="cuda")
    live = []
    bounce = uni._bounce

    def counted(scene, mats, skey, it, s, *rest):
        live.append((it, s["lane"].numel()))
        return bounce(scene, mats, skey, it, s, *rest)

    uni._bounce = counted
    r.render_sample(0)                                   # warm-up
    torch.cuda.synchronize()
    live.clear()
    t0 = time.perf_counter()
    rays = 0
    for s in range(1, 1 + args.spp):
        rays += r.render_sample(s)[1]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / args.spp
    iters = len(live) // args.spp
    tail = [n for it, n in live[:iters]]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        r.render_sample(1 + args.spp)
        torch.cuda.synchronize()
        prof_secs = time.perf_counter() - t1
    uni._bounce = bounce

    os.makedirs(args.out, exist_ok=True)
    avg = prof.key_averages()
    table = avg.table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(args.out, "kernels.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(args.out, "trace.json")
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
    layers["plain torch (shading, BSDF, NEE, state)"] = 0.0
    for name, us in kernels_us.items():
        for layer, key in LAYERS:
            if key in name:
                layers[layer] += us / 1e3
                break
        else:
            layers["plain torch (shading, BSDF, NEE, state)"] += us / 1e3
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:12]
    print(table[:6000])
    summary = dict(
        card=torch.cuda.get_device_name(0), width=args.width,
        height=args.height, depth=args.depth,
        sample_seconds=secs, mrays_per_s=rays / args.spp / secs / 1e6,
        rays_per_sample=rays / args.spp, bounce_iterations=iters,
        live_paths_per_bounce=tail,
        profiled_sample_seconds=prof_secs, device_busy_seconds=busy,
        device_idle_share=1.0 - busy / prof_secs,
        layer_ms=layers,
        top_kernels_ms={k[:60]: v / 1e3 for k, v in top},
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps(summary))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
