#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main paths, on one GPU.

Renders a main path (configs/cornell.rendertron, the ~82k-triangle
Cornell + bunny scene) through driver.Renderer with the engine asked for:
--engine mega (the config's default) or classic, the unidirectional path
at depth 8, one launch per sample of the per-path megakernel K5; or
--engine bdpt, Integrator BIDIRECTIONAL with Engine classic at the
config's eye and light depths, four launches per sample (the walks K12
twice, the splat K11, the connections K13); or --engine vcm / sppm,
Integrator VCM / SPPM with Engine classic at the same depths, five
launches and a sort per sample (K12's light walk, vcm_splat (not SPPM),
photon_pack, torch.sort, photon_table, vcm_eye). One
timed warm-up sample, then timed samples (host clock around samples that
end in a synchronize, and CUDA events around the same samples), then one
sample under torch.profiler. Prints per-kernel device time grouped by layer, the
device's busy time and idle share over the profiled sample, and each
sample's time and Mrays/s. Writes the profiler table and a Chrome trace
under --out (the trace gzipped). Run from the repository root:

    python3 tools/profile_torch_classic.py
        [--engine mega|classic|bdpt|vcm|sppm]
        [--width 1920 --height 1080 --spp 4]
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
          ("K12 BDPT walks", "bdpt_walk_kernel"),
          ("K11 splat (BDPT or VCM form)", "bdpt_splat_kernel"),
          ("K13 BDPT connections", "bdpt_connect_kernel"),
          ("K8 photon_pack", "photon_pack_kernel"),
          ("K8 sort (torch.sort)", "RadixSort"),
          ("K8 photon_table", "photon_table_kernel"),
          ("K13 VCM eye pass (with K9)", "vcm_eye_kernel"),
          ("K1 traverse8", "traverse8_kernel"),
          ("K6 rng", "uniform_id_kernel"),
          ("K7 camera", "generate_rays_kernel"))
OTHER = "other device work (sums, copies, accumulation)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", choices=("mega", "classic", "bdpt", "vcm",
                                         "sppm"), default="mega")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--spp", type=int, default=4, help="timed samples")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from cudapathtracer_tpu_torch.driver import Renderer
    from cudapathtracer_tpu_torch.utils.config import MeshConfig, load_config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    integ = {"bdpt": "BIDIRECTIONAL", "vcm": "VCM", "sppm": "SPPM"}.get(
        args.engine, "UNIDIRECTIONAL")
    bdpt = integ != "UNIDIRECTIONAL"
    cfg = dataclasses.replace(
        load_config(os.path.join(ROOT, "configs", "cornell.rendertron")),
        integrator=integ,
        engine="classic" if bdpt else args.engine, width=args.width,
        height=args.height, max_depth=args.depth,
        meshes=[MeshConfig("builtin:cornell_bunny", 1.0, (0.0, 0.0, 0.0),
                           2)])
    r = Renderer(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render_sample(0)                                   # warm-up
    torch.cuda.synchronize()
    warmup_secs = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    per_sample, rays = [], 0
    for s in range(1, 1 + args.spp):
        t1 = time.perf_counter()
        n = r.render_sample(s)[1]          # ends in a sync (the ray count)
        per_sample.append((time.perf_counter() - t1, n))
        rays += n
    end.record()
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / args.spp
    event_ms = start.elapsed_time(end) / args.spp

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        r.render_sample(1 + args.spp)
        torch.cuda.synchronize()
        prof_secs = time.perf_counter() - t1

    os.makedirs(args.out, exist_ok=True)
    avg = prof.key_averages()
    table = avg.table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(args.out, f"kernels_{args.engine}.txt"),
              "w") as f:
        f.write(table)
    trace = os.path.join(args.out, f"trace_{args.engine}.json")
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
        width=args.width, height=args.height,
        depth=((cfg.bdpt_eye_depth, cfg.bdpt_light_depth) if bdpt
               else args.depth),
        warmup_sample_seconds=warmup_secs, sample_seconds=secs,
        sample_event_ms=event_ms,
        mrays_per_s=rays / args.spp / secs / 1e6,
        rays_per_sample=rays / args.spp,
        samples=[dict(seconds=t, rays=n) for t, n in per_sample],
        profiled_sample_seconds=prof_secs, device_busy_seconds=busy,
        device_idle_share=1.0 - busy / prof_secs,
        layer_ms=layers,
        top_kernels_ms={k[:60]: v / 1e3 for k, v in top},
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps(summary))
    with open(os.path.join(args.out, f"summary_{args.engine}.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
