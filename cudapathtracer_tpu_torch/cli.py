"""Command-line entry point of the PyTorch + CUDA port.

The same flags as `python -m cudapathtracer_tpu`, plus --device (default
cuda; the CPU only when asked for with --device cpu). A config's
`Mesh Shape: <n_tile> <n_spp>` renders over that mesh of cards (or CPU
ranks with --device cpu), which is described once it is built. After
each render it prints the metrics and the numerical checks' summary
(CUDAPATHTRACER_TPU_CHECKS=1 turns the checks on).

Usage:
    python -m cudapathtracer_tpu_torch [configs/config.rendertron]
        [--renders N] [--samples N] [--integrator NAME]
        [--checkpoint PATH.npz] [--no-progressive]
        [--width W] [--height H] [--samples-per-dispatch N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cudapathtracer_tpu_torch",
                                 description=__doc__)
    ap.add_argument("config", nargs="?", default="configs/config.rendertron")
    ap.add_argument("--renders", type=int, default=1,
                    help="number of animated renders (reference runs 75)")
    ap.add_argument("--samples", type=int, default=None,
                    help="override Sample Count")
    ap.add_argument("--integrator", default=None,
                    help="override the config integrator")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path (.npz; enables exact resume)")
    ap.add_argument("--no-progressive", action="store_true")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--samples-per-dispatch", type=int, default=None,
                    help="samples accumulated per device dispatch (the same "
                         "image as 1; amortizes dispatch overhead at small "
                         "frames; default: the config's, 0 = auto)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu "
                         "runs the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    from cudapathtracer_tpu_torch.driver import (Renderer, check_supported,
                                                 resolve_device)
    from cudapathtracer_tpu_torch.scene.bvh import bvh_stats
    from cudapathtracer_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    if args.integrator:
        cfg = dataclasses.replace(cfg, integrator=args.integrator)
    if args.width:
        cfg = dataclasses.replace(cfg, width=args.width)
    if args.height:
        cfg = dataclasses.replace(cfg, height=args.height)
    if args.samples_per_dispatch:
        cfg = dataclasses.replace(
            cfg, samples_per_dispatch=args.samples_per_dispatch)
    check_supported(cfg.normalized())
    device = resolve_device(args.device)

    for rn in range(args.renders):
        print(f'Began render number {rn}: "{cfg.name}" on {device}')
        r = Renderer(cfg, device=device, render_number=rn)
        st = bvh_stats(r.bvh)
        print(f"  {r.mesh.num_triangles} triangles, {r.mesh.num_lights} "
              "lights; "
              f"BVH: {st['num_nodes']} nodes, {st['num_leaves']} leaves, "
              f"depth mean {st['depth_mean']:.1f} / max {st['depth_max']}")
        if r.device_mesh is not None:
            print(f"  mesh: {r.device_mesh.describe()}")
        r.render(num_samples=args.samples, checkpoint_path=args.checkpoint,
                 progressive=not args.no_progressive)
        r.save_final(rn)
        print(f"  saved {cfg.output_dir}/{cfg.name}{rn}.bmp")
        print(r.metrics.summary())
        print(f"  {r.checks.summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
