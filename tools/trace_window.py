#!/usr/bin/env python3
"""The program's tracing in a benchmark cell's window, on and off in turns.

For each cell of BENCHMARK.json named, the cell's inputs as perfbench/
makes them (its configuration, traffic and seed) drive two of the
benchmark's Renderers (perfbench/pb/program.py), one with the program's
tracing off and one with it on. In each turn each renders the benchmark's
window (perfbench/pb/cell.window) of --seconds under torch.profiler, and
the harness's perfbench/pb/trace.py reads it. Only the split of the
program's `tpt.` events is this tool's own. Printed and written as JSON:

* each counted kernel's device milliseconds a dispatch (the cell's
  configuration's `counted` kernels, found by perfbench/counts/*.py's
  KERNELS substrings), on and off: what the counters cost when on;
* with tracing on, the program's spans: self milliseconds a dispatch of
  the driver, the step (its stages included) and the kernel entries
  (RenderMetrics.layer_ms), their sum against the mean
  tpt.driver.render_batch span, and the device counters' ratios (rows a
  ray, lane use) over the window, reset after the warm-up;
* the profiler's view: how many device events carry a `tpt.` name (the
  device-side copies of the spans' record_function ranges, left out of
  every device time here) and the longest idle gaps between device
  operations, each named by the innermost program span the host was in
  when the gap began (or the benchmark's span, outside the program).

Run from the repository root on a card:

    python3 tools/trace_window.py [--cells NAME ...] [--seconds 3]
        [--turns 2] [--seed N] [--out FILE.json] [--chrome DIR]

--chrome saves each traced window's Chrome trace (gzipped) under DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "perfbench")]

from pb import cell as bench_cell, inputs, program, spec  # noqa: E402
from pb import trace as tr  # noqa: E402

PREFIX = "tpt."


def renderer(cell: str, seed: int, trace: bool):
    """The benchmark's Renderer over the cell's inputs, with the program's
    tracing as asked -> (it, samples a dispatch, the configuration, the
    pixels)."""
    _, cfg, traffic = spec.cell(spec.load_benchmark(), cell)
    mesh, mats, atlas = inputs.scene_inputs(cfg)
    r = program.renderer(inputs.settings_text(cfg, traffic, seed), mesh,
                         mats, atlas, "cuda")
    r.metrics.trace = trace
    return (r, program.samples_per_dispatch(r), cfg,
            traffic["width"] * traffic["height"])


def split_events(prof) -> tuple:
    """The profiler's events -> (pb/trace.device_events less the
    device-side copies of the program's spans; the program's spans on the
    host with the benchmark's own (pb/trace.host_spans), by start; the
    number of those device-side copies)."""
    import torch
    dev = tr.device_events(prof)
    ops = [d for d in dev if not d[0].startswith(PREFIX)]
    spans = sorted(tr.host_spans(prof) + [
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.name.startswith(PREFIX)
        and e.device_type != torch.autograd.DeviceType.CUDA])
    return ops, spans, len(dev) - len(ops)


def measure(r, k: int, pixels: int, seconds: float, seed: int,
            counted: list, chrome: str | None, stem: str) -> dict:
    """One profiled window of the Renderer r after a warm-up dispatch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cudapathtracer_tpu_torch.utils import metrics
    r.render_batch(0, k)
    torch.cuda.synchronize()
    r.metrics.reset_trace()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w = bench_cell.window(r, k, seconds, seed, pixels, "cuda", True)
    n = w["dispatches"]
    dev, spans, copies = split_events(prof)
    summ = tr.summarize(dev, spans)
    res = {"dispatches": n, "window_s": w["seconds"],
           "msamples_per_s": n * k * pixels / w["seconds"] / 1e6,
           "counted_ms_a_dispatch": {
               name: tr.device_seconds(summ["kernel_s"],
                                       spec.counts(name).KERNELS) / n * 1e3
               for name in counted},
           "span_copies_on_device": copies}
    if r.metrics.trace:
        m = r.metrics
        batch = m.span_totals.get("tpt.driver.render_batch", [0, 0.0, 0.0])
        layers = m.layer_ms()
        res.update(
            layer_ms=layers,
            render_batch_ms=batch[1] / max(batch[0], 1) * 1e3,
            layers_over_render_batch=(sum(layers.values())
                                      / (batch[1] / batch[0] * 1e3)
                                      if batch[0] else None),
            ratios=metrics.ratios(m.counter_totals()),
            counters=m.counter_totals(),
            idle_gaps_s=summ["idle_gaps"],
            span_self_ms={name: t[2] / n * 1e3
                          for name, t in sorted(m.span_totals.items())})
        if chrome:
            tr.save_chrome(prof, chrome, stem)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=[
        "uni-bunny-1080p", "vcm-upstream-800", "uni-bunny-512-spd8"])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 4321)
    ap.add_argument("--out", default=None)
    ap.add_argument("--chrome", default=None)
    args = ap.parse_args(argv)
    import torch
    out = {"card": torch.cuda.get_device_name(0), "cells": {}}
    for cell in args.cells:
        runs = {False: [], True: []}
        rs = {t: renderer(cell, args.seed, t) for t in (False, True)}
        for turn in range(args.turns):
            for trace in (False, True):
                r, k, cfg, pixels = rs[trace]
                res = measure(r, k, pixels, args.seconds, args.seed,
                              cfg["counted"],
                              args.chrome if turn == 0 else None,
                              f"{cell}_{args.seed}")
                runs[trace].append(res)
                print(f"{cell} turn {turn} trace {int(trace)}: "
                      + json.dumps(res), flush=True)
        del rs
        torch.cuda.empty_cache()
        cost = {}
        for name in runs[False][0]["counted_ms_a_dispatch"]:
            off = statistics.median(x["counted_ms_a_dispatch"][name]
                                    for x in runs[False])
            on = statistics.median(x["counted_ms_a_dispatch"][name]
                                   for x in runs[True])
            cost[name] = {"off_ms": off, "on_ms": on,
                          "on_over_off": on / off if off else None}
        out["cells"][cell] = {"runs": {"off": runs[False], "on": runs[True]},
                              "cost": cost}
        print(f"{cell}: counted kernels, ms a dispatch, tracing off / on: "
              + json.dumps(cost), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
