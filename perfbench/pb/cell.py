"""One run of one cell: set-up, the measured window, the check, the line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (counted in setup_s, from the process's start to the first timed
dispatch): imports, the card, the inputs, the program's Renderer (its
kernels built or loaded from build/torch_ext/ of the checkout) and one
warm-up dispatch of the cell's own shape. The window then queues
dispatches of the resolved samples as the driver's Renderer.render does
(accum += radiance, the ray and dropped totals summed as int64 on the
card), at most IN_FLIGHT of them unfinished, for --seconds, and ends in
one synchronize. Nothing reads the frame back inside it. With --trace 1
torch.profiler records the window and the benchmark's spans around each
call into the program; the per-layer metrics are read from it.

After the window: the peak memory is read, the checked dispatch's answer
is kept and the program is freed; the plain reference recomputes that
dispatch on the card, and each compared number is printed beside its
limit on standard error and in the result's last key. The result is the
last line of standard output.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from pb import check, inputs, program, spec, trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "cudapathtracer_tpu")

# The program's switches read from the environment (its merge estimator,
# its mega engines' shape, its host-side checks). The configurations state
# the defaults and the reference holds them fixed, so a run with any of
# them set measures another program and is refused.
PROGRAM_SWITCHES = ("TPT_MERGE_REWEIGHT", "TPT_GRID_ONE_BRICK",
                    "TPT_MEGA_LIGHT", "TPT_MEGA_WIDTH",
                    "CUDAPATHTRACER_TPU_CHECKS")

# Dispatches of a run held to the reference, drawn from the seed out of
# all the window's: the plain reference takes 18-56 s for one.
CHECKED = 1

# Dispatches queued and unfinished at most. Renderer.render queues with no
# bound; then the launch queue fills, the closing synchronize drains 1.6-4
# s of work past --seconds and the host's time in render_batch becomes the
# wait for the queue (15.9 ms a 1080p dispatch against 0.7 ms). Depth 1
# loses 2-2.7%; 2-4 read as unbounded within 0.15% (PERF.md section 2).
IN_FLIGHT = 3


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the reference, its radiance rounded to "
                         "bfloat16, in the program's place (the precision "
                         "control; not part of a benchmark run)")
    return ap.parse_args(argv)


def refuse_switches() -> None:
    found = sorted(k for k in PROGRAM_SWITCHES if k in os.environ)
    if found:
        raise SystemExit(f"perfbench: the program's switches {found} are "
                         "set; the configurations state their defaults")


def require_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("perfbench: torch.cuda.is_available() is False: "
                         "no card, no result")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"perfbench: the cell needs {chips} cards, "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}")


class Control:
    """The reference in the program's place, each sample's radiance rounded
    to bfloat16: render_batch(s0, k) -> (radiance, rays, dropped) as the
    program's, the counts 0-d int64 tensors."""

    def __init__(self, ref):
        self.ref = ref

    def render_batch(self, s0: int, k: int):
        import torch
        li, rays, dropped, _ = self.ref.dispatch(s0, k, round_bf16=True)
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=li.device)
        return ((li, t(rays)) if dropped is None
                else (li, t(rays), t(dropped)))


def window(r, k: int, seconds: float, seed: int, pixels: int, device,
           traced: bool, min_dispatches: int = 0) -> dict:
    """The measured loop, as Renderer.render drives the program: each
    dispatch queued while at most IN_FLIGHT are unfinished, nothing read
    back, one synchronize at the end. -> the window's counts, times and
    the checked dispatch's answer (a reservoir sample drawn from the seed
    out of all the window's dispatches)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    span = ((lambda n: torch.profiler.record_function(n)) if traced
            else (lambda n: contextlib.nullcontext()))
    draw = np.random.default_rng(seed % (1 << 64))
    zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
    accum = torch.zeros((pixels, 3), dtype=torch.float32, device=device)
    rtot, dtot = zero(), zero()
    pending = collections.deque()
    kept, enqueue = [], []
    n = s = 0
    t0 = time.perf_counter()
    stop = t0 + seconds
    while time.perf_counter() < stop or n < min_dispatches:
        if len(pending) >= IN_FLIGHT:
            with span("wait_in_flight"):
                pending.popleft().synchronize()
        with span("render_batch"):
            ta = time.perf_counter()
            out = r.render_batch(s, k)
            enqueue.append(time.perf_counter() - ta)
        with span("accumulate"):
            accum += out[0]
            rtot = rtot + out[1]
            if len(out) > 2:
                dtot = dtot + out[2]
            if cuda:
                pending.append(torch.cuda.Event())
                pending[-1].record()
        answer = (n, s, out)
        if len(kept) < CHECKED:
            kept.append(answer)
        else:
            j = int(draw.integers(0, n + 1))
            if j < CHECKED:
                kept[j] = answer
        del out, answer
        s += k
        n += 1
    queued = time.perf_counter() - t0
    with span("window_end"):
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return dict(accum=accum, rays=int(rtot), dropped=int(dtot),
                dispatches=n, seconds=secs, queued_s=queued,
                enqueue_s=enqueue, kept=sorted(kept, key=lambda a: a[0]))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import torch
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def run(workload: str, seed: int, seconds: float, trace: bool = False,
        control: bool = False, device: str = "cuda", t_start: float = None,
        traffic_override: dict | None = None, log=sys.stderr) -> dict:
    """One run of a cell -> the result line's object. device="cpu" (the
    tests) runs the program's plain versions and reports no device
    metric."""
    t_start = time.perf_counter() if t_start is None else t_start
    refuse_switches()
    import torch
    from reference.render import Reference
    marks = [("imports", time.perf_counter())]

    bench = spec.load_benchmark()
    cell, cfg, traffic = spec.cell(bench, workload)
    traffic = {**traffic, **(traffic_override or {})}
    text = inputs.settings_text(cfg, traffic, seed)
    mesh, mats, atlas = inputs.scene_inputs(cfg)
    marks.append(("inputs", time.perf_counter()))
    if control:
        r = Control(Reference(text, mesh, mats, atlas, device))
        k = inputs.samples_per_dispatch(r.ref.cfg, device)
        phases = {}
    else:
        r = program.renderer(text, mesh, mats, atlas, device)
        k = program.samples_per_dispatch(r)
        phases = r.metrics.phases
    marks.append(("renderer", time.perf_counter()))
    pixels = traffic["width"] * traffic["height"]
    warm = r.render_batch(0, k)                       # the cell's shape
    del warm
    if device != "cpu":
        torch.cuda.synchronize()
    before = program.launches()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", t_start + setup_s))

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    w = window(r, k, seconds, seed, pixels, device, trace,
               min_dispatches=CHECKED if control else 0)
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = {name: v - before.get(name, 0)
                for name, v in program.launches().items()}
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    bad_values = check.nonfinite(w["accum"])
    answers = [(out[0].cpu(), int(out[1]),
                int(out[2]) if len(out) > 2 else None)
               for _, _, out in w["kept"]]
    checked = [(s0, k) for _, s0, _ in w["kept"]]
    del r, w["kept"], w["accum"]
    if device != "cpu":
        torch.cuda.empty_cache()

    ref = Reference(text, mesh, mats, atlas, device)
    refs, stage = [], {}
    t_ref = time.perf_counter()
    for s0, kk in checked:
        li, rays, dropped, st = ref.dispatch(s0, kk)
        refs.append((li.cpu(), rays, dropped))
        for name, v in st.items():
            stage[name] = stage.get(name, 0) + v
        del li
    t_ref = time.perf_counter() - t_ref
    del ref
    samples_checked = sum(kk for _, kk in checked)
    numbers = check.compare(answers, refs)
    numbers["nonfinite"] = bad_values
    correct, table, failed = check.judge(numbers, cfg["limits"])

    samples = w["dispatches"] * k
    q = {"dispatches": w["dispatches"], "pixel_samples": samples * pixels,
         "rays": w["rays"]}
    for name, v in stage.items():   # the reference's counts a sample
        if name != "rays":
            q[name] = v / max(samples_checked, 1) * samples
    ctx = dict(cell=cell, config=cfg, traffic=traffic, k=k, pixels=pixels,
               samples=samples, window_s=w["seconds"], q=q,
               enqueue_s=w["enqueue_s"], launches=launches,
               phases=dict(phases), trace=None)
    result = {"correct": bool(correct), "attempted": w["dispatches"],
              "failed": len(answers) if not correct else 0}
    device_info = {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if device != "cpu" else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    if prof is not None:
        summ = tr.summarize(tr.device_events(prof), tr.host_spans(prof))
        ctx["trace"] = summ
        device_info.update(busy_s=summ["busy_s"], window_s=w["seconds"])
        result["breakdown"] = {"device_ops": summ["device_ops"],
                               "idle_gaps": summ["idle_gaps"]}
        where = os.environ.get("TMPDIR") or tempfile.gettempdir()
        path = tr.save_chrome(prof, os.path.join(where, "perfbench"),
                              f"{workload}_{seed}")
        print(f"perfbench: chrome trace {path}", file=log)

    metrics = {}
    if trace:
        for m in spec.metrics_of(bench, workload, trace=True):
            value = spec.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s,
               "msamples_per_s": samples * pixels / w["seconds"] / 1e6}
        for m in spec.metrics_of(bench, workload, trace=False):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=device_info)

    print(f"perfbench: {workload} seed {seed}: {w['dispatches']} dispatches"
          f" of {k} samples of {pixels} pixels in {w['seconds']:.4f} s;"
          f" set-up {setup_s:.4f} s; reference {t_ref:.3f} s over"
          f" {samples_checked} samples; peak memory {peak} bytes", file=log)
    print("perfbench: set-up by stage: " + ", ".join(
        f"{name} {t - t0:.4f} s" for (name, t), t0 in
        zip(marks, [t_start] + [t for _, t in marks[:-1]])), file=log)
    enq = w["enqueue_s"]
    print(f"perfbench: queued for {w['queued_s']:.4f} s, drained in"
          f" {w['seconds'] - w['queued_s']:.4f} s; host in render_batch"
          f" {sum(enq) / len(enq) * 1e3:.4f} ms a dispatch", file=log)
    if len(answers[0]) > 2 and answers[0][2] is not None:
        print(f"perfbench: merge-cap dropped {w['dropped']} over {samples}"
              f" samples: {w['dropped'] / max(samples, 1):.1f} a sample,"
              f" {stage.get('eye_records', 0) / max(samples_checked, 1):.1f}"
              " eye records a sample", file=log)
    if device != "cpu":
        print(f"perfbench: card {card_line()}", file=log)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"perfbench: forbidden modules loaded: {found}")
    for name, (v, lim) in table.items():
        print(f"check {name} {v} limit {lim}", file=log)
    result["checks"] = table
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    cell, _, _ = spec.cell(bench, args.workload)
    require_card(int(cell["chips"]))
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 args.control, "cuda", t_start)
    print(json.dumps(result))
    return 0
