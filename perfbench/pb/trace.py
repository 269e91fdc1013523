"""What a traced window did on the device, from torch.profiler's events.

The arithmetic of tools/profile_torch_classic.py, copied, with two
repairs: the device-side copies of the benchmark's spans are not device
work, and the busy time is the union of the operations' intervals. A
kernel's device time is the sum of its events' durations.
Beside it: the longest idle gaps between device events, each named by
the benchmark's span the host was inside when the gap began.
"""

from __future__ import annotations

import bisect
import gzip
import os
import shutil

SPANS = ("render_batch", "accumulate", "wait_in_flight", "window_end")


def device_events(prof) -> list:
    """[(name, start_us, end_us)] of every device operation, by start: the
    profiler's device events less the device-side copies of the
    benchmark's own spans, each operation once."""
    import torch
    out = set()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in SPANS):
            out.add((e.name, e.time_range.start, e.time_range.end))
    return sorted(out, key=lambda x: x[1])


def host_spans(prof) -> list:
    """[(start_us, end_us, name)] of the benchmark's own spans, by start."""
    out = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.name in SPANS]
    return sorted(out)


def summarize(dev: list, spans: list, top: int = 10) -> dict:
    """Device seconds by kernel name, busy seconds, and the top device
    operations and idle gaps (the breakdown of a result line)."""
    by_name = {}
    for name, t0, t1 in dev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
    busy, end = 0.0, None      # the union of the operations' intervals
    for _, t0, t1 in dev:
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    busy /= 1e6
    starts = [s[0] for s in spans]
    gaps = []
    end = None
    for name, t0, t1 in dev:
        if end is not None and t0 > end:
            i = bisect.bisect_right(starts, end) - 1
            label = "host"
            while i >= 0:
                if spans[i][1] >= end:
                    label = spans[i][2]
                    break
                i -= 1
            gaps.append((label, (t0 - end) / 1e6))
        end = t1 if end is None else max(end, t1)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    return {"kernel_s": by_name, "busy_s": busy,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def device_seconds(kernel_s: dict, substrings) -> float:
    """Device seconds of the kernels whose names hold any substring."""
    return sum(s for n, s in kernel_s.items()
               if any(k in n for k in substrings))


def save_chrome(prof, directory: str, stem: str) -> str:
    """The Chrome trace, gzipped, under directory -> its path."""
    os.makedirs(directory, exist_ok=True)
    raw = os.path.join(directory, f"{stem}.json")
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(raw)
    return raw + ".gz"
