"""First-class render metrics: phase timers + ray counters, and the
program's tracing.

Formalizes the reference's ad-hoc chrono prints (main.cu:511-513, 542-544,
910-920) into a metrics object that also reports Mrays/s and spp/s — the
BASELINE.md headline numbers the reference never recorded.

Started as the port's own copy of cudapathtracer_tpu/utils/metrics.py;
the tracing below is the port's alone. It is off by default and switched
on by RenderMetrics(trace=True) (driver.Renderer's trace argument):

* Spans. `phase(name)` times a phase into `phases` as before and, when
  tracing, is also the span `tpt.<name>`; `span(name, ident)` is a span
  only. A span opens a torch.profiler.record_function range of its name,
  so a profiler window shows the program's spans on the clock of its
  device events; every span name starts with `tpt.` (SPAN_PREFIX). Each
  span records its parent (the span open around it in its thread, or for
  the first span of a mesh rank's thread the span open where the ranks
  were started) and an identifier, the first sample index of its
  dispatch, inherited from its parent. The levels:
  `tpt.driver.render_batch` (Renderer.render_batch, the body of
  Renderer.render's loop), `tpt.step.<model>` (the model's sample or batch
  function), `tpt.step.<model>.<stage>` (a multi-launch integrator's
  stages, e.g. tpt.step.vcm.light_walk), `tpt.kernel.<entry>` (a public
  entry of the kernel library, from entry to return: its checks,
  allocations, argument packing and launch).
  Code without the RenderMetrics at hand opens a span with the module's
  `span(name)`: a no-op (one attribute test) unless a tracing
  RenderMetrics has a span open in the calling thread. Spans of a mesh's
  rank threads carry the rank (handoff / adopted).
* Device counters (COUNTERS): int64 buffers on the card that the hot
  kernels add into when given one (kernels/__init__.py asks `counter()`
  for them while a tracing span is open), accumulated across dispatches
  with no host sync, and read once by counter_totals(). RATIOS derives
  rows a ray, the share of a warp's lanes that work, and the share of
  the connections' slots queued and of the queued pairs that trace.

* Host counters: a counter of what the host knows before it launches is
  kept as an int64 tensor on the CPU beside the device ones and added to
  by count(): mesh.bytes, the bytes a mesh's collectives move and its
  ranks hand to the first device (parallel/sharding.py).
* A mesh (driver.Renderer with a `Mesh Shape` above 1 1) adds two phases,
  timed whether or not it traces: mesh_build, the seconds the Renderer's
  thread waited for the mesh's rank threads after its scene build (the
  span tpt.mesh.build), and mesh_wait, the host seconds the rank threads
  waited at their collectives' barriers, summed over the ranks (each wait the span
  tpt.mesh.<collective>).

With tracing off nothing is recorded and no kernel is given a counter.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

SPAN_PREFIX = "tpt."
SPAN_RECORDS = 1 << 16   # spans kept, the newest; span_totals keeps all

# device counters: name -> the words of its int64 buffer (each word summed
# over the launches that were given the buffer)
COUNTERS = {
    # K5 (uni_mega.cu): BVH rows visited and rays traced by its paths (its
    # per-pixel rows and rays outputs, summed on the card)
    "k5.tally": ("rows", "rays"),
    # K5's, K12's light walk's and the VCM eye walk's lane counters
    # (persistent.cuh add_lane_counts): events stepped, the sum over warps
    # of the warp's busiest lane's events, the warps' calls of the event
    # code (an eye walk's event is a bounce)
    "k5.lanes": ("events", "busiest", "calls"),
    "k12.lanes": ("events", "busiest", "calls"),
    "eye_walk.lanes": ("events", "busiest", "calls"),
    # the VCM eye passes' walk and connection stages (eye.cuh): rows and
    # rays of the stage; the warps' calls of the connection's shadow ray
    # (the lanes that trace it together count once), the pairs its queue
    # held and the (eye depth, light row, path) slots of its launches
    "eye_walk.tally": ("rows", "rays"),
    "eye_connect.tally": ("rows", "rays", "calls", "queued", "slots"),
    # a mesh (parallel/sharding.py): the bytes each collective brought its
    # rank and the bytes each rank but the first handed to the first (its
    # radiance and counts), summed over the ranks (a host counter)
    "mesh.bytes": ("all_gather", "all_reduce", "to_first"),
}
# ratio -> (counter, numerator word, denominator word, denominator scale)
RATIOS = {
    "k5.rows_per_ray": ("k5.tally", "rows", "rays", 1),
    "k5.lane_use": ("k5.lanes", "events", "calls", 32),
    "k12.lane_use": ("k12.lanes", "events", "calls", 32),
    "eye_walk.rows_per_ray": ("eye_walk.tally", "rows", "rays", 1),
    "eye_walk.lane_use": ("eye_walk.lanes", "events", "calls", 32),
    "eye_walk.event_balance": ("eye_walk.lanes", "events", "busiest", 32),
    "eye_connect.rows_per_ray": ("eye_connect.tally", "rows", "rays", 1),
    "eye_connect.lane_use": ("eye_connect.tally", "rays", "calls", 32),
    "eye_connect.queue_share": ("eye_connect.tally", "queued", "slots", 1),
    "eye_connect.trace_share": ("eye_connect.tally", "rays", "queued", 1),
}
# the layers a dispatch's spans fall into, by name prefix (self times)
LAYERS = (("driver", "tpt.driver."), ("step", "tpt.step."),
          ("kernels", "tpt.kernel."))


class Span(NamedTuple):
    """One closed span. Times are time.perf_counter() seconds; self_s is
    its duration less the durations of the spans directly inside it in
    its thread."""
    sid: int
    parent: int          # sid of the span around it, -1 at the root
    name: str
    ident: int | None    # the first sample index of its dispatch
    rank: int | None     # the mesh rank whose thread opened it
    start: float
    end: float
    self_s: float


class _Here(threading.local):
    """A thread's tracing state: the RenderMetrics with a span open in it
    (None: not tracing), its open spans, and what a rank thread adopted."""
    metrics = None
    parent = -1
    ident = None
    rank = None

    def __init__(self):
        self.stack = []


_here = _Here()
_sids = itertools.count()
_NULL = contextlib.nullcontext()


class _Open:
    """An open span (RenderMetrics.span's context manager)."""
    __slots__ = ("m", "name", "ident", "sid", "parent", "prev", "rf", "t0",
                 "child")

    def __init__(self, m, name: str, ident):
        self.m, self.name, self.ident = m, name, ident

    def __enter__(self):
        from torch.autograd.profiler import record_function
        h = _here
        top = h.stack[-1] if h.stack else None
        self.parent = top.sid if top is not None else h.parent
        if self.ident is None:
            self.ident = top.ident if top is not None else h.ident
        self.sid = next(_sids)
        self.prev, h.metrics = h.metrics, self.m
        h.stack.append(self)
        self.child = 0.0
        self.rf = record_function(
            self.name, None if h.rank is None else f"rank {h.rank}")
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        h = _here
        h.stack.pop()
        h.metrics = self.prev
        dur = t1 - self.t0
        if h.stack:
            h.stack[-1].child += dur
        self.m._record(Span(self.sid, self.parent, self.name, self.ident,
                            h.rank, self.t0, t1, dur - self.child))
        return False


def span(name: str, ident: int | None = None):
    """The span `name` under the RenderMetrics tracing in this thread, or
    a no-op where none is."""
    m = _here.metrics
    return _NULL if m is None else _Open(m, name, ident)


def counter(name: str, device):
    """The tracing RenderMetrics' counter `name` on `device`, or None where
    this thread is not tracing."""
    m = _here.metrics
    return None if m is None else m.counter(name, device)


def count(name: str, word: str, n: int) -> None:
    """Add n to `word` of the host counter `name` of the RenderMetrics
    tracing in this thread; a no-op where none is."""
    m = _here.metrics
    if m is not None:
        t = m.counter(name, "cpu")
        with m._lock:
            t[COUNTERS[name].index(word)] += n


def handoff():
    """The calling thread's tracing state, for the threads it starts (a
    mesh's ranks; adopted), or None where it is not tracing."""
    h = _here
    if h.metrics is None:
        return None
    top = h.stack[-1] if h.stack else None
    return (h.metrics, top.sid if top is not None else h.parent,
            top.ident if top is not None else h.ident)


@contextmanager
def adopted(state, rank: int):
    """Trace in this thread under `state` (handoff's), its spans carrying
    `rank`; a no-op for None."""
    if state is None:
        yield
        return
    h = _here
    saved = h.metrics, h.parent, h.ident, h.rank
    (h.metrics, h.parent, h.ident), h.rank = state, rank
    try:
        yield
    finally:
        h.metrics, h.parent, h.ident, h.rank = saved


def ratios(totals: dict) -> dict:
    """RATIOS of counter_totals()'s totals, those whose counters ran."""
    out = {}
    for name, (c, num, den, scale) in RATIOS.items():
        t = totals.get(c)
        if t and t[den]:
            out[name] = t[num] / (scale * t[den])
    return out


@dataclass
class RenderMetrics:
    phases: dict = field(default_factory=dict)    # name -> seconds
    rays_traced: int = 0
    samples_done: int = 0
    pixels: int = 0
    # photons truncated by the VCM merge's static max_per_cell cap (upper
    # bound on in-range photons dropped); None = integrator doesn't count
    merge_dropped: int | None = None
    trace: bool = False
    # tracing: the newest closed spans, and name -> [spans, seconds, self
    # seconds] over all of them
    spans: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=SPAN_RECORDS))
    span_totals: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)  # (name, device) -> tensor
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @contextmanager
    def phase(self, name: str, span: str | None = None):
        """Time a phase into `phases`; when tracing, also the span
        tpt.<name> (or `span`)."""
        t0 = time.perf_counter()
        try:
            with self.span(span or SPAN_PREFIX + name):
                yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - t0)

    def span(self, name: str, ident: int | None = None):
        """The span `name` (prefix tpt.) when tracing, else a no-op. ident:
        the dispatch's first sample index (default: the parent's)."""
        return _Open(self, name, ident) if self.trace else _NULL

    def _record(self, s: Span) -> None:
        with self._lock:
            self.spans.append(s)
            t = self.span_totals.setdefault(s.name, [0, 0.0, 0.0])
            t[0] += 1
            t[1] += s.end - s.start
            t[2] += s.self_s

    def counter(self, name: str, device):
        """The int64 counter `name` (COUNTERS) on `device`, zeros at its
        first use; the kernels given it add into it on the card."""
        key = (name, str(device))
        t = self.counters.get(key)
        if t is None:
            import torch
            with self._lock:
                t = self.counters.get(key)
                if t is None:
                    t = torch.zeros(len(COUNTERS[name]), dtype=torch.int64,
                                    device=device)
                    self.counters[key] = t
        return t

    def counter_totals(self) -> dict:
        """{counter: {word: total over devices}} of the counters that were
        given to a kernel; reads them from the card (it waits for it)."""
        out = {}
        for (name, _), t in list(self.counters.items()):
            d = out.setdefault(name, dict.fromkeys(COUNTERS[name], 0))
            for w, v in zip(COUNTERS[name], t.tolist()):
                d[w] += v
        return out

    def reset_trace(self) -> None:
        """Zero the counters on the card (no host sync) and forget the
        spans, e.g. after a warm-up."""
        with self._lock:
            for t in self.counters.values():
                t.zero_()
            self.spans.clear()
            self.span_totals.clear()

    def layer_ms(self) -> dict:
        """Self milliseconds a dispatch of each of LAYERS (the spans whose
        names start with its prefix) over the tpt.driver.render_batch
        spans so far."""
        n = self.span_totals.get("tpt.driver.render_batch", [0])[0]
        if not n:
            return {}
        return {layer: sum(t[2] for name, t in self.span_totals.items()
                           if name.startswith(prefix)) / n * 1e3
                for layer, prefix in LAYERS}

    def add_rays(self, n: int):
        self.rays_traced += int(n)

    @property
    def render_seconds(self) -> float:
        return self.phases.get("render", 0.0)

    @property
    def mrays_per_sec(self) -> float:
        t = self.render_seconds
        return (self.rays_traced / t / 1e6) if t > 0 else 0.0

    @property
    def spp_per_sec(self) -> float:
        t = self.render_seconds
        return (self.samples_done / t) if t > 0 else 0.0

    def summary(self) -> str:
        lines = [f"  {k}: {v:.3f}s" for k, v in self.phases.items()]
        lines.append(f"  rays traced: {self.rays_traced:,}")
        lines.append(f"  Mrays/s: {self.mrays_per_sec:.2f}")
        lines.append(f"  spp/s: {self.spp_per_sec:.3f}")
        if self.merge_dropped is not None:
            lines.append(f"  merge-cap dropped photons: "
                         f"{self.merge_dropped:,}")
        if self.trace:
            lines += self._trace_summary()
        return "\n".join(lines)

    def _trace_summary(self) -> list:
        lines = ["  spans (self time):"]
        for name, (n, secs, own) in sorted(self.span_totals.items(),
                                           key=lambda kv: -kv[1][2]):
            lines.append(f"    {name}: {n} x, {secs:.4f}s, self "
                         f"{own:.4f}s")
        layers = self.layer_ms()
        if layers:
            lines.append("  self ms a dispatch: " + ", ".join(
                f"{k} {v:.4f}" for k, v in layers.items()))
        for name, v in ratios(self.counter_totals()).items():
            lines.append(f"  {name}: {v:.4f}")
        return lines
