"""First-class render metrics: phase timers + ray counters.

Formalizes the reference's ad-hoc chrono prints (main.cu:511-513, 542-544,
910-920) into a metrics object that also reports Mrays/s and spp/s — the
BASELINE.md headline numbers the reference never recorded.

The port's own copy of cudapathtracer_tpu/utils/metrics.py.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class RenderMetrics:
    phases: dict = field(default_factory=dict)    # name -> seconds
    rays_traced: int = 0
    samples_done: int = 0
    pixels: int = 0
    # photons truncated by the VCM merge's static max_per_cell cap (upper
    # bound on in-range photons dropped); None = integrator doesn't count
    merge_dropped: int | None = None

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - t0)

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
        return "\n".join(lines)
