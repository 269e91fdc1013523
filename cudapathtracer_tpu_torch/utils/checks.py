"""Staged numerical health checks: per-stage NaN/Inf/negative scans of the
arrays a stage produced, and an end-of-render report.

The port's own copy of cudapathtracer_tpu/utils/checks.py (the
reference's checkCudaErrors analogue). The switch is read under the JAX
package's name, CUDAPATHTRACER_TPU_CHECKS=1, or set with
`enable_checks(True)`. A check scans the tensors where they lie
(torch.isnan / torch.isinf on the card for CUDA tensors) and fetches its
three counts in one transfer: that is the only host sync the checks add,
and only while they are on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

_ENABLED = os.environ.get("CUDAPATHTRACER_TPU_CHECKS", "0") not in ("0", "")


def enable_checks(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def checks_enabled() -> bool:
    return _ENABLED


@dataclass
class StageReport:
    stage: str
    nan: int
    inf: int
    negative: int

    @property
    def ok(self) -> bool:
        return self.nan == 0 and self.inf == 0


def _counts(a) -> torch.Tensor:
    """[nan, inf, negative] counts of one array (tensor or numpy), as an
    int64 tensor on the array's device."""
    t = torch.as_tensor(a)
    neg = (t < 0).sum() if t.is_floating_point() else t.new_zeros(
        (), dtype=torch.int64)
    return torch.stack([torch.isnan(t).sum(), torch.isinf(t).sum(), neg])


@dataclass
class CheckLog:
    """Accumulates per-stage reports; `raise_on_error` mirrors the hard
    failure the reference's sync+error-string produces."""
    reports: list = field(default_factory=list)

    def check(self, stage: str, *arrays, allow_negative: bool = True,
              raise_on_error: bool = False):
        if not _ENABLED:
            return None
        nan = inf = neg = 0
        for a in arrays:
            c = _counts(a).tolist()
            nan, inf, neg = nan + c[0], inf + c[1], neg + c[2]
        rep = StageReport(stage, nan, inf, neg if not allow_negative else 0)
        self.reports.append(rep)
        if raise_on_error and not rep.ok:
            raise FloatingPointError(
                f"stage {stage!r}: {rep.nan} NaN, {rep.inf} Inf values")
        return rep

    def summary(self) -> str:
        if not self.reports:
            return "checks disabled (set CUDAPATHTRACER_TPU_CHECKS=1)"
        bad = [r for r in self.reports if not r.ok]
        if not bad:
            return (f"render executed with no numerical errors "
                    f"({len(self.reports)} stages checked)")
        return "\n".join(f"STAGE ERROR {r.stage}: nan={r.nan} inf={r.inf}"
                         for r in bad)
