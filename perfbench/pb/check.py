"""The comparison that decides `correct`: the program's answers against
the plain reference's, number by number, each against its limit.

The answers are dispatches of the window: a dispatch's radiance summed
over its samples, its ray count and, for VCM, the photons the merge cap
left out. A sample of them, drawn from the seed out of every dispatch of
the window, is recomputed by the reference after the window.

  px_off       the share of a frame's pixels where a channel differs from
               the reference's by more than RTOL of the reference's value
               plus ATOL of the frame's mean (worst checked dispatch)
  rays_rel     |rays - reference rays| / reference rays (worst)
  dropped_rel  the same for the merge-cap dropped photons (VCM)
  nonfinite    NaN, Inf or negative values in the accumulated frame
"""

from __future__ import annotations

import torch

RTOL = 1e-5
ATOL = 1e-5


def px_off(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of pixels [P, 3] off the reference (a non-finite one is off)."""
    prog, ref = prog.double(), ref.double()
    tol = RTOL * ref.abs() + ATOL * ref.abs().mean()
    bad = ((prog - ref).abs() > tol).any(dim=1)
    bad |= ~torch.isfinite(prog).all(dim=1)
    return float(bad.double().mean())


def rel(value: int, ref: int) -> float:
    return abs(int(value) - int(ref)) / max(abs(int(ref)), 1)


def nonfinite(accum: torch.Tensor) -> int:
    return int((~torch.isfinite(accum)).sum()) + int((accum < 0).sum())


def compare(answers: list, refs: list) -> dict:
    """answers, refs: [(radiance, rays, dropped or None)] of the same
    dispatches -> {number: worst value}."""
    out = {"px_off": 0.0, "rays_rel": 0.0}
    for (li, rays, dropped), (rli, rrays, rdropped) in zip(answers, refs):
        out["px_off"] = max(out["px_off"], px_off(li, rli.to(li.device)))
        out["rays_rel"] = max(out["rays_rel"], rel(rays, rrays))
        if rdropped is not None:
            out["dropped_rel"] = max(out.get("dropped_rel", 0.0),
                                     rel(-1 if dropped is None else dropped,
                                         rdropped))
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: [value, limit]}, failed names). A number above its
    limit, a limit with no number, or a number with no limit fails."""
    table, failed = {}, []
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        table[name] = [v, lim]
        if v is None or lim is None or not v <= lim:
            failed.append(name)
    return not failed, table, failed
