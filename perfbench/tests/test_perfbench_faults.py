"""A run with the timed path broken underneath comes out not correct;
the same run unbroken comes out correct. The harness's look for a card is
skipped (device="cpu") and everything else of a run is driven: set-up,
the window, the checked dispatch drawn from the seed, the reference.

The faults a cell of this benchmark can have (one-chip cells: no exchange
between chips):
  unchanged  a dispatch returns its state unchanged: no radiance added;
  half       half of the frame's pixels left out, the mean taken over the
             rest (the other half doubled);
  altered    an answer altered where it is produced: a block of 1% of the
             pixels 50% too bright."""

import pytest
import torch

from cudapathtracer_tpu_torch.driver import Renderer
from pb import cell

TINY = dict(width=16, height=12)


def _broken(kind):
    real = Renderer.render_batch

    def render_batch(self, s0, k):
        out = list(real(self, s0, k))
        li = out[0].clone()
        p = li.shape[0]
        if kind == "unchanged":
            li.zero_()
        elif kind == "half":
            li[: p // 2] = 0.0
            li[p // 2:] *= 2.0
        elif kind == "altered":
            li[: max(1, p // 100)] *= 1.5
        out[0] = li
        return tuple(out)
    return render_batch


def _run(workload, seed):
    return cell.run(workload, seed, 0.01, device="cpu",
                    traffic_override=TINY)


def test_sound_run_is_correct():
    res = _run("uni-bunny-1080p", 2 ** 31 + 21)
    assert res["correct"] and res["failed"] == 0
    assert set(res["checks"]) == {"px_off", "rays_rel", "nonfinite"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, kind):
    monkeypatch.setattr(Renderer, "render_batch", _broken(kind))
    res = _run("uni-bunny-1080p", 2 ** 31 + 22)
    assert not res["correct"]
    assert res["checks"]["px_off"][0] > res["checks"]["px_off"][1]


def test_broken_vcm_is_not_correct(monkeypatch):
    monkeypatch.setattr(Renderer, "render_batch", _broken("altered"))
    assert not _run("vcm-upstream-800", 2 ** 31 + 23)["correct"]


def test_nan_in_the_frame_is_not_correct(monkeypatch):
    real = Renderer.render_batch

    def render_batch(self, s0, k):
        out = list(real(self, s0, k))
        out[0] = out[0].clone()
        out[0][0, 0] = torch.nan
        return tuple(out)
    monkeypatch.setattr(Renderer, "render_batch", render_batch)
    res = _run("uni-bunny-1080p", 2 ** 31 + 24)
    assert not res["correct"] and res["checks"]["nonfinite"][0] >= 1
