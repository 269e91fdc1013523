"""The plain reference against the program's plain path at 16x12 on the
CPU, for both integrators; its batched pass; the precision control."""

import pytest
import torch

from pb import check, inputs, program, spec
from reference.render import Reference

TINY = dict(width=16, height=12, samples_per_dispatch=1)


def _pair(config, seed):
    cfg = spec.config(config)
    text = inputs.settings_text(cfg, TINY, seed)
    mesh, mats, atlas = inputs.scene_inputs(cfg)
    return (program.renderer(text, mesh, mats, atlas, "cpu"),
            Reference(text, mesh, mats, atlas, "cpu"))


@pytest.mark.parametrize("config,dispatches", [
    ("cornell-bunny-uni", ((0, 1), (5, 2))),
    ("cornell-bunny-vcm-upstream", ((3, 1),))])
def test_reference_matches_the_program_plain_path(config, dispatches):
    r, ref = _pair(config, 2 ** 31 + 3)
    for s0, k in dispatches:
        out = r.render_batch(s0, k)
        li, rays, dropped, _ = ref.dispatch(s0, k)
        assert torch.equal(out[0], li)
        assert int(out[1]) == rays
        if len(out) > 2:
            assert int(out[2]) == dropped


def test_batched_pass_equals_single_samples():
    _, ref = _pair("cornell-bunny-uni", 7)
    acc, rays = torch.zeros(16 * 12, 3), 0
    for s in range(3, 6):
        li, r, _, _ = ref.sample(s)
        acc, rays = acc + li, rays + r
    li, r, _, _ = ref.dispatch(3, 3)
    assert torch.equal(li, acc) and r == rays


@pytest.mark.parametrize("config", ["cornell-bunny-uni",
                                    "cornell-bunny-vcm-upstream"])
def test_precision_control_fails_the_check(config):
    """The reference with each sample's radiance rounded to bfloat16, in
    the program's place, reads px_off far above the limit."""
    _, ref = _pair(config, 11)
    good = ref.dispatch(2, 1)
    ctrl = ref.dispatch(2, 1, round_bf16=True)
    numbers = check.compare([(ctrl[0], ctrl[1], ctrl[2])],
                            [(good[0], good[1], good[2])])
    numbers["nonfinite"] = 0
    ok, table, failed = check.judge(numbers, spec.config(config)["limits"])
    assert not ok and failed == ["px_off"]
    assert table["px_off"][0] > 100 * table["px_off"][1]
