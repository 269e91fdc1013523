"""K13, the classic BDPT connection stage, as two stages (models/bdpt.py:
connect_pairs_plain, one weighted term per eye depth, strategy and pixel;
connect_gather_plain, the per-pixel ordered sum) on the golden setup of
tests/test_torch_bdpt.py: cornell_with_blocks, 16x16, pinhole at (0,0,1),
fov 60, base_key(), eye depth 6, light depth 4, fed the JAX package's own
eye and light buffers (sample 0).

  * The composition is connect_plain bit for bit, with the splat's frame
    buffer and without it.
  * The terms of invalid or delta eye vertices, and of pairs whose shadow
    ray was blocked, are exactly +0 (the gather's additions of them leave
    the sum unchanged).
  * The gather adds in the fused loop's order: hand-built terms whose
    float32 sum depends on the order give the sequential sum.
  * The composition matches the radiance of JAX render_sample (without
    the splat) at test_connections_match_jax's tolerance: rtol 1e-3 on at
    least 99% of the elements, the image mean within 1e-3.
  * On a card (marker cuda): kernels.bdpt_pairs against the plain pairs
    under chip_smoke.compare_image's K13 criteria (rays within 0.1%, terms
    within rtol 1e-3 on >= 99.5% of the elements) and bit-equal with
    other pairs a thread (per), and kernels.bdpt_gather
    bit-equal to the plain gather on the same hand-built terms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import bdpt as jbdpt
from cudapathtracer_tpu.models import paths as jpaths
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import bdpt, paths
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.math import (EPSILON, RAY_EPSILON, dot,
                                                 length_sq)

W = H = 16
N = W * H
CFG = bdpt.BDPTConfig(eye_depth=6, light_depth=4)
JCFG = jbdpt.BDPTConfig(eye_depth=6, light_depth=4)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    jc = JCamera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    tc = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    px, py = gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)
    jpx, jpy = jnp.asarray(px), jnp.asarray(py)
    pid = jrng.pixel_ids(jpx, jpy)
    skey = jrng.sample_key(jrng.base_key(), 0)
    jl = jpaths.generate_light_path(js, jax.random.fold_in(skey, 1), N,
                                    CFG.light_depth, ids=pid)
    je = jpaths.generate_eye_path(js, jc, jax.random.fold_in(skey, 2), jpx,
                                  jpy, CFG.eye_depth, ids=pid)
    jli, _, jrays = jbdpt.render_sample(js, jc, jrng.base_key(), 0, jpx, jpy,
                                        cfg=JCFG, splat_shape=N)
    tpx, tpy = torch.as_tensor(px), torch.as_tensor(py)
    lv0 = {k: torch.as_tensor(np.array(v)) for k, v in jl[1].items()}
    ebufs = paths.PathBuffers.from_numpy(je[0])
    lbufs = paths.PathBuffers.from_numpy(jl[0])
    ev0 = {k: torch.as_tensor(np.array(v)) for k, v in je[1].items()}
    esc = paths.Escape(*(torch.as_tensor(np.array(a)) for a in je[2]))
    _, _, key_c = bdpt.sample_keys(rng.base_key(), 0)
    ids = rng.pixel_ids(tpx, tpy)
    terms, rays = bdpt.connect_pairs_plain(ts, key_c, ebufs, lbufs, CFG, ids)
    fb, _ = bdpt.light_trace_splat(ts, tc, lbufs, lv0, CFG,
                                   torch.zeros((N, 3)))
    return dict(ts=ts, tc=tc, px=tpx, py=tpy, ids=ids, key_c=key_c,
                ebufs=ebufs, lbufs=lbufs, ev0=ev0, esc=esc, lv0=lv0,
                terms=terms, rays=rays, fb=fb, jli=np.asarray(jli),
                jrays_walks=int(jl[2]) + int(je[3]), jrays=int(jrays))


@pytest.mark.parametrize("splat", [False, True], ids=["no_splat", "splat"])
def test_composition_is_connect_plain(setup, splat):
    s = setup
    fb = s["fb"] if splat else None
    assert not splat or bool((fb > 0).any())
    li, rays = bdpt.connect_plain(s["ts"], s["tc"], s["key_c"], s["ebufs"],
                                  s["ev0"], s["esc"], s["lbufs"], s["lv0"],
                                  CFG, s["ids"], fb)
    lg = bdpt.connect_gather_plain(s["ts"], s["tc"], s["ebufs"], s["ev0"],
                                   s["esc"], s["terms"], CFG, fb)
    assert rays == s["rays"] > 0
    assert torch.equal(_bits(li), _bits(lg))


def test_terms_zero_without_a_strategy(setup):
    """Invalid or delta eye vertices and blocked pairs store exactly +0."""
    s = setup
    terms = s["terms"]
    assert terms.shape == (CFG.eye_depth - 1, CFG.light_depth, N, 3)
    zero = terms == 0.0
    assert not bool(_bits(terms)[zero].any())
    blocked_total = dead_total = 0
    for t in range(2, CFG.eye_depth + 1):
        ev = bdpt._vertex(s["ebufs"], t - 2)
        dead = ~(ev["valid"] & ~ev["is_delta"])
        dead_total += int(dead.sum())
        assert not bool(_bits(terms[t - 2][:, dead]).any())
        for j in range(CFG.light_depth - 1):
            lv = bdpt._vertex(s["lbufs"], j)
            e2l = lv["pt"] - ev["pt"]
            d2 = torch.clamp(length_sq(e2l), min=RAY_EPSILON)
            dist = torch.sqrt(d2)
            e2l_u = e2l / dist[:, None]
            traced = (~dead & lv["valid"] & ~lv["is_delta"]
                      & (torch.abs(dot(lv["n"], -e2l_u)) > EPSILON)
                      & (torch.abs(dot(ev["n"], e2l_u)) > EPSILON))
            shadow = traverse.shadow_factor(
                s["ts"], ev["pt"] + ev["n"] * RAY_EPSILON, e2l_u,
                dist - RAY_EPSILON, active=traced)
            blocked = traced & ~(shadow.amax(dim=-1) > 0.0)
            blocked_total += int(blocked.sum())
            assert not bool(_bits(terms[t - 2, 1 + j][blocked | ~traced])
                            .any())
    assert dead_total > 0 and blocked_total > 0


def _ordered_terms(n):
    """Terms whose float32 sum depends on the order of the additions."""
    gen = np.random.default_rng(5)
    vals = np.array([1e8, 1.0, -1e8, 3.0, 0.5, -2.0], dtype=np.float32)
    t = vals[gen.integers(0, len(vals), (CFG.eye_depth - 1, CFG.light_depth,
                                         n, 3))]
    return torch.as_tensor(t)


def _sequential(ebufs, terms, cfg):
    """The gather's sum written out per pixel: from 0, per valid non-delta
    eye depth the slots in order (s = 0 and the sky off)."""
    valid = ebufs.valid.numpy()
    delta = ebufs.is_delta.numpy()
    tt = terms.numpy()
    out = np.zeros((terms.shape[2], 3), np.float32)
    for i in range(terms.shape[2]):
        acc = np.zeros(3, np.float32)
        for t in range(cfg.eye_depth - 1):
            if not valid[t, i]:
                break
            if delta[t, i]:
                continue
            for slot in range(cfg.light_depth):
                acc = (acc + tt[t, slot, i]).astype(np.float32)
        out[i] = acc
    return out


def test_gather_adds_in_order(setup):
    s = setup
    cfg = dataclasses.replace(CFG, naive=False)
    terms = _ordered_terms(N)
    got = bdpt.connect_gather_plain(s["ts"], s["tc"], s["ebufs"], s["ev0"],
                                    s["esc"], terms, cfg)
    want = _sequential(s["ebufs"], terms, cfg)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    swapped = terms.flip(1)
    assert not torch.equal(got, bdpt.connect_gather_plain(
        s["ts"], s["tc"], s["ebufs"], s["ev0"], s["esc"], swapped, cfg))


def test_stages_match_jax(setup):
    s = setup
    li = bdpt.connect_gather_plain(s["ts"], s["tc"], s["ebufs"], s["ev0"],
                                   s["esc"], s["terms"], CFG)
    assert s["rays"] + s["jrays_walks"] + bdpt.light_trace_splat(
        s["ts"], s["tc"], s["lbufs"], s["lv0"], CFG,
        torch.zeros((N, 3)))[1] == s["jrays"]
    got, want = li.numpy(), s["jli"]
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-6)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() / want.mean() - 1.0) < 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA for sm_90a)")
    kernels.build()
    return torch.device("cuda")


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return type(x)(*(_to(f, dev) for f in x))


@pytest.mark.cuda
def test_stages_match_plain_on_card(setup, cuda):
    s = setup
    sc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device=cuda)
    eye = dict(bufs=_to(s["ebufs"], cuda), v0=_to(s["ev0"], cuda),
               escape=_to(s["esc"], cuda))
    light = dict(bufs=_to(s["lbufs"], cuda))
    px, py = s["px"].to(cuda), s["py"].to(cuda)
    rays = torch.zeros(N, dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    terms = kernels.bdpt_pairs(sc, s["tc"], s["key_c"], eye, light, rays,
                               CFG, px=px, py=py)
    assert kernels.launches["bdpt_pairs"] == 1
    pterms, prays = bdpt.connect_pairs_plain(
        sc, s["key_c"], eye["bufs"], light["bufs"], CFG, s["ids"].to(cuda))
    assert abs(int(rays.sum()) - prays) <= 1e-3 * prays
    # the terms of valid non-delta eye vertices that either side made
    # nonzero (the others are +0: test_terms_zero_without_a_strategy), as
    # chip_smoke.compare_k13 holds them
    eb = eye["bufs"]
    live = (eb.valid & ~eb.is_delta)[:, None, :].expand(
        -1, CFG.light_depth, -1) & ((terms != 0) | (pterms != 0)).any(-1)
    assert int(live.sum()) > 0
    got, want = terms[live], pterms[live]
    close = torch.isclose(got, want, rtol=1e-3, atol=1e-6)
    assert close.float().mean().item() >= 0.995
    assert abs(got.sum().item() / want.sum().item() - 1.0) < 1e-3
    pairs = (CFG.eye_depth - 1) * CFG.light_depth
    for per in (CFG.light_depth, pairs):   # a thread per (t, pixel), pixel
        rays_p = torch.zeros_like(rays)
        tp = kernels.bdpt_pairs(sc, s["tc"], s["key_c"], eye, light, rays_p,
                                CFG, px=px, py=py, per=per)
        assert torch.equal(_bits(tp), _bits(terms))
        assert torch.equal(rays_p, rays)
    cfg = dataclasses.replace(CFG, naive=False)
    hand = _ordered_terms(N).to(cuda)
    got = kernels.bdpt_gather(sc, s["tc"], eye, hand, None, cfg)
    assert kernels.launches["bdpt_gather"] == 1
    want = bdpt.connect_gather_plain(sc, s["tc"], eye["bufs"], eye["v0"],
                                     eye["escape"], hand, cfg)
    assert torch.equal(_bits(got), _bits(want))
