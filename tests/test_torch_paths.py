"""The BDPT walks of the PyTorch port (kernel K12's plain versions,
models/paths.py and models/mis.py) and the pieces they add to the camera
and the hit fetch, against the JAX package on the CPU.

Tolerances, with their reasons:
  * mis.advance: rtol 1e-6 on random inputs (the same float32 formula,
    eager on both sides; XLA:CPU may contract one product into an FMA).
  * interpolate_hit, world_to_raster: atol 1e-6 (the same formulas;
    XLA:CPU contracts the dot products into FMAs); importance: rtol 1e-5
    within 84 degrees of the view axis (1/cos^4 amplifies the dot's ulp).
  * The walks on cornell_blocks, 16x16, eye depth 6, light depth 4,
    samples 0 and 1: every draw is bit-equal, so a lane diverges only where
    one ulp flips a discrete decision; at most 1 of the 256 lanes may, and
    `valid` and the flag words must be equal on all others (measured: no
    lane diverged). There, points within atol 1e-5; pdf_fwd, d_vcm and
    d_vc within rtol 1e-3 (measured 9e-5: pdf_fwd divides by a squared
    distance and carries |cos| of grazing hits); the octahedral words
    within one snorm16 step per component (measured: equal); float16 beta
    and uv within one half ulp, 2^-10 relative (measured: equal).
  * The VCM light walk (eta_vcm set, which seeds and advances the d_vm
    chain), sample 0: the same bounds, d_vm within rtol 1e-3 as d_vc.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import VCM_ETA
from cudapathtracer_tpu.models import mis as jmis
from cudapathtracer_tpu.models import paths as jpaths
from cudapathtracer_tpu.ops import traverse as jtraverse
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch.models import bdpt, mis, paths
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = H = 16
EYE_DEPTH, LIGHT_DEPTH = 6, 4


@pytest.mark.parametrize("vcm", [False, True])
def test_mis_advance_matches_jax(vcm):
    gen = np.random.default_rng(21 + vcm)
    n = 4096
    f = lambda lo, hi: gen.uniform(lo, hi, n).astype(np.float32)
    state = [f(0.0, 50.0), f(0.0, 50.0), f(0.0, 50.0) if vcm else
             np.zeros(n, np.float32), f(0.0, 3.0), gen.uniform(size=n) < 0.3]
    args = dict(depth_is_first=gen.uniform(size=n) < 0.2,
                pdf_fwd_area=np.where(gen.uniform(size=n) < 0.05, 0.0,
                                      f(1e-3, 20.0)).astype(np.float32),
                g=f(0.0, 10.0), pdf_rev_sa=f(0.0, 3.0),
                cur_is_delta=gen.uniform(size=n) < 0.3,
                first_d_vcm=f(0.0, 5.0), first_d_vc=f(0.0, 5.0))
    first_vm = f(0.0, 5.0) if vcm else None
    eta = 0.37 if vcm else None
    jout = jmis.advance(jmis.MisState(*(jnp.asarray(a) for a in state)),
                        *(jnp.asarray(a) for a in args.values()),
                        None if first_vm is None else jnp.asarray(first_vm),
                        eta)
    tout = mis.advance(mis.MisState(*(torch.as_tensor(a) for a in state)),
                       *(torch.as_tensor(a) for a in args.values()),
                       None if first_vm is None else torch.as_tensor(first_vm),
                       eta)
    for j, t in zip(jout[:3], tout[:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=0)
    for j, t in zip(jout[3], tout[3]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if not vcm:
        assert not tout[2].any()


def _grid(w, h):
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    return gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)


@pytest.fixture(scope="module")
def scenes():
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    jc = JCamera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    tc = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    return js, ts, jc, tc


def test_interpolate_hit_matches_jax(scenes):
    js, ts, _, _ = scenes
    gen = np.random.default_rng(5)
    n = 2048
    o = gen.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    d = gen.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jh = jtraverse.closest_hit(js, jo, jd)
    th = traverse.closest_hit(ts, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(th.tri.numpy(), np.asarray(jh.tri))
    ji = jtraverse.interpolate_hit(js, jo, jd, jh)
    ti = traverse.interpolate_hit(ts, torch.as_tensor(o), torch.as_tensor(d),
                                  th)
    assert set(ti) == set(ji)
    for k in ("mat_id", "light_ind", "backface", "valid", "tri"):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]))
    for k in ("point", "normal", "uv", "emission", "t"):
        np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]),
                                   rtol=0, atol=1e-6)


def test_world_to_raster_and_importance_match_jax():
    gen = np.random.default_rng(6)
    for args in (((0.0, 0.0, 1.0), 24, 16, 0.0, 0.0, 0.0, 60.0),
                 ((0.2, -0.1, 1.5), 32, 18, 10.0, -25.0, 5.0, 45.0)):
        jc, tc = JCamera.pinhole(*args), Camera.pinhole(*args)
        p = gen.uniform(-1.0, 1.0, (4096, 3)).astype(np.float32)
        jx, jy, jok = jc.world_to_raster(jnp.asarray(p))
        tx, ty, tok = tc.world_to_raster(torch.as_tensor(p))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert 0.2 < tok.float().mean().item() < 0.9
        for a, b in ((tx, jx), (ty, jy)):
            np.testing.assert_allclose(a.numpy()[tok.numpy()],
                                       np.asarray(b)[np.asarray(jok)],
                                       rtol=1e-6, atol=1e-4)
        d = gen.normal(size=(4096, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        jwe, jpdf = jc.importance(jnp.asarray(d))
        twe, tpdf = tc.importance(torch.as_tensor(d))
        # where the direction is within 84 degrees of forward: near 90 the
        # 1/cos^4 amplifies the dot product's last-ulp differences
        fwd = d @ np.asarray(jc.forward)
        m = fwd > 0.1
        np.testing.assert_allclose(twe.numpy()[m], np.asarray(jwe)[m],
                                   rtol=1e-5)
        np.testing.assert_allclose(tpdf.numpy()[m], np.asarray(jpdf)[m],
                                   rtol=1e-5)
        assert np.isfinite(twe.numpy()).all()
        assert tc.plane_area() == pytest.approx(
            float(4.0 * (jc.width / jc.height) * jc.fov_scale
                  * jc.fov_scale), rel=1e-7)


@pytest.fixture(scope="module")
def walks(scenes):
    """JAX and port walks for samples 0 and 1 (keys key_l, key_e)."""
    js, ts, jc, tc = scenes
    px, py = _grid(W, H)
    jpx, jpy = jnp.asarray(px), jnp.asarray(py)
    tpx, tpy = torch.as_tensor(px), torch.as_tensor(py)
    pid = jrng.pixel_ids(jpx, jpy)
    out = []
    for s in (0, 1):
        skey = jrng.sample_key(jrng.base_key(), s)
        jkl, jke = jax.random.fold_in(skey, 1), jax.random.fold_in(skey, 2)
        kl, ke, _ = bdpt.sample_keys(rng.base_key(), s)
        jl = jpaths.generate_light_path(js, jkl, W * H, LIGHT_DEPTH, ids=pid)
        je = jpaths.generate_eye_path(js, jc, jke, jpx, jpy, EYE_DEPTH,
                                      ids=pid)
        tl = paths.generate_light_path(ts, kl, tpx, tpy, LIGHT_DEPTH)
        te = paths.generate_eye_path(ts, tc, ke, tpx, tpy, EYE_DEPTH)
        out.append(dict(light=(jl[0], tl[0], int(jl[2]), tl[2], jl[1],
                               tl[1]),
                        eye=(je[0], te[0], int(je[3]), te[3], je[1], te[1],
                             je[2], te[2])))
    return out


def _oct_steps(a, b):
    """Largest per-component snorm16 difference between two code words."""
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    worst = 0
    for shift in (0, 16):
        x = ((a >> shift) & 0xFFFF).astype(np.int16).astype(np.int64)
        y = ((b >> shift) & 0xFFFF).astype(np.int16).astype(np.int64)
        worst = max(worst, int(np.abs(x - y).max(initial=0)))
    return worst


@pytest.mark.parametrize("side", ["eye", "light"])
def test_walks_match_jax(walks, side):
    for w in walks:
        jb, tb, jrays, trays = w[side][:4]
        assert tb.valid.shape == (
            (EYE_DEPTH if side == "eye" else LIGHT_DEPTH) - 1, W * H)
        jv, tv = np.asarray(jb.valid), tb.valid.numpy()
        jf, tf = np.asarray(jb.flags), tb.flags.numpy().view(np.uint32)
        jp, tp = np.asarray(jb.pt), tb.pt.numpy()
        diverged = ((jv != tv) | ((jf != tf) & jv)
                    | ((np.abs(jp - tp).max(-1) > 1e-3) & jv)).any(0)
        assert diverged.sum() <= 1, f"{diverged.sum()} lanes diverged"
        assert abs(jrays - trays) <= 2 * diverged.sum() * jv.shape[0]
        keep = ~diverged[None]
        np.testing.assert_array_equal(tv[:, ~diverged], jv[:, ~diverged])
        m = jv & keep
        assert m.sum() > 100
        np.testing.assert_array_equal(tf[m], jf[m])
        np.testing.assert_allclose(tp[m], jp[m], rtol=0, atol=1e-5)
        for f in ("pdf_fwd", "d_vcm", "d_vc"):
            np.testing.assert_allclose(getattr(tb, f).numpy()[m],
                                       np.asarray(getattr(jb, f))[m],
                                       rtol=1e-3, atol=1e-6, err_msg=f)
        assert not tb.d_vm.any()
        for f in ("n_oct", "wo_oct"):
            assert _oct_steps(getattr(tb, f).numpy().view(np.uint32)[m],
                              np.asarray(getattr(jb, f))[m]) <= 1, f
        for f in ("uv_h", "beta_h"):
            a = getattr(tb, f).numpy().astype(np.float32)[m]
            b = np.asarray(getattr(jb, f)).astype(np.float32)[m]
            np.testing.assert_allclose(a, b, rtol=2.0 ** -10, atol=1e-7,
                                       err_msg=f)
        if side == "eye":
            jesc, tesc = w["eye"][6], w["eye"][7]
            ok = ~diverged
            np.testing.assert_array_equal(tesc.valid.numpy()[ok],
                                          np.asarray(jesc.valid)[ok])
            e = tesc.valid.numpy() & ok
            np.testing.assert_allclose(tesc.beta.numpy()[e],
                                       np.asarray(jesc.beta)[e], rtol=1e-4)
            np.testing.assert_allclose(tesc.d.numpy()[e],
                                       np.asarray(jesc.d)[e], atol=1e-5)


def test_walk_endpoints_match_jax(walks):
    """Vertex 0 of both walks: the lens point and camera forward (eye); the
    light sample, its interpolated normal, beta0 = Le pi / pdf0 and the ids
    (light)."""
    for w in walks:
        jv0, tv0 = w["light"][4], w["light"][5]
        for k in ("light_ind", "mat_id", "tri"):
            np.testing.assert_array_equal(tv0[k].numpy(), np.asarray(jv0[k]))
        for k in ("pt", "n", "beta", "pdf_fwd"):
            np.testing.assert_allclose(tv0[k].numpy(), np.asarray(jv0[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        jv0, tv0 = w["eye"][4], w["eye"][5]
        for k in ("pt", "n"):
            np.testing.assert_allclose(tv0[k].numpy(), np.asarray(jv0[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_path_buffers_from_numpy(walks):
    """PathBuffers.from_numpy keeps every bit of the JAX buffers, and the
    decoded views agree with the JAX package's."""
    jb = walks[0]["eye"][0]
    tb = paths.PathBuffers.from_numpy(jb)
    assert tb.flags.dtype == torch.int32
    np.testing.assert_array_equal(tb.flags.numpy().view(np.uint32),
                                  np.asarray(jb.flags))
    np.testing.assert_array_equal(tb.uv_h.numpy(), np.asarray(jb.uv_h))
    for k in ("n", "wo", "beta", "uv"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    for k in ("is_delta", "backface", "light_ind", "mat_id"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)))


def test_vcm_light_walk_matches_jax(scenes):
    """generate_light_path with eta_vcm against the JAX VCM light walk
    (models/vcm.py: first_vm_seed = first_vc_scale / eta_vcm)."""
    js, ts, _, _ = scenes
    px, py = _grid(W, H)
    pid = jrng.pixel_ids(jnp.asarray(px), jnp.asarray(py))
    jkl = jax.random.fold_in(jrng.sample_key(jrng.base_key(), 0), 1)
    kl, _, _ = bdpt.sample_keys(rng.base_key(), 0)
    eta = np.float32(VCM_ETA)
    start, _ = jpaths.start_light_walk(js, jkl, W * H, ids=pid)
    seed = start.first_vc_scale / jnp.maximum(eta, 1e-30)
    jb = jpaths.generate_light_path(js, jkl, W * H, LIGHT_DEPTH, eta_vcm=eta,
                                    first_vm_seed=seed, ids=pid)[0]
    tb = paths.generate_light_path(ts, kl, torch.as_tensor(px),
                                   torch.as_tensor(py), LIGHT_DEPTH,
                                   eta_vcm=float(eta))[0]
    jv, tv = np.asarray(jb.valid), tb.valid.numpy()
    jf, tf = np.asarray(jb.flags), tb.flags.numpy().view(np.uint32)
    diverged = ((jv != tv) | ((jf != tf) & jv)
                | ((np.abs(np.asarray(jb.pt) - tb.pt.numpy()).max(-1)
                    > 1e-3) & jv)).any(0)
    assert diverged.sum() <= 1, f"{diverged.sum()} lanes diverged"
    m = jv & ~diverged[None]
    assert m.sum() > 100
    np.testing.assert_array_equal(tf[m], jf[m])
    jvm = np.asarray(jb.d_vm)[m]
    assert (jvm != 0).mean() > 0.5
    for f in ("pdf_fwd", "d_vcm", "d_vc", "d_vm"):
        np.testing.assert_allclose(getattr(tb, f).numpy()[m],
                                   np.asarray(getattr(jb, f))[m],
                                   rtol=1e-3, atol=1e-6, err_msg=f)
