"""BSDF lobes and dispatch of the PyTorch port against the JAX package,
on the same numpy-made directions, uniforms and builtin materials.

Two checks per function:
  * same formulas: the port in float64 against the JAX function in float64
    (jax x64 mode), rtol 1e-9, atol 1e-12 on every element. bsdf_sample is
    fed its four uniforms explicitly for this (the keyed draws are float32
    in both packages);
  * same float32 results, per element: the port's float32 result and the
    JAX package's float32 result are each held to the float64 result r on
    the same inputs, within

        |x32 - r| <= 1e-6 + 1e-5 |r| + K u (A_rel |r| + A_abs),

    u = 2^-24 (float32's unit roundoff), K = 32. A_rel and A_abs are the
    lane's condition: how much the formula amplifies a last-ulp rounding
    of an intermediate. Both are 0 for a lane without cancellation, so
    there the bound is rtol 1e-5, atol 1e-6. The conditions, each from the
    formula in float64:
      - GGX peak, for every f or pdf that holds D: D's denominator
        den = 1 - h_z^2 (1 - alpha^2) cancels where h_z^2 -> 1, so an
        error of one ulp in h_z^2 moves D by 2 (1 - alpha^2) / den
        relative: A_rel = 2 (1 - alpha^2) / den, h = normalize(wi + wo).
        (At roughness 0.05, alpha^2 = 6.25e-6, this reaches ~3e5.)
      - GGX half-vector sample (ggx_sample_h): cos_t^2 = (1 - u1) / s with
        s = 1 + (alpha^2 - 1) u1, which cancels where u1 -> 1 at small
        alpha, and sin_t = sqrt(1 - cos_t^2), which cancels where
        cos_t -> 1. The tangential components move by
        A_abs = (1 + 1/s) / sin_t absolute. A direction built from that
        half vector (wo = 2 (wi.h) h - wi) gets 3 A_abs, and its h_z^2 an
        error of (1 + 1/s) ulps, so D there gets A_rel (1 + 1/s).
      - Branch edges: a lane whose float64 decision quantity lies within
        1e-5 of its threshold can take the other branch in float32 (the
        leaf 3-event sample's u_sel < F, the dielectric's u < F, its
        TIR test cos_t^2 < 0 and its F >= 0.99999 forced mirror). Such a
        lane is held only to a finite result, and the edges must stay
        rare (< 1% of lanes).
      - Refraction: wo_t,z = -sqrt(cos_t^2) and f = (1 - F) / |wo_t,z|
        cancel near TIR: A_rel = A_abs = 1 / cos_t^2.
      - Bilinear texture lookup: the weight fx - floor(fx) carries one ulp
        of fx = u w - 0.5 (and fy), times a texel difference <= 1:
        A_abs = 2 (|u w| + |v h| + 1).
    K was set on one host (AMD EPYC, no AVX-512), where the largest
    multiple of u (A_rel |r| + A_abs) that any element needed beyond the
    rtol/atol part was ~9 (leaf_sample's f from the JAX package): K = 32
    leaves a margin of more than 3x for hosts whose XLA:CPU or PyTorch
    rounds differently (XLA contracts a*b+c into FMA under jit, its rsqrt
    is not correctly rounded, and PyTorch's CPU sqrt is not always).
"""

import dataclasses

import jax.numpy as jnp
from jax import enable_x64
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.ops import bsdf as jb
from cudapathtracer_tpu.scene.materials import (
    MaterialTable as JMaterialTable)
from cudapathtracer_tpu.scene.materials import build_table as jbuild_table
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch.ops import bsdf as tb
from cudapathtracer_tpu_torch.scene.materials import (MAT_LEAF, MAT_METAL,
                                                      MAT_SMOOTHDIELECTRIC,
                                                      MaterialTable,
                                                      build_table,
                                                      builtin_materials)
from cudapathtracer_tpu_torch.utils import rng as trng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

N = 2048
ATOL, RTOL = 1e-6, 1e-5
K_ULP = 32 * 2.0 ** -24   # K u of the module docstring
EDGE = 1e-5               # branch-edge width


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _make_inputs():
    gen = np.random.default_rng(23)
    wi = gen.normal(size=(N, 3))
    wi[:, 2] = np.abs(wi[:, 2]) + 0.05
    wo = gen.normal(size=(N, 3))
    mat_idx = gen.integers(0, 24, N)
    jt = jbuild_table(jbuiltin_materials(), device=False)
    tt = build_table(builtin_materials())
    jmat = JMaterialTable(**{f.name: jnp.asarray(
        np.asarray(getattr(jt, f.name))[mat_idx])
        for f in dataclasses.fields(jt)})
    tmat = MaterialTable(**{f.name: torch.as_tensor(
        getattr(tt, f.name)[mat_idx]) for f in dataclasses.fields(tt)})
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        wi=_unit(wi), wo=_unit(wo),
        u=[f32(gen.uniform(size=N)) for _ in range(4)],
        albedo=f32(gen.uniform(0.0, 1.0, (N, 3))),
        eta=f32(gen.uniform(0.5, 3.0, (N, 3))),
        k=f32(gen.uniform(0.0, 3.0, (N, 3))),
        rough=f32(gen.uniform(0.05, 1.0, N)),
        ior=f32(gen.uniform(1.1, 2.5, N)),
        eta_i=f32(gen.choice([1.0, 1.333, 1.5], N)),
        trans=f32(gen.uniform(0.0, 1.0, N)),
        backface=gen.uniform(size=N) < 0.5,
        jmat=jmat, tmat=tmat)


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs()


def _flat(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o, np.float64) for o in out]


def _cast(args, dtype):
    return [a.astype(dtype) if isinstance(a, np.ndarray)
            and a.dtype == np.float32 else a for a in args]


def _check(jfn, tfn, args, cond=None):
    """Compare tfn (port) and jfn (JAX) under the bounds in the module
    docstring. cond(args64, outs64) -> (a_rel, a_abs, edge): per-lane [N]
    arrays (or 0) of the lane's condition, edge the lanes at a branch
    edge (or None)."""
    j32 = _flat(jfn(*[jnp.asarray(a) for a in args]))
    t32 = _flat(tfn(*[torch.as_tensor(a) for a in args]))
    a64 = _cast(args, np.float64)
    with enable_x64(True):
        j64 = _flat(jfn(*[jnp.asarray(a) for a in a64]))
    r64 = _flat(tfn(*[torch.as_tensor(a) for a in a64]))
    for t, j in zip(r64, j64):
        np.testing.assert_allclose(t, j, rtol=1e-9, atol=1e-12)
    a_rel, a_abs, edge = cond(a64, r64) if cond else (0.0, 0.0, None)
    n = r64[0].shape[0]
    edge = np.zeros(n, bool) if edge is None else edge
    assert edge.mean() < 0.01, f"{edge.mean():.4f} of lanes at a branch edge"
    lane = lambda a, r: np.broadcast_to(
        np.reshape(a, np.shape(a) + (1,) * (r.ndim - np.ndim(a))), r.shape)
    for k, r in enumerate(r64):
        bound = ATOL + RTOL * np.abs(r) + K_ULP * (
            lane(a_rel, r) * np.abs(r) + lane(a_abs, r))
        keep = ~lane(edge, r)
        for who, x in (("port", t32[k]), ("jax", j32[k])):
            np.testing.assert_array_equal(np.isfinite(x), np.isfinite(r))
            fin = keep & np.isfinite(r)
            err = np.abs(x[fin] - r[fin])
            over = err > bound[fin]
            assert not over.any(), (
                f"output {k}, {who}: {int(over.sum())} elements over their "
                f"bound; worst err/bound {np.max(err / bound[fin]):.3g}, "
                f"float64 {r[fin][over][:3]}, float32 {x[fin][over][:3]}")


def _both(name, *args, cond=None):
    _check(getattr(jb, name), getattr(tb, name), list(args), cond)


def _half_vector(wi, wo):
    h = wi + wo
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-300)
    return np.where(h[:, 2:3] <= 0.0, -h, h)


def _peak(h_z, alpha):
    """A_rel of D(h_z, alpha): 2 (1 - alpha^2) / den."""
    a2 = alpha * alpha
    return 2.0 * (1.0 - a2) / (1.0 - h_z * h_z * (1.0 - a2))


def _ggx_sample_cond(u1, alpha):
    """(1 + 1/s, sin_t) of the GGX half-vector sample."""
    s = 1.0 + (alpha * alpha - 1.0) * u1
    cos2 = np.clip((1.0 - u1) / s, 0.0, 1.0)
    return 1.0 + 1.0 / s, np.sqrt(np.maximum(1.0 - cos2, 1e-300))


def _schlick(cos_t, eta_i, eta_t):
    r0 = ((eta_i - eta_t) / (eta_i + eta_t)) ** 2
    return r0 + (1.0 - r0) * (1.0 - np.abs(cos_t)) ** 5


def _on_peak(wi_i, wo_i, alpha_i):
    """cond for a lobe evaluated at given wi, wo."""
    def cond(a, out):
        wi, wo = a[wi_i], a[wo_i]
        return _peak(_half_vector(wi, wo)[:, 2], a[alpha_i] ** 2), 0.0, None
    return cond


def _ggx_h_cond(a, out):
    amp, sin_t = _ggx_sample_cond(a[0], a[2])
    return 0.0, amp / sin_t, None


def _leaf_sample_cond(a, out):
    u_sel, _, u1, _, wi, ior, eta_i, rough = a[:8]
    amp, sin_t = _ggx_sample_cond(u1, rough * rough)
    a_rel = _peak(_half_vector(wi, out[0])[:, 2], rough * rough) * amp
    edge = np.abs(u_sel - _schlick(wi[:, 2], eta_i, ior)) < EDGE
    return a_rel, 3.0 * amp / sin_t, edge


def _dielectric_cond(a, out):
    u, wi, ior, backface = a
    eta_i = np.where(backface, ior, 1.0)
    eta_t = np.where(backface, 1.0, ior)
    cos_i = np.clip(wi[:, 2], 1e-5, 1.0)
    eta = eta_i / eta_t
    cos_t2 = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    fres = _schlick(cos_i, eta_i, eta_t)
    edge = ((np.abs(u - fres) < EDGE) | (np.abs(cos_t2) < EDGE)
            | (np.abs(fres - 0.99999) < EDGE))
    amp = 1.0 / np.maximum(np.abs(cos_t2), 1e-300)
    return amp, amp, edge


# name -> (arguments, condition)
LOBES = {
    "fresnel_schlick": (lambda x: (x["wi"][:, 2], x["eta_i"], x["ior"]),
                        None),
    "fresnel_conductor": (lambda x: (x["wi"][:, 2], x["eta"], x["k"]), None),
    "cosine_pdf": (lambda x: (x["wo"],), None),
    "cosine_sample": (lambda x: (x["u"][0], x["u"][1]), None),
    "d_ggx": (lambda x: (x["wo"][:, 2], x["rough"]),
              lambda a, out: (_peak(a[0], a[1]), 0.0, None)),
    "g1_ggx": (lambda x: (x["wo"][:, 2], x["rough"]), None),
    "ggx_sample_h": (lambda x: (x["u"][0], x["u"][1], x["rough"] ** 2),
                     _ggx_h_cond),
    "metal_f": (lambda x: (x["eta"], x["k"], x["rough"], x["wi"], x["wo"]),
                _on_peak(3, 4, 2)),
    "metal_pdf": (lambda x: (x["rough"], x["wi"], x["wo"]),
                  _on_peak(1, 2, 0)),
    "mirror_f": (lambda x: (x["wo"],), None),
    "leaf_f": (lambda x: (x["albedo"], x["ior"], x["eta_i"], x["rough"],
                          x["trans"], x["wi"], x["wo"]), _on_peak(5, 6, 3)),
    "leaf_pdf": (lambda x: (x["ior"], x["eta_i"], x["rough"], x["trans"],
                            x["wi"], x["wo"]), _on_peak(4, 5, 2)),
    "leaf_sample": (lambda x: (x["u"][0], x["u"][1], x["u"][2], x["u"][3],
                               x["wi"], x["ior"], x["eta_i"], x["rough"],
                               x["albedo"], x["trans"]), _leaf_sample_cond),
}


@pytest.mark.parametrize("lobe", sorted(LOBES))
def test_lobe_matches_jax(inputs, lobe):
    args, cond = LOBES[lobe]
    _both(lobe, *args(inputs), cond=cond)


@pytest.mark.parametrize("mode", [0, 1])
def test_dielectric_sample_matches_jax(inputs, mode):
    x = inputs
    args = [x["u"][0], x["wi"], x["ior"], x["backface"]]
    _check(lambda *a: jb.dielectric_sample(*a, mode),
           lambda *a: tb.dielectric_sample(*a, mode), args, _dielectric_cond)
    # both branches and the forced mirror (TIR) are exercised
    wo, _, pdf = tb.dielectric_sample(*[torch.as_tensor(a) for a in args],
                                      mode)
    refl = wo[:, 2].numpy() > 0
    assert 0.0 < refl.mean() < 1.0
    assert (pdf.numpy() == 1.0).any()


def test_dispatch_matches_jax(inputs, monkeypatch):
    x = inputs
    jm, tm = x["jmat"], x["tmat"]
    args = [x[k] for k in ("albedo", "wi", "wo", "eta_i", "trans")]
    rough = tm.roughness.numpy().astype(np.float64)
    on_peak = lambda a, out: (
        _peak(_half_vector(a[1], a[2])[:, 2], rough * rough), 0.0, None)
    _check(lambda a, wi, wo, e, tr: jb.bsdf_f(jm, a, wi, wo, e, tr),
           lambda a, wi, wo, e, tr: tb.bsdf_f(tm, a, wi, wo, e, tr), args,
           on_peak)
    _check(lambda a, wi, wo, e, tr: jb.bsdf_pdf(jm, wi, wo, e, tr),
           lambda a, wi, wo, e, tr: tb.bsdf_pdf(tm, wi, wo, e, tr), args,
           on_peak)

    ids = np.arange(N, dtype=np.int32)
    jkey = jrng.bounce_key(jrng.sample_key(jrng.base_key(), 2), 1)
    tkey = trng.bounce_key(trng.sample_key(trng.base_key(), 2), 1)
    # the four draws bsdf_sample consumes, bit-equal in both packages
    us = [trng.uniform_any(tkey, 4 + k, N, torch.as_tensor(ids)).numpy()
          for k in range(4)]
    for k, u in enumerate(us):
        ju = np.asarray(jrng.uniform_any(jkey, 4 + k, N, jnp.asarray(ids)))
        np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))

    def explicit(pkg, mat):
        """bsdf_sample of `pkg` on the uniforms passed in (any float dtype)
        in place of its keyed draws."""
        def fn(a, wi, bf, e, *u):
            with monkeypatch.context() as mp:
                mp.setattr(pkg.rng, "uniform_any",
                           lambda key, draw, n, ids=None: u[draw - 4])
                return pkg.bsdf_sample(None, 4, mat, a, wi, bf, e)
        return fn

    args = [x["albedo"], x["wi"], x["backface"], x["eta_i"], *us]
    jfn, tfn = explicit(jb, jm), explicit(tb, tm)
    mtype = tm.type.numpy()
    ior = tm.ior.numpy().astype(np.float64)

    def sample_cond(a, out):
        """GGX lanes (metal, leaf): the sampled half vector's condition;
        leaf and dielectric lanes: their branch edges and refraction."""
        _, wi, bf, eta_i, u_sel, _, u1, _ = a
        ggx = (mtype == MAT_METAL) | (mtype == MAT_LEAF)
        amp, sin_t = _ggx_sample_cond(u1, rough * rough)
        a_rel = np.where(ggx, _peak(_half_vector(wi, out[0])[:, 2],
                                    rough * rough) * amp, 0.0)
        a_abs = np.where(ggx, 3.0 * amp / sin_t, 0.0)
        leaf_edge = np.abs(u_sel - _schlick(wi[:, 2], eta_i, ior)) < EDGE
        d_rel, _, d_edge = _dielectric_cond((u_sel, wi, ior, bf), out)
        diel = mtype == MAT_SMOOTHDIELECTRIC
        a_rel = np.where(diel, d_rel, a_rel)
        a_abs = np.where(diel, d_rel, a_abs)
        edge = np.where(diel, d_edge, (mtype == MAT_LEAF) & leaf_edge)
        return a_rel, a_abs, edge

    _check(jfn, tfn, args, sample_cond)
    # with its key, the port draws exactly those uniforms
    keyed = tb.bsdf_sample(tkey, 4, tm, *[torch.as_tensor(a)
                                          for a in args[:4]],
                           ids=torch.as_tensor(ids))
    for a, b in zip(keyed, tfn(*[torch.as_tensor(a) for a in args])):
        assert torch.equal(a, b)
    assert len(np.unique(tm.type.numpy())) == 5   # every lobe selected


def test_textures_match_jax(inputs):
    gen = np.random.default_rng(4)
    atlas = gen.uniform(size=(64 * 64 + 32 * 16, 3)).astype(np.float32)
    start = gen.choice([-1, 0, 64 * 64], N).astype(np.int32)
    width = np.where(start == 64 * 64, 32, 64).astype(np.int32)
    height = np.where(start == 64 * 64, 16, 64).astype(np.int32)
    uv = gen.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    # the bilinear weight fx - floor(fx) carries the rounding of
    # fx = u * w - 0.5, one ulp of |fx|, times a texel difference <= 1
    texel = lambda a, out: (0.0, 2.0 * (np.abs(a[4][:, 0] * a[2])
                                        + np.abs(a[4][:, 1] * a[3]) + 1.0),
                            None)
    _both("sample_texture", atlas, start, width, height, uv, cond=texel)
