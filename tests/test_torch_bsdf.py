"""BSDF lobes and dispatch of the PyTorch port against the JAX package,
on the same numpy-made directions, uniforms and builtin materials.

Two checks per function:
  * same formulas: the port in float64 against the JAX function in float64
    (jax x64 mode), rtol 1e-9, atol 1e-12 on every element. bsdf_sample is
    fed its four uniforms explicitly for this (the keyed draws are float32
    in both packages);
  * same float32 results: rtol 1e-5, atol 1e-6 on at least 97% of the
    elements of every output, and rtol 1e-2 on every element. The lanes
    between the two bounds are where the formula itself cancels: 1 - cos^2
    in ggx_sample_h, d_ggx's denominator near a narrow GGX peak. There a
    one-ulp difference in an intermediate moves the result by up to ~6e-3
    relative (measured), and the two float32 paths do differ in the last
    ulp: XLA:CPU's rsqrt is not correctly rounded, PyTorch's CPU sqrt is
    not always, and cos/sin/exp differ. One condition is looser: a metal
    lane of bsdf_sample whose sampled half vector lies on the GGX peak
    (1 - h_z^2 < 1e-4). float32 resolves 1 - h_z^2 only to ~6e-8 there,
    which at roughness 0.05 (alpha^2 = 6.25e-6) is a ~1% step of D's
    denominator before it is squared; its f and pdf are held to rtol 1e-1
    (measured worst 7.2e-2). The float64 check covers those lanes exactly.
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
from cudapathtracer_tpu_torch.scene.materials import (MAT_METAL,
                                                      MaterialTable,
                                                      build_table,
                                                      builtin_materials)
from cudapathtracer_tpu_torch.utils import rng as trng

N = 2048
TOL = dict(rtol=1e-5, atol=1e-6)


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


def _check(jfn, tfn, args, f64=True, peak=None):
    """Compare tfn (port) with jfn (JAX) under the bounds in the module
    docstring. peak: [N] bool, the GGX-peak lanes held to rtol 1e-1."""
    j32 = _flat(jfn(*[jnp.asarray(a) for a in args]))
    t32 = _flat(tfn(*[torch.as_tensor(a) for a in args]))
    if f64:
        a64 = _cast(args, np.float64)
        with enable_x64(True):
            j64 = _flat(jfn(*[jnp.asarray(a) for a in a64]))
        t64 = _flat(tfn(*[torch.as_tensor(a) for a in a64]))
        for t, j in zip(t64, j64):
            np.testing.assert_allclose(t, j, rtol=1e-9, atol=1e-12)
    for t, j in zip(t32, j32):
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
        close = np.isclose(t, j, **TOL)
        assert close.mean() >= 0.97, (
            f"only {close.mean():.4f} of elements within rtol 1e-5, atol "
            f"1e-6; worst: jax {j[~close][:3]}, port {t[~close][:3]}")
        fin = np.isfinite(j)
        loose = np.zeros(j.shape, bool) if peak is None else \
            np.broadcast_to(peak.reshape(peak.shape + (1,) * (j.ndim - 1)),
                            j.shape)
        np.testing.assert_allclose(t[fin & ~loose], j[fin & ~loose],
                                   rtol=1e-2, atol=1e-6)
        np.testing.assert_allclose(t[fin & loose], j[fin & loose],
                                   rtol=1e-1, atol=1e-6)


def _both(name, *args):
    _check(getattr(jb, name), getattr(tb, name), list(args))


LOBES = {
    "fresnel_schlick": lambda x: (x["wi"][:, 2], x["eta_i"], x["ior"]),
    "fresnel_conductor": lambda x: (x["wi"][:, 2], x["eta"], x["k"]),
    "cosine_pdf": lambda x: (x["wo"],),
    "cosine_sample": lambda x: (x["u"][0], x["u"][1]),
    "d_ggx": lambda x: (x["wo"][:, 2], x["rough"]),
    "g1_ggx": lambda x: (x["wo"][:, 2], x["rough"]),
    "ggx_sample_h": lambda x: (x["u"][0], x["u"][1], x["rough"] ** 2),
    "metal_f": lambda x: (x["eta"], x["k"], x["rough"], x["wi"], x["wo"]),
    "metal_pdf": lambda x: (x["rough"], x["wi"], x["wo"]),
    "mirror_f": lambda x: (x["wo"],),
    "leaf_f": lambda x: (x["albedo"], x["ior"], x["eta_i"], x["rough"],
                         x["trans"], x["wi"], x["wo"]),
    "leaf_pdf": lambda x: (x["ior"], x["eta_i"], x["rough"], x["trans"],
                           x["wi"], x["wo"]),
    "leaf_sample": lambda x: (x["u"][0], x["u"][1], x["u"][2], x["u"][3],
                              x["wi"], x["ior"], x["eta_i"], x["rough"],
                              x["albedo"], x["trans"]),
}


@pytest.mark.parametrize("lobe", sorted(LOBES))
def test_lobe_matches_jax(inputs, lobe):
    _both(lobe, *LOBES[lobe](inputs))


@pytest.mark.parametrize("mode", [0, 1])
def test_dielectric_sample_matches_jax(inputs, mode):
    x = inputs
    args = [x["u"][0], x["wi"], x["ior"], x["backface"]]
    _check(lambda *a: jb.dielectric_sample(*a, mode),
           lambda *a: tb.dielectric_sample(*a, mode), args)
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
    _check(lambda a, wi, wo, e, tr: jb.bsdf_f(jm, a, wi, wo, e, tr),
           lambda a, wi, wo, e, tr: tb.bsdf_f(tm, a, wi, wo, e, tr), args)
    _check(lambda a, wi, wo, e, tr: jb.bsdf_pdf(jm, wi, wo, e, tr),
           lambda a, wi, wo, e, tr: tb.bsdf_pdf(tm, wi, wo, e, tr), args)

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
    # metal lanes whose half vector sits on the GGX peak (module docstring)
    wo = np.asarray(jfn(*[jnp.asarray(a) for a in args])[0], np.float64)
    h = x["wi"] + wo
    hz2 = h[:, 2] ** 2 / np.maximum((h * h).sum(axis=1), 1e-30)
    peak = (tm.type.numpy() == MAT_METAL) & (1.0 - hz2 < 1e-4)
    assert peak.any() and peak.mean() < 0.1
    _check(jfn, tfn, args, peak=peak)
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
    _both("sample_texture", atlas, start, width, height, uv)
