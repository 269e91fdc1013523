"""NEE, light pdf, power-2 MIS and the medium stack of the PyTorch port
against the JAX package (models/common.py), on the golden Cornell scene
with numpy-made surface points, normals and materials.

Tolerance: rtol 1e-5, atol 1e-6 for light samples, pdfs, directions and
MIS weights (the same float32 formulas; the draws are bit-equal and the
shadow rays are traced by the ported BVH8 traversal). NEE contributions
carry the BSDF value, so they follow test_torch_bsdf.py's rule: that
tolerance on at least 97% of the elements, the rest being metal and leaf
lanes near a narrow GGX peak, where one ulp of an intermediate moves f by
up to ~1e-2 relative. The medium stack is integer state and must be
equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import common as jc
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.materials import \
    MaterialTable as JMaterialTable
from cudapathtracer_tpu.scene.materials import build_table as jbuild_table
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch.models import common as tc
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.scene.materials import (MaterialTable,
                                                      build_table,
                                                      builtin_materials)
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng as trng

N = 1024
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores with the plain versions' many small operators.
    The count is restored after the module. The port's test modules import
    this fixture (an imported autouse fixture applies to its module);
    test_torch_kernels, which runs on the card, defines its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    gen = np.random.default_rng(9)
    # points on the floor and back wall, facing into the box
    p = gen.uniform(-0.45, 0.45, (N, 3))
    n = np.zeros((N, 3))
    floor = gen.uniform(size=N) < 0.5
    p[floor, 1] = -0.5
    n[floor, 1] = 1.0
    p[~floor, 2] = -0.5
    n[~floor, 2] = 1.0
    wi = gen.normal(size=(N, 3))
    wi[:, 2] = np.abs(wi[:, 2]) + 0.1
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    mat_idx = gen.choice([2, 3, 4, 6, 7, 13, 16, 19], N)
    jt = jbuild_table(jbuiltin_materials(), device=False)
    jmat = JMaterialTable(**{f.name: jnp.asarray(
        np.asarray(getattr(jt, f.name))[mat_idx])
        for f in dataclasses.fields(jt)})
    tt = build_table(builtin_materials())
    tmat = MaterialTable(**{f.name: torch.as_tensor(
        getattr(tt, f.name)[mat_idx]) for f in dataclasses.fields(tt)})
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(js=js, ts=ts, p=f32(p), n=f32(n), wi=f32(-wi),
                albedo=f32(gen.uniform(size=(N, 3))),
                eta_i=f32(gen.choice([1.0, 1.5], N)),
                active=gen.uniform(size=N) < 0.9,
                ids=np.arange(N, dtype=np.int32) * 7,
                jmat=jmat, tmat=tmat)


def _keys():
    return (jrng.bounce_key(jrng.sample_key(jrng.base_key(), 1), 2),
            trng.bounce_key(trng.sample_key(trng.base_key(), 1), 2))


def test_light_sample_and_pdf(setup):
    x = setup
    jk, tk = _keys()
    ids = x["ids"]
    jl = jc.sample_light_point(x["js"], jk, 0, N, jnp.asarray(ids))
    tl = tc.sample_light_point(x["ts"], tk, 0, N, torch.as_tensor(ids))
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jp = jc.nee_pdf(x["js"], jnp.asarray(x["p"]), jl.point, jl.normal,
                    jl.area)
    tp = tc.nee_pdf(x["ts"], torch.as_tensor(x["p"]), tl.point, tl.normal,
                    tl.area)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    assert (tp.numpy() > 0).mean() > 0.5


def test_next_event_estimation(setup):
    """The port's NEE as its integrator runs it (nee_sample, then the
    shadow ray, then the contribution where the ray is clear) against the
    JAX package's next_event_estimation."""
    x = setup
    jk, tk = _keys()
    jargs = [jnp.asarray(x[k]) for k in ("p", "n", "wi")]
    targs = [torch.as_tensor(x[k]) for k in ("p", "n", "wi")]
    jr = jc.next_event_estimation(
        x["js"], jk, 0, *jargs, x["jmat"], jnp.asarray(x["albedo"]),
        jnp.asarray(x["eta_i"]), jnp.asarray(x["active"]),
        ids=jnp.asarray(x["ids"]))
    ns = tc.nee_sample(
        x["ts"], tk, 0, *targs, x["tmat"], torch.as_tensor(x["albedo"]),
        torch.as_tensor(x["eta_i"]), torch.as_tensor(x["active"]),
        ids=torch.as_tensor(x["ids"]))
    shadow = traverse.shadow_factor(x["ts"], ns.origin, ns.dir, ns.max_t,
                                    active=ns.active)
    clear = shadow.amax(dim=-1) > 0.0
    tr = (torch.where(clear[:, None], ns.contrib * shadow, 0.0),
          ns.light_pdf, ns.wo_local)
    for a, b in zip(tr[1:], jr[1:]):   # light pdf, light direction
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    contrib = tr[0].numpy()
    close = np.isclose(contrib, np.asarray(jr[0]), **TOL)
    assert close.mean() >= 0.97, close.mean()
    assert (contrib.max(axis=1) > 0).mean() > 0.3     # lit points
    assert (contrib[~x["active"]] == 0).all()


def test_power2_weight():
    gen = np.random.default_rng(2)
    p = np.concatenate([gen.uniform(0, 10, 500), [0.0, -1.0, 1e30, 1e-30]])
    q = np.concatenate([gen.uniform(0, 10, 500), [1.0, 1.0, 1e30, 1.0]])
    p, q = p.astype(np.float32), q.astype(np.float32)
    want = np.asarray(jc.power2_weight(jnp.asarray(p), jnp.asarray(q)))
    got = tc.power2_weight(torch.as_tensor(p), torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all()


def _random_stacks(gen, n):
    """Medium stacks built by random pushes/removes of builtin boundary
    materials (air 99, glass 1, tea 2, ice 0 - priority 0 -, water 2)."""
    mats = np.array([5, 8, 9, 10], np.int32)
    pri = np.array([1, 2, 0, 2], np.int32)
    js = jc.MediumStack.make(n, 99)
    ts = tc.MediumStack.make(n, 99)
    for _ in range(6):
        k = gen.integers(0, 4, n)
        m = mats[k]
        push = gen.uniform(size=n) < 0.6
        js = jc.stack_push(js, jnp.asarray(m), jnp.asarray(pri[k]),
                           jnp.asarray(push))
        ts = tc.stack_push(ts, torch.as_tensor(m), torch.as_tensor(pri[k]),
                           torch.as_tensor(push))
        k = gen.integers(0, 4, n)
        rem = gen.uniform(size=n) < 0.3
        js = jc.stack_remove(js, jnp.asarray(mats[k]), jnp.asarray(rem))
        ts = tc.stack_remove(ts, torch.as_tensor(mats[k]),
                             torch.as_tensor(rem))
        np.testing.assert_array_equal(ts.stack.numpy(), np.asarray(js.stack))
        np.testing.assert_array_equal(ts.top.numpy(), np.asarray(js.top))
    return js, ts, mats


def test_medium_stack_matches_jax():
    gen = np.random.default_rng(12)
    js, ts, mats = _random_stacks(gen, 512)
    for a, b in zip(tc.dominant_medium(ts), jc.dominant_medium(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    excl = mats[gen.integers(0, 4, 512)]
    np.testing.assert_array_equal(
        tc.second_lowest_medium(ts, torch.as_tensor(excl)).numpy(),
        np.asarray(jc.second_lowest_medium(js, jnp.asarray(excl))))
    assert (ts.top.numpy() > 2).any()


def test_second_lowest_skips_priority_zero():
    """Reference quirk: the exit scan ignores priority-0 media (ice), so
    leaving glass inside ice reports air, not ice."""
    ts = tc.MediumStack.make(1, 99)
    ts = tc.stack_push(ts, torch.tensor([9]), torch.tensor([0]),
                       torch.tensor([True]))     # ice, priority 0
    ts = tc.stack_push(ts, torch.tensor([5]), torch.tensor([1]),
                       torch.tensor([True]))     # glass, priority 1
    assert int(tc.second_lowest_medium(ts, torch.tensor([5]))[0]) == 0
    mat, pri = tc.dominant_medium(ts)
    assert (int(mat[0]), int(pri[0])) == (9, 0)
    ts = tc.stack_remove(ts, torch.tensor([9]), torch.tensor([True]))
    assert ts.top.tolist() == [2]
    assert (ts.stack[0, 1].item() & 1023) == 5


def test_one_over_tensor_rounds_once():
    """`1.0 / t` (ops/bsdf.py, models/common.py) is PyTorch's reciprocal
    times 1.0, and the product by one is exact: bit-equal to the correctly
    rounded division true_div(1.0, t) and to float64's quotient rounded
    to float32, on random, tiny (subnormal) and huge floats of both
    signs."""
    from cudapathtracer_tpu_torch.utils.math import true_div
    gen = np.random.default_rng(29)
    x = np.concatenate([
        gen.uniform(-4.0, 4.0, 4096),
        gen.lognormal(0.0, 20.0, 4096) * gen.choice([-1.0, 1.0], 4096),
        np.float32(2.0 ** -149) * gen.integers(1, 2 ** 23, 1024),
        np.float32(2.0 ** 127) * gen.uniform(1.0, 1.99, 1024),
        [np.finfo(np.float32).tiny, np.finfo(np.float32).max, 1.0, -1.0,
         3.0, 0.1]]).astype(np.float32)
    t = torch.from_numpy(x)
    got = (1.0 / t).numpy().view(np.int32)
    np.testing.assert_array_equal(got, true_div(1.0, t).numpy().view(
        np.int32))
    with np.errstate(over="ignore"):   # 1 / a subnormal overflows to inf
        want = (1.0 / x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, want.view(np.int32))
