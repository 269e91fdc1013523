"""BVH8 traversal of the PyTorch port (kernel K1's plain version) against
the JAX package and against the brute-force oracle, on ~4k numpy rays over
three scenes (the last one MAT_LEAF, so shadow transmission is covered).

Tolerances:
  * triangle ids equal on >= 99.99% of rays, and every mismatch an edge
    tie (|dt| <= 1e-5 t): XLA:CPU may fuse a*b+c where PyTorch rounds twice,
    which can move u, v by an ulp at a shared edge;
  * t, u, v within atol 1e-5 where the ids match (u, v are 1/det-scaled);
  * shadow scale within atol 1e-5 (a product of a few float32 factors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.ops import traverse8 as jt8
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.ops import traverse8 as tt8
from cudapathtracer_tpu_torch.ops.intersect import (brute_force_closest_hit,
                                                    moller_trumbore)
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from test_torch_common import _one_thread  # noqa: F401  (autouse)

N = 1400  # rays per scene
SCENES = {
    "blocks": builtin.cornell_with_blocks,
    "bunny2": lambda: builtin.cornell_with_bunny(subdivisions=2),
    "bunny2_leaf": lambda: builtin.cornell_with_bunny(subdivisions=2,
                                                      bunny_mat=13),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    mesh_fn = SCENES[request.param]
    js, _ = jbuild_scene(mesh_fn(), jbuiltin_materials())
    ts, _ = build_scene(mesh_fn(), builtin_materials(), device="cpu")
    gen = np.random.default_rng(17)
    o = gen.uniform(-0.45, 0.45, (N, 3)).astype(np.float32)
    d = gen.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a third of the rays get a finite max_t, a tenth are inactive
    max_t = np.where(gen.uniform(size=N) < 0.33,
                     gen.uniform(0.05, 1.0, N), 999999.0).astype(np.float32)
    active = gen.uniform(size=N) > 0.1
    return request.param, js, ts, o, d, max_t, active, gen


def _check_hits(t, tri, u, v, t_ref, tri_ref, u_ref, v_ref):
    eq = tri == tri_ref
    assert eq.mean() >= 0.9999, f"ids equal on {eq.mean():.5f}"
    if not eq.all():   # edge ties only
        dt = np.abs(t[~eq] - t_ref[~eq])
        assert (dt <= 1e-5 * np.minimum(t[~eq], t_ref[~eq])).all()
    m = eq & (tri >= 0)
    for a, b in ((t, t_ref), (u, u_ref), (v, v_ref)):
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t[tri < 0], t_ref[tri < 0])


def test_closest_matches_jax(case):
    name, js, ts, o, d, max_t, active, gen = case
    full = jt8.closest_hit8(js, jnp.asarray(o), jnp.asarray(d))
    # skip_tri: a third of the rays ignore the triangle they hit
    skip = np.where(gen.uniform(size=N) < 0.33, np.asarray(full.tri),
                    -1).astype(np.int32)
    jh = jt8.closest_hit8(js, jnp.asarray(o), jnp.asarray(d),
                          max_t=jnp.asarray(max_t), skip_tri=jnp.asarray(skip),
                          active=jnp.asarray(active))
    th = traverse.closest_hit(ts, torch.as_tensor(o), torch.as_tensor(d),
                              max_t=torch.as_tensor(max_t),
                              skip_tri=torch.as_tensor(skip),
                              active=torch.as_tensor(active))
    _check_hits(th.t.numpy(), th.tri.numpy(), th.u.numpy(), th.v.numpy(),
                np.asarray(jh.t), np.asarray(jh.tri), np.asarray(jh.u),
                np.asarray(jh.v))
    assert (th.tri.numpy()[~active] == -1).all()
    assert (th.tri.numpy()[active] >= 0).mean() > 0.5
    assert (th.tri.numpy()[skip >= 0] != skip[skip >= 0]).all()
    assert sum(kernels.launches.values()) == 0   # CPU: plain version only


@pytest.mark.parametrize("fn", ["moller_trumbore", "aabb_intersect",
                                "safe_inv_dir"])
def test_intersect_matches_jax(fn):
    """The intersection twins on numpy rays and triangles/boxes; the same
    float32 formulas, so rtol/atol 1e-5 on t, u, v (compared where the
    reference reports a hit: random triangles include near-degenerate ones
    whose 1/det amplifies rounding) and equal hit masks except where a
    value sits within rounding of a test's bound."""
    from cudapathtracer_tpu.ops import intersect as ji
    from cudapathtracer_tpu_torch.ops import intersect as ti
    gen = np.random.default_rng(8)
    f32 = lambda *s: gen.normal(size=s).astype(np.float32)
    args = {"moller_trumbore": (f32(N, 3), f32(N, 3), f32(N, 3), f32(N, 3),
                                f32(N, 3)),
            "aabb_intersect": (f32(N, 3), f32(N, 3), f32(N, 3) - 1.0,
                               f32(N, 3) + 1.0),
            "safe_inv_dir": (np.concatenate([f32(N - 2, 3),
                                             np.zeros((2, 3), np.float32)]),)
            }[fn]
    want = getattr(ji, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(ti, fn)(*[torch.as_tensor(a) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    hit = np.asarray(want[-1]) if fn == "moller_trumbore" else Ellipsis
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if fn == "moller_trumbore" and g.dtype != np.bool_:
            g, w = g[hit], w[hit]
        if g.dtype == np.bool_:
            assert (g == w).mean() >= 0.999
            assert g.any() and not g.all()
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_closest_matches_brute_force(case):
    name, js, ts, o, d, max_t, active, gen = case
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    th = tt8.closest_hit8(ts, to, td, max_t=torch.as_tensor(max_t))
    bt, btri, bu, bv = brute_force_closest_hit(
        to, td, ts.tri_v0, ts.tri_e1, ts.tri_e2,
        max_t=torch.as_tensor(max_t))
    tri, btri = th.tri.numpy(), btri.numpy()
    np.testing.assert_array_equal(tri >= 0, btri >= 0)
    m = tri >= 0
    np.testing.assert_allclose(th.t.numpy()[m], bt.numpy()[m], rtol=0,
                               atol=1e-5)
    # the reported triangle is hit at the closest distance (coplanar faces,
    # shared edges and SBVH's duplicated references tie with another id)
    rows = ts.tri_f32[torch.clamp(th.tri, min=0)]
    mt_t, _, _, ok = moller_trumbore(to, td, rows[:, 0:3], rows[:, 3:6],
                                     rows[:, 6:9])
    assert ok.numpy()[m].all()
    np.testing.assert_allclose(mt_t.numpy()[m], bt.numpy()[m], rtol=0,
                               atol=1e-5)


def test_shadow_matches_jax(case):
    name, js, ts, o, d, max_t, active, gen = case
    mt = np.minimum(max_t, gen.uniform(0.1, 2.0, N)).astype(np.float32)
    want = np.asarray(jt8.shadow_factor8(js, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(mt),
                                         active=jnp.asarray(active)))
    got = traverse.shadow_factor(ts, torch.as_tensor(o), torch.as_tensor(d),
                                 torch.as_tensor(mt),
                                 active=torch.as_tensor(active)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[~active] == 1.0).all()
    occluded = (got.max(axis=1) == 0.0).mean()
    assert 0.0 < occluded < 1.0
    partial = ((got > 0.0) & (got < 1.0)).any(axis=1).mean()
    if name == "bunny2_leaf":
        assert partial > 0.0, "no ray crossed a MAT_LEAF triangle"
    else:
        assert partial == 0.0


_JAX_SMALL_STACK = """
import sys
import numpy as np, jax.numpy as jnp
from cudapathtracer_tpu.ops import traverse8
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.materials import builtin_materials
from cudapathtracer_tpu.scene.scene import build_scene
assert traverse8.STACK_D == 7
rays = np.load(sys.argv[1])
sc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=4),
                    builtin_materials())
h = traverse8.closest_hit8(sc, jnp.asarray(rays["o"]), jnp.asarray(rays["d"]))
np.savez(sys.argv[2], t=np.asarray(h.t), tri=np.asarray(h.tri))
"""


def test_stack_overflow_restart(monkeypatch, tmp_path):
    """Grazing rays overflow a 7-entry stack (the least the JAX push
    takes) on the ~5k-triangle bunny. A ray that lost entries restarts from
    the root with its tightened t_best, at most 3 times. The port must do
    what the JAX traversal does with the same stack depth (TPT_STACK_D is
    read when the JAX module is imported, hence the subprocess), and here
    the restarts recover every hit of the 16-entry stack."""
    import os
    import subprocess
    import sys
    ts, _ = build_scene(builtin.cornell_with_bunny(subdivisions=4),
                        builtin_materials(), device="cpu")
    gen = np.random.default_rng(3)
    o = gen.uniform(-0.49, 0.49, (2000, 3))
    o[:, 1] = gen.uniform(-0.5, -0.2, 2000)     # near the floor ...
    d = gen.normal(size=(2000, 3))
    d[:, 1] *= 0.05                             # ... nearly parallel to it
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    np.savez(tmp_path / "rays.npz", o=o, d=d)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, TPT_STACK_D="7", JAX_PLATFORMS="cpu",
               PYTHONPATH=repo)
    subprocess.run([sys.executable, "-c", _JAX_SMALL_STACK,
                    str(tmp_path / "rays.npz"), str(tmp_path / "jax.npz")],
                   check=True, env=env, cwd=repo, timeout=300)
    want = np.load(tmp_path / "jax.npz")

    to, td = torch.as_tensor(o), torch.as_tensor(d)
    ref = tt8.closest_hit8(ts, to, td)
    lost = []
    push = tt8._push

    def spy(*args):
        out = push(*args)
        lost.append(int(out[3].sum()))
        return out

    monkeypatch.setattr(tt8, "STACK_D", 7)
    monkeypatch.setattr(tt8, "_push", spy)
    small = tt8.closest_hit8(ts, to, td)
    assert sum(lost) > 0, "the 7-entry stack never overflowed"
    np.testing.assert_array_equal(small.tri.numpy(), ref.tri.numpy())
    np.testing.assert_array_equal(small.tri.numpy(), want["tri"])
    np.testing.assert_allclose(small.t.numpy(), want["t"], rtol=0, atol=1e-5)
