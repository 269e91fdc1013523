"""The hit fetch's record (scene.shade_table, K2) and the fused lobe
evaluation (K3) of the PyTorch port.

Scenes: the Cornell box with a small bunny (subdivisions 2), the
SDS-caustics scene of configs/vcm_caustics.rendertron (builtin
cornell_spheres: mirror and glass spheres), and the small bunny in the
textured MAT_LEAF material 13 with checker maps in the atlas windows of the
textured materials.

Tolerance:
- shade_table's fields, the light rows and mat_f32 against tri_f32: none
  (uint32 views equal); the light rows decide that a 64-byte record (no
  emission, area or light normal of its own) holds everything a hit needs;
- the plain shade_data on shade_table against the JAX package's
  lanemajor.shade_dataT (XLA:CPU) on the same hits: the ids, backface,
  emission and material fields exact, and area on light hits (the only
  ones that read it: the NEE counter-pdf); point, normal, normal_a and uv
  within rtol 1e-6, atol 1e-6, as tests/test_lanemajor.py holds
  shade_dataT to the row-major fetch (the same float32 operations);
- ops/bsdf.bsdf_eval against bsdf_f and bsdf_pdf both ways: none (bit
  for bit) for all five material types.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.ops import lanemajor as lm
from cudapathtracer_tpu.ops.traverse import Hit as JHit
from cudapathtracer_tpu.scene import builtin as jbuiltin
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu_torch.ops import bsdf, traverse
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.materials import (MAT_DELTAMIRROR,
                                                      MAT_DIFFUSE, MAT_LEAF,
                                                      MAT_METAL,
                                                      MAT_SMOOTHDIELECTRIC,
                                                      MaterialTable,
                                                      builtin_materials)
from cudapathtracer_tpu_torch.scene.scene import build_scene
from test_torch_common import _one_thread  # noqa: F401  (autouse)

N = 1024


def _atlas():
    """Two 64x64 checker maps and the four texture windows."""
    a = builtin.checker_texture(64)
    b = builtin.checker_texture(64, (0.8, 0.3, 0.1), (0.1, 0.7, 0.2))
    wins = [(0, 64, 64), (4096, 64, 64), (4096, 64, 64), (0, 64, 64)]
    return np.concatenate([a, b]).astype(np.float32), wins


# name -> (JAX mesh, port mesh, textured)
SCENES = {
    "bunny": (lambda: jbuiltin.cornell_with_bunny(subdivisions=2),
              lambda: builtin.cornell_with_bunny(subdivisions=2), False),
    "caustics": (jbuiltin.cornell_with_spheres, builtin.cornell_with_spheres,
                 False),
    "leaf_textured": (
        lambda: jbuiltin.cornell_with_bunny(subdivisions=2, bunny_mat=13),
        lambda: builtin.cornell_with_bunny(subdivisions=2, bunny_mat=13),
        True),
}


def _scene(name):
    _, tmesh, textured = SCENES[name]
    tex, wins = _atlas() if textured else (None, None)
    sc, _ = build_scene(tmesh(), builtin_materials(wins), tex, device="cpu")
    return sc


def _u32(t):
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shade_table_fields(name):
    sc = _scene(name)
    tri, rec = sc.tri_f32, sc.shade_table
    assert rec.shape == (sc.num_triangles, 16)
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    assert rec.data_ptr() % 16 == 0
    # normals and uvs: the JAX shade row's columns 0:15 (tri_f32 28:43)
    np.testing.assert_array_equal(_u32(rec[:, 0:15]), _u32(tri[:, 28:43]))
    word = rec[:, 15].contiguous().view(torch.int32)
    ids = tri[:, 76:78].contiguous().view(torch.int32)
    torch.testing.assert_close(word & 1023, ids[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(word >> 10, ids[:, 1], rtol=0, atol=0)
    # the material of every triangle by id: the shade row's columns 20:46
    np.testing.assert_array_equal(_u32(sc.mat_f32[word & 1023]),
                                  _u32(tri[:, 48:74]))
    if name == "leaf_textured":
        mat = sc.mat_f32[word & 1023].contiguous().view(torch.int32)
        assert bool((mat[:, 0] == MAT_LEAF).any())
        assert bool((mat[:, 20] >= 0).any())   # an albedo map is read


@pytest.mark.parametrize("name", sorted(SCENES))
def test_light_rows_equal_triangles(name):
    """Every emissive triangle's light row holds its vertex-a normal,
    emission and area, and no other triangle emits: so the record needs no
    emission, area or light normal of its own (64 bytes, not 80)."""
    sc = _scene(name)
    tri = sc.tri_f32
    light = tri[:, 77].contiguous().view(torch.int32)
    lit = light >= 0
    assert int(lit.sum()) > 0
    rows = sc.light_f32[light[lit].long()]
    np.testing.assert_array_equal(_u32(rows[:, 9:12]), _u32(tri[lit, 28:31]))
    np.testing.assert_array_equal(_u32(rows[:, 12:15]),
                                  _u32(tri[lit, 43:46]))
    np.testing.assert_array_equal(_u32(rows[:, 15:16]),
                                  _u32(tri[lit, 74:75]))
    assert bool((tri[~lit, 43:46] == 0.0).all())


def _rays(seed):
    """Half the rays in random directions, half up toward the light, from
    points inside the box."""
    gen = np.random.default_rng(seed)
    o = gen.uniform(-0.4, 0.4, (N, 3)).astype(np.float32)
    d = gen.normal(size=(N, 3))
    d[N // 2:, 1] = np.abs(d[N // 2:, 1]) + 4.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("name", ["bunny", "leaf_textured"])
def test_shade_data_matches_jax(name):
    jmesh, _, textured = SCENES[name]
    tex, wins = _atlas() if textured else (None, None)
    js, _ = jbuild_scene(jmesh(), jbuiltin_materials(wins), tex)
    sc = _scene(name)
    o, d = _rays(5)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    hit = traverse.closest_hit(sc, to, td)
    assert int(hit.valid.sum()) > N // 2
    info, mat = traverse.shade_data(sc, to, td, hit)
    jhit = JHit(t=jnp.asarray(hit.t.numpy()), tri=jnp.asarray(hit.tri.numpy()),
                u=jnp.asarray(hit.u.numpy()), v=jnp.asarray(hit.v.numpy()))
    jinfo, jmat = lm.shade_dataT(js, jnp.asarray(o).T, jnp.asarray(d).T, jhit)
    ok = hit.valid.numpy()
    light = info["light_ind"].numpy()
    assert (light[ok] >= 0).any() and (light[ok] < 0).any()
    for k in ("light_ind", "mat_id", "backface"):
        np.testing.assert_array_equal(info[k].numpy()[ok],
                                      np.asarray(jinfo[k])[ok], err_msg=k)
    np.testing.assert_array_equal(info["emission"].numpy()[ok],
                                  np.asarray(jinfo["emission"]).T[ok])
    on = ok & (light >= 0)
    np.testing.assert_array_equal(info["area"].numpy()[on],
                                  np.asarray(jinfo["area"])[on])
    for k in ("point", "normal", "normal_a", "uv"):
        np.testing.assert_allclose(info[k].numpy()[ok],
                                   np.asarray(jinfo[k]).T[ok], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for f in lm.MatT._fields:
        got = getattr(mat, f).numpy()[ok]
        want = np.asarray(getattr(jmat, f))
        want = (want.T if want.ndim == 2 else want)[ok]
        np.testing.assert_array_equal(got, want, err_msg=f)


def _mat_rows(mtype, gen):
    f = lambda *s: torch.as_tensor(gen.uniform(0.05, 0.95, s),
                                   dtype=torch.float32)
    i = lambda v: torch.full((N,), v, dtype=torch.int32)
    return MaterialTable(
        type=i(mtype), albedo=f(N, 3), roughness=f(N), eta=f(N, 3) * 2.0,
        k=f(N, 3) * 4.0, ior=1.0 + f(N), transmission=f(N),
        is_specular=torch.zeros(N, dtype=torch.bool),
        boundary=torch.zeros(N, dtype=torch.bool),
        thin_walled=torch.zeros(N, dtype=torch.bool), absorption=f(N, 3),
        priority=i(0), tex_start=i(-1), tex_width=i(0), tex_height=i(0),
        trans_tex_start=i(-1), trans_tex_width=i(0), trans_tex_height=i(0))


@pytest.mark.parametrize("mtype", [MAT_DIFFUSE, MAT_METAL,
                                   MAT_SMOOTHDIELECTRIC, MAT_LEAF,
                                   MAT_DELTAMIRROR])
def test_bsdf_eval_bit_equal(mtype):
    gen = np.random.default_rng(100 + mtype)
    mat = _mat_rows(mtype, gen)
    dirs = []
    for _ in range(2):
        v = gen.normal(size=(N, 3))
        dirs.append(torch.as_tensor(v / np.linalg.norm(v, axis=1,
                                                       keepdims=True),
                                    dtype=torch.float32))
    wi, wo = dirs
    albedo = mat.albedo
    eta_i = torch.as_tensor(gen.choice([1e-5, 1.0, 1.333, 1.5], N),
                            dtype=torch.float32)
    trans = mat.transmission * 0.5
    f, pdf, pdf_rev = bsdf.bsdf_eval(mat, albedo, wi, wo, eta_i, trans)
    want = (bsdf.bsdf_f(mat, albedo, wi, wo, eta_i, trans),
            bsdf.bsdf_pdf(mat, wi, wo, eta_i, trans),
            bsdf.bsdf_pdf(mat, wo, wi, eta_i, trans))
    for name, got, ref in zip(("f", "pdf", "pdf_rev"), (f, pdf, pdf_rev),
                              want):
        np.testing.assert_array_equal(_u32(got), _u32(ref), err_msg=name)
    if mtype in (MAT_METAL, MAT_LEAF):   # both sides and a nonzero lobe
        assert bool((f != 0).any()) and bool((pdf != pdf_rev).any())
