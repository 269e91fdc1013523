"""The threaded binary engine of the PyTorch port (traversal="threaded",
kernel K15's plain version in ops/traverse.py) against the JAX package's
threaded engine and the brute-force oracle, on ~4k numpy rays over three
scenes (the last one MAT_LEAF, so shadow transmission is covered), and the
classic integrators on a threaded scene.

Tolerances (those of tests/test_torch_traverse8.py):
  * triangle ids equal on >= 99.99% of rays, and every mismatch an edge
    tie (|dt| <= 1e-5 t): XLA:CPU may fuse a*b+c where PyTorch rounds twice,
    which can move u, v by an ulp at a shared edge;
  * t, u, v within atol 1e-5 where the ids match;
  * shadow scale within atol 1e-5 (a product of a few float32 factors).
The links mirror tests/test_bvh.py (every node once per octant, miss links
leave the subtree) and the engines' agreement tests/test_traverse8.py (the
same hit flags, t within rtol 1e-5, shadow within atol 1e-5). Integrators
on a threaded cornell_with_blocks: classic unidirectional within rmse 1e-3
of tests/golden/cornell_uni_16x16_8spp.npy (built on the default SBVH
scene; the image does not depend on the tree up to edge ties); naive,
BIDIRECTIONAL, VCM and SPPM (classic) one 16x16 sample equal to the BVH8
engine on the same scene (image mean within 1e-3 relative, >= 99% of the
pixels within rtol 1e-3, rays within 0.1%); one VCM-mega sample against
JAX's on its threaded scene (tests/test_torch_vcm_mega.py's bound: >= 99%
of the pixels within 2^-8 max_c + 1e-4 |x| + 1e-5, mean within 1e-3).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import vcm as jvcm
from cudapathtracer_tpu.models import vcm_mega as jvcm_mega
from cudapathtracer_tpu.ops import traverse as jt
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import (bdpt, naive, unidirectional, vcm,
                                             vcm_mega)
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.ops.intersect import (brute_force_closest_hit,
                                                    moller_trumbore)
from cudapathtracer_tpu_torch.scene import builtin as tbuiltin
from cudapathtracer_tpu_torch.scene import bvh as tbvh
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.image import rmse

N = 1400  # rays per scene
SCENES = {
    "blocks": builtin.cornell_with_blocks,
    "bunny2": lambda: builtin.cornell_with_bunny(subdivisions=2),
    "bunny2_leaf": lambda: builtin.cornell_with_bunny(subdivisions=2,
                                                      bunny_mat=13),
}
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "cornell_uni_16x16_8spp.npy")


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain walks issue many small operators; when the suite runs in
    parallel workers, their intra-op threads oversubscribe the cores and
    slow them many times over, so these tests run on one thread and
    restore the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    mesh_fn = SCENES[request.param]
    js, _ = jbuild_scene(mesh_fn(), jbuiltin_materials(),
                         traversal="threaded")
    ts, _ = build_scene(mesh_fn(), builtin_materials(), traversal="threaded",
                        device="cpu")
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
    full = traverse.closest_hit(ts, torch.as_tensor(o), torch.as_tensor(d))
    # skip_tri: a third of the rays ignore the triangle they hit
    skip = np.where(gen.uniform(size=N) < 0.33, full.tri.numpy(),
                    -1).astype(np.int32)
    jh = jt.closest_hit(js, jnp.asarray(o), jnp.asarray(d),
                        max_t=jnp.asarray(max_t), skip_tri=jnp.asarray(skip),
                        active=jnp.asarray(active))
    kernels.reset_launches()
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


def test_closest_matches_brute_force(case):
    name, js, ts, o, d, max_t, active, gen = case
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    th = traverse.closest_hit(ts, to, td, max_t=torch.as_tensor(max_t))
    bt, btri, bu, bv = brute_force_closest_hit(
        to, td, ts.tri_v0, ts.tri_e1, ts.tri_e2,
        max_t=torch.as_tensor(max_t))
    tri, btri = th.tri.numpy(), btri.numpy()
    np.testing.assert_array_equal(tri >= 0, btri >= 0)
    m = tri >= 0
    np.testing.assert_allclose(th.t.numpy()[m], bt.numpy()[m], rtol=0,
                               atol=1e-5)
    # the reported triangle is hit at the closest distance (coplanar faces
    # and shared edges tie with another id)
    rows = ts.tri_f32[torch.clamp(th.tri, min=0)]
    mt_t, _, _, ok = moller_trumbore(to, td, rows[:, 0:3], rows[:, 3:6],
                                     rows[:, 6:9])
    assert ok.numpy()[m].all()
    np.testing.assert_allclose(mt_t.numpy()[m], bt.numpy()[m], rtol=0,
                               atol=1e-5)


def test_shadow_matches_jax(case):
    name, js, ts, o, d, max_t, active, gen = case
    mt = np.minimum(max_t, gen.uniform(0.1, 2.0, N)).astype(np.float32)
    want = np.asarray(jt.shadow_factor(js, jnp.asarray(o), jnp.asarray(d),
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


@pytest.mark.parametrize("case", ["bunny2_leaf"], indirect=True)
def test_plain_counts(case):
    """with_counts leaves the results alone and counts what K15 does: a
    row per visited node (none for an inactive ray), at most leaf_k
    triangle tests a row (on the MAT_LEAF scene, so the shadow walk's
    transmission path is counted too)."""
    name, js, ts, o, d, max_t, active, gen = case
    k, nodes = ts.max_leaf_size, ts.node_packed.shape[0]
    to, td, tm, ta = (torch.as_tensor(a) for a in (o, d, max_t, active))
    skip = torch.full((N,), -1, dtype=torch.int32)
    base = traverse.closest_hit_bin_plain(ts.bin_table, nodes, to, td, tm,
                                          skip, ta)
    *hit, rows, tests = traverse.closest_hit_bin_plain(
        ts.bin_table, nodes, to, td, tm, skip, ta, with_counts=True)
    for a, b in zip(base, hit):
        assert torch.equal(a, b)
    assert (rows[~ta] == 0).all() and (rows[ta] >= 1).all()
    assert (tests <= k * rows).all() and tests.sum() > 0
    args = (ts.bin_table, nodes, ts.tri_f32, to, td, tm, skip, ta)
    scale, srows, stests = traverse.shadow_factor_bin_plain(
        *args, with_counts=True)
    assert torch.equal(scale, traverse.shadow_factor_bin_plain(*args))
    assert (srows[~ta] == 0).all() and (stests <= k * srows).all()


def _node_packed_walk(nodes, leaf_k, tri_f32, o, d, max_t, skip, active,
                      shadow):
    """A reference walk over the JAX package's node_packed (its row
    layout, K15's design before the derived tables): the JAX threaded
    step's row semantics (box, octant links, all leaf_k slots folded in
    slot order), one row a step for the rays in flight -> (results, rows
    a ray, triangle tests a ray)."""
    from cudapathtracer_tpu_torch.ops.traverse8 import leaf_factor
    n = o.shape[0]
    inv_d = traverse.safe_inv_dir(d)
    octs = traverse._octant(d)
    cur = torch.where(active, 0, -1).to(torch.int32)
    t_best, scale = max_t.clone(), torch.ones((n, 3))
    tri = torch.full((n,), -1, dtype=torch.int32)
    u, v = torch.zeros(n), torch.zeros(n)
    rows = torch.zeros(n, dtype=torch.int32)
    tests = torch.zeros(n, dtype=torch.int32)
    with_leaf = tri_f32 is not None and tri_f32.shape[1] >= 94
    ids_at = 24 + 9 * leaf_k
    while (cur >= 0).any():
        live = torch.nonzero(cur >= 0)[:, 0]
        rows[live] += 1
        row = nodes[cur[live].long()]
        irow = row.view(torch.int32)
        tmin, _, hit = traverse.aabb_intersect(o[live], inv_d[live],
                                               row[:, 0:3], row[:, 3:6])
        hit = hit & (tmin < (max_t[live] if shadow else t_best[live]))
        oc = octs[live][:, None]
        count = irow[:, 22]
        nxt = torch.where(hit & (count == 0), irow.gather(1, 6 + oc)[:, 0],
                          irow.gather(1, 14 + oc)[:, 0])
        blocked = torch.zeros(live.numel(), dtype=torch.bool)
        for k in range(leaf_k):
            on = hit & (count > k) & ~blocked
            lane = live[on]
            tests[lane] += 1
            tv = row[on, 24 + 9 * k:33 + 9 * k]
            raw = irow[on, ids_at + k]
            tid = torch.where(raw < 0, -1, raw & ~traverse.LEAF_MAT_FLAG)
            tt, uu, vv, ok = traverse.moller_trumbore(
                o[lane], d[lane], tv[:, 0:3], tv[:, 3:6], tv[:, 6:9])
            ok = ok & (tid >= 0) & (tid != skip[lane])
            if not shadow:
                ok = ok & (tt < t_best[lane])
                t_best[lane] = torch.where(ok, tt, t_best[lane])
                tri[lane] = torch.where(ok, tid, tri[lane])
                u[lane] = torch.where(ok, uu, u[lane])
                v[lane] = torch.where(ok, vv, v[lane])
                continue
            ok = ok & (tt < max_t[lane])
            stop = ok
            if with_leaf:
                lm = (raw & traverse.LEAF_MAT_FLAG) != 0
                scale[lane] = torch.where(
                    (ok & lm)[:, None], scale[lane] * leaf_factor(
                        tri_f32, d[lane], uu, vv, tid), scale[lane])
                stop = ok & (~lm | (scale[lane].amax(dim=1) < 0.01))
            scale[lane[stop]] = 0.0
            blocked[torch.nonzero(on)[:, 0][stop]] = True
        cur[live] = torch.where(blocked, -1, nxt)
    return ((scale,) if shadow else (t_best, tri, u, v)), rows, tests


def test_threaded_table_fields(case):
    """bin_table, derived from the JAX package's node_packed, holds its
    fields: per node the box and, per octant, the miss link and (inner
    nodes) the hit link or (leaves) -2 - the first triangle's slot; per
    leaf, its triangles in slot order (v0, e1, e2, id word) with the last
    one flagged. The port's scene derives the same table at upload."""
    name, js, ts, *_ = case
    nodes = torch.from_numpy(np.asarray(js.node_packed).copy())
    m, k = nodes.shape[0], js.max_leaf_size
    table = traverse.threaded_table(nodes, k)
    assert torch.equal(table.view(torch.int32), ts.bin_table.view(torch.int32))
    head, tris = traverse.bin_tables(table, m)
    ihead, itris = head.view(torch.int32), tris.view(torch.int32)
    inodes = nodes.view(torch.int32)
    count = inodes[:, 22]
    first = torch.cumsum(count, 0) - count
    assert itris.shape[0] == int(count.sum())
    leaf = count > 0
    assert torch.equal(ihead[:, 0:6], inodes[:, 0:6])
    assert (ihead[:, 6:8] == 0).all()
    for o in range(8):
        hit, miss = ihead[:, 8 + 2 * o], ihead[:, 9 + 2 * o]
        assert torch.equal(miss, inodes[:, 14 + o])
        assert torch.equal(hit[~leaf], inodes[~leaf, 6 + o])
        assert torch.equal(hit[leaf], -2 - first[leaf])
        assert (hit[~leaf] >= 0).all()
    for j in range(int(count.max())):
        sel = count > j
        slot = (first + j)[sel].long()
        assert torch.equal(itris[slot, 0:9],
                           inodes[sel, 24 + 9 * j:33 + 9 * j])
        assert torch.equal(itris[slot, 9], inodes[sel, 24 + 9 * k + j])
        assert torch.equal(itris[slot, 10],
                           (count[sel] == j + 1).to(torch.int32))
    assert (itris[:, 11] == 0).all()


def test_plain_walk_matches_node_packed_walk(case):
    """The plain K15 walk over bin_table visits the rows a walk of the
    JAX package's node_packed visits, makes the same triangle tests and
    gives the same results bit for bit, closest (with max_t, skip_tri and
    inactive rays) and shadow (MAT_LEAF transmission on bunny2_leaf);
    test_closest_matches_jax and test_shadow_matches_jax hold those
    results to the JAX engine."""
    name, js, ts, o, d, max_t, active, gen = case
    nodes = torch.from_numpy(np.asarray(js.node_packed).copy())
    m = nodes.shape[0]
    to, td, tm, ta = (torch.as_tensor(a) for a in (o, d, max_t, active))
    skip = torch.as_tensor(np.where(gen.uniform(size=N) < 0.33,
                                    gen.integers(0, ts.num_triangles, N),
                                    -1).astype(np.int32))
    for shadow in (False, True):
        tri = ts.tri_f32 if shadow else None
        want, rows, tests = _node_packed_walk(nodes, js.max_leaf_size, tri,
                                              to, td, tm, skip, ta, shadow)
        args = (ts.bin_table, m) + ((tri,) if shadow else ()) + (
            to, td, tm, skip, ta)
        fn = (traverse.shadow_factor_bin_plain if shadow
              else traverse.closest_hit_bin_plain)
        *got, grows, gtests = fn(*args, with_counts=True)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(grows, rows) and torch.equal(gtests, tests)
        assert rows[ta].float().mean() > 3.0


def _tree(n=200, leaf=2, seed=0):
    """The port's SAH build with links on random small triangles (the
    triangles of tests/test_bvh.py)."""
    rs = np.random.RandomState(seed)
    p0 = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    p1 = p0 + rs.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    p2 = p0 + rs.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    return tbvh.build_bvh(*tbvh.triangle_bounds(p0, p1, p2), leaf,
                          use_native=False)


def test_threaded_links_visit_every_node():
    """Following hit links everywhere enumerates the whole tree exactly
    once per octant (tests/test_bvh.py, on the port's copy)."""
    bvh = _tree(200, 1)
    for o in range(8):
        seen, cur = [], 0
        while cur != -1:
            seen.append(cur)
            is_leaf = bvh.leaf[cur, 1] > 0
            cur = int(bvh.links[cur, o, 1] if is_leaf
                      else bvh.links[cur, o, 0])
        assert sorted(seen) == list(range(bvh.num_nodes))


def test_miss_links_skip_subtrees():
    bvh = _tree(200, 2)

    def subtree(n):
        out, stack = set(), [n]
        while stack:
            x = stack.pop()
            out.add(x)
            if bvh.leaf[x, 1] == 0:
                stack += [bvh.left[x], bvh.right[x]]
        return out

    for o in range(8):
        for n in range(bvh.num_nodes):
            miss = bvh.links[n, o, 1]
            if miss != -1:
                assert miss not in subtree(n)


@pytest.mark.parametrize("mesh_fn", [tbuiltin.cornell_with_blocks,
                                     tbuiltin.cornell_with_spheres])
def test_bvh8_matches_threaded(mesh_fn):
    """The two engines agree on random rays (tests/test_traverse8.py), each
    on its own default tree."""
    s8, _ = build_scene(mesh_fn(), builtin_materials(), device="cpu")
    sb, _ = build_scene(mesh_fn(), builtin_materials(), traversal="threaded",
                        device="cpu")
    rs = np.random.RandomState(3)
    o = torch.as_tensor(rs.uniform(-0.45, 0.45, (512, 3)), dtype=torch.float32)
    d = torch.as_tensor(rs.normal(size=(512, 3)), dtype=torch.float32)
    d = d / d.norm(dim=1, keepdim=True)
    h8, hb = traverse.closest_hit(s8, o, d), traverse.closest_hit(sb, o, d)
    np.testing.assert_array_equal(h8.tri.numpy() >= 0, hb.tri.numpy() >= 0)
    m = h8.tri.numpy() >= 0
    np.testing.assert_allclose(h8.t.numpy()[m], hb.t.numpy()[m], rtol=1e-5)
    np.testing.assert_allclose(traverse.shadow_factor(s8, o, d, 0.6).numpy(),
                               traverse.shadow_factor(sb, o, d, 0.6).numpy(),
                               atol=1e-5)
# --- the classic integrators on a threaded scene ----------------------------

# --- the classic integrators on a threaded scene ------------------------------

@pytest.fixture(scope="module")
def blocks():
    """cornell_with_blocks threaded, the same scene read by the BVH8
    engine (its bvh8_table is the collapse of the same tree), a 16x16
    pinhole camera and its pixels."""
    ts, _ = build_scene(tbuiltin.cornell_with_blocks(), builtin_materials(),
                        traversal="threaded", device="cpu")
    cam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    gy, gx = torch.meshgrid(torch.arange(16, dtype=torch.int32),
                            torch.arange(16, dtype=torch.int32),
                            indexing="ij")
    return ts, dataclasses.replace(ts, traversal="bvh8"), cam, \
        gx.reshape(-1), gy.reshape(-1)


def test_trace_fused_is_the_two_calls(blocks):
    """trace_fused on a threaded scene: closest lanes equal closest_hit's,
    shadow lanes equal shadow_factor's (the JAX threaded form), and the
    other lanes' results are a miss and a clear shadow."""
    ts = blocks[0]
    gen = np.random.default_rng(5)
    to = torch.as_tensor(gen.uniform(-0.45, 0.45, (512, 3)),
                         dtype=torch.float32)
    td = torch.as_tensor(gen.normal(size=(512, 3)), dtype=torch.float32)
    td = td / td.norm(dim=1, keepdim=True)
    tm = torch.as_tensor(gen.uniform(0.1, 2.0, 512), dtype=torch.float32)
    is_sh = torch.as_tensor(gen.uniform(size=512) < 0.5)
    act = torch.as_tensor(gen.uniform(size=512) > 0.1)
    hit, scale = traverse.trace_fused(ts, to, td, tm, is_sh, active=act)
    ch = traverse.closest_hit(ts, to, td, max_t=tm, active=act & ~is_sh)
    sf = traverse.shadow_factor(ts, to, td, tm, active=act & is_sh)
    for a, b in zip(hit, ch):
        assert torch.equal(a, b)
    assert torch.equal(scale, sf)
    assert (hit.tri[is_sh] == -1).all() and (scale[~is_sh] == 1.0).all()


def test_unidirectional_golden_threaded(blocks):
    ts, _, cam, px, py = blocks
    acc = torch.zeros((256, 3))
    for s in range(8):
        li, _ = unidirectional.render_sample(ts, cam, rng.base_key(), s, px,
                                             py, max_depth=6)
        acc += li
    err = rmse((acc / 8).numpy(), np.load(GOLDEN))
    assert err < 1e-3, f"golden drift on the threaded scene: rmse={err:.2e}"


def _render(name, scene, cam, px, py):
    if name == "naive":
        return naive.render_sample(scene, cam, rng.base_key(), 1, px, py,
                                   max_depth=4)
    if name == "bdpt":
        return bdpt.render_sample(scene, cam, rng.base_key(), 1, px, py,
                                  cfg=bdpt.BDPTConfig(eye_depth=3,
                                                      light_depth=3))
    cfg = vcm.VCMConfig(eye_depth=3, light_depth=3)
    if name == "sppm":
        cfg = dataclasses.replace(cfg, light_trace=False, nee=False,
                                  naive=False, connection=False,
                                  do_mis=False, do_sppm=True)
    return vcm.render_sample(scene, cam, rng.base_key(), 1, px, py, cfg=cfg)


@pytest.mark.parametrize("name", ["naive", "bdpt", "vcm", "sppm"])
def test_classic_threaded_equals_bvh8(blocks, name):
    ts, t8, cam, px, py = blocks
    got, want = _render(name, ts, cam, px, py), _render(name, t8, cam, px, py)
    g, w = got[0].numpy(), want[0].numpy()
    assert np.isfinite(g).all() and g.max() > 0.0
    assert abs(g.mean() / w.mean() - 1.0) < 1e-3
    close = np.isclose(g, w, rtol=1e-3, atol=1e-6).all(axis=1)
    assert close.mean() >= 0.99
    assert abs(got[1] - want[1]) <= 1e-3 * want[1]


def test_vcm_mega_threaded_matches_jax(blocks):
    """The mega eye pass stays on BVH8 (JAX's make_fused_step) while the
    light walk and the splat follow the threaded scene."""
    ts, _, cam, px, py = blocks
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials(),
                         traversal="threaded")
    jc = JCamera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    jcfg = jvcm.VCMConfig(eye_depth=3, light_depth=3)
    jli, jrays, jdrop = jvcm_mega.render_sample(
        js, jc, jrng.base_key(), 1, jnp.asarray(px.numpy()),
        jnp.asarray(py.numpy()), cfg=jcfg, steps_per_iter=2, mini_splits=1,
        count_merge_dropped=True)
    li, rays, dropped = vcm_mega.render_sample(
        ts, cam, rng.base_key(), 1, px, py,
        cfg=vcm.VCMConfig(eye_depth=3, light_depth=3))
    got, want = li.numpy(), np.asarray(jli)
    maxc = np.maximum(got.max(axis=1), want.max(axis=1))[:, None]
    tol = 2.0 ** -8 * maxc + 1e-4 * np.abs(want) + 1e-5
    assert (np.abs(got - want) <= tol).all(axis=1).mean() >= 0.99
    assert abs(got.mean() / want.mean() - 1.0) < 1e-3
    assert abs(rays - int(jrays)) <= 1e-3 * int(jrays)
    assert dropped == int(jdrop)
