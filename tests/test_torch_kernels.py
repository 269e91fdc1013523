"""The port's CUDA kernels (kernels/csrc/*.cu) against their plain PyTorch
versions, and the wrappers' device rules.

The kernel tests need an NVIDIA card (sm_90a) and nvcc; they carry the
`cuda` marker and skip without a card:
    python -m pytest -m cuda tests/test_torch_kernels.py
chip_smoke.py makes the same comparisons at the main path's sizes.
Tolerances: K6 bit-equal; K7 max abs 1e-6; K1 triangle ids and restart
counts equal, t/u/v and shadow scale within 1e-5 (the kernels are built
with -fmad=false and follow the plain versions operation for operation);
K5 (render_unidirectional) and its test entry shade_eval under
chip_smoke.py's criteria (compare_render, compare_shade_eval): rays within
0.1%, image mean within 1e-3, >= 99% of pixels within rtol 1e-3; the
per-element bounds of tests/test_torch_bsdf.py. The BDPT kernels under
chip_smoke.py's criteria too: K10's codecs bit-equal (compare_codecs);
K12's walks with at most 0.1% of lanes diverged and each field within its
bound on >= 99.9% of the vertices (compare_walk); K11 and K13 on the same
buffers as their plain versions, rays within 0.1%, image mean within
1e-3, >= 99.9% (K11) and 99.5% (K13) of pixels within rtol 1e-3
(compare_image), at the defaults and with each strategy flag set and the
VCM d_vm chain on (compare_bdpt); the BDPT golden at rmse < 1e-3. The
photon family under chip_smoke.py's criteria too: K8's grid bit-equal to
build_grid's (compare_grid, also with a table above 2^24 buckets), the VCM
splat and the eye kernel on the same light buffers and grid as their plain
versions (compare_vcm: rays within 0.1%, image mean within 1e-3, >= 99.9%
and 99.5% of pixels within rtol 1e-3, dropped photons equal) for VCM,
SPPM and each merge mode; the VCM and SPPM goldens at rmse < 1e-3.
The modes added for samples per dispatch and the keyed light walk are
bit-equal to what they replace: K5 with k samples to k launches of one
sample summed in sample order (three schedules), K6's keyed mode to the
plain uniform_keyed and to uniform_id, K12's table mode to the folded walk
(every buffer field, vertex 0, rays). K5's path regeneration gives the
same bits on any grid (three schedules, both engines). K13 runs as two
launches (bdpt_pairs, bdpt_gather), checked under compare_bdpt.
The VCM eye passes run as three stage kernels (eye_walk.cu,
eye_connect.cu, eye_gather.cu): each stage against its plain twin on the
same inputs inside compare_vcm / compare_mega (the walk's records within
chip_smoke.compare_records' bounds, the connections and the gather under
compare_image), one pass = three launches (two without connections), the
gather bit-equal to its twin on hand-built terms whose float32 sum
depends on the order, and no host sync inside the passes. The
connection stage's queue holds its twin's slots (eye_connect_queue_plain),
and in each of the trace kernel's four instantiations each path's rays and
rows are exactly its twin's and conn exactly zero where nothing adds.
K15, the threaded engine (traversal="threaded"), as K1: triangle ids
equal, t/u/v and shadow scale within 1e-5 of its plain version; K5's
classic and naive schedules on a threaded scene under compare_render; on
such a scene ops/traverse launches K15's entries and none of K1's, and K5
visits other rows than on the BVH8 engine (its threaded instantiation).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import (bdpt, bdpt_mega, naive, paths,
                                             vcm, vcm_mega)
from cudapathtracer_tpu_torch.models import unidirectional as uni
from cudapathtracer_tpu_torch.models import unidirectional_mega as mega
from cudapathtracer_tpu_torch.ops import hashgrid, traverse, traverse8
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import packing, rng


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """test_torch_common._one_thread, defined here too: this module runs on
    the card, where JAX (which test_torch_common imports) is absent."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA for sm_90a)")
    kernels.build()
    return torch.device("cuda")


def test_import_builds_nothing():
    """Importing the port compiles nothing; the CPU path launches nothing."""
    import cudapathtracer_tpu_torch.driver  # noqa: F401
    assert not kernels._libs or torch.cuda.is_available()
    kernels.reset_launches()
    rng.uniform_id(rng.base_key(), 0, torch.arange(8, dtype=torch.int32))
    assert all(v == 0 for v in kernels.launches.values())


@pytest.mark.parametrize("call", ["uniform_id", "generate_rays",
                                  "closest_hit8", "shadow_factor8",
                                  "closest_hit_bin", "shadow_factor_bin",
                                  "render_unidirectional", "shade_eval",
                                  "packing_roundtrip", "bdpt_walk",
                                  "bdpt_splat", "bdpt_connect", "bdpt_pairs",
                                  "bdpt_gather", "vcm_splat",
                                  "photon_pack", "photon_table", "vcm_eye",
                                  "rgb9e5_roundtrip", "neighbor_slots",
                                  "mega_eye", "uniform_keyed",
                                  "vcm_eye_pass", "mega_eye_pass",
                                  "splat_pass"])
def test_wrappers_refuse_non_cuda_tensors(call):
    """A wrapper launches on CUDA tensors or raises; it never falls back."""
    kernels.reset_launches()
    n = 4
    f1 = torch.zeros(n)
    f3 = torch.zeros((n, 3))
    i1 = torch.zeros(n, dtype=torch.int32)
    scene = build_scene(builtin.cornell_box(), builtin_materials(),
                        device="cpu")[0]
    b1 = torch.zeros(n, dtype=torch.bool)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 2, 2, 0.0, 0.0, 0.0, 60.0)
    cfg = bdpt.BDPTConfig(eye_depth=3, light_depth=2)
    vcfg = vcm.VCMConfig(eye_depth=3, light_depth=1)
    bufs = paths.PathBuffers.empty(1, n, "cpu")
    v0 = dict(pt=f3, n=f3, beta=f3, pdf_fwd=f1, mat_id=i1)
    eye = dict(bufs=paths.PathBuffers.empty(2, n, "cpu"), v0=v0,
               escape=paths.Escape(b1, f3, f3))
    args = {
        "uniform_id": (i1, 1, 2, False),
        "generate_rays": (torch.zeros(n), torch.zeros(n), i1, [0.0] * 19,
                          [0] * 8),
        "closest_hit8": (torch.zeros((2, 96)), f3, f3, torch.zeros(n), i1,
                         None),
        "shadow_factor8": (torch.zeros((2, 96)), torch.zeros((2, 78)), f3,
                           f3, torch.zeros(n), i1, None),
        "closest_hit_bin": (torch.zeros((2, 48)), 2, f3, f3, torch.zeros(n),
                            i1, None),
        "shadow_factor_bin": (torch.zeros((2, 48)), 2, torch.zeros((2, 78)),
                              f3, f3, torch.zeros(n), i1, None),
        "render_unidirectional": (scene, i1, i1, [0.0] * 19, (0, 1), 0, 2),
        "shade_eval": (scene, f3, f3, f1, i1, f1, f1, i1, f1, [0] * 18),
        "packing_roundtrip": (f3, f3, b1, b1, i1, i1),
        "bdpt_walk": (scene, i1, i1, [0] * 12),
        "bdpt_splat": (scene, cam, bufs, v0, f3, i1, cfg),
        "splat_pass": (scene, cam, bufs, v0, f3, i1, cfg),
        "bdpt_connect": (scene, cam, (0, 1), eye, dict(bufs=bufs, v0=v0),
                         f3, i1, cfg),
        "bdpt_pairs": (scene, cam, (0, 1), eye, dict(bufs=bufs, v0=v0), i1,
                       cfg),
        "bdpt_gather": (scene, cam, eye, torch.zeros((2, 2, n, 3)), f3,
                        cfg),
        "vcm_splat": (scene, cam, bufs, f3, i1, vcfg, 1.0),
        "photon_pack": (bufs, (0.0, 0.0, 0.0), 0.1, 7),
        "photon_table": (torch.zeros((n, 8)), i1,
                         torch.zeros(n, dtype=torch.int64),
                         torch.zeros((8, 2), dtype=torch.int32)),
        "vcm_eye": (scene, cam, [0] * 12, bufs, None, None, i1, vcfg),
        "rgb9e5_roundtrip": (f3,),
        "neighbor_slots": (hashgrid.PhotonGrid(
            torch.zeros((16, 8)), torch.zeros((8, 2), dtype=torch.int32),
            (0.0, 0.0, 0.0), 0.1, 7), f3, 0.05, 4),
        "mega_eye": (scene, cam, [0] * 22, bufs, None, f3, i1, vcfg),
        "vcm_eye_pass": (scene, cam, [0] * 12, bufs, None, None, i1, vcfg),
        "mega_eye_pass": (scene, cam, [0] * 22, bufs, None, f3, i1, vcfg),
        "uniform_keyed": (i1, i1, i1),
    }[call]
    k5 = dict(max_depth=4, use_mis=True, sample_environment=False,
              schedule="mega", air_priority=99)
    kw = {"render_unidirectional": k5,
          "bdpt_walk": dict(mode="light", max_depth=2, rays=i1),
          "bdpt_connect": dict(px=i1, py=i1),
          "bdpt_pairs": dict(px=i1, py=i1),
          "vcm_eye": dict(px=i1, py=i1, merge_radius=0.1, eta_vcm=1.0,
                          merge_norm=1.0, one_brick=True,
                          reweight=True),
          "vcm_eye_pass": dict(px=i1, py=i1, merge_radius=0.1, eta_vcm=1.0,
                               merge_norm=1.0, one_brick=True,
                               reweight=True),
          "mega_eye_pass": dict(px=i1, py=i1, cnt=n, gbase=0,
                                flavor="vcm"),
          "neighbor_slots": dict(mode="slots", one_brick=True,
                                 reweight=True),
          "mega_eye": dict(px=i1, py=i1, cnt=n, gbase=0,
                           flavor="vcm")}.get(call, {})
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, call)(*args, **kw)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, call)(*meta, **kw)
    assert kernels.launches[{"rgb9e5_roundtrip": "rgb9e5",
                             "bdpt_connect": "bdpt_pairs",
                             "vcm_eye": "vcm_eye_walk",
                             "vcm_eye_pass": "vcm_eye_walk",
                             "mega_eye": "mega_eye_walk",
                             "mega_eye_pass": "mega_eye_walk",
                             "bdpt_splat": "bdpt_splat_bin",
                             "vcm_splat": "vcm_splat_bin",
                             "splat_pass": "bdpt_splat_bin"
                             }.get(call, call)] == 0


@pytest.mark.cuda
def test_k6_matches_plain(cuda):
    ids = torch.arange(0, (1079 << 14) + 1920, 997, dtype=torch.int32,
                       device=cuda)
    k0, k1 = rng.draw_key(rng.base_key(), 3)
    kernels.reset_launches()
    ku = rng.uniform_draw_key(k0, k1, ids, two=True)
    assert kernels.launches["uniform_id"] == 1
    pu = rng.uniform_draw_key_plain(k0, k1, ids, two=True)
    for a, b in zip(ku, pu):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_k7_matches_plain(cuda):
    w, h = 64, 48
    gy, gx = torch.meshgrid(torch.arange(h, device=cuda),
                            torch.arange(w, device=cuda), indexing="ij")
    px, py = gx.reshape(-1).float(), gy.reshape(-1).float()
    ids = rng.pixel_ids(gx.reshape(-1), gy.reshape(-1))
    key = rng.fold_in(rng.sample_key(rng.base_key(), 2), 2 ** 20)
    for cam in (Camera.pinhole((0.0, 0.0, 1.0), w, h, 5.0, -10.0, 0.0, 60.0),
                Camera.thin_lens((0.1, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 45.0,
                                 0.05, 1.3)):
        ko, kd = cam.generate_rays(key, px, py, ids)
        po, pd = cam.generate_rays_plain(key, px, py, ids)
        assert (ko - po).abs().max().item() <= 1e-6
        assert (kd - pd).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("bunny_mat", [2, 13])
def test_k1_matches_plain(cuda, bunny_mat):
    sc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=3,
                                                   bunny_mat=bunny_mat),
                        builtin_materials(), device=cuda)
    gen = np.random.default_rng(1)
    n = 20000
    o = torch.as_tensor(gen.uniform(-0.45, 0.45, (n, 3)), dtype=torch.float32,
                        device=cuda)
    d = torch.as_tensor(gen.normal(size=(n, 3)), dtype=torch.float32,
                        device=cuda)
    d = d / d.norm(dim=1, keepdim=True)
    mt = torch.as_tensor(gen.uniform(0.05, 2.0, n), dtype=torch.float32,
                         device=cuda)
    skip = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    active = torch.as_tensor(gen.uniform(size=n) < 0.9, device=cuda)
    k = traverse8.closest_hit8(sc, o, d, mt, skip, active)
    p = traverse8.closest_hit8_plain(sc.bvh8_table, o, d, mt, skip, active)
    assert torch.equal(k.tri, p[1])
    m = k.tri >= 0
    for a, b in zip(k, p):
        if a.dtype == torch.float32:
            assert (a[m] - b[m]).abs().max().item() <= 1e-5
    ks = traverse8.shadow_factor8(sc, o, d, mt, skip, active)
    ps = traverse8.shadow_factor8_plain(sc.bvh8_table, sc.tri_f32, o, d, mt,
                                        skip, active)
    assert (ks - ps).abs().max().item() <= 1e-5


def grazing_rays(n=2000, seed=3):
    """Rays near the floor and nearly parallel to it: the rays of
    test_torch_traverse8.py::test_stack_overflow_restart, which overflow a
    7-entry stack on cornell_with_bunny(subdivisions=4)."""
    gen = np.random.default_rng(seed)
    o = gen.uniform(-0.49, 0.49, (n, 3))
    o[:, 1] = gen.uniform(-0.5, -0.2, n)
    d = gen.normal(size=(n, 3))
    d[:, 1] *= 0.05
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.cuda
def test_k1_stack_overflow_restart(cuda, monkeypatch):
    """A 7-entry build of traverse8.cu drives the ring and the restart
    from the root. On the grazing rays, whose plain version at 7 entries
    matches the JAX traversal at TPT_STACK_D=7 (test_torch_traverse8.py),
    rays overflow, and the kernel's restart counts, ids and t equal the
    plain version's at the same depth; the restarts recover every hit of
    the 16-entry kernel. Shadow rays through the same ring match too."""
    sc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=4),
                        builtin_materials(), device=cuda)
    o, d = (torch.as_tensor(a, device=cuda) for a in grazing_rays())
    n = o.shape[0]
    mt = torch.full((n,), 999999.0, device=cuda)
    skip = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    full = kernels.closest_hit8(sc.bvh8_table, o, d, mt, skip, None,
                                with_restarts=True)
    monkeypatch.setattr(traverse8, "STACK_D", 7)
    k = kernels.closest_hit8(sc.bvh8_table, o, d, mt, skip, None,
                             stack_d=7, with_restarts=True)
    p = traverse8.closest_hit8_plain(sc.bvh8_table, o, d, mt, skip, None,
                                     with_restarts=True)
    assert int((k[4] > 0).sum()) > 0, "the 7-entry stack never overflowed"
    assert int((full[4] > 0).sum()) == 0
    assert torch.equal(k[4], p[4])
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[1], full[1])
    m = k[1] >= 0
    assert (k[0][m] - p[0][m]).abs().max().item() <= 1e-5
    # the entry point builds and launches the depth traverse8.STACK_D names
    kernels.reset_launches()
    assert torch.equal(traverse8.closest_hit8(sc, o, d).tri, k[1])
    assert kernels.launches["closest_hit8"] == 1
    gen = np.random.default_rng(5)
    smt = torch.as_tensor(gen.uniform(0.1, 2.0, n), dtype=torch.float32,
                          device=cuda)
    ks = traverse8.shadow_factor8(sc, o, d, smt)
    ps = traverse8.shadow_factor8_plain(sc.bvh8_table, sc.tri_f32, o, d, smt,
                                        skip, None)
    assert (ks - ps).abs().max().item() <= 1e-5


def _grid(w, h, dev):
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=dev),
                            torch.arange(w, dtype=torch.int32, device=dev),
                            indexing="ij")
    return gx.reshape(-1).contiguous(), gy.reshape(-1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["mega", "classic"])
@pytest.mark.parametrize("name", ["blocks", "spheres", "leaf"])
def test_k5_matches_plain(cuda, name, schedule):
    mesh = {"blocks": builtin.cornell_with_blocks,
            "spheres": builtin.cornell_with_spheres,
            "leaf": lambda: builtin.cornell_with_bunny(3, bunny_mat=13)}[name]
    sc, _ = build_scene(mesh(), builtin_materials(), device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 96, 64, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(96, 64, cuda)
    kernels.reset_launches()
    k = uni.render_kernel(sc, cam, rng.base_key(), 1, px, py, max_depth=6,
                          use_mis=True, sample_environment=False,
                          schedule=schedule)
    assert kernels.launches["render_unidirectional"] == 1
    p = uni.render_plain(sc, cam, rng.base_key(), 1, px, py, max_depth=6,
                         schedule=schedule)
    chip_smoke.compare_render(k, p, f"{name} {schedule}")


@pytest.mark.cuda
@pytest.mark.parametrize("bunny_mat", [2, 13])
def test_shade_eval_matches_plain(cuda, bunny_mat):
    sc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=3,
                                                   bunny_mat=bunny_mat),
                        builtin_materials(), device=cuda)
    gen = np.random.default_rng(2)
    n = 50000
    o = torch.as_tensor(gen.uniform(-0.45, 0.45, (n, 3)), dtype=torch.float32,
                        device=cuda)
    d = torch.as_tensor(gen.normal(size=(n, 3)), dtype=torch.float32,
                        device=cuda)
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    hit = traverse8.closest_hit8(sc, o, d)
    ids = torch.arange(n, dtype=torch.int32, device=cuda) * 191 + 5
    eta = torch.as_tensor(gen.choice([1e-5, 1.0, 1.5], n),
                          dtype=torch.float32, device=cuda)
    skey = rng.sample_key(rng.base_key(), 6)
    kernels.reset_launches()
    k = mega.shade_eval(sc, o, d, hit, ids, eta, skey)
    assert kernels.launches["shade_eval"] == 1
    p = mega.shade_eval_plain(sc, o, d, hit, ids, eta, skey)
    chip_smoke.compare_shade_eval(sc, d, hit, k, p, eta,
                                  rng.uniform_id(skey, 4, ids),
                                  rng.uniform_id(skey, 6, ids), "test")


@pytest.mark.cuda
def test_k10_matches_plain(cuda):
    gen = np.random.default_rng(8)
    n = 200000
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=cuda)
    vec = t(gen.normal(size=(n, 3)))
    vec = (vec / vec.norm(dim=1, keepdim=True)).contiguous()
    beta = t(gen.lognormal(0.0, 6.0, (n, 3)))
    dl = t(gen.uniform(size=n) < 0.5, torch.bool)
    bf = t(gen.uniform(size=n) < 0.5, torch.bool)
    li = t(gen.integers(-1, 1 << 20, n), torch.int32)
    mi = t(gen.integers(0, 1024, n), torch.int32)
    kernels.reset_launches()
    k = kernels.packing_roundtrip(vec, beta, dl, bf, li, mi)
    assert kernels.launches["packing_roundtrip"] == 1
    o, h = packing.pack_oct(vec), packing.to_half3(beta)
    f = packing.pack_flags(dl, bf, li, mi)
    p = dict(oct=o, dec=packing.unpack_oct(o), half3=h,
             beta_dec=packing.from_half3(h), flags=f,
             unflags=torch.stack([x.to(torch.int32)
                                  for x in packing.unpack_flags(f)], dim=1))
    chip_smoke.compare_codecs(k, p, "test")


BDPT_CASES = ([(scene, "defaults") for scene in ("blocks", "spheres", "leaf")]
              + [("spheres", f) for f in sorted(chip_smoke.BDPT_FLAGS)]
              + [("spheres", "vcm_walk")])


@pytest.mark.cuda
@pytest.mark.parametrize("name,flags", BDPT_CASES)
def test_bdpt_kernels_match_plain(cuda, name, flags):
    """K12 (both walks), then K11 and K13 on the kernel walk's buffers,
    against their plain versions on the same inputs (chip_smoke's
    compare_bdpt): at the defaults on three scenes, then on the mirror +
    glass spheres with each strategy flag set in turn and with the light
    walk's VCM d_vm chain on."""
    mesh = {"blocks": builtin.cornell_with_blocks,
            "spheres": builtin.cornell_with_spheres,
            "leaf": lambda: builtin.cornell_with_bunny(3, bunny_mat=13)}[name]
    sc, _ = build_scene(mesh(), builtin_materials(), device=cuda)
    w, h = 96, 64
    cam = Camera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(w, h, cuda)
    cfg = dataclasses.replace(bdpt.BDPTConfig(eye_depth=6, light_depth=4),
                              **chip_smoke.BDPT_FLAGS.get(flags, {}))
    eta = chip_smoke.VCM_ETA if flags == "vcm_walk" else None
    kernels.reset_launches()
    chip_smoke.compare_bdpt(sc, cam, px, py, cfg,
                            bdpt.sample_keys(rng.base_key(), 2),
                            f"{name} {flags}", eta_vcm=eta)
    # K13's stages once each, then once more as the composed pass
    assert (kernels.launches["bdpt_walk"],
            kernels.launches["bdpt_splat_trace"],
            kernels.launches["bdpt_pairs"],
            kernels.launches["bdpt_gather"]) == (2, 1, 2, 2)


@pytest.mark.cuda
def test_bdpt_golden_on_card(cuda):
    import os
    sc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(16, 16, cuda)
    cfg = bdpt.BDPTConfig(eye_depth=6, light_depth=4)
    kernels.reset_launches()
    acc = torch.zeros((256, 3), device=cuda)
    for s in range(8):
        li, rays = bdpt.render_sample(sc, cam, rng.base_key(), s, px, py,
                                      cfg=cfg)
        acc += li
    assert kernels.launches["bdpt_pairs"] == 8
    assert kernels.launches["bdpt_gather"] == 8
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "golden", "cornell_bdpt_16x16_8spp.npy"))
    err = np.sqrt(np.mean(((acc / 8).cpu().numpy() - golden) ** 2))
    assert err < 1e-3, f"rmse {err:.3g}"


def _vcm_setup(name, cuda, w=96, h=64):
    mesh = {"blocks": builtin.cornell_with_blocks,
            "spheres": builtin.cornell_with_spheres}[name]
    sc, _ = build_scene(mesh(), builtin_materials(), device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    return sc, cam, *_grid(w, h, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("table", [None, 3 * 2 ** 23 + 7])
def test_photon_grid_matches_plain(cuda, table):
    """K8 on a VCM light walk's buffers against build_grid, bit for bit;
    the second case with a table above 2^24 buckets (the key wraps)."""
    sc, cam, px, py = _vcm_setup("blocks", cuda)
    cfg = vcm.VCMConfig(eye_depth=6, light_depth=4)
    size = None if table is None else hashgrid.photon_table_size(table // 2)
    key_l, _ = vcm.sample_keys(rng.base_key(), 3)
    mr, eta, _ = vcm.sample_scalars(sc, cfg, 3, px.shape[0])
    salt = hashgrid.photon_salt(3)
    lb = kernels.bdpt_walk(
        sc, px, py, paths.walk_keys(key_l, "light"), mode="light",
        max_depth=cfg.light_depth + 1,
        rays=torch.zeros(px.shape[0], dtype=torch.int32, device=cuda),
        eta_vcm=eta)["bufs"]
    kernels.reset_launches()
    kgrid = hashgrid.build_grid_kernel(lb, sc.scene_min, mr, salt, size)
    assert kernels.launches["photon_pack"] == 1
    assert kernels.launches["photon_table"] == 1
    assert kgrid.table_size == (size or hashgrid.photon_table_size(
        cfg.light_depth * px.shape[0]))
    rows, valid = hashgrid.photon_rows(lb)
    pgrid = hashgrid.build_grid(rows, valid, sc.scene_min, mr,
                                kgrid.table_size, salt=salt)
    chip_smoke.compare_grid(kgrid, pgrid, "grid test")


@pytest.mark.cuda
@pytest.mark.parametrize("table", [None, 3 * 2 ** 23 + 7])
def test_photon_rows_mode_matches_plain(cuda, table):
    """K8's rows mode on two tiles' photons gathered tile-major, as a (2,1)
    mesh gathers them: the pack-only photon_pack against
    hashgrid.photon_rows, photon_bucket against its plain version, the grid
    against build_grid, bit for bit; the second case with a table above
    2^24 buckets (the key wraps)."""
    sc, cam, px, py = _vcm_setup("blocks", cuda)
    cfg = vcm.VCMConfig(eye_depth=6, light_depth=4)
    key_l, _ = vcm.sample_keys(rng.base_key(), 3)
    mr, eta, _ = vcm.sample_scalars(sc, cfg, 3, px.shape[0])
    salt = hashgrid.photon_salt(3)
    half = px.shape[0] // 2
    rows, valid = [], []
    for sl in (slice(0, half), slice(half, None)):
        lb = kernels.bdpt_walk(
            sc, px[sl].clone(), py[sl].clone(),
            paths.walk_keys(key_l, "light"), mode="light",
            max_depth=cfg.light_depth + 1,
            rays=torch.zeros(half, dtype=torch.int32, device=cuda),
            eta_vcm=eta)["bufs"]
        r, v = kernels.photon_rows(lb)
        pr, pv = hashgrid.photon_rows(lb)
        assert torch.equal(r.view(torch.int32), pr.view(torch.int32))
        assert torch.equal(v.bool(), pv)
        rows.append(r)
        valid.append(v)
    rows, valid = torch.cat(rows), torch.cat(valid)
    size = hashgrid.photon_table_size(table // 2 if table else rows.shape[0])
    kernels.reset_launches()
    h, se = kernels.photon_bucket(rows, valid, sc.scene_min, 2.0 * mr, size)
    assert kernels.launches["photon_bucket"] == 1
    ph, pse = hashgrid.photon_bucket_plain(rows, valid, sc.scene_min,
                                           2.0 * mr, size)
    assert torch.equal(h, ph) and torch.equal(se, pse)
    kgrid = hashgrid.build_grid_rows_kernel(rows, valid, sc.scene_min, mr,
                                            salt, size)
    pgrid = hashgrid.build_grid(rows, valid.bool(), sc.scene_min, mr, size,
                                salt=salt)
    chip_smoke.compare_grid(kgrid, pgrid, "rows-mode grid test")


VCM_CASES = {"vcm": ({}, {}), "sppm": (dict(
    light_trace=False, nee=False, naive=False, connection=False,
    do_mis=False, do_sppm=True), {}),
    "two_brick": ({}, {"TPT_GRID_ONE_BRICK": "0"}),
    "cap12": (dict(max_per_cell=12), {}), "no_reweight": ({}, None),
    "environment": (dict(sample_environment=True), {})}


@pytest.mark.cuda
@pytest.mark.parametrize("name,case", [("blocks", c) for c in VCM_CASES]
                         + [("spheres", "vcm"), ("spheres", "sppm")])
def test_vcm_kernels_match_plain(cuda, monkeypatch, name, case):
    """vcm_splat, K8 and vcm_eye against their plain versions on the same
    light buffers and grid (chip_smoke's compare_vcm), for VCM, SPPM, each
    merge mode and the environment term."""
    over, env = VCM_CASES[case]
    if env is None:
        monkeypatch.setattr(hashgrid, "REWEIGHT", False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    sc, cam, px, py = _vcm_setup(name, cuda)
    cfg = dataclasses.replace(vcm.VCMConfig(eye_depth=6, light_depth=4),
                              **over)
    kernels.reset_launches()
    res = chip_smoke.compare_vcm(sc, cam, px, py, cfg, 1, f"{name} {case}")
    # the pass, then its stages one by one against their twins
    assert kernels.launches["vcm_eye_walk"] == 2
    assert kernels.launches["vcm_splat_trace"] == int(cfg.light_trace)
    assert res["photons"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vcm", "sppm"])
def test_vcm_goldens_on_card(cuda, name):
    import os
    sc, cam, px, py = _vcm_setup("blocks", cuda, 16, 16)
    cfg = vcm.VCMConfig(eye_depth=6, light_depth=4)
    if name == "sppm":
        cfg = dataclasses.replace(cfg, **VCM_CASES["sppm"][0])
    kernels.reset_launches()
    acc = torch.zeros((256, 3), device=cuda)
    for s in range(8):
        li, rays, _ = vcm.render_sample(sc, cam, rng.base_key(), s, px, py,
                                        cfg=cfg)
        acc += li
    assert kernels.launches["vcm_eye_walk"] == 8
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "golden", f"cornell_{name}_16x16_8spp.npy"))
    err = np.sqrt(np.mean(((acc / 8).cpu().numpy() - golden) ** 2))
    assert err < 1e-3, f"rmse {err:.3g}"


# --- the mega engines (K14), K9's materialised forms, RGB9E5, naive ---------

@pytest.mark.cuda
def test_rgb9e5_matches_plain(cuda):
    """K10's RGB9E5 mode bit-equal to the plain codec, edge values
    included (chip_smoke's rgb9e5_inputs and compare_rgb9e5)."""
    c = chip_smoke.rgb9e5_inputs(200000).to(cuda)
    kernels.reset_launches()
    k = kernels.rgb9e5_roundtrip(c)
    assert kernels.launches["rgb9e5"] == 1
    chip_smoke.compare_rgb9e5(k, c, "test")


@pytest.mark.cuda
@pytest.mark.parametrize("one_brick", [True, False])
@pytest.mark.parametrize("cap", [4, 8])
def test_neighbor_slots_match_plain(cuda, monkeypatch, one_brick, cap):
    """The three materialised forms bit-equal to their plain versions on a
    VCM light walk's grid and the first hit points of the eye paths."""
    monkeypatch.setenv("TPT_GRID_ONE_BRICK", "1" if one_brick else "0")
    sc, cam, px, py = _vcm_setup("blocks", cuda)
    cfg = vcm.VCMConfig(eye_depth=6, light_depth=4, max_per_cell=cap,
                        r0_multiplier=0.03)
    ch = chip_smoke.mega_inputs(sc, px, py, cfg, "vcm", 2,
                                vcm_mega.mega_chunks(px.shape[0]))[0]
    q, hit = chip_smoke.first_hits(sc, cam, px, py, 2)
    kernels.reset_launches()
    found = chip_smoke.compare_slots(ch["grid"], q, hit, ch["mr"], cap,
                                     f"cap {cap}")
    assert kernels.launches["neighbor_slots"] == 3
    assert found > 0


MEGA_CASES = {
    "vcm": ("vcm", {}, {}), "sppm": ("vcm", VCM_CASES["sppm"][0], {}),
    "vcm_two_chunks": ("vcm", {}, dict(chunk_pixels=96 * 32)),
    "vcm_pad": ("vcm", {}, dict(width=1000)),
    "cap12": ("vcm", dict(max_per_cell=12), {}),
    "environment": ("vcm", dict(sample_environment=True), {}),
    "bdpt": ("bdpt", {}, {}), "bdpt_pad": ("bdpt", {}, dict(width=1000)),
    "bdpt_no_nee": ("bdpt", dict(nee=False), {}),
    "bdpt_no_connection": ("bdpt", dict(connection=False), {}),
    "bdpt_paint_weight": ("bdpt", dict(paint_weight=True), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,case", [("blocks", c) for c in MEGA_CASES]
                         + [("spheres", "vcm"), ("spheres", "bdpt")])
def test_mega_eye_matches_plain(cuda, name, case):
    """K14 against its plain version on every chunk of a sample, on the
    same light buffers and grid (chip_smoke's compare_mega: rays and
    dropped photons equal, >= 99.9% of pixels within rtol 1e-3), in both
    flavours, with two chunks, with pads, with the fold's cap and the
    strategy flags."""
    flavor, over, part = MEGA_CASES[case]
    sc, cam, px, py = _vcm_setup(name, cuda)
    cfg = dataclasses.replace(vcm.VCMConfig(eye_depth=6, light_depth=4),
                              **over)
    if flavor == "bdpt":
        cfg = bdpt_mega.as_machine_cfg(dataclasses.replace(
            bdpt.BDPTConfig(eye_depth=6, light_depth=4), **over))
    kernels.reset_launches()
    res = chip_smoke.compare_mega(sc, cam, px, py, cfg, flavor, 1,
                                  f"{name} {case}", **part)
    # each chunk's pass, then its stages one by one against their twins
    assert kernels.launches["mega_eye_walk"] == 2 * res["chunks"].n_chunks


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["VCM", "SPPM", "BIDIRECTIONAL"])
def test_mega_render_launches(cuda, integrator):
    """One sample of each mega engine through render_sample on the card:
    finite, non-negative, the launches per chunk (VCM: K12, vcm_splat,
    photon_pack, photon_table, mega_eye; SPPM without the splat; BDPT:
    K12, bdpt_splat, mega_eye)."""
    sc, cam, px, py = _vcm_setup("blocks", cuda)
    kernels.reset_launches()
    if integrator == "BIDIRECTIONAL":
        li, rays = bdpt_mega.render_sample(
            sc, cam, rng.base_key(), 0, px, py,
            cfg=bdpt.BDPTConfig(eye_depth=6, light_depth=4),
            chunk_pixels=96 * 32)
        want = dict(bdpt_walk=2, bdpt_splat_trace=2, mega_eye_walk=2)
    else:
        cfg = vcm.VCMConfig(eye_depth=6, light_depth=4)
        if integrator == "SPPM":
            cfg = dataclasses.replace(cfg, **VCM_CASES["sppm"][0])
        li, rays, _ = vcm_mega.render_sample(sc, cam, rng.base_key(), 0, px,
                                             py, cfg=cfg,
                                             chunk_pixels=96 * 32)
        want = dict(bdpt_walk=2, vcm_splat_trace=2 * cfg.light_trace,
                    photon_pack=2, photon_table=2, mega_eye_walk=2)
    assert all(kernels.launches[k] == v for k, v in want.items()), \
        kernels.launches
    assert bool(torch.isfinite(li).all()) and bool((li >= 0).all())
    assert rays > px.shape[0]


EYE_PASSES = {  # name -> (pass, flavor, config overrides)
    "vcm": ("vcm_eye", "classic", {}),
    "sppm": ("vcm_eye", "classic", VCM_CASES["sppm"][0]),
    "vcm_no_connection": ("vcm_eye", "classic", dict(connection=False)),
    "mega_vcm": ("mega_eye", "vcm", {}),
    "mega_sppm": ("mega_eye", "vcm", VCM_CASES["sppm"][0]),
    "mega_bdpt": ("mega_eye", "bdpt", {}),
    "mega_bdpt_no_connection": ("mega_eye", "bdpt",
                                dict(connection=False)),
}


def _eye_pass_inputs(cuda, flavor, over):
    """A set-up eye pass on the blocks scene (96x64, eye 6, light 4,
    sample 1) and its inputs."""
    sc, cam, px, py = _vcm_setup("blocks", cuda)
    cfg = dataclasses.replace(vcm.VCMConfig(eye_depth=6, light_depth=4),
                              **over)
    if flavor == "bdpt":
        cfg = bdpt_mega.as_machine_cfg(dataclasses.replace(
            bdpt.BDPTConfig(eye_depth=6, light_depth=4), **over))
    if flavor == "classic":
        res = chip_smoke.compare_vcm(sc, cam, px, py, cfg, 1, "setup")
        return sc, cam, cfg, res["eps"][0], res
    res = chip_smoke.compare_mega(sc, cam, px, py, cfg, flavor, 1, "setup")
    return sc, cam, cfg, res["eps"][0], res


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EYE_PASSES))
def test_eye_pass_is_three_stage_launches(cuda, case):
    """One pass = its walk, its connections (not without them) and its
    gather, each counted once under its stage; the stages on their own
    launch only themselves."""
    name, flavor, over = EYE_PASSES[case]
    sc, cam, cfg, ep, _ = _eye_pass_inputs(cuda, flavor, over)
    kernels.reset_launches()
    kernels.run_eye_pass(ep)
    torch.cuda.synchronize()
    conn = int(cfg.connection)
    want = {f"{name}_walk": 1, f"{name}_connect": conn,
            f"{name}_gather": 1}
    got = {k: v for k, v in kernels.launches.items() if v}
    assert got == {k: v for k, v in want.items() if v}, got
    assert (ep.conn is not None) == bool(conn)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vcm", "mega_vcm", "mega_bdpt"])
def test_eye_gather_adds_in_jax_order(cuda, case):
    """The gather kernel on hand-built records whose float32 sum depends
    on the order (1e8, 1, -1e8): bit-equal to its plain twin, which adds
    s=0, NEE, then the connections, depth by depth; the sky at an
    escape."""
    from cudapathtracer_tpu_torch.models import vcm_mega
    name, flavor, over = EYE_PASSES[case]
    sc, cam, cfg, ep, res = _eye_pass_inputs(
        cuda, flavor, dict(over, sample_environment=True, **(
            {} if flavor == "bdpt" else dict(do_merge=False))))
    rec, n = ep.rec, ep.rec.flags.shape[1]
    depth, lrows = rec.flags.shape[0], ep.conn.shape[1]
    gen = np.random.default_rng(8)
    big = np.float32(1e8)
    vals = np.array([big, 1.0, -big, 0.5, -1.0], np.float32)
    for f in ("implicit", "nee"):
        getattr(rec, f).copy_(torch.as_tensor(
            gen.choice(vals, size=(depth, n, 3))))
    ep.conn.copy_(torch.as_tensor(gen.choice(vals,
                                             size=(depth, lrows, n, 3))))
    live = vcm.REC_CONN
    flags = np.full((depth, n), live, np.int32)
    flags[1, ::3] = live | vcm.REC_END
    flags[2:, ::3] = 0
    flags[1, 1::3] = vcm.REC_ESCAPED | vcm.REC_END
    flags[2:, 1::3] = 0
    flags[-1, 2::3] |= vcm.REC_END
    rec.flags.copy_(torch.as_tensor(flags))
    kernels.eye_gather(ep)
    torch.cuda.synchronize()
    if flavor == "classic":
        li, _ = vcm.eye_gather_plain(sc, rec, ep.conn, None, cfg, 0.0, 0.0,
                                     0.0)
        got = ep.out
    else:
        li, _ = vcm_mega.eye_gather_plain(sc, rec, ep.conn, None, cfg,
                                          flavor=flavor)
        got = ep.out[:n]
    assert torch.equal(got.view(torch.int32), li.view(torch.int32))


CONNECT_CASES = {  # the trace kernel's instantiation -> (flavor, engine)
    "classic_bvh8": ("classic", "bvh8"),
    "classic_threaded": ("classic", "threaded"),
    "mega_vcm": ("vcm", "bvh8"),
    "mega_bdpt": ("bdpt", "bvh8"),
}


def _twin_rays(sc, rec, lb, n: int, flavor: str, cfg):
    """The twin's shadow rays of every (t, j) on the kernel's records,
    traced by the same device traversal with their rows: -> (traced [D, L,
    n] bool, blocked [D, L, n] bool, rays [n] i64, rows [n] i64)."""
    from cudapathtracer_tpu_torch.models.bdpt import _vertex
    from cudapathtracer_tpu_torch.utils.math import RAY_EPSILON
    lanes = paths.PathBuffers(*(f[:, :n] for f in lb))
    depth, lrows = rec.flags.shape[0], lanes.pt.shape[0]
    dev = rec.flags.device
    traced = torch.zeros((depth, lrows, n), dtype=torch.bool, device=dev)
    blocked = torch.zeros_like(traced)
    rows = torch.zeros(n, dtype=torch.int64, device=dev)
    for t in range(depth):
        eye = rec.eye(sc, t)
        if flavor != "classic":
            eye["n"] = vcm_mega._toward_prev(eye["n"], eye["to_prev"])
        for j in range(lrows):
            do, e2l_u, dist, *_ = vcm.conn_geometry(eye, _vertex(lanes, j),
                                                    rec.conn(t))
            o = eye["pos"] + eye["n"] * RAY_EPSILON
            skip = torch.full((n,), -1, dtype=torch.int32, device=dev)
            if sc.traversal == "threaded":
                sh, r = kernels.shadow_factor_bin(
                    sc.bin_table, sc.node_packed.shape[0], sc.tri_f32, o,
                    e2l_u, dist - RAY_EPSILON, skip, do, with_rows=True)
            else:
                sh, r = kernels.shadow_factor8(
                    sc.bvh8_table, sc.tri_f32, o, e2l_u, dist - RAY_EPSILON,
                    skip, do, with_rows=True)
            traced[t, j] = do
            blocked[t, j] = do & (sh.amax(dim=1) <= 0.0)
            rows += torch.where(do, r, 0)
    return traced, blocked, traced.sum((0, 1)), rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONNECT_CASES))
def test_eye_connect_queue_matches_twin(cuda, case):
    """The connection stage (queue, then trace) in each of the trace
    kernel's four instantiations, on the records of the kernel's walk: the
    queued slots are eye_connect_queue_plain's, each once; each path's rays
    and rows are exactly its twin shadow rays' (the same device traversal);
    conn is exactly zero on every pair of a live record that the twin does
    not trace or finds blocked (the queue pass's zero rows among them), and
    the traced pairs' contributions equal the twin's under the stage's
    bounds (compare_image, 99.5%: the kernel evaluates each lobe fused,
    the twin by operator, tests/test_torch_bsdf.py). The mega flavours run
    a chunk whose last 37 light lanes are pads (light lanes != paths).
    Delta light vertices and records are marked by hand (the scene has
    none), so the gate's two delta tests are held too."""
    flavor, engine = CONNECT_CASES[case]
    sc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        traversal=engine, device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 96, 64, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(96, 64, cuda)
    n_buf = px.shape[0]
    cfg = vcm.VCMConfig(eye_depth=6, light_depth=4, do_merge=False)
    key_l, key_e = vcm.sample_keys(rng.base_key(), 1)
    _, eta, _ = vcm.sample_scalars(sc, cfg, 1, n_buf)
    if flavor == "bdpt":
        cfg = bdpt_mega.as_machine_cfg(bdpt.BDPTConfig(eye_depth=6,
                                                       light_depth=4))
        eta = 0.0
    z = lambda: torch.zeros(n_buf, dtype=torch.int32, device=cuda)
    lb = kernels.bdpt_walk(sc, px, py, paths.walk_keys(key_l, "light"),
                           mode="light", max_depth=cfg.light_depth + 1,
                           rays=z(), eta_vcm=eta or None)["bufs"]
    # the scene has no delta surface: every fourth lane's light vertices
    # and (below) every fifth path's depth-1 record are marked delta
    lanes = torch.arange(n_buf, device=cuda)
    lb = lb._replace(flags=torch.where((lanes % 4 == 1)[None],
                                       lb.flags | -2 ** 31, lb.flags))
    if flavor == "classic":
        n = n_buf
        ep = kernels.vcm_eye_pass(
            sc, cam, paths.walk_keys(key_e, "eye"), lb, None, None, z(), cfg,
            px=px, py=py, merge_radius=0.0, eta_vcm=eta, merge_norm=0.0,
            one_brick=False, reweight=True, with_rows=True)
    else:
        n = n_buf - 37
        ep = kernels.mega_eye_pass(
            sc, cam, vcm_mega.eye_keys(key_e), lb, None,
            torch.zeros((n, 3), device=cuda), z(), cfg, px=px, py=py, cnt=n,
            gbase=0, flavor=flavor, eta_vcm=eta, with_rows=True)
    kernels.eye_walk(ep)
    ep.rec.flags[1, lanes[:n] % 5 == 2] &= ~vcm.REC_NON_DELTA
    rays0, rows0 = ep.rays[:n].clone(), ep.rows[:n].clone()
    ep.conn.fill_(float("nan"))   # every slot the gather reads is written
    kernels.eye_connect(ep)
    torch.cuda.synchronize()
    rec = ep.rec
    # the queue
    q = int(ep.queued[0])
    got = torch.sort(ep.queue[:q].to(torch.int64) & 0xFFFFFFFF).values
    want = vcm.eye_connect_queue_plain(rec, lb)
    assert torch.equal(got, want) and q > 0
    # each path's rays and rows
    traced, blocked, rays, rows = _twin_rays(sc, rec, lb, n, flavor, cfg)
    assert torch.equal((ep.rays[:n] - rays0).to(torch.int64), rays)
    assert torch.equal((ep.rows[:n] - rows0).to(torch.int64), rows)
    assert int(rays.sum()) > 0 and bool(blocked.any())
    # conn: exact zeros where nothing adds, the twin's values elsewhere
    live = ((rec.flags & vcm.REC_CONN) == vcm.REC_CONN)[:, None, :].expand(
        -1, ep.conn.shape[1], -1)
    conn = ep.conn
    assert bool(torch.isfinite(conn[live]).all())
    zero = live & (~traced | blocked)
    assert bool((conn[zero] == 0).all())
    if flavor == "classic":
        pconn, prays = vcm.eye_connect_plain(sc, rec, lb, cfg, eta)
    else:
        pconn, prays = vcm_mega.eye_connect_plain(sc, rec, lb, cfg,
                                                  flavor=flavor, eta_vcm=eta)
    assert prays == int(rays.sum())
    assert bool((pconn[zero] == 0).all())
    lit = live & traced & ~blocked
    chip_smoke.compare_image((conn[lit], prays), (pconn[lit], prays),
                             f"{case} connections", "K13v", 0.995)


@pytest.mark.cuda
def test_eye_passes_sync_free(cuda):
    """One sample of every integrator whose eye pass is staged, on the
    card with torch.cuda's sync debug mode "error": no host sync inside
    the passes (every buffer is sized from the shapes)."""
    sc, cam, px, py = _vcm_setup("blocks", cuda)
    vc = vcm.VCMConfig(eye_depth=6, light_depth=4)
    sp = dataclasses.replace(vc, **VCM_CASES["sppm"][0])
    bc = bdpt.BDPTConfig(eye_depth=6, light_depth=4)
    runs = [lambda: vcm.render_sample(sc, cam, rng.base_key(), 0, px, py,
                                      cfg=vc),
            lambda: vcm.render_sample(sc, cam, rng.base_key(), 0, px, py,
                                      cfg=sp),
            lambda: vcm_mega.render_sample(sc, cam, rng.base_key(), 0, px,
                                           py, cfg=vc),
            lambda: vcm_mega.render_sample(sc, cam, rng.base_key(), 0, px,
                                           py, cfg=sp),
            lambda: bdpt_mega.render_sample(sc, cam, rng.base_key(), 0, px,
                                            py, cfg=bc)]
    for run in runs:
        run()   # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(c.dtype == torch.int64 and c.dim() == 0
                   for c in out[1:])
        assert bool(torch.isfinite(out[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blocks", "spheres", "leaf"])
def test_naive_matches_plain(cuda, name):
    mesh = {"blocks": builtin.cornell_with_blocks,
            "spheres": builtin.cornell_with_spheres,
            "leaf": lambda: builtin.cornell_with_bunny(3, bunny_mat=13)}[name]
    sc, _ = build_scene(mesh(), builtin_materials(), device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 96, 64, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(96, 64, cuda)
    kernels.reset_launches()
    k = naive.render_kernel(sc, cam, rng.base_key(), 1, px, py, max_depth=6)
    assert kernels.launches["naive"] == 1
    assert kernels.launches["render_unidirectional"] == 0
    p = naive.render_plain(sc, cam, rng.base_key(), 1, px, py, max_depth=6)
    chip_smoke.compare_render(k, p, f"{name} naive")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["mega", "classic", "naive"])
def test_k5_batch_mode_bit_equal_to_singles(cuda, schedule):
    """One launch of K5 with k = 3 (3 samples from sample 2) against three
    launches of one sample summed in sample order: radiance and rays
    bit-equal."""
    sc, _ = build_scene(builtin.cornell_with_spheres(), builtin_materials(),
                        device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 96, 64, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(96, 64, cuda)
    kw = dict(max_depth=6, use_mis=schedule != "naive",
              sample_environment=False, schedule=schedule)
    kernels.reset_launches()
    li, rays = uni.render_batch_kernel(sc, cam, rng.base_key(), 2, px, py, 3,
                                       **kw)
    assert kernels.launches["naive" if schedule == "naive"
                            else "render_unidirectional"] == 1
    assert sum(kernels.launches.values()) == 1
    acc = torch.zeros_like(li)
    total = 0
    for s in range(2, 5):
        l1, r1 = uni.render_kernel(sc, cam, rng.base_key(), s, px, py, **kw)
        acc = acc + l1
        total += int(r1)
    assert torch.equal(li, acc)
    assert int(rays) == total


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["mega", "classic", "naive"])
@pytest.mark.parametrize("traversal", ["bvh8", "threaded"])
def test_k5_result_independent_of_grid(cuda, schedule, traversal):
    """K5 with path regeneration: 2 samples on the resident grid, on one
    block and on one block per SM give bit-equal radiance, rays and rows;
    the lane counters count every event (the closest rays of the naive
    schedule), at most 32 a warp's call of the event code and a warp's
    busiest lane's event."""
    sc, _ = build_scene(builtin.cornell_with_spheres(), builtin_materials(),
                        traversal=traversal, device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 96, 64, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(96, 64, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    outs = []
    for grid in (None, 1, sms):
        lanes = torch.zeros(3, dtype=torch.int64, device=cuda)
        outs.append(kernels.render_unidirectional(
            sc, px, py, cam.kernel_params(), rng.base_key(), 3, 2,
            max_depth=6,
            use_mis=schedule != "naive", sample_environment=False,
            schedule=schedule, air_priority=sc.air_priority, with_rows=True,
            grid=grid, lanes=lanes) + (lanes.tolist(),))
    for li, rays, rows, _ in outs[1:]:
        assert torch.equal(li.view(torch.int32), outs[0][0].view(torch.int32))
        assert torch.equal(rays, outs[0][1]) and torch.equal(rows, outs[0][2])
    events, busiest, calls = outs[0][3]
    assert 0 < events <= 32 * busiest and events <= 32 * calls
    if schedule == "naive":
        assert events == int(outs[0][1].sum())
    assert kernels.render_unidirectional_grid(sc, px.shape[0], schedule) \
        >= 1


@pytest.mark.cuda
def test_renderer_batch_is_one_k5_launch(cuda, tmp_path):
    """Through Renderer on the card, 5 samples at 2 per dispatch: three K5
    launches (k = 2, 2, 1), and the image of 1 per dispatch within float
    association (rays equal)."""
    from cudapathtracer_tpu_torch.driver import Renderer
    from cudapathtracer_tpu_torch.utils.config import MeshConfig, RenderConfig

    def cfg(spd):
        return RenderConfig(width=64, height=48, sample_count=5, max_depth=4,
                            meshes=[MeshConfig("builtin:cornell_blocks")],
                            samples_per_dispatch=spd,
                            output_dir=str(tmp_path))
    kernels.reset_launches()
    r2 = Renderer(cfg(2), device="cuda")
    r2.render(progressive=False, verbose=False)
    assert kernels.launches["render_unidirectional"] == 3
    r1 = Renderer(cfg(1), device="cuda")
    r1.render(progressive=False, verbose=False)
    assert r1.metrics.rays_traced == r2.metrics.rays_traced
    assert torch.allclose(r1.accum, r2.accum, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_k6_keyed_matches_plain(cuda):
    gen = np.random.default_rng(41)
    n = 100003
    words = lambda: torch.as_tensor(gen.integers(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32),
        device=cuda)
    k0, k1 = words(), words()
    ids = torch.as_tensor(gen.integers(0, 2 ** 31, n).astype(np.int32),
                          device=cuda)
    kernels.reset_launches()
    ku = rng.uniform_keyed(k0, k1, ids)
    assert kernels.launches["uniform_keyed"] == 1
    pu = rng.uniform_keyed_plain(k0, k1, ids)
    assert torch.equal(ku.view(torch.int32), pu.view(torch.int32))
    a, b = rng.draw_key(rng.base_key(), 9)
    full = lambda w: torch.full((n,), w, dtype=torch.int64).to(
        torch.uint32).view(torch.int32).to(cuda)
    assert torch.equal(rng.uniform_keyed(full(a), full(b), ids),
                       rng.uniform_id(rng.base_key(), 9, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("eta", [None, chip_smoke.VCM_ETA])
def test_k12_table_mode_bit_equal_to_folded(cuda, eta):
    """K12's table mode (light_mega's walk) against its folded mode on the
    same pixels: every buffer field, the endpoint and the rays bit-equal."""
    from cudapathtracer_tpu_torch.models import light_mega
    from cudapathtracer_tpu_torch.scene.materials import TRANSPORT_IMPORTANCE
    sc, _ = build_scene(builtin.cornell_with_spheres(), builtin_materials(),
                        device=cuda)
    px, py = _grid(96, 64, cuda)
    n, depth = px.shape[0], 7
    key = rng.sample_key(rng.base_key(), 5)
    ktab, ketab = light_mega.key_tables(key, depth)
    table = light_mega.device_table(ktab, ketab, cuda)
    walk = lambda tab: kernels.bdpt_walk(
        sc, px, py, paths.walk_keys(key, "light"), mode="light",
        max_depth=depth, rays=torch.zeros(n, dtype=torch.int32, device=cuda),
        eta_vcm=eta, key_table=tab)
    kernels.reset_launches()
    tw, fw = walk(table), walk(None)
    assert (kernels.launches["bdpt_walk_table"],
            kernels.launches["bdpt_walk"]) == (1, 1)
    for name, a, b in zip(paths.PathBuffers._fields, tw["bufs"], fw["bufs"]):
        assert torch.equal(a, b), name
    for k in fw["v0"]:
        assert torch.equal(tw["v0"][k], fw["v0"][k]), k
    kernels.reset_launches()
    lb, lv0, lrays = light_mega.walk_with_endpoint(
        sc, key, n, depth, TRANSPORT_IMPORTANCE, eta_vcm=eta, pxc=px, pyc=py)
    assert kernels.launches["bdpt_walk_table"] == 1
    for k in fw["v0"]:
        assert torch.equal(lv0[k], fw["v0"][k]), k
    rays = torch.zeros(n, dtype=torch.int32, device=cuda)
    kernels.bdpt_walk(sc, px, py, paths.walk_keys(key, "light"),
                      mode="light", max_depth=depth, rays=rays, eta_vcm=eta)
    assert int(lrays) == int(rays.sum())
    for name, a, b in zip(paths.PathBuffers._fields, lb, fw["bufs"]):
        assert torch.equal(a, b), name


def _rays(n, dev, seed):
    gen = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    o = f(gen.uniform(-0.45, 0.45, (n, 3)))
    d = f(gen.normal(size=(n, 3)))
    mt = f(gen.uniform(0.05, 2.0, n))
    active = torch.as_tensor(gen.uniform(size=n) < 0.9, device=dev)
    return o, d / d.norm(dim=1, keepdim=True), mt, active


@pytest.mark.cuda
@pytest.mark.parametrize("bunny_mat", [2, 13])
def test_k15_matches_plain(cuda, bunny_mat):
    sc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=3,
                                                   bunny_mat=bunny_mat),
                        builtin_materials(), traversal="threaded",
                        device=cuda)
    n = 20000
    o, d, mt, active = _rays(n, cuda, 1)
    skip = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    nodes = sc.node_packed.shape[0]
    kernels.reset_launches()
    k = traverse.closest_hit(sc, o, d, mt, skip, active)
    p = traverse.closest_hit_bin_plain(sc.bin_table, nodes, o, d, mt, skip,
                                       active)
    assert torch.equal(k.tri, p[1])
    m = k.tri >= 0
    for a, b in zip(k, p):
        if a.dtype == torch.float32:
            assert (a[m] - b[m]).abs().max().item() <= 1e-5
    ks = traverse.shadow_factor(sc, o, d, mt, skip, active)
    ps = traverse.shadow_factor_bin_plain(sc.bin_table, nodes, sc.tri_f32, o,
                                          d, mt, skip, active)
    assert (ks - ps).abs().max().item() <= 1e-5
    assert kernels.launches["closest_hit_bin"] == 1
    assert kernels.launches["shadow_factor_bin"] == 1
    assert kernels.launches["closest_hit8"] == 0
    assert kernels.launches["shadow_factor8"] == 0
    # the kernel visits the rows the plain walk counts
    krows = kernels.closest_hit_bin(sc.bin_table, nodes, o, d, mt, skip,
                                    active, with_rows=True)[4]
    prows = traverse.closest_hit_bin_plain(
        sc.bin_table, nodes, o, d, mt, skip, active, with_counts=True)[4]
    assert (krows == prows).float().mean().item() >= 0.9999
    ksrows = kernels.shadow_factor_bin(sc.bin_table, nodes, sc.tri_f32, o, d,
                                       mt, skip, active, with_rows=True)[1]
    psrows = traverse.shadow_factor_bin_plain(
        sc.bin_table, nodes, sc.tri_f32, o, d, mt, skip, active,
        with_counts=True)[1]
    assert (ksrows == psrows).float().mean().item() >= 0.9999


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["classic", "naive"])
@pytest.mark.parametrize("name", ["blocks", "leaf"])
def test_k5_threaded_matches_plain(cuda, name, schedule):
    mesh = {"blocks": builtin.cornell_with_blocks,
            "leaf": lambda: builtin.cornell_with_bunny(3, bunny_mat=13)}[name]
    sc, _ = build_scene(mesh(), builtin_materials(), traversal="threaded",
                        device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 96, 64, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(96, 64, cuda)
    k = uni.render_kernel(sc, cam, rng.base_key(), 1, px, py, max_depth=6,
                          use_mis=schedule == "classic",
                          sample_environment=False, schedule=schedule)
    if schedule == "classic":
        p = uni.render_plain(sc, cam, rng.base_key(), 1, px, py, max_depth=6,
                             schedule=schedule)
    else:
        p = naive.render_plain(sc, cam, rng.base_key(), 1, px, py,
                               max_depth=6)
    chip_smoke.compare_render(k, p, f"{name} {schedule} threaded")


@pytest.mark.cuda
def test_threaded_scene_runs_k15(cuda):
    """On a threaded scene ops/traverse launches K15, never K1's entries;
    K5's classic schedule visits other rows than on the BVH8 engine of the
    same scene (its threaded instantiation), its mega schedule the same
    rows (BVH8 on every scene)."""
    sc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        traversal="threaded", device=cuda)
    s8 = dataclasses.replace(sc, traversal="bvh8")
    o, d, mt, active = _rays(4096, cuda, 4)
    kernels.reset_launches()
    traverse.closest_hit(sc, o, d, active=active)
    traverse.shadow_factor(sc, o, d, mt, active=active)
    assert kernels.launches["closest_hit_bin"] == 1
    assert kernels.launches["shadow_factor_bin"] == 1
    assert kernels.launches["closest_hit8"] == 0
    assert kernels.launches["shadow_factor8"] == 0
    cam = Camera.pinhole((0.0, 0.0, 1.0), 64, 64, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(64, 64, cuda)
    rows = {}
    for scene in (sc, s8):
        for sched in ("classic", "mega"):
            rows[scene.traversal, sched] = kernels.render_unidirectional(
                scene, px, py, cam.kernel_params(), rng.base_key(), 0, 1,
                max_depth=6,
                use_mis=True, sample_environment=False, schedule=sched,
                air_priority=scene.air_priority, with_rows=True)[2]
    assert not torch.equal(rows["threaded", "classic"],
                           rows["bvh8", "classic"])
    assert torch.equal(rows["threaded", "mega"], rows["bvh8", "mega"])


def test_photon_sort_refuses_non_cuda_tensors():
    """K8's sort launches on CUDA tensors or raises; it never falls back
    to its twin or to torch.sort."""
    kernels.reset_launches()
    with pytest.raises(ValueError):
        kernels.photon_sort(torch.zeros(4, dtype=torch.int32), 32)
    assert kernels.launches["photon_sort"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "high", "equal", "sentinel"])
def test_photon_sort_matches_torch_sort(cuda, kind):
    """The hand-written radix sort (radix_sort.cu) against torch.sort
    (stable) on the same uint32 keys, and its twin: the order and the
    sorted buckets exactly equal; one launch counted; the buckets left as
    they were. Unsalted, the key is the bucket (any uint32 value); salted,
    the key of photon i in bucket h is hashgrid.sort_keys'. 1,000,003
    photons (not a multiple of the tile), and 1."""
    gen = np.random.default_rng(5)
    for n in (1_000_003, 1):
        if kind == "equal":
            k = np.full(n, 0x80000001, dtype=np.uint32)
        elif kind == "sentinel":
            k = np.where(gen.uniform(size=n) < 0.47, np.uint32(24_883_207),
                         gen.integers(0, 24_883_207, n).astype(np.uint32))
        else:
            lo = 2 ** 31 if kind == "high" else 0
            k = gen.integers(lo, 2 ** 32, n, dtype=np.uint64).astype(
                np.uint32)
        bucket = torch.from_numpy(k.view(np.int32).copy()).to(cuda)
        salts = [None] + ([hashgrid.photon_salt(n)] if kind == "sentinel"
                          else [])
        for salt in salts:
            key = hashgrid.sort_keys(bucket.to(torch.int64) & 0xFFFFFFFF,
                                     salt)
            before = bucket.clone()
            kernels.reset_launches()
            order, got = kernels.photon_sort(bucket, 32, salt)
            assert kernels.launches["photon_sort"] == 1
            want = torch.sort(key, stable=True).indices
            assert torch.equal(order.to(torch.int64), want)
            assert torch.equal(got, bucket[want])
            assert torch.equal(bucket, before)
            twin, _ = hashgrid.radix_sort_plain(key, 32)
            assert torch.equal(twin, want)
