"""Tile x spp rendering over a mesh of ranks (cudapathtracer_tpu_torch/
parallel/sharding.py) on the CPU: CPU ranks, one thread a rank, on the JAX
sharding tests' setup (cornell_with_blocks, 16x16, pinhole at (0,0,1),
fov 60, depth 4; BDPT and VCM at eye depth 4, light depth 3).

  (a) rank r of an (n_tile, n_spp) mesh sits at divmod(r, n_spp), the
      ranks are the world once each, and its tile group gathers exactly
      the ranks JAX's reshape(n_tile, n_spp) puts on its tile axis, in
      axis order, and sums them.
  (b) naive and unidirectional on a (4,2) mesh against the JAX functions
      composed shard by shard on one device (key fold_in(fold_in(key, ti),
      si), sample s n_spp + si, summed over si), held as test_torch_naive
      holds naive (test_torch_vcm_mega.assert_parity).
  (c) BDPT on a (4,1) mesh (splat=True) against JAX's single-device render
      at the JAX sharding test's tolerance (rtol 2e-4, atol 2e-5), rays
      equal.
  (d) VCM with merging on a (4,1) mesh (photon_axis="tile": the photons
      gathered over the tile axis) against JAX's single-device render and
      the port's single-rank render at the same tolerance (the union's
      fold order differs); rays and dropped photons equal.
  (e) splat_shape on one rank: li + fb equals the render without it, bit
      for bit, on BDPT and VCM.
  (f) K8's rows mode, plain, stage for stage as build_grid_rows_kernel
      runs it (photon_bucket_plain, the radix sort twin, grid_table), on
      the photon rows of two tiles gathered tile-major, equals
      photon_rows + build_grid on the same rows, bit for bit (salted,
      unsalted, and above 2^24 buckets, where the key wraps).
  (g) the mega engine on a (4,2) mesh agrees with classic in brightness
      within 0.25 (test_sharding.py's test_tile_sharded_mega_engine).
  (h) the BDPT and VCM mega engines take no splat_shape and are refused.
  (i) a mesh whose CUDA devices are missing raises; nothing falls back to
      the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import bdpt as jbdpt
from cudapathtracer_tpu.models import naive as jnaive
from cudapathtracer_tpu.models import unidirectional as juni
from cudapathtracer_tpu.models import vcm as jvcm
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import (bdpt, bdpt_mega, naive, paths,
                                             unidirectional,
                                             unidirectional_mega, vcm,
                                             vcm_mega)
from cudapathtracer_tpu_torch.ops import hashgrid
from cudapathtracer_tpu_torch.parallel import sharding
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from test_torch_vcm_mega import assert_parity
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = H = 16
N = W * H
DEPTH = 4
BCFG = bdpt.BDPTConfig(eye_depth=4, light_depth=3)
VCFG = vcm.VCMConfig(eye_depth=4, light_depth=3, do_merge=True,
                     max_per_cell=64, r0_multiplier=0.05)


@pytest.fixture(scope="module")
def setup():
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    tc = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32),
                            indexing="ij")
    return dict(ts=ts, tc=tc, px=px.reshape(-1), py=py.reshape(-1))


@pytest.fixture(scope="module")
def jax_setup():
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials())
    jc = JCamera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    jpx, jpy = jnp.meshgrid(jnp.arange(W), jnp.arange(H))
    return dict(js=js, jc=jc, px=jpx.ravel(), py=jpy.ravel())


def _cpu_mesh(n_tile, n_spp):
    return sharding.make_mesh(n_tile, n_spp, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def spp_mesh_render(setup):
    """render(fn) -> (acc, done, rays) of fn's sharded render on a (4,2)
    mesh, 2 samples (one call), depth 4; each fn rendered once."""
    mesh, done = _cpu_mesh(4, 2), {}

    def render(fn):
        if fn not in done:
            done[fn] = sharding.render_sharded(fn, mesh, setup["ts"],
                                               setup["tc"], W, H, 2,
                                               max_depth=DEPTH)
        return done[fn]
    return render


@pytest.mark.parametrize("n_tile,n_spp", [(8, 1), (4, 2), (1, 8)])
def test_mesh_placement_and_groups(n_tile, n_spp):
    mesh = _cpu_mesh(n_tile, n_spp)
    assert mesh.shape == {"tile": n_tile, "spp": n_spp}
    assert len(mesh.ranks) == n_tile * n_spp
    grid = np.arange(n_tile * n_spp).reshape(n_tile, n_spp)

    def members(r):
        me = torch.tensor([r.rank])
        return r.tile.all_gather(me).tolist(), int(r.tile.all_reduce(me))

    got = mesh.run(members)
    assert [r.rank for r in mesh.ranks] == list(range(n_tile * n_spp))
    for r in mesh.ranks:
        assert (r.ti, r.si) == divmod(r.rank, n_spp)
        assert grid[r.ti, r.si] == r.rank
        tile, total = got[r.rank]
        assert tile == list(grid[:, r.si]) == list(r.tile.members)
        assert total == grid[:, r.si].sum()
        assert (r.tile.rank, r.tile.size) == (r.ti, n_tile)


@pytest.mark.parametrize("name", ["naive", "unidirectional"])
def test_tile_spp_mesh_matches_jax_per_shard(spp_mesh_render, jax_setup,
                                             name):
    fn, jfn = {"naive": (naive.render_sample, jnaive.render_sample),
               "unidirectional": (unidirectional.render_sample,
                                  juni.render_sample)}[name]
    kernels.reset_launches()
    acc, done, rays = spp_mesh_render(fn)
    assert done == 2 and sum(kernels.launches.values()) == 0
    n_local = N // 4
    want = np.zeros((N, 3), np.float32)
    want_rays = 0
    key = jrng.base_key()
    for ti in range(4):
        sl = slice(ti * n_local, (ti + 1) * n_local)
        for si in range(2):
            k = jax.random.fold_in(jax.random.fold_in(key, ti), si)
            li, r = jfn(jax_setup["js"], jax_setup["jc"], k, si,
                        jax_setup["px"][sl], jax_setup["py"][sl],
                        max_depth=DEPTH)
            want[sl] += np.asarray(li)
            want_rays += int(r)
    assert_parity(torch.as_tensor(acc), want, rays, want_rays)


def test_tile_sharded_bdpt_matches_jax_single_device(setup, jax_setup):
    mesh = _cpu_mesh(4, 1)
    acc, done, rays = sharding.render_sharded(
        bdpt.render_sample, mesh, setup["ts"], setup["tc"], W, H, 1,
        splat=True, cfg=BCFG)
    assert done == 1 and rays > 0
    li, jrays = jbdpt.render_sample(
        jax_setup["js"], jax_setup["jc"], jrng.base_key(), 0,
        jax_setup["px"], jax_setup["py"],
        cfg=jbdpt.BDPTConfig(eye_depth=4, light_depth=3))
    assert rays == int(jrays)
    np.testing.assert_allclose(acc, np.asarray(li), rtol=2e-4, atol=2e-5)


def test_tile_sharded_vcm_merge_matches_single_rank(setup, jax_setup):
    mesh = _cpu_mesh(4, 1)
    fn = sharding.make_sharded_sample_fn(vcm.render_sample, mesh,
                                         setup["ts"], setup["tc"],
                                         splat=True, cfg=VCFG,
                                         photon_axis="tile")
    li_s, rays_s, drop_s = fn(rng.base_key(), 0, setup["px"], setup["py"])
    li, rays, drop = vcm.render_sample(setup["ts"], setup["tc"],
                                       rng.base_key(), 0, setup["px"],
                                       setup["py"], cfg=VCFG)
    jli, jrays, jdrop = jvcm.render_sample(
        jax_setup["js"], jax_setup["jc"], jrng.base_key(), 0,
        jax_setup["px"], jax_setup["py"],
        cfg=jvcm.VCMConfig(**dataclasses.asdict(VCFG)),
        count_merge_dropped=True)
    assert rays_s == rays == int(jrays) > 0
    assert drop_s == drop == int(jdrop)
    assert li.mean() > 0
    for want in (li.numpy(), np.asarray(jli)):
        np.testing.assert_allclose(li_s.numpy(), want, rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("name", ["bdpt", "vcm"])
def test_splat_shape_adds_to_the_render(setup, name):
    fn, cfg = {"bdpt": (bdpt.render_sample, BCFG),
               "vcm": (vcm.render_sample, VCFG)}[name]
    args = (setup["ts"], setup["tc"], rng.base_key(), 1, setup["px"],
            setup["py"])
    whole = fn(*args, cfg=cfg)
    li, fb, *counts = fn(*args, cfg=cfg, splat_shape=N)
    assert fb.shape == (N, 3) and (fb > 0).any()
    assert torch.equal(li + fb, whole[0])
    assert counts == list(whole[1:])


@pytest.mark.parametrize("salted,table", [(True, None), (False, None),
                                          (True, (1 << 24) + 43)])
def test_rows_mode_grid_matches_build_grid(setup, salted, table):
    """The photons of two tiles of a VCM sample, gathered tile-major."""
    key_l, _ = vcm.sample_keys(rng.base_key(), 0)
    mr, eta, _ = vcm.sample_scalars(setup["ts"], VCFG, 0, N)
    rows, valid = [], []
    for t in range(2):
        sl = slice(t * N // 2, (t + 1) * N // 2)
        lbufs, _, _ = paths.generate_light_path(
            setup["ts"], key_l, setup["px"][sl], setup["py"][sl],
            VCFG.light_depth + 1, eta_vcm=eta)
        r, v = hashgrid.photon_rows(lbufs)
        rows.append(r)
        valid.append(v.to(torch.uint8))
    rows, valid = torch.cat(rows), torch.cat(valid)
    assert 0 < int(valid.sum()) < rows.shape[0]
    table = table or hashgrid.photon_table_size(rows.shape[0])
    salt = hashgrid.photon_salt(3) if salted else None
    h, cell_se = hashgrid.photon_bucket_plain(rows, valid,
                                              setup["ts"].scene_min, 2 * mr,
                                              table)
    want_h, _ = hashgrid.grid_keys(rows, valid.bool(),
                                   setup["ts"].scene_min, 2 * mr, table)
    assert h.dtype == torch.int32 and torch.equal(h.long(), want_h)
    assert (cell_se[:, 0] == rows.shape[0]).all() and (cell_se[:, 1] == 0
                                                       ).all()
    salted = salt is not None and hashgrid.REWEIGHT
    order, _ = hashgrid.radix_sort_plain(
        hashgrid.sort_keys(h.long(), salt if salted else None),
        hashgrid.key_bits(table, salted))
    got_rows, got_se = hashgrid.grid_table(rows, h.long(), order, table)
    want = hashgrid.build_grid(rows, valid.bool(), setup["ts"].scene_min,
                               mr, table, salt=salt)
    assert torch.equal(got_rows.view(torch.int32),
                       want.rows.view(torch.int32))
    assert torch.equal(got_se, want.cell_se)
    assert want.table_size == table


def test_tile_sharded_mega_engine(spp_mesh_render):
    acc, done, rays = spp_mesh_render(unidirectional_mega.render_sample)
    assert done == 2 and rays > 0 and np.isfinite(acc).all()
    acc1, _, _ = spp_mesh_render(unidirectional.render_sample)
    assert abs(acc.mean() - acc1.mean()) / max(acc1.mean(), 1e-6) < 0.25


@pytest.mark.parametrize("mod", [vcm_mega, bdpt_mega])
def test_mega_splat_engines_are_refused(setup, mod):
    mesh = _cpu_mesh(1, 1)
    with pytest.raises(NotImplementedError, match="splat_shape"):
        sharding.render_sharded(mod.render_sample, mesh, setup["ts"],
                                setup["tc"], W, H, 1, splat=True)


@pytest.mark.parametrize("devices", [None, ["cuda:0"], ["cpu", "cuda:3"]])
def test_missing_device_is_an_error(devices):
    """A mesh without its devices raises; nothing moves to the CPU (on a
    machine without a CUDA device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA device"):
        sharding.make_mesh(1, 1, devices=devices)
