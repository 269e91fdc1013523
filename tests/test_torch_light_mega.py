"""The keyed light walk of the PyTorch port (models/light_mega.py: K12's
table mode on the card, its plain version here) and K6's keyed draws
(utils/rng.py: draw_key_table, uniform_keyed), against the JAX package on
the CPU.

Tolerances, with their reasons:
  * draw_key_table and uniform_keyed: bit-equal (the same Threefry words).
  * light_walk_mega against JAX's light_walk_mega (the lane machine), on
    tests/test_light_mega.py's scene (Cornell box, two boxes, 16x16 paths,
    depth 5), both flavours (eta_vcm set, and None): the draws are
    bit-equal, so `valid`, the ray counts, mat_id, is_delta and light_ind
    are equal, and the valid vertices are held to test_light_mega.py's own
    per-field bounds between its machine and its classic walk (pt rtol
    1e-5; beta rtol 1e-2; pdf_fwd, d_vcm, d_vc, d_vm rtol 1e-4; decoded
    normals and directions within 1e-2): the two differ only in float
    association (XLA's lane-major machine against eager PyTorch).
  * The port's keyed walk against its own folded walk
    (paths.generate_light_path): every buffer field and vertex 0
    bit-equal, rays equal (the same code with the same draw bits).
  * TPT_MEGA_LIGHT=1 through Renderer: the route goes through
    light_walk_mega, and the image equals the toggle-off render bit for bit
    (the keyed walk's buffers, and BDPT's vertex 0 from the keyed walk,
    are the folded walk's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import light_mega as jlight_mega
from cudapathtracer_tpu.scene import builtin as jbuiltin
from cudapathtracer_tpu.scene.materials import TRANSPORT_IMPORTANCE
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch.driver import Renderer
from cudapathtracer_tpu_torch.models import light_mega, paths
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.config import MeshConfig, RenderConfig
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = 16
C = W * W
DEPTH = 5
FIELD_TOL = (("pt", 1e-5, 1e-6), ("beta", 1e-2, 1e-3), ("pdf_fwd", 1e-4, 1e-8),
             ("d_vcm", 1e-4, 1e-6), ("d_vc", 1e-4, 1e-6), ("d_vm", 1e-4, 1e-6))


def _mesh(mod):
    mesh = mod.cornell_box(light_scale=1.6, light_emission=(3.0, 3.0, 3.0))
    mod.box(mesh, (-0.30, -0.5, -0.25), (-0.05, 0.1, 0.0), 2)
    mod.box(mesh, (0.05, -0.5, 0.05), (0.30, -0.2, 0.30), 2)
    return mesh


@pytest.fixture(scope="module")
def scenes():
    js, _ = jbuild_scene(_mesh(jbuiltin), jbuiltin_materials())
    ts, _ = build_scene(_mesh(builtin), builtin_materials(), device="cpu")
    return js, ts


def test_draw_key_table_matches_jax():
    key = rng.sample_key(rng.base_key(), 3)
    jkey = jrng.sample_key(jrng.base_key(), 3)
    for bounces, draws in ((range(DEPTH), range(4)),
                           (None, range(100, 105))):
        t = rng.draw_key_table(key, bounces, draws)
        j = np.asarray(jrng.draw_key_table(jkey, bounces, draws))
        assert t.dtype == torch.uint32
        np.testing.assert_array_equal(t.numpy(), j)


def test_uniform_keyed_matches_jax():
    gen = np.random.default_rng(31)
    n = 4096
    k0 = gen.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    k1 = gen.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    ids = gen.integers(0, 2 ** 31, n).astype(np.int32)
    t = rng.uniform_keyed(torch.as_tensor(k0), torch.as_tensor(k1),
                          torch.as_tensor(ids))
    j = jrng.uniform_keyed(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(ids))
    np.testing.assert_array_equal(t.numpy().view(np.int32),
                                  np.asarray(j).view(np.int32))
    # broadcast pairs: uniform_id's draw
    key = rng.bounce_key(rng.base_key(), 2)
    a, b = rng.draw_key(key, 7)
    ti = torch.as_tensor(ids)
    u = rng.uniform_keyed(torch.full((n,), a, dtype=torch.int64)
                          .to(torch.uint32), torch.full(
                              (n,), b, dtype=torch.int64).to(torch.uint32),
                          ti)
    assert torch.equal(u, rng.uniform_id(key, 7, ti))


@pytest.mark.parametrize("flavor", ["vcm", "bdpt"])
def test_light_walk_mega_matches_jax(scenes, flavor):
    js, ts = scenes
    s = 3 if flavor == "vcm" else 7
    key, jkey = (rng.sample_key(rng.base_key(), s),
                 jrng.sample_key(jrng.base_key(), s))
    eta = 37.5 if flavor == "vcm" else None
    if flavor == "vcm":   # pairing by grid arithmetic
        jb, jrays = jlight_mega.light_walk_mega(
            js, jkey, C, DEPTH, TRANSPORT_IMPORTANCE,
            eta_vcm=jnp.float32(eta), grid_w=W, width=64, steps_per_iter=1,
            mini_splits=1)
        tb, trays = light_mega.light_walk_mega(
            ts, key, C, DEPTH, TRANSPORT_IMPORTANCE, eta_vcm=eta, grid_w=W,
            width=64, steps_per_iter=1, mini_splits=1)
    else:                 # pairing by pixel tables
        gx, gy = np.meshgrid(np.arange(W), np.arange(W))
        px, py = gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)
        jb, jrays = jlight_mega.light_walk_mega(
            js, jkey, C, DEPTH, TRANSPORT_IMPORTANCE, eta_vcm=None,
            pxc=jnp.asarray(px), pyc=jnp.asarray(py), width=64,
            steps_per_iter=2, mini_splits=2)
        tb, trays = light_mega.light_walk_mega(
            ts, key, C, DEPTH, TRANSPORT_IMPORTANCE, pxc=torch.as_tensor(px),
            pyc=torch.as_tensor(py))
    assert tb.pt.shape == (DEPTH - 1, C, 3)
    m = np.asarray(jb.valid)
    np.testing.assert_array_equal(tb.valid.numpy(), m)
    assert m.sum() > C
    assert int(trays) == int(jrays)
    for name, rtol, atol in FIELD_TOL:
        np.testing.assert_allclose(getattr(tb, name).numpy()[m],
                                   np.asarray(getattr(jb, name))[m],
                                   rtol=rtol, atol=atol, err_msg=name)
    for name in ("mat_id", "is_delta", "light_ind"):
        np.testing.assert_array_equal(getattr(tb, name).numpy()[m],
                                      np.asarray(getattr(jb, name))[m])
    for name in ("n", "wo"):
        d = np.abs(getattr(tb, name).numpy()[m]
                   - np.asarray(getattr(jb, name))[m])
        assert (d < 1e-2).all(), name
    if flavor == "bdpt":
        assert not tb.d_vm.numpy()[m].any()


@pytest.mark.parametrize("eta", [None, 5.1471854])
def test_keyed_walk_bit_equal_to_folded(scenes, eta):
    _, ts = scenes
    key = rng.sample_key(rng.base_key(), 4)
    gx, gy = np.meshgrid(np.arange(W), np.arange(W))
    px = torch.as_tensor(gx.ravel().astype(np.int32))
    py = torch.as_tensor(gy.ravel().astype(np.int32))
    kb, kv0, krays = light_mega.walk_with_endpoint(
        ts, key, C, DEPTH, TRANSPORT_IMPORTANCE, eta_vcm=eta, pxc=px, pyc=py)
    fb, fv0, frays = paths.generate_light_path(ts, key, px, py, DEPTH,
                                               eta_vcm=eta)
    assert krays == frays
    for name, a, b in zip(paths.PathBuffers._fields, kb, fb):
        assert torch.equal(a, b), name
    assert kv0.keys() == fv0.keys()
    for name in fv0:
        assert torch.equal(kv0[name], fv0[name]), name


@pytest.mark.parametrize("integrator", ["BIDIRECTIONAL", "VCM"])
def test_renderer_routes_through_light_mega(tmp_path, monkeypatch,
                                            integrator):
    cfg = RenderConfig(width=12, height=12, sample_count=1,
                       integrator=integrator, bdpt_eye_depth=4,
                       bdpt_light_depth=3, pinhole_camera=True,
                       cam_pos=(0.0, 0.0, 1.0),
                       meshes=[MeshConfig(path="builtin:cornell_blocks")],
                       output_dir=str(tmp_path))
    assert cfg.engine == "mega"
    monkeypatch.delenv("TPT_MEGA_LIGHT", raising=False)
    off = Renderer(cfg, device="cpu")
    off.render(progressive=False, verbose=False)
    monkeypatch.setenv("TPT_MEGA_LIGHT", "1")
    light_mega.calls["light_walk_mega"] = 0
    on = Renderer(cfg, device="cpu")
    on.render(progressive=False, verbose=False)
    assert light_mega.calls["light_walk_mega"] == 1   # one chunk, 1 sample
    assert bool(torch.isfinite(on.accum).all())
    assert torch.equal(on.accum, off.accum)
    assert on.metrics.rays_traced == off.metrics.rays_traced
