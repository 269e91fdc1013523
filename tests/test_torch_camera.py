"""Primary ray generation (kernel K7's plain version) against the JAX
package. Tolerance: atol 1e-6. The draws are bit-equal; cos, sin and rsqrt
of XLA:CPU and PyTorch may differ in the last ulp. At aperture 0 the lens
is off: every origin is the camera's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu.utils.config import parse_config
from cudapathtracer_tpu_torch.scene.camera import Camera as TCamera
from cudapathtracer_tpu_torch.utils import rng as trng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W, H = 24, 16
CAMERAS = {
    "pinhole": ("pinhole", ((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)),
    "pinhole_rotated": ("pinhole", ((0.2, -0.1, 1.5), W, H, 10.0, -25.0,
                                    5.0, 45.0)),
    "thin_lens": ("thin_lens", ((0.1, 0.2, 1.0), W, H, 10.0, -20.0, 5.0,
                                45.0, 0.05, 1.3)),
    # aperture 0 (K7 skips the lens) with a nonzero jitter
    "aperture_0": ("thin_lens", ((-0.3, 0.1, 1.2), W, H, -5.0, 15.0, 0.0,
                                 50.0, 0.0, 1.1, 1.5)),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_generate_rays_matches_jax(name):
    factory, args = CAMERAS[name]
    jc = getattr(JCamera, factory)(*args)
    tc = getattr(TCamera, factory)(*args)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    px, py = gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)
    for sample in (0, 5):
        jkey = jax.random.fold_in(jrng.sample_key(jrng.base_key(), sample),
                                  2 ** 20)
        tkey = trng.fold_in(trng.sample_key(trng.base_key(), sample), 2 ** 20)
        jo, jd = jc.generate_rays(
            jkey, jnp.asarray(px, jnp.float32), jnp.asarray(py, jnp.float32),
            ids=jrng.pixel_ids(jnp.asarray(px), jnp.asarray(py)))
        ids = trng.pixel_ids(torch.as_tensor(px), torch.as_tensor(py))
        to, td = tc.generate_rays(tkey, torch.as_tensor(px).float(),
                                  torch.as_tensor(py).float(), ids)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(td.numpy(), axis=1), 1.0,
                               atol=1e-6)
    if tc.aperture == 0.0:
        np.testing.assert_array_equal(
            to.numpy(), np.broadcast_to(np.float32(tc.origin), to.shape))


def test_from_config():
    cfg = parse_config("width: 32\nheight: 24\nPinhole Camera: true\n"
                       "Camera Position: 0.0 0.0 1.0\nCamera FOV: 60.0\n")
    jc, tc = JCamera.from_config(cfg), TCamera.from_config(cfg)
    assert (tc.width, tc.height) == (32, 24)
    np.testing.assert_allclose(tc.forward, np.asarray(jc.forward), atol=1e-7)
    assert tc.fov_scale == pytest.approx(float(jc.fov_scale), abs=1e-7)
    assert tc.aperture == pytest.approx(float(jc.aperture), abs=1e-12)
    assert tc.focal_dist == pytest.approx(float(jc.focal_dist), abs=1e-9)
