"""The port's mirror of tests/test_adversarial.py (the adversarial numeric
sweeps): grazing angles, degenerate UVs, extreme scene scales and
near-TIR dielectrics, on the port's plain CPU paths (ops/bsdf.py and
models/unidirectional.render_plain through render_sample on CPU tensors),
with the same inputs and invariants: every output finite, a sampled
direction of unit length within 1e-4, a non-negative image whose light is
visible, and no NaN from a 1e6-luminance light's MIS weights.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cudapathtracer_tpu_torch.models import unidirectional
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import (Material,
                                                      MaterialTable,
                                                      build_table,
                                                      builtin_materials)
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

GRAZE = [1e-7, 1e-4, 1e-2]


def _finite(*arrays):
    for a in arrays:
        assert torch.isfinite(torch.as_tensor(a)).all()


def _rows(mats, n):
    """n lanes of the first material, as tensors."""
    table = build_table(mats)
    return MaterialTable(**{f.name: torch.as_tensor(
        getattr(table, f.name)[np.zeros(n, dtype=np.int64)])
        for f in dataclasses.fields(table)})


def _lanes(v, n):
    return torch.tensor(v, dtype=torch.float32).expand(n, 3).contiguous()


def _sample(mat, alb, wi, backface, eta_i):
    n = wi.shape[0]
    return bsdf_ops.bsdf_sample(rng.base_key(), 0, mat, alb, wi, backface,
                                eta_i, ids=torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("z", GRAZE)
def test_ggx_grazing_angles(z):
    """GGX metal f / pdf / sample stay finite as wi nears the horizon."""
    n = 4
    mat = _rows([Material.metal((0.14, 0.16, 0.13), (0.14, 0.16, 0.13),
                                0.1)], n)
    s = float(np.sqrt(max(1.0 - z * z, 0.0)))
    wi, wo = _lanes([s, 0.0, z], n), _lanes([-s * 0.5, 0.5, z], n)
    alb, one = torch.ones((n, 3)), torch.ones(n)
    f = bsdf_ops.bsdf_f(mat, alb, wi, wo, one)
    pdf = bsdf_ops.bsdf_pdf(mat, wi, wo, one)
    _finite(f, pdf, *_sample(mat, alb, wi, torch.zeros(n, dtype=torch.bool),
                             one))


@pytest.mark.parametrize("z", GRAZE)
def test_leaf_grazing_angles(z):
    """The layered leaf BSDF at grazing incidence."""
    n = 4
    mat = _rows([Material.leaf(ior=1.4, roughness=0.3,
                               albedo=(0.2, 0.5, 0.1), transmission=0.4)], n)
    s = float(np.sqrt(max(1.0 - z * z, 0.0)))
    wi, wo = _lanes([s, 0.0, z], n), _lanes([0.0, s, -z], n)
    alb, one = torch.full((n, 3), 0.3), torch.ones(n)
    f = bsdf_ops.bsdf_f(mat, alb, wi, wo, one)
    pdf = bsdf_ops.bsdf_pdf(mat, wi, wo, one)
    _finite(f, pdf, *_sample(mat, alb, wi, torch.zeros(n, dtype=torch.bool),
                             one))


def test_dielectric_near_tir():
    """A smooth dielectric at and just inside the critical angle, leaving
    the dense medium: the sample stays finite and of unit length."""
    n, ior = 8, 1.5
    zc = np.sqrt(1.0 - 1.0 / ior ** 2)
    mat = _rows([Material.smooth_dielectric(ior, (0.0, 0.0, 0.0), 1)], n)
    for dz in (1e-6, -1e-6, 0.0):
        z = float(np.clip(zc + dz, 1e-6, 1.0))
        s = float(np.sqrt(max(1.0 - z * z, 0.0)))
        wo, f, pdf = _sample(mat, torch.ones((n, 3)), _lanes([s, 0.0, z], n),
                             torch.ones(n, dtype=torch.bool),
                             torch.full((n,), ior))
        _finite(wo, f, pdf)
        assert float((torch.linalg.norm(wo, dim=-1) - 1.0).abs().max()) \
            < 1e-4


def test_degenerate_uv_texture_lookup():
    """Texture fetch at uv 0, 1, negative and far outside (wrap
    addressing) stays in bounds and finite."""
    tex = torch.as_tensor(np.random.default_rng(0).random((16, 3)),
                          dtype=torch.float32)
    uv = torch.tensor([[0.0, 0.0], [1.0, 1.0], [-0.25, 2.75], [1e6, -1e6],
                       [0.5, 0.5]])
    n = uv.shape[0]
    out = bsdf_ops.sample_texture(tex, torch.zeros(n, dtype=torch.int32),
                                  torch.full((n,), 4, dtype=torch.int32),
                                  torch.full((n,), 4, dtype=torch.int32), uv)
    _finite(out)


def _render8(mesh, eye_z):
    scene, _ = build_scene(mesh, builtin_materials(), device="cpu")
    cam = Camera.pinhole((0.0, 0.0, eye_z), 8, 8, 0.0, 0.0, 0.0, 60.0)
    py, px = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij")
    li, _ = unidirectional.render_sample(scene, cam, rng.base_key(), 0,
                                         px.reshape(-1), py.reshape(-1),
                                         max_depth=4)
    return li


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_scene_scale_extremes(scale):
    """The whole path (BVH build, traversal epsilons, NEE geometry terms)
    renders finite at millimetre and kilometre scene scales."""
    mesh = builtin.cornell_with_blocks()
    mesh.positions = (np.asarray(mesh.positions) * scale).astype(np.float32)
    img = _render8(mesh, 1.0 * scale)
    _finite(img)
    assert (img >= 0.0).all()
    assert img.max() > 0.0   # the light is visible, not a black frame


def test_huge_emission_firefly_path():
    """A 1e6-luminance light must not NaN the power-2 MIS weights."""
    _finite(_render8(builtin.cornell_box(light_scale=1e6), 1.0))
