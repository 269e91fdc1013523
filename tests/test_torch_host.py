"""The port's own copies of the host code against the JAX package's originals.

The port keeps its own copy of every host module it needs (the config
parser, the OBJ loader, the builtin meshes, the SAH/SBVH builders, the BVH8
collapse and their native C++ library), so it never imports the JAX
package. Tolerance: none. A copy must give what the original gives: equal
dataclasses (the config's one key of the port's own, `Mesh Shape`, aside:
the shipped configs leave it at its default), and arrays equal element
for element (floats as uint32 views).
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from cudapathtracer_tpu.scene import builtin as jbuiltin
from cudapathtracer_tpu.scene.bvh import build_bvh as jbuild_bvh
from cudapathtracer_tpu.scene.bvh import build_sbvh as jbuild_sbvh
from cudapathtracer_tpu.scene.bvh import bvh_stats as jbvh_stats
from cudapathtracer_tpu.scene.bvh import thread_links as jthread_links
from cudapathtracer_tpu.scene.bvh import triangle_bounds as jtriangle_bounds
from cudapathtracer_tpu.utils import config as jconfig
from cudapathtracer_tpu.utils.obj import MeshData as JMeshData
from cudapathtracer_tpu.utils.obj import load_obj as jload_obj
from cudapathtracer_tpu_torch.scene import builtin as tbuiltin
from cudapathtracer_tpu_torch.scene.bvh import build_bvh, build_sbvh, bvh_stats
from cudapathtracer_tpu_torch.scene.bvh import thread_links, triangle_bounds
from cudapathtracer_tpu_torch.utils import config as tconfig
from cudapathtracer_tpu_torch.utils.metrics import RenderMetrics
from cudapathtracer_tpu_torch.utils.obj import MeshData, load_obj
from test_torch_common import _one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.rendertron")))
_MESH_FIELDS = ("positions", "normals", "uvs", "pos_idx", "nrm_idx",
                "uv_idx", "mat_id", "emission", "light_ind")


def _equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype.kind == "f":
        got = got.view(np.uint32 if got.itemsize == 4 else np.uint64)
        want = want.view(got.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _as_dict(obj):
    """A config dataclass as plain nested values (class names dropped)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _as_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_as_dict(x) for x in obj]
    return obj


# the port's own settings (no key of the JAX package) and their defaults,
# which the shipped configs leave as they are
PORT_ONLY = {"mesh_shape": [1, 1]}


def _shared(cfg) -> dict:
    d = _as_dict(cfg)
    assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return d


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_equal(path):
    want = jconfig.load_config(path)
    got = tconfig.load_config(path)
    assert [f.name for f in dataclasses.fields(got)
            if f.name not in PORT_ONLY] == \
        [f.name for f in dataclasses.fields(want)]
    assert _shared(got) == _as_dict(want)
    assert _shared(got.normalized()) == _as_dict(want.normalized())


_OBJ = """# a quad, a triangle without normals, a degenerate face
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 2 0 1
v 2 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 0
f 1/1/1 2/2/1 3/3/1 4/4/1
f 2/2 5/3 3/1
f 5 6 5
f 1//2 2//2 4//2
"""


def test_obj_equal(tmp_path):
    path = tmp_path / "m.obj"
    path.write_text(_OBJ)
    want = jload_obj(str(path), JMeshData(), 3, (1.0, 0.5, 0.25),
                     offset=(0.0, -0.01, 0.0))
    got = load_obj(str(path), MeshData(), 3, (1.0, 0.5, 0.25),
                   offset=(0.0, -0.01, 0.0))
    assert got.num_triangles == want.num_triangles > 0
    for f in _MESH_FIELDS:
        _equal(getattr(got, f), getattr(want, f), f)


# every builtin mesh the tests and chip_smoke.py build
MESHES = {
    "cornell_box": lambda b: b.cornell_box(),
    "cornell_with_blocks": lambda b: b.cornell_with_blocks(),
    "cornell_with_spheres": lambda b: b.cornell_with_spheres(),
    "cornell_with_bunny_2": lambda b: b.cornell_with_bunny(subdivisions=2),
    "cornell_with_bunny_2_leaf": lambda b: b.cornell_with_bunny(
        subdivisions=2, bunny_mat=13),
    "cornell_with_bunny_4": lambda b: b.cornell_with_bunny(subdivisions=4),
    "cornell_with_bunny_6": lambda b: b.cornell_with_bunny(subdivisions=6),
    "cornell_pool": lambda b: b.cornell_pool(),
    "cornell_glass_core": lambda b: b.cornell_glass_core(),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_builtin_mesh_equal(name):
    want, got = MESHES[name](jbuiltin), MESHES[name](tbuiltin)
    for f in _MESH_FIELDS:
        _equal(getattr(got, f), getattr(want, f), f"{name}.{f}")


def test_checker_texture_equal():
    _equal(tbuiltin.checker_texture(64, (0.9, 0.85, 0.8), (0.3, 0.6, 0.4)),
           jbuiltin.checker_texture(64, (0.9, 0.85, 0.8), (0.3, 0.6, 0.4)),
           "checker")


@pytest.mark.parametrize("sbvh", [False, True], ids=["sah", "sbvh"])
def test_bvh_and_stats_equal(sbvh):
    mesh = tbuiltin.cornell_with_bunny(subdivisions=3)
    p = [mesh.positions[mesh.pos_idx[:, k]] for k in range(3)]
    if sbvh:
        want = jbuild_sbvh(*p, 2, spatial_depth=6, native_below=True)
        got = build_sbvh(*p, 2, spatial_depth=6, native_below=True)
    else:
        c, lo, hi = jtriangle_bounds(*p)
        for a, b in zip(triangle_bounds(*p), (c, lo, hi)):
            _equal(a, b, "triangle_bounds")
        want = jbuild_bvh(c, lo, hi, 2, use_native=True, thread=False)
        got = build_bvh(c, lo, hi, 2, use_native=True, thread=False)
    for f in ("bounds", "leaf", "perm", "left", "right", "axis"):
        _equal(getattr(got, f), getattr(want, f), f)
    assert bvh_stats(got) == jbvh_stats(want)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_thread_links_equal(native):
    """The threaded engine's per-octant (hit, miss) links: build_bvh with
    thread=True and thread_links on the same tree, both builders."""
    mesh = tbuiltin.cornell_with_bunny(subdivisions=2)
    p = [mesh.positions[mesh.pos_idx[:, k]] for k in range(3)]
    c, lo, hi = jtriangle_bounds(*p)
    want = jbuild_bvh(c, lo, hi, 2, use_native=native, thread=True)
    got = build_bvh(c, lo, hi, 2, use_native=native, thread=True)
    for f in ("bounds", "leaf", "perm", "left", "right", "axis", "links"):
        _equal(getattr(got, f), getattr(want, f), f)
    assert got.links.shape == (got.num_nodes, 8, 2)
    _equal(thread_links(got.left, got.right, got.axis, got.leaf),
           jthread_links(want.left, want.right, want.axis, want.leaf),
           "thread_links")
    # without thread the links are the [1, 8, 2] sentinel, as in JAX
    _equal(build_bvh(c, lo, hi, 2, use_native=native, thread=False).links,
           jbuild_bvh(c, lo, hi, 2, use_native=native, thread=False).links,
           "sentinel")


def test_metrics():
    m = RenderMetrics()
    with m.phase("render"):
        m.add_rays(2_000_000)
    m.samples_done = 1
    assert m.rays_traced == 2_000_000 and m.render_seconds > 0.0
    assert m.mrays_per_sec > 0.0 and "Mrays/s" in m.summary()
