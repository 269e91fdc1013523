"""Host scene packing of the PyTorch port against the JAX package.

Tolerance: none. The port packs tri_f32, light_f32 and bvh8_table itself
(and the root box's min corner and half diagonal, which place and size
the VCM photon grid; on a traversal="threaded" scene also node_packed, the
threaded engine's node rows, its largest leaf and the BVH8 table collapsed
from the non-SBVH tree),
from its own builtin meshes with its own copies of the SAH/SBVH builders,
the BVH8 collapse and their native C++ library, so the blocks are compared
as uint32 views and must be bit-equal: both packages must traverse the
same tables.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.materials import build_table as jbuild_table
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu_torch.scene import builtin as tbuiltin
from cudapathtracer_tpu_torch.scene import materials as tmaterials
from cudapathtracer_tpu_torch.scene.scene import build_scene, pack_scene
from test_torch_common import _one_thread  # noqa: F401  (autouse)

# name -> (JAX package's mesh, port's mesh)
SCENES = {
    "blocks": (builtin.cornell_with_blocks, tbuiltin.cornell_with_blocks),
    "bunny2": (lambda: builtin.cornell_with_bunny(subdivisions=2),
               lambda: tbuiltin.cornell_with_bunny(subdivisions=2)),
    # material 13 is MAT_LEAF: SBVH off, 94 columns
    "bunny2_leaf": (
        lambda: builtin.cornell_with_bunny(subdivisions=2, bunny_mat=13),
        lambda: tbuiltin.cornell_with_bunny(subdivisions=2, bunny_mat=13)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_blocks_bit_equal(name):
    jmesh, tmesh = SCENES[name]
    js, _ = jbuild_scene(jmesh(), jbuiltin_materials())
    hs, _ = pack_scene(tmesh(), tmaterials.builtin_materials())
    for blk in ("tri_f32", "light_f32", "bvh8_table"):
        want = np.asarray(getattr(js, blk))
        got = getattr(hs, blk)
        assert got.shape == want.shape, blk
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=blk)
    assert hs.tri_f32.shape[1] == (94 if name == "bunny2_leaf" else 78)
    assert hs.num_lights == js.num_lights
    assert hs.has_leaf_materials == js.has_leaf_materials
    assert hs.has_trans_maps == js.has_trans_maps
    assert hs.bvh8_leaf_tris == js.bvh8_leaf_tris
    # the photon grid's origin and the merge radius' scale (VCM)
    np.testing.assert_array_equal(
        np.asarray(hs.scene_min, np.float32).view(np.uint32),
        np.asarray(js.node_bounds)[0, 0:3].view(np.uint32))
    assert np.float32(hs.scene_radius) == np.float32(js.scene_radius)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_threaded_blocks_bit_equal(name):
    jmesh, tmesh = SCENES[name]
    js, _ = jbuild_scene(jmesh(), jbuiltin_materials(), traversal="threaded")
    hs, bvh = pack_scene(tmesh(), tmaterials.builtin_materials(),
                         traversal="threaded")
    for blk in ("tri_f32", "light_f32", "bvh8_table", "node_packed"):
        want = np.asarray(getattr(js, blk))
        got = getattr(hs, blk)
        assert got.shape == want.shape, blk
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=blk)
    assert hs.traversal == js.traversal == "threaded"
    assert hs.max_leaf_size == js.max_leaf_size
    assert hs.node_packed.shape == (bvh.num_nodes, 48)   # K = 2
    assert bvh.links.shape == (bvh.num_nodes, 8, 2)
    # the default scene keeps the JAX sentinel and no links
    hd, bd = pack_scene(tmesh(), tmaterials.builtin_materials())
    assert hd.traversal == "bvh8" and hd.node_packed.shape == (1, 8)
    assert bd.links.shape == (1, 8, 2)


def test_materials_table_equal():
    want = jbuild_table(jbuiltin_materials(), device=False)
    got = tmaterials.build_table(tmaterials.builtin_materials())
    assert len(tmaterials.builtin_materials()) == 24
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
    dev = got.to("cpu")
    assert isinstance(dev.albedo, torch.Tensor)
    assert dev.albedo.dtype == torch.float32 and dev.type.dtype == torch.int32


def test_upload_and_views():
    scene, bvh = build_scene(tbuiltin.cornell_with_blocks(),
                             tmaterials.builtin_materials(), device="cpu")
    assert scene.tri_f32.dtype == torch.float32
    assert scene.bvh8_table.shape[1] == 96
    assert scene.tri_shade_row.shape == (scene.num_triangles, 48)
    assert scene.num_triangles == bvh.perm.shape[0]
    assert scene.materials.count == 24
    assert scene.traversal == "bvh8" and scene.max_leaf_size == 2
    tsc, tbvh = build_scene(tbuiltin.cornell_with_blocks(),
                            tmaterials.builtin_materials(),
                            traversal="threaded", device="cpu")
    assert tsc.traversal == "threaded"
    assert tsc.node_packed.shape == (tbvh.num_nodes, 48)
    with pytest.raises(ValueError, match="traversal"):
        pack_scene(tbuiltin.cornell_box(), tmaterials.builtin_materials(),
                   traversal="stack")
