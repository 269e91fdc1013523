"""Material system: host-side Material rows and the tensor MaterialTable.

Counterpart of cudapathtracer_tpu/scene/materials.py with the same type
ids, factories, 24-entry builtin registry (index-compatible with config
material ids) and `Materials` config overrides. `build_table` returns the
table as numpy columns (what the scene packer reads) or as tensors on a
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

MAT_DIFFUSE = 0
MAT_METAL = 1
MAT_SMOOTHDIELECTRIC = 2
MAT_MICROFACETDIELECTRIC = 3
MAT_LEAF = 4
MAT_FLOWER = 5
MAT_DELTAMIRROR = 6

AIR_PRIORITY = 99  # priority of the ambient medium

TRANSPORT_RADIANCE = 0
TRANSPORT_IMPORTANCE = 1


@dataclass
class Material:
    """Host-side material description (one row of the table)."""
    type: int = MAT_DIFFUSE
    albedo: tuple = (0.8, 0.8, 0.8)
    roughness: float = 0.5
    eta: tuple = (0.0, 0.0, 0.0)    # conductor IOR, real part
    k: tuple = (0.0, 0.0, 0.0)      # conductor IOR, imaginary part
    ior: float = 1.5                # dielectric IOR
    transmission: float = 0.0
    is_specular: bool = False
    boundary: bool = False          # takes part in the medium stack
    thin_walled: bool = False
    absorption: tuple = (0.0, 0.0, 0.0)  # Beer-Lambert sigma_a
    priority: int = 0               # nested-dielectric priority (lower wins)
    tex_start: int = -1             # texture atlas window; -1 = none
    tex_width: int = 0
    tex_height: int = 0
    trans_tex_start: int = -1
    trans_tex_width: int = 0
    trans_tex_height: int = 0

    @staticmethod
    def diffuse(color) -> "Material":
        return Material(type=MAT_DIFFUSE, albedo=tuple(color), roughness=1.0)

    @staticmethod
    def diffuse_textured(start: int, w: int, h: int) -> "Material":
        return Material(type=MAT_DIFFUSE, roughness=1.0,
                        tex_start=start, tex_width=w, tex_height=h)

    @staticmethod
    def metal(eta, k, roughness: float = 0.1) -> "Material":
        return Material(type=MAT_METAL, eta=tuple(eta), k=tuple(k),
                        roughness=roughness, albedo=(1.0, 1.0, 1.0))

    @staticmethod
    def smooth_dielectric(ior: float = 1.5, absorption=(0.0, 0.0, 0.0),
                          priority: int = 0) -> "Material":
        return Material(type=MAT_SMOOTHDIELECTRIC, ior=ior,
                        albedo=(1.0, 1.0, 1.0), absorption=tuple(absorption),
                        priority=priority, is_specular=True, boundary=True)

    @staticmethod
    def leaf(ior: float = 1.5, roughness: float = 0.7, albedo=(0.0, 0.0, 0.0),
             transmission: float = 0.05, tex_start: int = -1,
             tex_width: int = 0, tex_height: int = 0,
             trans_tex_start: int = -1, trans_tex_width: int = 0,
             trans_tex_height: int = 0) -> "Material":
        return Material(type=MAT_LEAF, ior=ior, roughness=roughness,
                        albedo=tuple(albedo), transmission=transmission,
                        thin_walled=True, tex_start=tex_start,
                        tex_width=tex_width, tex_height=tex_height,
                        trans_tex_start=trans_tex_start,
                        trans_tex_width=trans_tex_width,
                        trans_tex_height=trans_tex_height)

    @staticmethod
    def mirror() -> "Material":
        return Material(type=MAT_DELTAMIRROR, is_specular=True)

    @staticmethod
    def air() -> "Material":
        """The ambient medium, always material index 0."""
        return Material.smooth_dielectric(1.0, (0.0, 0.0, 0.0), AIR_PRIORITY)


@dataclass
class MaterialTable:
    """Struct of arrays over materials (or over hits, see
    ops/traverse.shade_data): [M] or [M,3] numpy arrays or tensors."""
    type: object
    albedo: object
    roughness: object
    eta: object
    k: object
    ior: object
    transmission: object
    is_specular: object
    boundary: object
    thin_walled: object
    absorption: object
    priority: object
    tex_start: object
    tex_width: object
    tex_height: object
    trans_tex_start: object
    trans_tex_width: object
    trans_tex_height: object

    @property
    def count(self) -> int:
        return self.type.shape[0]

    def to(self, device) -> "MaterialTable":
        """Tensor copy of every column on `device`."""
        return MaterialTable(**{
            f.name: torch.as_tensor(getattr(self, f.name)).to(device)
            for f in dataclasses.fields(self)})


_COLUMNS = (("type", np.int32, None), ("albedo", np.float32, 3),
            ("roughness", np.float32, None), ("eta", np.float32, 3),
            ("k", np.float32, 3), ("ior", np.float32, None),
            ("transmission", np.float32, None),
            ("is_specular", np.bool_, None), ("boundary", np.bool_, None),
            ("thin_walled", np.bool_, None), ("absorption", np.float32, 3),
            ("priority", np.int32, None), ("tex_start", np.int32, None),
            ("tex_width", np.int32, None), ("tex_height", np.int32, None),
            ("trans_tex_start", np.int32, None),
            ("trans_tex_width", np.int32, None),
            ("trans_tex_height", np.int32, None))


def build_table(mats: list[Material], device=None) -> MaterialTable:
    """Material struct of arrays: numpy columns when device is None, else
    tensors on `device`."""
    cols = {}
    for name, dtype, dim in _COLUMNS:
        arr = np.asarray([getattr(m, name) for m in mats], dtype=dtype)
        cols[name] = arr.reshape(len(mats), dim) if dim else arr
    table = MaterialTable(**cols)
    return table if device is None else table.to(device)


def builtin_materials(tex_windows: list[tuple[int, int, int]] | None = None
                      ) -> list[Material]:
    """The reference's hard-coded 24-material registry, index-compatible
    with config material ids. tex_windows: up to 4 (start, width, height)
    atlas windows for the textured materials 11, 12, 13 and 16."""
    tw = list(tex_windows or [(-1, 0, 0)] * 4)
    while len(tw) < 4:
        tw.append((-1, 0, 0))

    eta_steel = (0.14, 0.16, 0.13)
    # reference quirk: gold and steel are built as Metal(eta, eta), k = eta
    eta_gold = (0.17, 0.35, 1.5)

    return [
        Material.air(),                                         # 0
        Material.diffuse((0.4, 0.4, 0.8)),                      # 1  blue
        Material.diffuse((0.9, 0.9, 0.9)),                      # 2  white
        Material.diffuse((0.2, 0.6, 0.6)),                      # 3  green
        Material.metal(eta_gold, eta_gold, 0.05),               # 4  gold
        Material.smooth_dielectric(1.5, (0.0, 0.0, 0.0), 1),    # 5  glass
        Material.diffuse((0.90, 0.1, 0.1)),                     # 6  red
        Material.metal(eta_steel, eta_steel, 0.15),             # 7  steel
        Material.smooth_dielectric(
            1.333, (2.5 * 0.180, 2.5 * 1.5, 2.5 * 2.996), 2),   # 8  tea
        Material.smooth_dielectric(1.31, (0.2, 0.2, 0.2), 0),   # 9  ice
        Material.smooth_dielectric(1.333, (0.0, 0.0, 0.0), 2),  # 10 water
        Material.diffuse_textured(*tw[0]),                      # 11
        Material.diffuse_textured(*tw[1]),                      # 12
        Material.leaf(1.5, 0.10, (0.22, 0.75, 0.28), 0.15,
                      tw[2][0], tw[2][1], tw[2][2]),            # 13 leaf
        Material.diffuse((0.90, 0.9, 0.83)),                    # 14 leafStem
        Material.diffuse((0.4, 0.4, 1.0)),                      # 15 sky
        Material.leaf(1.5, 0.8, (0.22, 0.75, 0.28), 0.6,
                      tw[3][0], tw[3][1], tw[3][2]),            # 16 autumn
        Material.diffuse((0.8, 0.8, 0.8)),                      # 17 grey
        Material.smooth_dielectric(2.42, (0.0, 0.0, 0.0), 1),   # 18 diamond
        Material.mirror(),                                      # 19
        Material.diffuse((0.0, 0.0, 0.0)),                      # 20 black
        Material.diffuse((0.95, 0.95, 0.95)),                   # 21
        Material.diffuse((0.5, 0.5, 0.5)),                      # 22
        Material.diffuse((0.1, 0.9, 0.1)),                      # 23 green
    ]


# `Materials` config-section kinds -> constructors
_MATERIAL_KINDS = {
    "diffuse": lambda albedo=(0.8, 0.8, 0.8): Material.diffuse(albedo),
    "metal": lambda eta=(0.17, 0.35, 1.5), k=None, roughness=0.1:
        Material.metal(eta, eta if k is None else k, roughness),
    "dielectric": lambda ior=1.5, absorption=(0.0, 0.0, 0.0), priority=0:
        Material.smooth_dielectric(ior, absorption, priority),
    "glass": lambda ior=1.5, absorption=(0.0, 0.0, 0.0), priority=0:
        Material.smooth_dielectric(ior, absorption, priority),
    "leaf": Material.leaf,
    "mirror": lambda: Material.mirror(),
    "raw": lambda **kw: Material(**{
        k: tuple(v) if isinstance(v, tuple) else v for k, v in kw.items()}),
}


def apply_material_configs(base: list[Material], entries) -> list[Material]:
    """Apply `Materials` config-section overrides onto a registry copy.
    entries: objects with .material_id, .kind and .params
    (utils.config.MaterialConfig). Ids beyond the registry grow it with
    grey diffuse; id 0 must stay a boundary (medium) material."""
    mats = list(base)
    for e in entries:
        ctor = _MATERIAL_KINDS.get(e.kind.lower())
        if ctor is None:
            raise ValueError(
                f"Materials line: unknown kind {e.kind!r}; expected one of "
                f"{sorted(_MATERIAL_KINDS)}")
        mat = ctor(**e.params)
        if e.material_id < 0:
            raise ValueError(f"Materials line: bad id {e.material_id}")
        if e.material_id == 0 and not mat.boundary:
            raise ValueError(
                "Materials line: id 0 is the ambient medium and must be a "
                "boundary material (dielectric)")
        while len(mats) <= e.material_id:
            mats.append(Material.diffuse((0.5, 0.5, 0.5)))
        mats[e.material_id] = mat
    return mats
