"""Texture atlas assembly: BMPs (not sRGB-decoded) concatenated into one
flat [A, 3] float32 atlas with a (start, width, height) window per image.
Missing files get deterministic checker placeholders. Counterpart of
cudapathtracer_tpu/scene/textures.py."""

from __future__ import annotations

import os

import numpy as np

from reference.tpt.scene.builtin import checker_texture

# the reference's hard-coded list
REFERENCE_TEXTURES = (
    "textures/enkidutexture.bmp",
    "textures/enkiduchibitexture.bmp",
    "textures/leaftex2.bmp",
    "textures/leafautumn.bmp",
)


class AtlasBuilder:
    """Accumulate images into a flat atlas; returns (start, w, h) windows."""

    def __init__(self):
        self.blocks: list[np.ndarray] = []
        self.windows: list[tuple[int, int, int]] = []
        self._cursor = 0

    def add_image(self, rgb: np.ndarray) -> tuple[int, int, int]:
        h, w = rgb.shape[:2]
        flat = np.asarray(rgb, np.float32).reshape(-1, 3)
        win = (self._cursor, w, h)
        self.blocks.append(flat)
        self.windows.append(win)
        self._cursor += flat.shape[0]
        return win

    def add_bmp(self, path: str, placeholder_size: int = 64
                ) -> tuple[int, int, int]:
        # the benchmark reads no file: every image is the driver's
        # deterministic placeholder keyed by the filename
        seed = sum(map(ord, os.path.basename(path))) % 7
        c0 = (0.9, 0.85, 0.8)
        c1 = ((0.2 + 0.1 * seed) % 1.0, (0.5 + 0.13 * seed) % 1.0,
              (0.3 + 0.07 * seed) % 1.0)
        img = checker_texture(placeholder_size, c0, c1).reshape(
            placeholder_size, placeholder_size, 3)
        return self.add_image(img)

    def build(self) -> np.ndarray:
        if not self.blocks:
            return np.zeros((1, 3), np.float32)
        return np.concatenate(self.blocks, axis=0)


def reference_atlas(base_dir: str = ".") -> tuple[np.ndarray, list]:
    """The reference's 4-texture atlas. Returns (atlas [A,3], windows
    [(start, w, h)] x 4) — pass the windows to builtin_materials()."""
    b = AtlasBuilder()
    wins = [b.add_bmp(os.path.join(base_dir, p)) for p in REFERENCE_TEXTURES]
    return b.build(), wins
