"""The inputs of a run, made by the benchmark and handed to both sides.

The scene mesh, the material table and the texture atlas come from the
reference's frozen copies of the generators (reference/tpt/scene), so a
change to the program's generators cannot move them. The settings are a
.rendertron text built from the configuration's settings, the traffic's
frame and dispatch size and the run's seed.
"""

from __future__ import annotations

from reference.tpt.scene import builtin
from reference.tpt.scene.materials import builtin_materials
from reference.tpt.scene.textures import reference_atlas


def settings_text(cfg: dict, traffic: dict, seed: int) -> str:
    """The .rendertron text of a run: the configuration's keys, the
    traffic's frame and samples per dispatch, `Seed` from the run."""
    lines = [f"{k}: {v}" for k, v in cfg["rendertron"].items()]
    lines += [f"width: {traffic['width']}", f"height: {traffic['height']}",
              f"Samples Per Dispatch: {traffic['samples_per_dispatch']}",
              f"Seed: {int(seed)}"]
    return "\n".join(lines) + "\n"


def scene_inputs(cfg: dict):
    """(mesh, materials, atlas) of the configuration's scene."""
    scene = cfg["scene"]
    mesh = getattr(builtin, scene["builtin"])(**scene.get("args", {}))
    atlas, windows = reference_atlas()
    return mesh, builtin_materials(windows), atlas


def samples_per_dispatch(cfg, device) -> int:
    """The driver's rule (driver.resolve_samples_per_dispatch), copied for
    the control: an explicit value wins; else the CPU or a frame above
    512^2 pixels renders one sample a dispatch, and a card batches
    max(1, min(8, 2^21 // pixels))."""
    if cfg.samples_per_dispatch > 0:
        return cfg.samples_per_dispatch
    n = cfg.width * cfg.height
    if str(device).startswith("cpu") or n > (1 << 18):
        return 1
    return max(1, min(8, (1 << 21) // max(n, 1)))
