"""Render driver: config -> scene -> progressive render -> image files.

Counterpart of cudapathtracer_tpu/driver.py. Every integrator renders
with either engine, the default `Engine: mega` or `Engine: classic`:
UNIDIRECTIONAL (models/unidirectional_mega.py, models/unidirectional.py),
BIDIRECTIONAL (models/bdpt_mega.py, models/bdpt.py; BDPTConfig.from_config),
VCM and SPPM (models/vcm_mega.py, models/vcm.py; VCMConfig.from_config) and
NAIVE_UNIDIRECTIONAL (models/naive.py, one engine). An engine's draw
schedule is its own, so the two engines give different noise realisations
with different goldens: one is never rendered when the other was asked
for. Any other engine raises NotImplementedError. VCM and SPPM count the
photons their merge cap left out (metrics.merge_dropped).

The Renderer runs on an explicit device. "cuda" needs a CUDA build of
PyTorch and a card and raises otherwise; the CPU is used only when asked
for. Checkpoints are the JAX package's `.npz` format (accumulation buffer,
sample count and a config echo), so either package can resume the other's.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from cudapathtracer_tpu_torch.models import bdpt as bdpt_mod
from cudapathtracer_tpu_torch.models import bdpt_mega
from cudapathtracer_tpu_torch.models import naive as naive_mod
from cudapathtracer_tpu_torch.models import unidirectional as uni_mod
from cudapathtracer_tpu_torch.models import unidirectional_mega as mega_mod
from cudapathtracer_tpu_torch.models import vcm as vcm_mod
from cudapathtracer_tpu_torch.models import vcm_mega
from cudapathtracer_tpu_torch.ops import hashgrid
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import (apply_material_configs,
                                                      builtin_materials)
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.scene.textures import reference_atlas
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.config import RenderConfig
from cudapathtracer_tpu_torch.utils.image import Image, scrub
from cudapathtracer_tpu_torch.utils.metrics import RenderMetrics
from cudapathtracer_tpu_torch.utils.obj import MeshData, load_obj

BUILTIN_SCENES = {
    "builtin:cornell": builtin.cornell_box,
    "builtin:cornell_blocks": builtin.cornell_with_blocks,
    "builtin:cornell_spheres": builtin.cornell_with_spheres,
    "builtin:cornell_bunny": builtin.cornell_with_bunny,
}

# (integrator family, engine) -> render_sample
_RENDER = {
    ("UNIDIRECTIONAL", "mega"): mega_mod.render_sample,
    ("UNIDIRECTIONAL", "classic"): uni_mod.render_sample,
    ("BIDIRECTIONAL", "mega"): bdpt_mega.render_sample,
    ("BIDIRECTIONAL", "classic"): bdpt_mod.render_sample,
    ("VCM", "mega"): vcm_mega.render_sample,
    ("VCM", "classic"): vcm_mod.render_sample,
    ("NAIVE_UNIDIRECTIONAL", "mega"): naive_mod.render_sample,
    ("NAIVE_UNIDIRECTIONAL", "classic"): naive_mod.render_sample,
}


def _family(integrator: str) -> str:
    return "VCM" if integrator == "SPPM" else integrator


def resolve_device(device) -> torch.device:
    """torch.device for `device`; "cuda" without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False (no CUDA build of PyTorch or no card); pass --device cpu "
            "to render with the plain PyTorch versions on the CPU")
    return dev


def check_supported(cfg: RenderConfig) -> None:
    """Raise NotImplementedError unless the configuration is ported."""
    if (_family(cfg.integrator), cfg.engine) not in _RENDER:
        raise NotImplementedError(
            f"integrator {cfg.integrator} with engine {cfg.engine!r}: the "
            "engines are 'mega' (the default) and 'classic'")


def mesh_from_config(cfg: RenderConfig, render_number: int = 0) -> MeshData:
    """The scene triangle soup from the config's mesh list: OBJ files or
    builtin:<name> scenes. Emissive OBJ meshes move by (0, -0.01 *
    render_number, 0) per render, as in the reference."""
    mesh = MeshData()
    for mc in cfg.meshes:
        if mc.path in BUILTIN_SCENES:
            sub = BUILTIN_SCENES[mc.path]()
            off, noff, toff = (len(mesh.positions), len(mesh.normals),
                               len(mesh.uvs))
            lbase = (0 if mesh.light_ind.size == 0
                     else int(mesh.light_ind.max()) + 1)
            sub_light = np.where(sub.light_ind >= 0, sub.light_ind + lbase,
                                 -1)
            mesh.positions = np.concatenate([mesh.positions, sub.positions])
            mesh.normals = np.concatenate([mesh.normals, sub.normals])
            mesh.uvs = np.concatenate([mesh.uvs, sub.uvs])
            mesh.pos_idx = np.concatenate([mesh.pos_idx, sub.pos_idx + off])
            mesh.nrm_idx = np.concatenate([mesh.nrm_idx, sub.nrm_idx + noff])
            mesh.uv_idx = np.concatenate([mesh.uv_idx, sub.uv_idx + toff])
            mesh.mat_id = np.concatenate([mesh.mat_id, sub.mat_id])
            mesh.emission = np.concatenate([mesh.emission, sub.emission])
            mesh.light_ind = np.concatenate([mesh.light_ind, sub_light])
        else:
            emissive = sum(e * e for e in mc.emission) > 0.0
            offset = ((0.0, -0.01 * render_number, 0.0) if emissive
                      else (0.0, 0.0, 0.0))
            load_obj(mc.path, mesh, mc.material_id, mc.emission,
                     offset=offset)
    return mesh


def merge_note(dropped: int, max_per_cell: int) -> str:
    """The render's note on the photons the merge cap left out."""
    if hashgrid.REWEIGHT:
        # the salted count/kept reweighting keeps the capped visit an
        # unbiased subsample (ops/hashgrid.py)
        return (f"note: photon merge subsampled {dropped:,} candidate "
                f"photons (max_per_cell={max_per_cell}; unbiased "
                "reweighting — adds merge variance, not energy loss; raise "
                "'VCM Max Photons Per Cell' to trade speed for variance)")
    return (f"WARNING: photon merge cap truncated {dropped:,} candidate "
            f"photons (max_per_cell={max_per_cell}; 'VCM Max Photons Per "
            "Cell' in the config raises it if caustics look dim)")


class Renderer:
    """One configured render: scene, camera, integrator and framebuffer on
    one device."""

    def __init__(self, config: RenderConfig, mesh: MeshData | None = None,
                 materials=None, textures=None, device="cuda"):
        self.cfg = cfg = config.normalized()
        check_supported(cfg)
        self.device = resolve_device(device)
        self.metrics = RenderMetrics()

        if mesh is None:
            if len(cfg.meshes) == 1 and cfg.meshes[0].path in BUILTIN_SCENES:
                mesh = BUILTIN_SCENES[cfg.meshes[0].path]()
            else:
                mesh = mesh_from_config(cfg)
        if materials is None:
            atlas, wins = reference_atlas()
            materials = builtin_materials(wins)
            if cfg.materials:
                materials = apply_material_configs(materials, cfg.materials)
            if textures is None:
                textures = atlas

        with self.metrics.phase("scene_build"):
            self.mesh = mesh
        with self.metrics.phase("bvh_build"):
            self.scene, self.bvh = build_scene(
                mesh, materials, textures,
                max_leaf_size=max(cfg.bvh_leaf_size, 1), device=self.device)

        self.camera = Camera.from_config(cfg)
        self.key = rng.base_key(cfg.seed)
        py, px = torch.meshgrid(
            torch.arange(cfg.height, dtype=torch.int32, device=self.device),
            torch.arange(cfg.width, dtype=torch.int32, device=self.device),
            indexing="ij")
        self.px = px.reshape(-1)
        self.py = py.reshape(-1)
        self.metrics.pixels = cfg.width * cfg.height
        self.accum = torch.zeros((cfg.width * cfg.height, 3),
                                 dtype=torch.float32, device=self.device)
        self.sample_count = 0

    def render_sample(self, sample_idx: int):
        """One sample of every pixel -> (radiance [P,3], rays), and for VCM
        and SPPM also the photons the merge cap left out."""
        cfg = self.cfg
        fn = _RENDER[_family(cfg.integrator), cfg.engine]
        args = (self.scene, self.camera, self.key, sample_idx, self.px,
                self.py)
        if cfg.integrator == "BIDIRECTIONAL":
            return fn(*args, cfg=bdpt_mod.BDPTConfig.from_config(cfg))
        if cfg.integrator in ("VCM", "SPPM"):
            return fn(*args, cfg=vcm_mod.VCMConfig.from_config(cfg))
        return fn(*args, max_depth=max(cfg.max_depth, 1),
                  sample_environment=cfg.sample_environment)

    def render(self, num_samples: int | None = None,
               checkpoint_path: str | None = None, resume: bool = True,
               progressive: bool = True, verbose: bool = True) -> Image:
        """Run the progressive sample loop; returns the final Image."""
        cfg = self.cfg
        total = num_samples if num_samples is not None else cfg.sample_count
        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            self.load_checkpoint(checkpoint_path)
            if verbose:
                print(f"resumed at sample {self.sample_count}")
        last_save = time.monotonic()
        dropped = 0
        with self.metrics.phase("render"):
            while self.sample_count < total:
                li, rays, *rest = self.render_sample(self.sample_count)
                dropped += rest[0] if rest else 0
                self.accum += li
                self.metrics.add_rays(rays)
                self.sample_count += 1
                self.metrics.samples_done += 1
                now = time.monotonic()
                if (progressive
                        and now - last_save >= cfg.save_interval_seconds):
                    self.save_progressive()
                    if checkpoint_path:
                        self.save_checkpoint(checkpoint_path)
                    last_save = time.monotonic()
                    if verbose:
                        print(f"saved progress at {self.sample_count} "
                              "samples")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if dropped:
            self.metrics.merge_dropped = dropped
            if verbose:
                print(merge_note(dropped, cfg.vcm_max_per_cell))
        return self.finish()

    def framebuffer(self) -> np.ndarray:
        """Scrubbed, normalized [H,W,3] image."""
        cfg = self.cfg
        acc = self.accum.cpu().numpy().reshape(cfg.height, cfg.width, 3)
        return scrub(acc, max(self.sample_count, 1))

    def finish(self) -> Image:
        cfg = self.cfg
        return Image(cfg.width, cfg.height, self.framebuffer(),
                     post_process=cfg.post_process)

    def save_progressive(self):
        cfg = self.cfg
        img = self.finish()
        img.save_bmp(os.path.join(cfg.output_dir, "render.bmp"))
        img.save_csv_mono(os.path.join(cfg.output_dir, "renderCSV.csv"))

    def save_final(self, render_number: int = 0) -> Image:
        cfg = self.cfg
        img = self.finish()
        img.save_bmp(os.path.join(cfg.output_dir,
                                  f"{cfg.name}{render_number}.bmp"))
        img.save_csv_mono(os.path.join(cfg.output_dir,
                                       f"{cfg.name}{render_number}.csv"))
        return img

    # --- checkpoints: the JAX package's .npz format ----------------------
    def _meta(self) -> dict:
        return {"w": self.cfg.width, "h": self.cfg.height,
                "seed": self.cfg.seed, "integrator": self.cfg.integrator}

    def _check_meta(self, meta: dict):
        if (meta["w"], meta["h"]) != (self.cfg.width, self.cfg.height):
            raise ValueError("checkpoint resolution mismatch")
        if (meta["seed"] != self.cfg.seed
                or meta["integrator"] != self.cfg.integrator):
            raise ValueError("checkpoint config mismatch")

    @staticmethod
    def _require_npz(path: str):
        if not path.endswith(".npz"):
            raise NotImplementedError(
                "only .npz checkpoints are ported (the Orbax directory "
                "format belongs with multi-GPU, ROADMAP M13)")

    def save_checkpoint(self, path: str):
        self._require_npz(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp[:-4],  # savez appends .npz
            accum=self.accum.cpu().numpy(),
            sample_count=self.sample_count,
            config=json.dumps(self._meta()))
        os.replace(tmp, path)

    def load_checkpoint(self, path: str):
        self._require_npz(path)
        data = np.load(path, allow_pickle=False)
        self._check_meta(json.loads(str(data["config"])))
        self.accum = torch.as_tensor(data["accum"]).to(self.device)
        self.sample_count = int(data["sample_count"])
