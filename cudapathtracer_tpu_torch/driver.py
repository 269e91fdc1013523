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

Renderer(..., trace=True) turns the program's tracing on
(utils/metrics.py): spans at each layer boundary (tpt.driver.render_batch
around a dispatch, tpt.step.<model> around the model's sample or batch
function and its stages, tpt.kernel.<entry> around each kernel entry)
and the device counters of the hot kernels, which accumulate on the card
until metrics.counter_totals() reads them. It is off by default.

The Renderer runs on an explicit device. "cuda" needs a CUDA build of
PyTorch and a card and raises otherwise; the CPU is used only when asked
for. Checkpoints are the JAX package's `.npz` format (accumulation buffer,
sample count and a config echo), so either package can resume the other's.

As in the JAX driver: `Samples Per Dispatch` (0 = the auto rule of
resolve_samples_per_dispatch) renders k samples per dispatch through
models/batch.py, with the ray and merge-dropped totals kept as int64 on the
device and fetched once after the loop; CUDAPATHTRACER_TPU_CHECKS=1 scans
each progressive save's batch (utils/checks.py); BDPT_DRAWPATH composites
the eye-path overlay (utils/debugviz.py) for BIDIRECTIONAL, VCM and SPPM.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from cudapathtracer_tpu_torch.models import bdpt as bdpt_mod
from cudapathtracer_tpu_torch.models import bdpt_mega
from cudapathtracer_tpu_torch.models.batch import make_batched
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
from cudapathtracer_tpu_torch.utils import debugviz, rng
from cudapathtracer_tpu_torch.utils.checks import CheckLog
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
# the integrators whose sample is one K5 launch -> their k-sample batch
_BATCH = {
    ("UNIDIRECTIONAL", "mega"): mega_mod.render_batch,
    ("UNIDIRECTIONAL", "classic"): uni_mod.render_batch,
    ("NAIVE_UNIDIRECTIONAL", "mega"): naive_mod.render_batch,
    ("NAIVE_UNIDIRECTIONAL", "classic"): naive_mod.render_batch,
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


def resolve_samples_per_dispatch(cfg: RenderConfig, device) -> int:
    """Samples accumulated per dispatch, the JAX driver's rule with the
    device type in place of the backend: an explicit value wins; else a
    CPU device or a frame above 512^2 pixels renders one sample per
    dispatch, and a card batches max(1, min(8, 2^21 // pixels))."""
    if cfg.samples_per_dispatch > 0:
        return cfg.samples_per_dispatch
    n = cfg.width * cfg.height
    if torch.device(device).type == "cpu" or n > (1 << 18):
        return 1
    return max(1, min(8, (1 << 21) // max(n, 1)))


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
    one device. Without a mesh it loads the config's (mesh_from_config,
    render_number moving its emissive OBJ meshes), timed as the phase
    scene_build."""

    def __init__(self, config: RenderConfig, mesh: MeshData | None = None,
                 materials=None, textures=None, device="cuda",
                 trace: bool = False, render_number: int = 0):
        self.cfg = cfg = config.normalized()
        check_supported(cfg)
        self.device = resolve_device(device)
        self.metrics = RenderMetrics(trace=trace)
        self.checks = CheckLog()

        with self.metrics.phase("scene_build"):
            self.mesh = mesh = (mesh_from_config(cfg, render_number)
                                if mesh is None else mesh)
        if materials is None:
            atlas, wins = reference_atlas()
            materials = builtin_materials(wins)
            if cfg.materials:
                materials = apply_material_configs(materials, cfg.materials)
            if textures is None:
                textures = atlas

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
        self._overlay = None  # BDPT_DRAWPATH channel, built lazily

    def _sample_fn(self):
        """The per-sample step inner(scene, camera, key, sample_idx, px, py)
        -> (radiance [P,3], rays[, merge-dropped]), the counts Python ints
        on the CPU and 0-d int64 tensors on the card; for a K5 integrator
        with its one-launch batch as inner.k_sample (models/batch.py)."""
        cfg = self.cfg
        key = (_family(cfg.integrator), cfg.engine)
        fn = _RENDER[key]
        if cfg.integrator == "BIDIRECTIONAL":
            kw = dict(cfg=bdpt_mod.BDPTConfig.from_config(cfg))
        elif cfg.integrator in ("VCM", "SPPM"):
            kw = dict(cfg=vcm_mod.VCMConfig.from_config(cfg))
        else:
            kw = dict(max_depth=max(cfg.max_depth, 1),
                      sample_environment=cfg.sample_environment)

        step = "tpt.step." + fn.__module__.rsplit(".", 1)[1]
        span = self.metrics.span

        def inner(scene, camera, base_key, sample_idx, px, py):
            with span(step):
                return fn(scene, camera, base_key, sample_idx, px, py, **kw)
        if key in _BATCH:
            batch = _BATCH[key]

            def k_sample(scene, camera, base_key, s0, px, py, k):
                with span(step):
                    return batch(scene, camera, base_key, s0, px, py, k,
                                 **kw)
            inner.k_sample = k_sample
        return inner

    def render_sample(self, sample_idx: int):
        """One sample of every pixel -> (radiance [P,3], rays), and for VCM
        and SPPM also the photons the merge cap left out."""
        return self._sample_fn()(self.scene, self.camera, self.key,
                                 sample_idx, self.px, self.py)

    def render_batch(self, s0: int, k: int):
        """Samples s0 .. s0+k-1 in one dispatch (models/batch.py) ->
        (radiance summed [P,3], rays[, merge-dropped]) as 0-d int64
        tensors. Traced, the span tpt.driver.render_batch, identified by
        s0."""
        with self.metrics.span("tpt.driver.render_batch", s0):
            return make_batched(self._sample_fn())(
                self.scene, self.camera, self.key, s0, self.px, self.py, k)

    def render(self, num_samples: int | None = None,
               checkpoint_path: str | None = None, resume: bool = True,
               progressive: bool = True, verbose: bool = True) -> Image:
        """Run the progressive sample loop in batches of the resolved
        samples per dispatch; returns the final Image. Progressive saves
        (and the checks) happen at batch boundaries. Nothing in the loop
        waits for the card: the ray and dropped totals are int64 on the
        device, fetched once after it."""
        cfg = self.cfg
        total = num_samples if num_samples is not None else cfg.sample_count
        inner = self._sample_fn()
        spd = resolve_samples_per_dispatch(cfg, self.device)
        batched = make_batched(inner)
        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            self.load_checkpoint(checkpoint_path)
            if verbose:
                print(f"resumed at sample {self.sample_count}")
        last_save = time.monotonic()
        zero = lambda: torch.zeros((), dtype=torch.int64, device=self.device)
        rtot, dtot = zero(), zero()
        with self.metrics.phase("render"):
            while self.sample_count < total:
                k = min(spd, total - self.sample_count)
                args = (self.scene, self.camera, self.key, self.sample_count,
                        self.px, self.py)
                with self.metrics.span("tpt.driver.render_batch",
                                       self.sample_count):
                    out = batched(*args, k)
                    li, rays = out[0], out[1]
                    if len(out) > 2:
                        dtot = dtot + out[2]
                    self.accum += li
                    rtot = rtot + rays
                self.sample_count += k
                self.metrics.samples_done += k
                now = time.monotonic()
                if (progressive
                        and now - last_save >= cfg.save_interval_seconds):
                    self.checks.check(f"sample {self.sample_count}", li)
                    self.save_progressive()
                    if checkpoint_path:
                        self.save_checkpoint(checkpoint_path)
                    last_save = time.monotonic()
                    if verbose:
                        print(f"saved progress at {self.sample_count} "
                              "samples")
            rays_total, dropped = torch.stack([rtot, dtot]).tolist()
        self.metrics.add_rays(rays_total)
        if dropped:
            self.metrics.merge_dropped = dropped
            if verbose:
                print(merge_note(dropped, cfg.vcm_max_per_cell))
        return self.finish()

    def framebuffer(self) -> np.ndarray:
        """Scrubbed, normalized [H,W,3] image. With BDPT_DRAWPATH set
        (BIDIRECTIONAL, VCM and SPPM), the eye-path overlay of sample 0's
        key is composited over it, built once."""
        cfg = self.cfg
        acc = self.accum.cpu().numpy().reshape(cfg.height, cfg.width, 3)
        img = scrub(acc, max(self.sample_count, 1))
        if (cfg.bdpt_draw_path
                and cfg.integrator in ("BIDIRECTIONAL", "VCM", "SPPM")):
            if self._overlay is None:
                self._overlay = debugviz.bdpt_path_overlay(
                    self.scene, self.camera, rng.sample_key(self.key, 0),
                    self.px, self.py, eye_depth=max(cfg.bdpt_eye_depth, 2))
            img = debugviz.composite_overlay(img, self._overlay)
        return img

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
                "only .npz checkpoints are ported: the Orbax directory "
                "format needs orbax.checkpoint, which imports jax")

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
