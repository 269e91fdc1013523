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

`Mesh Shape: <n_tile> <n_spp>` above 1 1 renders over a (tile, spp) mesh
of n_tile * n_spp ranks (parallel/sharding.py): cuda:0 .. cuda:n-1 from
the Renderer's card on, or n CPU ranks with device="cpu". The cards'
contexts are made on the rank threads while the scene is built, and the
mesh is joined after (the phase mesh_build: the ranks' streams and the
first exchange within each tile group, which hold the interpreter, and
the scene's replication); the scene is
replicated on every rank and each dispatch runs the integrator through
make_sharded_sample_fn: the splat integrators with splat=True, VCM and
SPPM with their photons gathered over the tile axis. A call advances
n_spp samples, so a dispatch holds a multiple of n_spp samples. The frame
and the counts stay on the first device. The mega engines of BDPT, VCM
and SPPM are refused on a mesh. Without a mesh nothing of parallel/ is
imported.
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
    dispatch, and a card batches max(1, min(8, 2^21 // pixels)); on a
    mesh, rounded up to a multiple of its spp axis."""
    n = cfg.width * cfg.height
    if cfg.samples_per_dispatch > 0:
        spd = cfg.samples_per_dispatch
    elif torch.device(device).type == "cpu" or n > (1 << 18):
        spd = 1
    else:
        spd = max(1, min(8, (1 << 21) // max(n, 1)))
    n_spp = cfg.mesh_shape[1]
    return -(-spd // n_spp) * n_spp


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
    one device, or over the config's mesh of ranks (device_mesh; the frame
    on its first device). Without a triangle mesh it loads the config's
    (mesh_from_config, render_number moving its emissive OBJ meshes),
    timed as the phase scene_build."""

    def __init__(self, config: RenderConfig, mesh: MeshData | None = None,
                 materials=None, textures=None, device="cuda",
                 trace: bool = False, render_number: int = 0):
        self.cfg = cfg = config.normalized()
        check_supported(cfg)
        self.device = resolve_device(device)
        self.metrics = RenderMetrics(trace=trace)
        self.checks = CheckLog()
        self.device_mesh = None
        self._sharded = None
        join = None
        if tuple(cfg.mesh_shape) != (1, 1):
            from cudapathtracer_tpu_torch.parallel import sharding
            sharding.check_shardable(self._step()[0])
            n_tile, n_spp = cfg.mesh_shape
            n = n_tile * n_spp
            # consecutive cards from the Renderer's on, or n CPU ranks
            devices = ([self.device] * n if self.device.type == "cpu" else
                       [torch.device("cuda", (self.device.index or 0) + i)
                        for i in range(n)])
            join = sharding.start_mesh(n_tile, n_spp, devices)
            self.device = devices[0]
        self.camera = Camera.from_config(cfg)
        self._build_scene(cfg, mesh, materials, textures, render_number)
        if join is not None:
            with self.metrics.phase("mesh_build", "tpt.mesh.build"):
                self.device_mesh = join()
                self._sharded = self._sharded_fn()
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

    def _build_scene(self, cfg, mesh, materials, textures, render_number):
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

    def _step(self):
        """(the integrator's render_sample, its keyword settings)."""
        cfg = self.cfg
        fn = _RENDER[(_family(cfg.integrator), cfg.engine)]
        if cfg.integrator == "BIDIRECTIONAL":
            kw = dict(cfg=bdpt_mod.BDPTConfig.from_config(cfg))
        elif cfg.integrator in ("VCM", "SPPM"):
            kw = dict(cfg=vcm_mod.VCMConfig.from_config(cfg))
        else:
            kw = dict(max_depth=max(cfg.max_depth, 1),
                      sample_environment=cfg.sample_environment)
        return fn, kw

    def _sharded_fn(self):
        """The integrator's sample over the mesh (make_sharded_sample_fn):
        the splat integrators with splat=True, VCM and SPPM with the
        photons gathered over the tile axis."""
        from cudapathtracer_tpu_torch.parallel import sharding
        fn, kw = self._step()
        if fn in sharding.SPLAT_FNS:
            kw["splat"] = True
        if fn is vcm_mod.render_sample:
            kw["photon_axis"] = "tile"
        return sharding.make_sharded_sample_fn(
            fn, self.device_mesh, self.scene, self.camera, **kw)

    def _mesh_batch(self, s0: int, k: int):
        """Samples s0 .. s0+k-1 over the mesh, n_spp a call, summed in
        call order -> (radiance [P,3], rays[, merge-dropped]) as 0-d int64
        tensors on the first device. The ranks' waits at their
        collectives so far are the phase mesh_wait."""
        n_spp = self.device_mesh.shape["spp"]
        if k < 1 or k % n_spp or s0 % n_spp:
            raise ValueError(f"a dispatch over a mesh with {n_spp} spp "
                             f"ranks starts at and holds a multiple of "
                             f"{n_spp} samples, got {k} from {s0}")
        out = None
        for call in range(s0 // n_spp, (s0 + k) // n_spp):
            got = self._sharded(self.key, call, self.px, self.py)
            out = got if out is None else [a + b for a, b in zip(out, got)]
        self.metrics.phases["mesh_wait"] = self.device_mesh.wait_s()
        return tuple(out)

    def _sample_fn(self):
        """The per-sample step inner(scene, camera, key, sample_idx, px, py)
        -> (radiance [P,3], rays[, merge-dropped]), the counts Python ints
        on the CPU and 0-d int64 tensors on the card; for a K5 integrator
        with its one-launch batch as inner.k_sample (models/batch.py)."""
        cfg = self.cfg
        key = (_family(cfg.integrator), cfg.engine)
        fn, kw = self._step()

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
        and SPPM also the photons the merge cap left out; on the
        Renderer's (first) device alone."""
        return self._sample_fn()(self.scene, self.camera, self.key,
                                 sample_idx, self.px, self.py)

    def render_batch(self, s0: int, k: int):
        """Samples s0 .. s0+k-1 in one dispatch (models/batch.py) ->
        (radiance summed [P,3], rays[, merge-dropped]) as 0-d int64
        tensors. Traced, the span tpt.driver.render_batch, identified by
        s0. On a mesh s0 and k are multiples of its spp axis."""
        with self.metrics.span("tpt.driver.render_batch", s0):
            return self._dispatcher()(s0, k)

    def _dispatcher(self):
        """dispatch(s0, k) -> render_batch's result, over the mesh or one
        device."""
        if self._sharded is not None:
            return self._mesh_batch
        batched = make_batched(self._sample_fn())
        return lambda s0, k: batched(self.scene, self.camera, self.key, s0,
                                     self.px, self.py, k)

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
        spd = resolve_samples_per_dispatch(cfg, self.device)
        n_spp = cfg.mesh_shape[1]
        dispatch = self._dispatcher()
        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            self.load_checkpoint(checkpoint_path)
            if verbose:
                print(f"resumed at sample {self.sample_count}")
        last_save = time.monotonic()
        zero = lambda: torch.zeros((), dtype=torch.int64, device=self.device)
        rtot, dtot = zero(), zero()
        with self.metrics.phase("render"):
            while self.sample_count < total:
                # a mesh's last dispatch rounds up to its spp axis
                k = -(-min(spd, total - self.sample_count) // n_spp) * n_spp
                with self.metrics.span("tpt.driver.render_batch",
                                       self.sample_count):
                    out = dispatch(self.sample_count, k)
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
