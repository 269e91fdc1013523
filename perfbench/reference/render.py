"""Plain reference of the benchmark's integrators: one dispatch of samples.

The same estimator as the program: every draw is keyed by the sample, the
pixel (or path position) and the event, so sample s of every pixel is the
same float computation whichever code runs it. The reference builds its
scene tables itself from the inputs the benchmark made.
"""

from __future__ import annotations

import torch

from reference.tpt.models import unidirectional, vcm
from reference.tpt.models.vcm import VCMConfig
from reference.tpt.ops import hashgrid
from reference.tpt.scene.camera import Camera
from reference.tpt.scene.scene import build_scene
from reference.tpt.utils import rng
from reference.tpt.utils.config import parse_config

# (integrator, engine) the reference renders
SUPPORTED = (("UNIDIRECTIONAL", "mega"), ("VCM", "classic"))


class Reference:
    """One configured render: its own scene, camera and key on `device`."""

    def __init__(self, settings: str, mesh, materials, textures, device):
        self.cfg = cfg = parse_config(settings).normalized()
        self.kind = (cfg.integrator, cfg.engine)
        if self.kind not in SUPPORTED:
            raise NotImplementedError(f"reference of {self.kind}")
        self.scene, _ = build_scene(mesh, materials, textures,
                                    max_leaf_size=max(cfg.bvh_leaf_size, 1),
                                    device=device)
        self.camera = Camera.from_config(cfg)
        self.key = rng.base_key(cfg.seed)
        py, px = torch.meshgrid(
            torch.arange(cfg.height, dtype=torch.int32, device=device),
            torch.arange(cfg.width, dtype=torch.int32, device=device),
            indexing="ij")
        self.px, self.py = px.reshape(-1), py.reshape(-1)

    def sample(self, s: int):
        """Sample s of every pixel -> (radiance [P,3] f32, rays, merge-cap
        dropped photons or None, per-stage counts {name: int})."""
        cfg = self.cfg
        if self.kind[0] == "UNIDIRECTIONAL":
            li, rays = unidirectional.render_plain(
                self.scene, self.camera, self.key, s, self.px, self.py,
                max_depth=max(cfg.max_depth, 1), use_mis=True,
                sample_environment=cfg.sample_environment, schedule="mega")
            return li, int(rays), None, {"rays": int(rays)}
        return self._vcm_sample(s, VCMConfig.from_config(cfg))

    def _vcm_sample(self, s: int, vc: VCMConfig):
        """models/vcm.render_plain's stages in turn, counting each one's
        work: the light walk, the splat, the grid, then the eye pass's
        walk, connections and gather."""
        scene, px, py = self.scene, self.px, self.py
        key_l, key_e = vcm.sample_keys(self.key, s)
        n = px.shape[0]
        mr, eta, norm = vcm.sample_scalars(scene, vc, s, n)
        lbufs, _, rays_l = vcm.paths.generate_light_path(
            scene, key_l, px, py, vc.light_depth + 1, eta_vcm=eta)
        fb = torch.zeros((n, 3), dtype=torch.float32, device=px.device)
        rays_s = 0
        if vc.light_trace:
            fb, rays_s = vcm.vcm_light_splat(scene, self.camera, lbufs, vc,
                                             eta, fb)
        grid = None
        rows, valid = hashgrid.photon_rows(lbufs)
        if vc.do_merge:
            grid = hashgrid.build_grid(
                rows, valid, scene.scene_min, mr,
                hashgrid.photon_table_size(rows.shape[0]),
                salt=hashgrid.photon_salt(s))
        rec, rays_w = vcm.eye_walk_plain(scene, self.camera, key_e, vc, px,
                                         py, eta)
        conn, rays_c = None, 0
        if vc.connection:
            conn, rays_c = vcm.eye_connect_plain(scene, rec, lbufs, vc, eta)
        li, dropped = vcm.eye_gather_plain(scene, rec, conn, grid, vc, mr,
                                           eta, norm)
        rays = int(rays_l) + int(rays_s) + int(rays_w) + int(rays_c)
        stats = {"rays": rays, "light_rays": int(rays_l),
                 "light_vertices": int(valid.sum()),
                 "splat_rays": int(rays_s), "eye_walk_rays": int(rays_w),
                 "eye_records": int((rec.flags != 0).sum()),
                 "connect_rays": int(rays_c), "pixels": n}
        return li + fb, rays, int(dropped), stats

    def dispatch(self, s0: int, k: int, round_bf16: bool = False):
        """Samples s0 .. s0+k-1 summed in sample order from zeros, as the
        program's batch sums them -> (radiance [P,3], rays, dropped or
        None, counts summed). The unidirectional samples run as one
        batched pass (render_plain's `samples`). round_bf16 rounds each
        sample's radiance to bfloat16 first: the precision control."""
        p = self.px.shape[0]
        if self.kind[0] == "UNIDIRECTIONAL":
            cfg = self.cfg
            li, rays = unidirectional.render_plain(
                self.scene, self.camera, self.key, s0, self.px, self.py,
                max_depth=max(cfg.max_depth, 1), use_mis=True,
                sample_environment=cfg.sample_environment, schedule="mega",
                samples=list(range(s0, s0 + k)))
            parts = [(li[j * p:(j + 1) * p], None, None, {})
                     for j in range(k)]
            total = {"rays": int(rays)}
        else:
            parts = [self.sample(s) for s in range(s0, s0 + k)]
            total = {}
        acc = torch.zeros((p, 3), dtype=torch.float32, device=self.px.device)
        dropped = None
        for li, _, d, st in parts:
            if round_bf16:
                li = li.to(torch.bfloat16).to(torch.float32)
            acc = acc + li
            if d is not None:
                dropped = (dropped or 0) + d
            for name, v in st.items():
                total[name] = total.get(name, 0) + v
        return acc, total["rays"], dropped, total
