"""The keyed light walk of the mega engines (TPT_MEGA_LIGHT=1).

Counterpart of cudapathtracer_tpu/models/light_mega.py:light_walk_mega.
The JAX function is a persistent lane machine for the light pass of the
mega VCM and BDPT engines: lanes at different depths take their draws from
a per-(bounce, draw) key table folded once on the host
(rng.draw_key_table), each lane selecting its pair (rng.uniform_keyed), so
its uniforms are the classic walk's bit for bit. The machine itself (the
path queue, the refill, the transitions and the packed-row vertex scatter)
is TPU scheduling and is not ported. What is ported is the behaviour: the
same light paths, walked with the table's draws, in the same depth-major
PathBuffers [max_depth-1, c_pix].

On CUDA tensors the walk is ONE launch of K12 in its table mode
(kernels.bdpt_walk with key_table: kernels/csrc/bdpt_walk.cu); on CPU
tensors its plain version, models/paths.random_walk with the keyed draws
(start_light_walk and random_walk given the tables). As in JAX:
  * paths pair with pixels gbase + p of a row-major grid of width grid_w
    (pad paths clamp to gmax, the last pixel), or with pxc/pyc [c_pix];
  * eta_vcm turns on the VCM d_vm chain (first_vm_seed = first_vc /
    eta_vcm); None gives BDPT's weights;
  * rays count one ray per path and one per continuing bounce (the
    machine's count, equal to the classic walk's for max_depth >= 2);
  * vertex 0 is not returned: JAX's caller computes it from the endpoint
    math alone. walk_with_endpoint returns the endpoint the same walk
    computed (K12 writes it in the same launch), which is what bdpt_mega
    takes instead: the same draws, so the same vertex.
Only the buffers' valid vertices are the function's result; the fields of
an invalid row are the walk's, not the JAX machine's zeros.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import paths
from cudapathtracer_tpu_torch.scene.materials import TRANSPORT_IMPORTANCE
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.math import true_div

# calls since the last reset (the driver tests read it to see the route)
calls = {"light_walk_mega": 0}


def enabled() -> bool:
    """TPT_MEGA_LIGHT, read on every call under the JAX package's name, as
    the JAX mega engines read it."""
    return bool(os.environ.get("TPT_MEGA_LIGHT"))


def key_tables(key, max_depth: int):
    """(bounce pairs uint32 [max_depth, 4, 2] of draws 0-3 under
    bounce_key(key, b), endpoint pairs [5, 2] of draws 100..104 of key)."""
    return (rng.draw_key_table(key, range(max_depth), range(4)),
            rng.draw_key_table(key, None, paths.LIGHT_DRAWS)[0])


def device_table(ktab, ketab, device) -> torch.Tensor:
    """The tables as K12's table mode reads them: one int32 word array
    [max_depth * 8 + 10] (bounce pairs, then endpoint pairs) on `device`,
    copied without blocking the host."""
    return kernels.upload_words(np.concatenate(
        [t.numpy().reshape(-1) for t in (ktab, ketab)]), device)


def pairing(c_pix: int, pxc, pyc, grid_w: int, gbase: int, gmax, device):
    """The pixel (px, py) [c_pix] int32 each light path pairs with (its
    draws are keyed by that pixel's id)."""
    if grid_w:
        gp = gbase + torch.arange(c_pix, dtype=torch.int64, device=device)
        if gmax is not None:  # pad paths clamp to the last pixel
            gp = torch.clamp(gp, max=int(gmax))
        return ((gp % grid_w).to(torch.int32).contiguous(),
                (gp // grid_w).to(torch.int32).contiguous())
    return (pxc[:c_pix].to(torch.int32).contiguous(),
            pyc[:c_pix].to(torch.int32).contiguous())


def light_walk_mega(scene, key, c_pix: int, max_depth: int,
                    transport_mode: int, eta_vcm=None, pxc=None, pyc=None, *,
                    grid_w: int = 0, gbase: int = 0, gmax=None, **_schedule):
    """Walk c_pix light paths -> (PathBuffers [max_depth-1, c_pix], rays:
    a Python int on the CPU, a 0-d int64 tensor on the card). The JAX
    schedule arguments (width, steps_per_iter, mini_splits) are accepted
    and ignored."""
    bufs, _v0, rays = walk_with_endpoint(
        scene, key, c_pix, max_depth, transport_mode, eta_vcm, pxc, pyc,
        grid_w=grid_w, gbase=gbase, gmax=gmax)
    return bufs, rays


def walk_with_endpoint(scene, key, c_pix: int, max_depth: int,
                       transport_mode: int, eta_vcm=None, pxc=None, pyc=None,
                       *, grid_w: int = 0, gbase: int = 0, gmax=None):
    """light_walk_mega that also returns each path's vertex 0 (the dict of
    paths.start_light_walk) -> (bufs, v0, rays)."""
    calls["light_walk_mega"] += 1
    device = scene.tri_f32.device
    px, py = pairing(c_pix, pxc, pyc, grid_w, gbase, gmax, device)
    ktab, ketab = key_tables(key, max_depth)
    fn = walk_plain if device.type == "cpu" else walk_kernel
    bufs, v0, rays = fn(scene, key, px, py, max_depth, transport_mode,
                        eta_vcm, ktab, ketab)
    # the machine traces each path's first ray even when no row is kept
    return bufs, v0, (rays + c_pix if max_depth <= 1 else rays)


def walk_plain(scene, key, px, py, max_depth: int, transport_mode: int,
               eta_vcm, ktab, ketab):
    """Plain version of K12's table mode (any device): the classic walk
    with every draw through rng.uniform_keyed from the tables -> (bufs,
    v0, rays)."""
    ids = rng.pixel_ids(px, py)
    start, v0 = paths.start_light_walk(scene, key, px.shape[0], ids,
                                       key_table=ketab)
    fvm = None
    if eta_vcm is not None:
        fvm = true_div(start.first_vc_scale, max(float(eta_vcm), 1e-30))
    bufs, _esc, rays = paths.random_walk(scene, key, start, max_depth,
                                         transport_mode, eta_vcm, fvm,
                                         ids=ids, key_table=ktab)
    return bufs, v0, rays


def walk_kernel(scene, key, px, py, max_depth: int, transport_mode: int,
                eta_vcm, ktab, ketab):
    """One launch of K12's table mode -> (bufs, v0, rays)."""
    if transport_mode != TRANSPORT_IMPORTANCE:
        raise ValueError("K12's light walk carries importance; transport "
                         f"mode {transport_mode} is not a light walk")
    table = device_table(ktab, ketab, px.device)
    rays = torch.zeros(px.shape[0], dtype=torch.int32, device=px.device)
    lw = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key, "light"),
                           mode="light", max_depth=max_depth, rays=rays,
                           eta_vcm=eta_vcm, key_table=table)
    return lw["bufs"], lw["v0"], rays.sum()
