"""Multi-GPU rendering: image-tile x spp sharding over a mesh of ranks.

Counterpart of cudapathtracer_tpu/parallel/sharding.py. The mesh has two
axes, as the JAX package's:

  "tile" - the pixel list is cut into contiguous blocks, one a rank along
           this axis (the scene's tables are replicated on every device)
  "spp"  - the ranks along this axis render independent samples, summed

Rank r of an n_tile x n_spp mesh sits at (ti, si) = divmod(r, n_spp), as
JAX's reshape(n_tile, n_spp) places the devices. One process drives the
whole mesh, as JAX's single controller does: each rank is a thread with
its device (and, on a card, a CUDA stream of its own) and three
torch.distributed process groups built in-process on one HashStore: its
group along the tile axis (the ranks that share its si; the JAX psum over
"tile" sums over it), its group along the spp axis (the ranks that share
its ti) and the world. The backend is NCCL where every rank has a GPU of
its own and Gloo otherwise (CPU ranks, or a device that repeats: NCCL
refuses two ranks on one GPU); Mesh.backend and Mesh.reason state it.
Gloo's collectives on a CUDA tensor go through a host copy. The members
of a group meet at a host barrier once each has queued its part of a
collective. Under NCCL a card's collective kernel spins until its peers'
run, and a rank whose thread blocks in the CUDA driver (an allocation, a
synchronising copy) could otherwise hold up a peer that has yet to queue
its part; and a rank that fails breaks the barriers, so the others stop
waiting for it.

Integrators without a splat (naive, unidirectional classic and mega) fold
both mesh coordinates into each rank's key, so every rank draws its own
stream. The splat integrators (BDPT, VCM, SPPM; splat=True) are called
with the frame's pixel count as `splat_shape` and return the tile's
radiance beside a full-frame splat buffer, which is summed over the tile
axis; each rank adds its tile's slice. Their draws are keyed by pixel id,
so their keys are not folded and the tile-sharded image is the
single-rank image up to the order of float additions. VCM and SPPM with
merging on a tile axis of 2 or more ranks also take `photon_axis="tile"`:
each rank then all-gathers the photon rows of the tile axis and builds
the grid on their union (models/vcm.py photon_group). The mega engines of
BDPT, VCM and SPPM take no splat_shape, as in the JAX package, and are
refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

from cudapathtracer_tpu_torch.models import (bdpt, bdpt_mega, vcm,
                                             vcm_mega)
from cudapathtracer_tpu_torch.utils import metrics
from cudapathtracer_tpu_torch.utils import rng as rng_mod

SPLAT_FNS = (bdpt.render_sample, vcm.render_sample)
NO_SPLAT_SHAPE = (bdpt_mega.render_sample, vcm_mega.render_sample)
# how long a collective waits for the other ranks: longer than a rank's
# first call, which may build the kernels
TIMEOUT = datetime.timedelta(seconds=300)


class Group:
    """One rank's process group along a mesh axis (or the world): its
    members (global ranks in axis order), its index among them (`rank`)
    and `size`. Collectives sum or gather in member order."""

    def __init__(self, pg, backend: str, rank: int, members: tuple,
                 turn=None, queued=None):
        self.pg, self.backend = pg, backend
        self.rank, self.members, self.size = rank, members, len(members)
        self.turn = turn   # the CPU ranks' turn lock (Mesh.run), or None
        self.queued = queued   # the members' threading.Barrier, or None

    def _wait(self, work) -> None:
        if self.turn is not None:
            self.turn.release()   # the other ranks run up to this collective
        try:
            if self.queued is not None:
                self.queued.wait()   # every member has queued its part
            work.wait()
        finally:
            if self.turn is not None:
                self.turn.acquire()

    def _staged(self, t):
        """The tensor the backend reads: Gloo takes CUDA tensors through
        the host."""
        t = t.contiguous()
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum t over the group, in place; returns t."""
        buf = self._staged(t)
        self._wait(self.pg.allreduce([buf]))
        if buf.data_ptr() != t.data_ptr():
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every member's t, concatenated along dim 0 in member order (the
        JAX package's tiled all_gather), on t's device."""
        buf = self._staged(t)
        outs = [torch.empty_like(buf) for _ in range(self.size)]
        self._wait(self.pg.allgather([outs], [buf]))
        return torch.cat(outs).to(t.device)


@dataclass
class Rank:
    """One rank of a mesh: its place, its device and its groups."""
    rank: int
    ti: int
    si: int
    device: torch.device
    tile: Group     # the ranks along the tile axis (same si)
    spp: Group      # the ranks along the spp axis (same ti)
    world: Group
    stream: object  # its torch.cuda.Stream, or None on the CPU


@dataclass
class Mesh:
    """A ("tile", "spp") mesh of ranks; shape maps each axis to its size."""
    shape: dict
    devices: list
    backend: str
    reason: str
    ranks: list
    turn: object = None   # a threading.Lock where every rank is a CPU rank
    barriers: tuple = ()  # the groups' barriers (Group.queued)

    def describe(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return (f"({self.shape['tile']}, {self.shape['spp']}) mesh on "
                f"[{devs}]: {self.backend} ({self.reason})")

    def run(self, fn) -> list:
        """fn(rank) on one thread a rank, each on its device and stream;
        -> the results in rank order. The exception of the first rank to
        fail is raised here once every thread has ended (the others end at
        once where they wait at a group's barrier, else at their
        collectives' timeout). Where the caller traces (utils/metrics.py),
        each rank's thread traces too, its spans carrying its rank."""
        out = [None] * len(self.ranks)
        errors = []
        traced = metrics.handoff()

        def body(r: Rank):
            try:
                with (self.turn or contextlib.nullcontext(), _on(r),
                      metrics.adopted(traced, r.rank)):
                    out[r.rank] = fn(r)
            except BaseException as e:   # re-raised in the caller
                errors.append((r.rank, e))
                for b in self.barriers:   # the others stop waiting for it
                    b.abort()

        _threads(body, self.ranks)
        if errors:
            rank, err = errors[0]   # the first to fail; the others follow
            raise RuntimeError(f"rank {rank} of the {self.describe()} "
                               f"failed: {err!r}") from err
        return out

    def synchronize(self) -> None:
        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def close(self) -> None:
        """Shut every rank's groups down; the mesh takes no more calls."""
        for r in self.ranks:
            for g in (r.world, r.tile, r.spp):
                g.pg.shutdown()


@contextlib.contextmanager
def _on(r: Rank):
    """The rank's device and stream as the thread's current ones."""
    if r.device.type != "cuda":
        yield
        return
    with torch.cuda.device(r.device), torch.cuda.stream(r.stream):
        yield


def _threads(body, items) -> None:
    threads = [threading.Thread(target=body, args=(x,), daemon=True)
               for x in items]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cpu":
        return torch.device("cpu")
    if d.type != "cuda":
        raise ValueError(f"device {d}: a mesh holds CPU or CUDA devices")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = d.index if d.index is not None else 0
    if index >= count:
        raise RuntimeError(f"device {d} is missing: {count} CUDA devices "
                           "are visible")
    return torch.device("cuda", index)


def _backend(devices: list) -> tuple:
    """(backend, reason) for the ranks' devices."""
    if all(d.type == "cuda" for d in devices):
        if len(set(devices)) == len(devices):
            if not dist.is_nccl_available():
                raise RuntimeError("every rank has a GPU of its own, but "
                                   "this PyTorch has no NCCL")
            return "nccl", "every rank has a GPU of its own"
        return "gloo", ("a device repeats, and NCCL refuses two ranks on "
                        "one GPU; collectives through the host")
    if all(d.type == "cpu" for d in devices):
        return "gloo", "CPU ranks"
    return "gloo", "CPU and CUDA ranks; collectives through the host"


def _new_group(backend: str, store, prefix: str, rank: int, size: int):
    store = dist.PrefixStore(prefix, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = TIMEOUT
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    opts = dist.ProcessGroupGloo._Options()
    # every rank is in this process: the loopback device reaches them all
    opts._devices = [dist.ProcessGroupGloo.create_device(
        hostname="127.0.0.1")]
    opts._timeout = TIMEOUT
    return dist.ProcessGroupGloo(store, rank, size, opts)


def make_mesh(n_tile: int | None = None, n_spp: int = 1,
              devices=None) -> Mesh:
    """Build a ("tile", "spp") mesh; by default every visible CUDA device,
    all on the tile axis. devices: torch devices or their names, one a
    rank, repeats allowed (e.g. ["cpu"] * 8, or ["cuda:0"] * 4); the first
    n_tile * n_spp are used."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("no CUDA device is visible; name the mesh's "
                               "devices (devices=['cpu'] * n for the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_tile is None:
        n_tile = len(devices) // n_spp
    n = n_tile * n_spp
    if n_tile < 1 or n_spp < 1 or n > len(devices):
        raise ValueError(f"a ({n_tile}, {n_spp}) mesh needs {n} devices, "
                         f"{len(devices)} given")
    devices = devices[:n]
    backend, reason = _backend(devices)
    store = dist.HashStore()
    # CPU ranks take turns between collectives: their plain versions issue
    # many small operators, and threads that contend for the interpreter
    # run them several times slower than one thread at a time
    turn = (threading.Lock() if all(d.type == "cpu" for d in devices)
            else None)
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in devices]
    wait = TIMEOUT.total_seconds()
    barriers = {"world": threading.Barrier(n, timeout=wait),
                **{f"tile/{si}": threading.Barrier(n_tile, timeout=wait)
                   for si in range(n_spp)},
                **{f"spp/{ti}": threading.Barrier(n_spp, timeout=wait)
                   for ti in range(n_tile)}}
    ranks = [None] * n
    errors = []

    def build(r: int):
        ti, si = divmod(r, n_spp)
        tile = tuple(t * n_spp + si for t in range(n_tile))
        spp = tuple(ti * n_spp + s for s in range(n_spp))
        try:
            with (torch.cuda.device(devices[r]) if devices[r].type == "cuda"
                  else contextlib.nullcontext()):
                groups = [Group(_new_group(backend, store, prefix, k,
                                           len(members)),
                                backend, k, members, turn,
                                barriers[prefix])
                          for prefix, k, members in (
                              ("world", r, tuple(range(n))),
                              (f"tile/{si}", ti, tile),
                              (f"spp/{ti}", si, spp))]
        except BaseException as e:   # re-raised below
            errors.append((r, e))
            return
        ranks[r] = Rank(r, ti, si, devices[r], groups[1], groups[2],
                        groups[0], streams[r])

    _threads(build, range(n))
    if errors:
        r, err = min(errors, key=lambda e: e[0])
        raise RuntimeError(f"rank {r}: the {backend} groups of a "
                           f"({n_tile}, {n_spp}) mesh could not be built: "
                           f"{err!r}") from err
    return Mesh(shape={"tile": n_tile, "spp": n_spp}, devices=devices,
                backend=backend, reason=reason, ranks=ranks, turn=turn,
                barriers=tuple(barriers.values()))


def _base(fn):
    while isinstance(fn, functools.partial):
        fn = fn.func
    return fn


def replicate(obj, device: torch.device):
    """obj (a Scene, its MaterialTable, a tensor) with every tensor on
    device; obj itself where nothing moves."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        moved = {f.name: replicate(getattr(obj, f.name), device)
                 for f in dataclasses.fields(obj)}
        if all(moved[k] is getattr(obj, k) for k in moved):
            return obj
        return dataclasses.replace(obj, **moved)
    return obj


def _count(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device).reshape(())


def make_sharded_sample_fn(sample_fn, mesh: Mesh, scene, camera,
                           splat: bool = False, **static_kw):
    """Wrap a per-sample integrator fn (scene, camera, key, sample_idx, px,
    py, **static) into a sharded one over `mesh`.

    Returns fn(key, sample_idx, px, py) -> (radiance [N,3] on the mesh's
    first device, the integrator's counts summed over every rank as Python
    ints: rays, and VCM's merge-dropped photons). N must divide the tile
    axis. Each rank renders sample `sample_idx * n_spp + si` of its tile,
    summed over the spp axis, so one call advances n_spp samples.

    splat=True (BDPT, VCM, SPPM): the integrator gets splat_shape = N and
    returns (li_tile, fb [N,3], counts...); fb is summed over the tile axis
    only and each rank adds its tile's slice before the spp sum. Keys are
    not folded (the draws are keyed by pixel id). photon_axis="tile" (VCM
    and SPPM with merging) gathers the photons over the tile axis when it
    has 2 or more ranks."""
    base = _base(sample_fn)
    if base in NO_SPLAT_SHAPE:
        raise NotImplementedError(
            f"{base.__module__}.render_sample takes no splat_shape (nor does "
            "its JAX counterpart), so it cannot be sharded; use the "
            "classic engine")
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    photon_axis = static_kw.pop("photon_axis", None)
    if photon_axis not in (None, "tile") or (photon_axis and not splat):
        raise ValueError(f"photon_axis {photon_axis!r}: 'tile', with "
                         "splat=True")
    if n_tile > 1 and not splat and base in SPLAT_FNS:
        raise ValueError(f"{base.__module__}.render_sample splats into "
                         "raster pixels: shard it over tiles with "
                         "splat=True")
    scenes = {d: replicate(scene, d) for d in set(mesh.devices)}

    def call(key, sample_idx, px, py):
        n = px.shape[0]
        if n % n_tile:
            raise ValueError(f"{n} pixels do not divide the tile axis "
                             f"({n_tile})")
        n_local = n // n_tile

        def shard(r: Rank):
            sl = slice(r.ti * n_local, (r.ti + 1) * n_local)
            pxs, pys = px[sl].to(r.device), py[sl].to(r.device)
            my_sample = sample_idx * n_spp + r.si
            if splat:
                kw = dict(static_kw, splat_shape=n)
                if photon_axis and n_tile > 1:
                    kw["photon_group"] = r.tile
                li, fb, *counts = sample_fn(scenes[r.device], camera, key,
                                            my_sample, pxs, pys, **kw)
                # the tile axis only: each spp rank's fb is its own sample's
                li = li + r.tile.all_reduce_(fb)[sl]
            else:
                shard_key = rng_mod.fold_in(rng_mod.fold_in(key, r.ti), r.si)
                li, *counts = sample_fn(scenes[r.device], camera, shard_key,
                                        my_sample, pxs, pys, **static_kw)
            li = r.spp.all_reduce_(li)
            total = r.world.all_reduce_(torch.stack(
                [_count(c, r.device) for c in counts]))
            return li, total.tolist()   # the rank's stream is done here

        outs = mesh.run(shard)
        first = mesh.devices[0]
        li = torch.cat([outs[ti * n_spp][0].to(first)
                        for ti in range(n_tile)])
        # the ranks' tensors live on their streams: done before they go
        mesh.synchronize()
        return (li, *outs[0][1])

    call.samples_per_call = n_spp
    return call


def render_sharded(sample_fn, mesh: Mesh, scene, camera, width: int,
                   height: int, num_samples: int,
                   seed: int = rng_mod.DEFAULT_SEED, **static_kw):
    """Sharded progressive render of the whole frame. Returns (accumulated
    radiance [H*W,3] numpy, samples_done, rays)."""
    n_tile = mesh.shape["tile"]
    n = width * height
    assert n % n_tile == 0, "pixel count must divide the tile axis"
    py, px = torch.meshgrid(torch.arange(height, dtype=torch.int32),
                            torch.arange(width, dtype=torch.int32),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    fn = make_sharded_sample_fn(sample_fn, mesh, scene, camera, **static_kw)
    key = rng_mod.base_key(seed)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=mesh.devices[0])
    total_rays = 0
    done = 0
    call_idx = 0
    while done < num_samples:
        li, rays, *_ = fn(key, call_idx, px, py)
        acc = acc + li
        done += fn.samples_per_call
        call_idx += 1
        total_rays += rays
    return acc.cpu().numpy(), done, total_rays
