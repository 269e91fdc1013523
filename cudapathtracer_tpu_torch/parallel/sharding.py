"""Multi-GPU rendering: image-tile x spp sharding over a mesh of ranks.

Counterpart of cudapathtracer_tpu/parallel/sharding.py. The mesh has two
axes, as the JAX package's:

  "tile" - the pixel list is cut into contiguous blocks, one a rank along
           this axis (the scene's tables are replicated on every device)
  "spp"  - the ranks along this axis render independent samples, summed

Rank r of an n_tile x n_spp mesh sits at (ti, si) = divmod(r, n_spp), as
JAX's reshape(n_tile, n_spp) places the devices. One process drives the
whole mesh, as JAX's single controller does: each rank is a thread with
its device (on a card, a card of its own or one that repeats, and a CUDA
stream of its own) and its group along the tile axis (Group: the ranks
that share its si; the JAX psum over "tile" sums over it). A collective
is a board the members share: each posts its tensor (on a card beside an
event marking it ready on its stream), they meet at a host barrier, and
each copies the others' posts to its own device (card to card, over
NVLink between the cards of one host). No process group or communicator
is built. A rank that fails breaks the barriers, so the others stop
waiting for it.

start_mesh starts one thread a rank, which creates its card's context
through the driver API, leaving the interpreter to the caller
(driver.Renderer builds the scene meanwhile). Its join() then, on one
thread a rank again, creates each rank's stream and tile group and on
cards runs one collective of a single element over the group, so that
the copy streams and the cards' peer access exist before the first call.
Those steps are PyTorch calls that hold the interpreter, so run beside
the scene build they stretch it by more than they cost after it (on four
H100s, PERF.md).
make_mesh is start_mesh joined at once.

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
the grid on their union (models/vcm.py photon_group), in the single
rank's row order, so the merge's capped cells keep the same photons. The
mega engines of BDPT, VCM and SPPM take no splat_shape, as in the JAX
package, and are refused.

A sharded call queues its work on the ranks' streams and returns without
waiting for the cards: each rank's radiance and counts are copied to the
first device in order on the caller's stream there, which sums them over
the spp axis. Each rank's thread times its waits at its group's barrier
(Mesh.wait_s; driver.Renderer's phase mesh_wait), each wait is the span
tpt.mesh.<collective> carrying its rank, and the bytes each collective
brings a rank ((g - 1) x the tensor, over g members) and the bytes every
rank but the first hands to the first are added to the tracing
RenderMetrics' host counter mesh.bytes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading
import time
from dataclasses import dataclass

import torch

from cudapathtracer_tpu_torch.models import (bdpt, bdpt_mega, vcm,
                                             vcm_mega)
from cudapathtracer_tpu_torch.utils import metrics
from cudapathtracer_tpu_torch.utils import rng as rng_mod

SPLAT_FNS = (bdpt.render_sample, vcm.render_sample)
NO_SPLAT_SHAPE = (bdpt_mega.render_sample, vcm_mega.render_sample)
# how long a rank waits at a barrier for the other members: longer than
# a rank's first call, which may build the kernels
TIMEOUT_S = 300.0


class Group:
    """One rank's group along the tile axis: its members (global ranks in
    axis order), its index among them (`rank`) and `size`. Collectives sum
    or gather in member order: a member posts its tensor (on a card with
    an event marking it ready on the rank's stream) on the board the
    members share, they meet at the barrier, and each takes the others'
    posts to its own device, a card's copy queued on a stream of the
    source card (`pulls`) behind that event and waited for by the rank's
    stream. A posted tensor is read after the call returns, so the caller
    does not write to it again. wait_s: the host seconds this rank's
    thread has waited at the barrier."""

    def __init__(self, rank: int, members: tuple, turn, queued, board):
        self.rank, self.members, self.size = rank, members, len(members)
        self.turn = turn   # the CPU ranks' turn lock (Mesh.run), or None
        self.queued = queued   # the members' threading.Barrier
        self.board = board   # two rows of the members' posts
        self.pulls = {}      # source device -> the copy stream there
        self.seq = 0         # this rank's collectives so far
        self.wait_s = 0.0

    def _wait(self, op: str, nbytes: int) -> None:
        metrics.count("mesh.bytes", op, nbytes)
        t0 = time.perf_counter()
        with metrics.span("tpt.mesh." + op):
            if self.turn is not None:
                self.turn.release()   # the other ranks run up to here
            try:
                self.queued.wait()   # every member has posted its part
            finally:
                if self.turn is not None:
                    self.turn.acquire()
        self.wait_s += time.perf_counter() - t0

    def _exchange(self, t, op: str) -> list:
        """Post t, meet the members, and take each member's post to this
        rank's device -> the members' tensors in member order (t in this
        rank's place). A post's row is the collective's parity: a member
        posts in a row again only after every member has met at the
        collective between, so each has taken the post."""
        row = self.board[self.seq % 2]
        self.seq += 1
        ready = None
        if t.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        row[self.rank] = (t, ready)
        self._wait(op, (self.size - 1) * t.nbytes)
        out = []
        for k, (src, src_ready) in enumerate(row):
            if k == self.rank or src_ready is None:   # a CPU rank's
                out.append(src)
            elif src.device == t.device:   # a card that repeats
                here = torch.cuda.current_stream()
                here.wait_event(src_ready)
                src.record_stream(here)
                out.append(src)
            else:
                s = self.pulls.get(src.device)
                if s is None:
                    s = self.pulls[src.device] = torch.cuda.Stream(
                        src.device)
                s.wait_event(src_ready)
                with torch.cuda.stream(s):   # this rank's stream waits
                    out.append(src.to(t.device))
                src.record_stream(s)   # its memory outlives the copy
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the group, in member order (t itself for a
        group of one)."""
        return functools.reduce(torch.add,
                                self._exchange(t.contiguous(), "all_reduce"))

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every member's t, concatenated along `dim` in member order (the
        JAX package's tiled all_gather along dim 0), on t's device."""
        return torch.cat(self._exchange(t.contiguous(), "all_gather"), dim)


@dataclass
class Rank:
    """One rank of a mesh: its place, its device and its tile group."""
    rank: int
    ti: int
    si: int
    device: torch.device
    tile: Group     # the ranks along the tile axis (same si)
    stream: object  # its torch.cuda.Stream, or None on the CPU


@dataclass
class Mesh:
    """A ("tile", "spp") mesh of ranks; shape maps each axis to its size."""
    shape: dict
    devices: list
    ranks: list
    turn: object = None   # a threading.Lock where the ranks are CPU ranks
    barriers: tuple = ()  # the tile groups' barriers (Group.queued)

    def describe(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return (f"({self.shape['tile']}, {self.shape['spp']}) mesh on "
                f"[{devs}]")

    def run(self, fn) -> list:
        """fn(rank) on one thread a rank, each on its device and stream;
        -> the results in rank order. The exception of the first rank to
        fail is raised here once every thread has ended (the others end at
        once where they wait at a group's barrier). Where the caller
        traces (utils/metrics.py), each rank's thread traces too, its
        spans carrying its rank."""
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

        _join(_threads(body, self.ranks))
        if errors:
            rank, err = errors[0]   # the first to fail; the others follow
            raise RuntimeError(f"rank {rank} of the {self.describe()} "
                               f"failed: {err!r}") from err
        return out

    def wait_s(self) -> float:
        """Host seconds the ranks' threads have waited at their groups'
        barriers, summed over the ranks."""
        return sum(r.tile.wait_s for r in self.ranks)

    def synchronize(self) -> None:
        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)


@contextlib.contextmanager
def _on(r: Rank):
    """The rank's device and stream as the thread's current ones."""
    if r.device.type != "cuda":
        yield
        return
    with torch.cuda.device(r.device), torch.cuda.stream(r.stream):
        yield


def _threads(body, items) -> list:
    threads = [threading.Thread(target=body, args=(x,), daemon=True)
               for x in items]
    for t in threads:
        t.start()
    return threads


def _join(threads) -> None:
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


def _open_context(dev: torch.device) -> None:
    """Create the card's primary context through the driver API. A ctypes
    call lets go of the interpreter, so the other threads run while the
    context is made; PyTorch's first call on a card holds the interpreter
    meanwhile. PyTorch then takes the context as it finds it."""
    lib = ctypes.CDLL("libcuda.so.1")
    dev_handle, ctx = ctypes.c_int(), ctypes.c_void_p()
    for what, call in (
            ("cuInit", lambda: lib.cuInit(0)),
            ("cuDeviceGet", lambda: lib.cuDeviceGet(ctypes.byref(dev_handle),
                                                    dev.index)),
            ("cuDevicePrimaryCtxRetain", lambda: lib.cuDevicePrimaryCtxRetain(
                ctypes.byref(ctx), dev_handle))):
        rc = call()
        if rc:
            raise RuntimeError(f"{what} on {dev}: CUDA driver error {rc}")


def _connect(group: Group, dev) -> None:
    """One collective of one element: the copy streams from the members'
    cards and the cards' peer access exist before the first call (its
    wait is set-up, not counted in wait_s)."""
    group.all_reduce(torch.zeros(1, device=dev))
    group.wait_s = 0.0


def _finish(r: int, ti: int, si: int, dev, tile: Group) -> Rank:
    """Rank r with its stream (on a card, whose context exists) and its
    tile group, connected on cards."""
    if dev.type != "cuda":
        return Rank(r, ti, si, dev, tile, None)
    with torch.cuda.device(dev):
        rank = Rank(r, ti, si, dev, tile, torch.cuda.Stream())
    if tile.size > 1:
        with _on(rank):
            _connect(tile, dev)
            rank.stream.synchronize()
    return rank


def start_mesh(n_tile: int | None = None, n_spp: int = 1, devices=None):
    """Start building a ("tile", "spp") mesh -> join(), which waits for
    the rank threads and returns the Mesh. By default over every
    visible CUDA device, all on the tile axis. devices: torch devices or
    their names, one a rank, all CPU or all CUDA, repeats allowed (e.g.
    ["cpu"] * 8, or ["cuda:0"] * 4); the first n_tile * n_spp are used.
    The devices are checked here, and on cards one thread a rank creates
    the card's context while the caller goes on; join() then creates each
    rank's stream and tile group, on one thread a rank, and on cards
    connects each group with one collective of one element."""
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
    cuda = devices[0].type == "cuda"
    if any((d.type == "cuda") != cuda for d in devices):
        raise ValueError(f"a mesh's ranks are all CPU or all CUDA devices: "
                         f"{[str(d) for d in devices]}")
    # CPU ranks take turns between collectives: their plain versions issue
    # many small operators, and threads that contend for the interpreter
    # run them several times slower than one thread at a time
    turn = None if cuda else threading.Lock()
    barriers = [threading.Barrier(n_tile, timeout=TIMEOUT_S)
                for _ in range(n_spp)]
    boards = [([None] * n_tile, [None] * n_tile) for _ in range(n_spp)]
    ranks = [None] * n
    errors = []

    def opened(r: int):
        try:
            _open_context(devices[r])
        except BaseException as e:   # re-raised by join()
            errors.append((r, e))

    def build(r: int):
        ti, si = divmod(r, n_spp)
        try:
            ranks[r] = _finish(r, ti, si, devices[r], Group(
                ti, tuple(t * n_spp + si for t in range(n_tile)), turn,
                barriers[si], boards[si]))
        except BaseException as e:   # re-raised by join()
            errors.append((r, e))
            for b in barriers:   # the others stop waiting for it
                b.abort()

    threads = _threads(opened, range(n)) if cuda else []

    def join() -> Mesh:
        _join(threads)
        if not errors:
            _join(_threads(build, range(n)))
        if errors:
            r, err = min(errors, key=lambda e: e[0])
            raise RuntimeError(f"rank {r}: a ({n_tile}, {n_spp}) mesh "
                               f"could not be built: {err!r}") from err
        return Mesh(shape={"tile": n_tile, "spp": n_spp}, devices=devices,
                    ranks=ranks, turn=turn, barriers=tuple(barriers))

    return join


def make_mesh(n_tile: int | None = None, n_spp: int = 1,
              devices=None) -> Mesh:
    """Build a ("tile", "spp") mesh (start_mesh, joined)."""
    return start_mesh(n_tile, n_spp, devices)()


def _base(fn):
    while isinstance(fn, functools.partial):
        fn = fn.func
    return fn


def check_shardable(sample_fn) -> None:
    """Raise NotImplementedError for the integrators a mesh refuses: the
    mega engines of BDPT, VCM and SPPM."""
    base = _base(sample_fn)
    if base in NO_SPLAT_SHAPE:
        raise NotImplementedError(
            f"{base.__module__}.render_sample takes no splat_shape (nor does "
            "its JAX counterpart), so it cannot be sharded; use the "
            "classic engine")


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

    Returns fn(key, sample_idx, px, py) -> (radiance [N,3], the
    integrator's counts summed over every rank as 0-d int64 tensors: rays,
    and VCM's merge-dropped photons), all on the mesh's first device and
    ready in order on the caller's current stream there; nothing waits for
    the cards. N must divide the tile axis. Each rank renders sample
    `sample_idx * n_spp + si` of its tile, summed over the spp axis, so
    one call advances n_spp samples.

    Each rank's radiance and counts are copied to the first device, where
    the spp axis's radiance is summed.

    splat=True (BDPT, VCM, SPPM): the integrator gets splat_shape = N and
    returns (li_tile, fb [N,3], counts...); fb is summed over the tile axis
    only and each rank adds its tile's slice before the spp sum. Keys are
    not folded (the draws are keyed by pixel id). photon_axis="tile" (VCM
    and SPPM with merging) gathers the photons over the tile axis when it
    has 2 or more ranks."""
    check_shardable(sample_fn)
    base = _base(sample_fn)
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    photon_axis = static_kw.pop("photon_axis", None)
    if photon_axis not in (None, "tile") or (photon_axis and not splat):
        raise ValueError(f"photon_axis {photon_axis!r}: 'tile', with "
                         "splat=True")
    if n_tile > 1 and not splat and base in SPLAT_FNS:
        raise ValueError(f"{base.__module__}.render_sample splats into "
                         "raster pixels: shard it over tiles with "
                         "splat=True")
    first = mesh.devices[0]
    scenes = {d: replicate(scene, d) for d in set(mesh.devices)}
    mesh.synchronize()   # the copies are done before the ranks' streams
    placed = {}   # rank -> (px, py, the rank's slices of them)

    def call(key, sample_idx, px, py):
        n = px.shape[0]
        if n % n_tile:
            raise ValueError(f"{n} pixels do not divide the tile axis "
                             f"({n_tile})")
        n_local = n // n_tile
        main = (torch.cuda.current_stream(first) if first.type == "cuda"
                else None)

        def to_first(t):
            """t, a tensor on the rank's stream, in order on `main`."""
            if main is None:
                return t.to(first)
            if t.device == first:
                main.wait_stream(torch.cuda.current_stream(first))
                t.record_stream(main)
                return t
            with torch.cuda.stream(main):   # the copy on the rank's stream
                return t.to(first)

        def inputs(r: Rank):
            """The rank's slice of the pixels on its device, placed once
            for each pixel list."""
            got = placed.get(r.rank)
            if got is None or got[0] is not px or got[1] is not py:
                sl = slice(r.ti * n_local, (r.ti + 1) * n_local)
                with (torch.cuda.stream(main) if main is not None
                      else contextlib.nullcontext()):
                    got = (px, py, px[sl].to(r.device), py[sl].to(r.device))
                if r.stream is not None:
                    r.stream.wait_stream(main)
                placed[r.rank] = got
            return got[2], got[3]

        def shard(r: Rank):
            pxs, pys = inputs(r)
            my_sample = sample_idx * n_spp + r.si
            if splat:
                kw = dict(static_kw, splat_shape=n)
                if photon_axis and n_tile > 1:
                    kw["photon_group"] = r.tile
                li, fb, *counts = sample_fn(scenes[r.device], camera, key,
                                            my_sample, pxs, pys, **kw)
                # the tile axis only: each spp rank's fb is its own sample's
                sl = slice(r.ti * n_local, (r.ti + 1) * n_local)
                li = li + r.tile.all_reduce(fb)[sl]
            else:
                shard_key = rng_mod.fold_in(rng_mod.fold_in(key, r.ti), r.si)
                li, *counts = sample_fn(scenes[r.device], camera, shard_key,
                                        my_sample, pxs, pys, **static_kw)
            counts = torch.stack([_count(c, r.device) for c in counts])
            if r.rank:
                metrics.count("mesh.bytes", "to_first",
                              li.nbytes + counts.nbytes)
            return to_first(li), to_first(counts)

        outs = mesh.run(shard)
        # the spp axis's sum, in its order, on the first device
        li = torch.cat([functools.reduce(torch.add, (
            outs[ti * n_spp + si][0] for si in range(n_spp)))
            for ti in range(n_tile)])
        counts = torch.stack([o[1] for o in outs]).sum(0)
        return (li, *counts.unbind())

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
        total_rays += int(rays)
    return acc.cpu().numpy(), done, total_rays
