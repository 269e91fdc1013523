"""The port's hand-written CUDA kernels: build, load, launch, count.

Sources live in kernels/csrc (sm_90a): one .cu per launchable kernel family
and one .cuh of device code per TPU kernel, shared between them (K1
traverse8.cuh, K15 traverse_bin.cuh (the threaded binary engine, whose
batch entries are traverse_bin.cu), K7 camera.cuh, K2 shade.cuh, K3
bsdf.cuh, K4 nee.cuh, K6 threefry.cuh and its key tables keys.cuh, K10
packing.cuh, K12's MIS step
mis.cuh, the BDPT bodies bdpt.cuh, persistent threads persistent.cuh, a
traced run's device counters tally.cuh; the
persistent megakernel K5, uni_mega.cu, and the BDPT kernels K11
bdpt_splat.cu, K12 bdpt_walk.cu and K13's two stages bdpt_pairs.cu and
bdpt_gather.cu call them; the photon grid's hashgrid.cuh (K8-K10) serves
K8 photon_grid.cu (around its radix sort, radix_sort.cu), K9's test
entry neighbor_slots.cu and the VCM eye
passes: the classic one (K13's VCM form with K9's fold; strategies in
vcm.cuh) and the mega engines' K14 (its strategies in mega.cuh) run as the
same three stages, eye.cuh's bodies launched by eye_walk.cu,
eye_connect.cu and eye_gather.cu).
They are compiled on first use with nvcc, one process per source, all
started together, and linked into one shared library with a plain C
interface, build/torch_ext/libtpt_torch_kernels.so, called through ctypes
on PyTorch's current stream; the library is rebuilt whenever a source or
header is newer. Nothing is compiled when this module is imported. The
traversal's stack depth is fixed at build time: the default 16 is the
library above, and any other depth (stack_d=) builds its own
libtpt_torch_kernels_stack<d>.so.

Three entries have a second mode, counted under a name of its own: K6's
keyed draw (uniform_keyed, rng.cu), K12's table mode for the keyed
light walk (bdpt_walk_table, bdpt_walk.cu) and K8's rows mode, the grid
of a tile-sharded VCM sample built from the photon rows its ranks
gathered (photon_bucket, photon_grid.cu; the rows come from photon_pack's
pack-only mode, photon_rows, counted under photon_pack). K5 renders k >= 1 samples a
launch (samples per dispatch), counted under render_unidirectional, or
naive for its naive schedule. An eye pass (vcm_eye, mega_eye) counts each
of its stage calls under <pass>_walk, <pass>_connect and <pass>_gather;
K13 counts its two under bdpt_pairs and bdpt_gather; a splat (bdpt_splat,
vcm_splat) its two stages under <splat>_bin and <splat>_trace. A count is
of calls into the library's C entries: an entry may launch more than one
kernel (K5's key table kernel before it, K8's sort a launch a pass, the
eye connections' queue before their trace), so the device runs more
kernels than `launches` sums.

Tracing (utils/metrics.py): each entry that the models call is the
program span tpt.kernel.<entry>, from entry to return, while a tracing
RenderMetrics has a span open in the calling thread; then K5, K12's light
walk and the eye passes' walk and connection stages are also given that
RenderMetrics' device counters (COUNTERS: rows and rays, the lane
counters of K5, K12's light walk and the eye walk, the connections' warp
calls, pairs queued and slots) when the caller passes none.

The hit fetch (K2) reads scene.shade_table, the 64-byte record of each
triangle derived from tri_f32 at upload (scene/scene.py), and the kernels
read a material by id from scene.mat_f32: K5, K12, K13 and the eye passes
take both tables' addresses (K11's splat mat_f32 alone).

Engines: the kernels that trace rays (K5, K11-K13, the classic eye pass's
walk and connections) are built twice, once per traversal engine, and
launched with the scene's: BVH8 (K1, scene.bvh8_table) or threaded (K15,
scene.bin_table, derived from scene.node_packed), as the JAX functions
follow scene.traversal. Three launches read the BVH8 table on every
scene, as their JAX counterparts (make_fused_step) do: K5's mega
schedule, K12's table mode and K14's stages.

Each wrapper below checks its tensors (device, dtype, shape, contiguity),
allocates the outputs, launches, raises if the launch was refused, and then
adds one to its entry of `launches`. The launch counters are the package's
only global state besides the persistent kernels' scratch (K5's, K12's
and the eye walk's id counter, and K5's key tables, one buffer a device
and stream, written on the card by each launch);
`reset_launches()` zeroes them. No wrapper waits for the card: the key
tables a launch's draws read (keys.cuh: K5's, K12's, the classic eye
walk's, K13's pairs') are folded on the card by a prologue queued before
the kernel from the key words the launch takes by value, into scratch the
wrapper allocates; the few words the keyed walk's host table holds are
copied from pinned memory without blocking (upload_words).

Compile flags: -O3 and -fmad=false, no --use_fast_math (so sqrtf and
division are correctly rounded). -fmad=false keeps every a*b+c rounded
twice, as the plain PyTorch versions (one operator per op) and XLA:CPU
round it, so the traversal kernel returns the same triangle ids and t
values as its plain version instead of differing at triangle edges, and
the shading arithmetic follows the plain version; the kernels are bound by
memory latency, not by FMA throughput.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch

from cudapathtracer_tpu_torch.utils import metrics

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("rng.cu", "camera.cu", "traverse8.cu", "traverse_bin.cu",
           "uni_mega.cu", "packing.cu", "bdpt_walk.cu", "bdpt_splat.cu",
           "bdpt_pairs.cu", "bdpt_gather.cu", "photon_grid.cu",
           "neighbor_slots.cu", "eye_walk.cu", "eye_connect.cu",
           "eye_gather.cu", "radix_sort.cu")
HEADERS = ("threefry.cuh", "keys.cuh", "camera.cuh", "traverse8.cuh",
           "traverse_bin.cuh", "shade.cuh", "bsdf.cuh", "nee.cuh",
           "packing.cuh", "mis.cuh", "bdpt.cuh", "hashgrid.cuh", "vcm.cuh",
           "mega.cuh", "eye.cuh", "persistent.cuh", "tally.cuh")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_ext")
LIBRARY = os.path.join(BUILD_DIR, "libtpt_torch_kernels.so")
STACK_D = 16      # traverse8.cuh's default stack depth
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")
SHADE_EVAL_COLS = 38   # uni_mega.cu kShadeEvalCols
SHADE_COLS = 16        # floats a record of scene.shade_table (shade.cuh)
BIN_HEAD = 24         # traverse_bin.cuh: floats a node record of K15's
BIN_TRI = 12          # tables, floats a leaf triangle record
SCHEDULES = {"classic": 0, "mega": 1, "naive": 2}
EYE_FLAVORS = {"classic": 0, "vcm": 1, "bdpt": 2}   # eye.cuh kEye*
SLOT_MODES = {"slots": 0, "compact": 1, "gather": 2}
ENGINES = {"bvh8": 0, "threaded": 1}   # traverse_bin.cuh kEngine*
KEY_PAIR_WORDS = 2    # keys.cuh KeyPair: uint32 words a pair of a key table

# kernel name -> launches since the last reset_launches()
launches = {"closest_hit8": 0, "shadow_factor8": 0, "closest_hit_bin": 0,
            "shadow_factor_bin": 0, "uniform_id": 0,
            "generate_rays": 0, "render_unidirectional": 0, "shade_eval": 0,
            "packing_roundtrip": 0, "bdpt_walk": 0,
            "bdpt_pairs": 0, "bdpt_gather": 0,
            "photon_pack": 0, "photon_sort": 0, "photon_table": 0,
            # K8's rows mode (photon_grid.cu): the grid of a tile-sharded
            # VCM sample, built from the photon rows gathered over the tiles
            "photon_bucket": 0,
            "rgb9e5": 0, "key_table": 0,
            "neighbor_slots": 0, "naive": 0,
            "uniform_keyed": 0, "bdpt_walk_table": 0,
            # K11's two stages (bdpt_splat.cu): classify and bin, trace
            # and splat
            "bdpt_splat_bin": 0, "bdpt_splat_trace": 0,
            "vcm_splat_bin": 0, "vcm_splat_trace": 0,
            # the eye passes' stages (eye_walk.cu, eye_connect.cu,
            # eye_gather.cu)
            "vcm_eye_walk": 0, "vcm_eye_connect": 0, "vcm_eye_gather": 0,
            "mega_eye_walk": 0, "mega_eye_connect": 0, "mega_eye_gather": 0,
            # launches of a kernel's threaded instantiation (K15's device
            # code inside K5, K11-K13 or the VCM eye pass), counted beside
            # that kernel's own count
            "threaded_engine": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()   # the ranks of a mesh launch from threads
_libs = {}        # stack depth -> loaded library


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def _entry(fn):
    """A library entry that the models call: while this thread traces
    (utils/metrics.py), the program span tpt.kernel.<name> from entry to
    return."""
    name = "tpt.kernel." + fn.__name__

    @functools.wraps(fn)
    def entry(*args, **kw):
        with metrics.span(name):
            return fn(*args, **kw)
    entry.span = name
    return entry


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    home = CUDA_HOME or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}: the CUDA kernels "
                           "need the CUDA toolkit")
    return path


def _library(stack_d: int) -> str:
    """Path of the kernel library whose traversal stack holds stack_d."""
    if stack_d == STACK_D:
        return LIBRARY
    return os.path.join(BUILD_DIR, f"libtpt_torch_kernels_stack{stack_d}.so")


def build(verbose: bool = False, stack_d: int = STACK_D) -> str:
    """Compile the kernel library if it is missing or older than a source
    or header: one nvcc per source, all at once, then one link. With
    verbose it always builds, and ptxas's report of each kernel's
    registers and spills is printed and kept beside the library in
    <library>.ptxas.txt. Returns the library's path."""
    if not 7 <= stack_d <= 64:
        raise ValueError(f"stack_d {stack_d}: a row pushes up to 7 entries, "
                         "and the stack lives in local memory (<= 64)")
    lib = _library(stack_d)
    srcs = [os.path.join(CSRC, f) for f in SOURCES + HEADERS]
    if (not verbose and os.path.exists(lib) and all(
            os.path.getmtime(lib) >= os.path.getmtime(s) for s in srcs)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmpdir, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, f"-DTPT_STACK_D={stack_d}", "-c",
                   "-o", obj, os.path.join(CSRC, src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outs, failed = {}, []
        for src, _, proc in procs:
            outs[src] = proc.communicate(timeout=600)[0]
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(outs[f] for f in failed))
        tmp = f"{lib}.{os.getpid()}.tmp"
        res = subprocess.run([nvcc, "-shared", "-o", tmp,
                              *(obj for _, obj, _ in procs)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout
                               + res.stderr)
        os.replace(tmp, lib)
    if verbose:
        report = "\n".join(outs.values())
        with open(lib + ".ptxas.txt", "w") as f:
            f.write(report)
        print(report)
    return lib


def _load(stack_d: int = STACK_D):
    with _lock:
        if stack_d in _libs:
            return _libs[stack_d]
        lib = ctypes.CDLL(build(stack_d=stack_d))
        p, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int32,
                            ctypes.c_int64, ctypes.c_uint32)
        lib.tpt_error_string.restype = ctypes.c_char_p
        lib.tpt_error_string.argtypes = [ctypes.c_int]
        lib.tpt_uniform_id.restype = ctypes.c_int
        lib.tpt_uniform_id.argtypes = [p, p, p, i64, u32, u32, p]
        lib.tpt_uniform_keyed.restype = ctypes.c_int
        lib.tpt_uniform_keyed.argtypes = [p, p, p, p, i64, p]
        lib.tpt_generate_rays.restype = ctypes.c_int
        lib.tpt_generate_rays.argtypes = [p, p, p, p, p, i64, p, p, p]
        lib.tpt_closest_hit8.restype = ctypes.c_int
        lib.tpt_closest_hit8.argtypes = [p, p, p, p, p, p, i64,
                                         p, p, p, p, p, p, p]
        lib.tpt_shadow_factor8.restype = ctypes.c_int
        lib.tpt_shadow_factor8.argtypes = [p, p, i32, p, p, p, p, p, i64,
                                           p, p, p]
        lib.tpt_closest_hit_bin.restype = ctypes.c_int
        lib.tpt_closest_hit_bin.argtypes = [p, i32, i32, p, p, p, p, p, i64,
                                            p, p, p, p, p, p]
        lib.tpt_shadow_factor_bin.restype = ctypes.c_int
        lib.tpt_shadow_factor_bin.argtypes = [p, i32, i32, p, i32, p, p, p,
                                              p, p, i64, p, p, p]
        lib.tpt_render_unidirectional.restype = ctypes.c_int
        lib.tpt_render_unidirectional.argtypes = [
            p, p, i32, p, p, p, i32, p, p, p, p, i64, p, u32, u32, u32, i32,
            i32, i32, i32, i32, i32, i32, p, i32, i32, p, p, p, p, i32, p, p]
        lib.tpt_render_unidirectional_grid.restype = ctypes.c_int
        lib.tpt_render_unidirectional_grid.argtypes = [i32, i64, p]
        lib.tpt_render_unidirectional_scratch.restype = ctypes.c_int64
        lib.tpt_render_unidirectional_scratch.argtypes = [i32, i32, i32]
        lib.tpt_render_unidirectional_key_rows.restype = ctypes.c_int32
        lib.tpt_render_unidirectional_key_rows.argtypes = [i32, i32]
        lib.tpt_key_table.restype = ctypes.c_int64
        lib.tpt_key_table.argtypes = [i32, u32, u32, p, p, p]
        lib.tpt_shade_eval.restype = ctypes.c_int
        lib.tpt_shade_eval.argtypes = [p, p, p, i32, p, p, p, p, p, p, p,
                                       p, p, p, i64, p, p, p]
        lib.tpt_packing_roundtrip.restype = ctypes.c_int
        lib.tpt_packing_roundtrip.argtypes = [p, p, p, p, p, p, i64, p, p,
                                              p, p, p, p, p]
        lib.tpt_bdpt_walk_grid.restype = ctypes.c_int
        lib.tpt_bdpt_walk_grid.argtypes = [i32, i64, p]
        for name in ("tpt_bdpt_walk", "tpt_bdpt_pairs", "tpt_bdpt_gather"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [p, p, p, p, p]
        lib.tpt_bdpt_splat.restype = ctypes.c_int
        lib.tpt_bdpt_splat.argtypes = [p, p, p, p]
        lib.tpt_photon_pack.restype = ctypes.c_int
        lib.tpt_photon_pack.argtypes = [p, p, p, p]
        lib.tpt_photon_bucket.restype = ctypes.c_int
        lib.tpt_photon_bucket.argtypes = [p, p, p, p]
        lib.tpt_photon_table.restype = ctypes.c_int
        lib.tpt_photon_table.argtypes = [p, p, p]
        lib.tpt_radix_sort32.restype = ctypes.c_int
        lib.tpt_radix_sort32.argtypes = [p, i64, i32, i32, u32, p, p, p, p,
                                         p, p]
        lib.tpt_radix_sort32_scratch.restype = ctypes.c_int64
        lib.tpt_radix_sort32_scratch.argtypes = [i64]
        for name in ("tpt_eye_walk", "tpt_eye_connect", "tpt_eye_gather"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [p, p, p, p, p]
        lib.tpt_rgb9e5_roundtrip.restype = ctypes.c_int
        lib.tpt_rgb9e5_roundtrip.argtypes = [p, i64, p, p, p]
        lib.tpt_neighbor_slots.restype = ctypes.c_int
        lib.tpt_neighbor_slots.argtypes = [p, p, p, p]
        _libs[stack_d] = lib
        return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _cuda_device(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"kernel launch needs a CUDA tensor, got "
                         f"{t.device}")
    return t.device


def _launch(name: str, lib, fn, *args, engine: int = 0) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.tpt_error_string(err).decode()}")
    _count(name)
    if engine == ENGINES["threaded"]:
        _count("threaded_engine")


@_entry
def uniform_id(ids: torch.Tensor, k0: int, k1: int, two: bool):
    """K6 (rng.cu): Threefry-2x32 over (ids, 0) -> ([N] f32, [N] f32|None)."""
    dev = _cuda_device(ids)
    n = ids.shape[0]
    _check(ids, "ids", torch.int32, (n,), dev)
    u0 = torch.empty(n, dtype=torch.float32, device=dev)
    u1 = torch.empty(n, dtype=torch.float32, device=dev) if two else None
    lib = _load()
    with torch.cuda.device(dev):
        _launch("uniform_id", lib, lib.tpt_uniform_id, ids.data_ptr(),
                u0.data_ptr(), u1.data_ptr() if two else None, n,
                k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF, _stream(dev))
    return u0, u1


def _words32(k: torch.Tensor) -> torch.Tensor:
    """uint32 words (a uint32 or int32 tensor) viewed as int32."""
    return k.view(torch.int32) if k.dtype == torch.uint32 else k


@_entry
def uniform_keyed(ids: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor):
    """K6's keyed mode (rng.cu): Threefry-2x32 over (ids, 0) under each
    lane's key pair (k0, k1 [N] uint32 words) -> [N] f32."""
    dev = _cuda_device(ids)
    n = ids.shape[0]
    _check(ids, "ids", torch.int32, (n,), dev)
    k0, k1 = _words32(k0), _words32(k1)
    _check(k0, "k0", torch.int32, (n,), dev)
    _check(k1, "k1", torch.int32, (n,), dev)
    u0 = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        _launch("uniform_keyed", lib, lib.tpt_uniform_keyed, ids.data_ptr(),
                k0.data_ptr(), k1.data_ptr(), u0.data_ptr(), n, _stream(dev))
    return u0


KEY_TABLES = {"uni": 0, "walk": 1, "eye": 2, "nee": 3}   # rng.cu kinds


def uni_key_rows(schedule: str, max_depth: int) -> int:
    """The rows of K5's draw-key table a sample (uni_mega.cu key_rows): 132
    (every event a classic path can take), max_depth (naive) or 0 (mega:
    one row, draw_key(skey, d))."""
    return _load().tpt_render_unidirectional_key_rows(SCHEDULES[schedule],
                                                      max_depth)


def key_table(kind: str, key, dims: list, device) -> torch.Tensor:
    """Test entry (rng.cu tpt_key_table): the key table a host's prologue
    folds on the card (keys.cuh) -> int32 [pairs, 2] on `device`. kind:
    "uni" (K5's draw-key table; dims [s0, k, rows], rows
    uni_key_rows(schedule, max_depth)), "walk" (K12's; [max_depth]),
    "eye" (the classic eye walk's; [eye_depth]), "nee" (K13's s=1;
    [eye_depth]); key: the launch word pair (the base key, the walk key,
    key_e, key_c). The plain builders are
    models/unidirectional.sample_key_table, paths.walk_key_table,
    vcm.eye_key_table and bdpt.nee_key_table."""
    if kind not in KEY_TABLES:
        raise ValueError(f"key table {kind!r}: one of {sorted(KEY_TABLES)}")
    dims = list(dims)
    cdims = (ctypes.c_int64 * 3)(*(dims + [0] * (3 - len(dims))))
    lib = _load()
    k0, k1 = key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF
    pairs = lib.tpt_key_table(KEY_TABLES[kind], k0, k1, cdims, None, None)
    if pairs < 0:
        raise ValueError(f"key table {kind!r}: dims {dims}")
    out = torch.empty((pairs, KEY_PAIR_WORDS), dtype=torch.int32,
                      device=device)
    with torch.cuda.device(device):
        _launch("key_table", lib, lambda: max(0, -lib.tpt_key_table(
            KEY_TABLES[kind], k0, k1, cdims, out.data_ptr(),
            _stream(device))))
    return out


@_entry
def upload_words(words, device) -> torch.Tensor:
    """uint32 words (a nested list of ints) as an int32 tensor on `device`,
    copied from pinned memory without blocking the host."""
    host = torch.from_numpy(
        np.asarray(words, dtype=np.int64).astype(np.uint32).view(np.int32))
    return host.pin_memory().to(device, non_blocking=True)


@_entry
def generate_rays(px: torch.Tensor, py: torch.Tensor, ids: torch.Tensor,
                  params: list, keys: list):
    """K7 (camera.cu): primary rays. params: 19 floats (origin, right, up,
    forward, fov_scale, aperture, focal_dist, aspect, width, height,
    aa_jitter); keys: 8 uint32 (draw keys 0-3). -> (o, d) [N,3] f32."""
    dev = _cuda_device(px)
    n = px.shape[0]
    _check(px, "px", torch.float32, (n,), dev)
    _check(py, "py", torch.float32, (n,), dev)
    _check(ids, "ids", torch.int32, (n,), dev)
    if len(params) != 19 or len(keys) != 8:
        raise ValueError("generate_rays: 19 params and 8 key words")
    o = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    cparams = (ctypes.c_float * 19)(*params)
    ckeys = (ctypes.c_uint32 * 8)(*(k & 0xFFFFFFFF for k in keys))
    lib = _load()
    with torch.cuda.device(dev):
        _launch("generate_rays", lib, lib.tpt_generate_rays, px.data_ptr(),
                py.data_ptr(), ids.data_ptr(), o.data_ptr(), d.data_ptr(), n,
                ctypes.addressof(cparams), ctypes.addressof(ckeys),
                _stream(dev))
    return o, d


def _ray_args(table, o, d, max_t, skip_tri, active):
    """Check a ray batch (and the BVH8 table, unless None)."""
    dev = _cuda_device(o)
    n = o.shape[0]
    if table is not None:
        if table.dim() != 2 or table.shape[1] != 96:
            raise ValueError(f"bvh8 table must be [R,96], got "
                             f"{tuple(table.shape)}")
        _check(table, "table", torch.float32, table.shape, dev)
    _check(o, "o", torch.float32, (n, 3), dev)
    _check(d, "d", torch.float32, (n, 3), dev)
    _check(max_t, "max_t", torch.float32, (n,), dev)
    _check(skip_tri, "skip_tri", torch.int32, (n,), dev)
    if active is not None:
        _check(active, "active", torch.bool, (n,), dev)
    return dev, n


def _tri_args(tri_f32, dev):
    if tri_f32.dim() != 2 or tri_f32.shape[1] not in (78, 94):
        raise ValueError(f"tri_f32 must be [T,78|94], got "
                         f"{tuple(tri_f32.shape)}")
    _check(tri_f32, "tri_f32", torch.float32, tri_f32.shape, dev)


def _counts(want: bool, n: int, dev):
    return torch.empty(n, dtype=torch.int32, device=dev) if want else None


def _ptr(t):
    return None if t is None else t.data_ptr()


@_entry
def closest_hit8(table, o, d, max_t, skip_tri, active, stack_d=STACK_D,
                 with_restarts=False, with_rows=False):
    """K1 closest (traverse8.cu) -> (t, tri, u, v), each [N]; with
    with_restarts, also each ray's number of restarts from the root, and
    with with_rows, then the number of BVH8 rows it visited."""
    dev, n = _ray_args(table, o, d, max_t, skip_tri, active)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    restarts = _counts(with_restarts, n, dev)
    rows = _counts(with_rows, n, dev)
    lib = _load(stack_d)
    with torch.cuda.device(dev):
        _launch("closest_hit8", lib, lib.tpt_closest_hit8, table.data_ptr(),
                o.data_ptr(), d.data_ptr(), max_t.data_ptr(),
                skip_tri.data_ptr(),
                None if active is None else active.data_ptr(), n,
                t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                _ptr(restarts), _ptr(rows), _stream(dev))
    out = (t, tri, u, v)
    return out + tuple(x for x in (restarts, rows) if x is not None)


@_entry
def shadow_factor8(table, tri_f32, o, d, max_t, skip_tri, active,
                   stack_d=STACK_D, with_rows=False):
    """K1 shadow (traverse8.cu) -> transmission scale [N,3]; with
    with_rows, (scale, each ray's number of BVH8 rows visited)."""
    dev, n = _ray_args(table, o, d, max_t, skip_tri, active)
    _tri_args(tri_f32, dev)
    scale = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rows = _counts(with_rows, n, dev)
    lib = _load(stack_d)
    with torch.cuda.device(dev):
        _launch("shadow_factor8", lib, lib.tpt_shadow_factor8,
                table.data_ptr(), tri_f32.data_ptr(), tri_f32.shape[1],
                o.data_ptr(), d.data_ptr(), max_t.data_ptr(),
                skip_tri.data_ptr(),
                None if active is None else active.data_ptr(), n,
                scale.data_ptr(), _ptr(rows), _stream(dev))
    return scale if rows is None else (scale, rows)


def _bin_args(table, nodes: int, dev) -> int:
    """Check a threaded engine's flat bin_table (ops/traverse.py) of `nodes`
    node records; -> its number of leaf triangle slots."""
    head = BIN_HEAD * nodes
    if (table.dim() != 1 or nodes < 1 or table.numel() <= head
            or (table.numel() - head) % BIN_TRI or nodes >= 2 ** 31):
        raise ValueError(f"bin_table must hold {BIN_HEAD} * {nodes} header "
                         f"and {BIN_TRI} * S triangle floats, got "
                         f"{tuple(table.shape)}")
    _check(table, "bin_table", torch.float32, table.shape, dev)
    return (table.numel() - head) // BIN_TRI


@_entry
def closest_hit_bin(table, nodes: int, o, d, max_t, skip_tri, active,
                    with_rows=False):
    """K15 closest (traverse_bin.cu) on a threaded scene's bin_table of
    `nodes` node records -> (t, tri, u, v), each [N]; with with_rows, also
    each ray's number of node rows visited."""
    dev, n = _ray_args(None, o, d, max_t, skip_tri, active)
    slots = _bin_args(table, nodes, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    rows = _counts(with_rows, n, dev)
    lib = _load()
    with torch.cuda.device(dev):
        _launch("closest_hit_bin", lib, lib.tpt_closest_hit_bin,
                table.data_ptr(), nodes, slots, o.data_ptr(),
                d.data_ptr(), max_t.data_ptr(), skip_tri.data_ptr(),
                _ptr(active), n, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                v.data_ptr(), _ptr(rows), _stream(dev))
    out = (t, tri, u, v)
    return out if rows is None else out + (rows,)


@_entry
def shadow_factor_bin(table, nodes: int, tri_f32, o, d, max_t, skip_tri,
                      active, with_rows=False):
    """K15 shadow (traverse_bin.cu) -> transmission scale [N,3]; with
    with_rows, (scale, each ray's number of node rows visited)."""
    dev, n = _ray_args(None, o, d, max_t, skip_tri, active)
    slots = _bin_args(table, nodes, dev)
    _tri_args(tri_f32, dev)
    scale = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rows = _counts(with_rows, n, dev)
    lib = _load()
    with torch.cuda.device(dev):
        _launch("shadow_factor_bin", lib, lib.tpt_shadow_factor_bin,
                table.data_ptr(), nodes, slots, tri_f32.data_ptr(),
                tri_f32.shape[1], o.data_ptr(), d.data_ptr(),
                max_t.data_ptr(), skip_tri.data_ptr(), _ptr(active), n,
                scale.data_ptr(), _ptr(rows), _stream(dev))
    return scale if rows is None else (scale, rows)


def _engine_args(scene, dev, bvh8_only: bool = False) -> tuple:
    """(engine, threaded tables' address, their nodes, their slots) of a
    launch: the scene's engine, or BVH8 for the launches that read the
    BVH8 table on every scene (bvh8_only: K5's mega schedule, K12's table
    mode, K14)."""
    if scene.traversal not in ENGINES:
        raise ValueError(f"traversal {scene.traversal!r}: one of "
                         f"{sorted(ENGINES)}")
    if bvh8_only or scene.traversal == "bvh8":
        return ENGINES["bvh8"], 0, 0, 0
    nodes = scene.node_packed.shape[0]
    slots = _bin_args(scene.bin_table, nodes, dev)
    return ENGINES["threaded"], scene.bin_table.data_ptr(), nodes, slots


def _table(scene, dev):
    """The scene's BVH8 table [R, 96], checked."""
    tbl = scene.bvh8_table
    if tbl.dim() != 2 or tbl.shape[1] != 96:
        raise ValueError(f"bvh8 table must be [R,96], got {tuple(tbl.shape)}")
    _check(tbl, "table", torch.float32, tbl.shape, dev)
    return tbl


def _scene_args(scene, dev):
    """Check the scene blocks the per-path kernels read; returns them."""
    blocks = dict(tri_f32=scene.tri_f32, light_f32=scene.light_f32,
                  textures=scene.textures, medium=scene.medium_f32,
                  shade=scene.shade_table, mat_f32=scene.mat_f32)
    for name, t in blocks.items():
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        _check(t, name, torch.float32, t.shape, dev)
    cols = {"tri_f32": (78, 94), "light_f32": (17,), "textures": (3,),
            "medium": (4,), "shade": (SHADE_COLS,), "mat_f32": (26,)}
    for name, ok in cols.items():
        if blocks[name].shape[1] not in ok:
            raise ValueError(f"{name}: {blocks[name].shape[1]} columns, "
                             f"expected one of {ok}")
    if blocks["shade"].shape[0] != blocks["tri_f32"].shape[0] \
            or blocks["shade"].data_ptr() % 16:
        raise ValueError("shade_table: one 16-byte aligned record a "
                         "triangle")
    return blocks


# The persistent kernels' scratch (K5, K12), one int64 tensor a (device,
# stream), written on the card by each launch before its kernel runs: word
# 0 the id counter, then from byte 16 K5's camera rows (8 uint32 words a
# sample) and its draw-key table. Grown to the largest size asked for;
# launches on one stream are ordered.
_PERSISTENT_SCRATCH: dict = {}


def _persistent_scratch(dev, words: int = 1) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _PERSISTENT_SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = _PERSISTENT_SCRATCH[key] = torch.empty(words, dtype=torch.int64,
                                                     device=dev)
    return buf


def _resident_grid(entry: str, engine: int, n: int) -> int:
    """The blocks (of 128 threads) of a persistent kernel's resident grid
    for n ids on the current device (its C entry `entry`): its SMs times
    the blocks that fit on one, at most one block per 128 ids."""
    blocks = ctypes.c_int32(0)
    lib = _load()
    err = getattr(lib, entry)(engine, n, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{entry} failed: "
                           f"{lib.tpt_error_string(err).decode()}")
    return blocks.value


@_entry
def render_unidirectional(scene, px: torch.Tensor, py: torch.Tensor,
                          cam_params: list, base_key, s0: int, k: int, *,
                          max_depth: int, use_mis: bool,
                          sample_environment: bool, schedule: str,
                          air_priority: int, with_rows: bool = False,
                          grid: int | None = None, lanes=None):
    """K5 (uni_mega.cu): samples s0 .. s0+k-1 (k >= 1) of the
    unidirectional path tracer for the pixels (px, py) [P] int32 in one
    launch of K5. cam_params: the 19 camera floats; base_key: the render's
    key pair (two uint32 words), from which a small kernel launched just
    before derives each sample's keys as models/unidirectional.render_plain
    does. schedule: "classic",
    "mega" (each path retired through RGB9E5) or "naive" (the naive
    integrator, max_depth bounces; counted under "naive"). The classic and
    naive schedules trace with the scene's engine, the mega one with BVH8.
    -> (radiance summed over the k samples in their order [P,3] f32, rays
    summed [P] i32), and with with_rows each pixel's count of rows (BVH8
    rows or threaded nodes) visited [P] i32. Test arguments: grid, a
    number of blocks in place of the resident grid (the result does not
    depend on it); lanes, an int64 [3] tensor on the device to which the
    launch adds (events stepped, the sum over warps of the warp's busiest
    lane's events, the warps' calls of the event code): events / (32 x
    calls) is the lane use, events / (32 x busiest) the event balance.
    While this thread traces, lanes defaults to the RenderMetrics' counter
    k5.lanes, and the sums of the rows and rays outputs are added to its
    counter k5.tally, reduced on the card after the launch (so the kernel
    is the one an untraced call runs)."""
    dev = _cuda_device(px)
    n = px.shape[0]
    _check(px, "px", torch.int32, (n,), dev)
    _check(py, "py", torch.int32, (n,), dev)
    if k < 1 or not 0 <= s0 < 2 ** 32:
        raise ValueError(f"samples {s0} + {k}: k >= 1 from a uint32 start")
    if lanes is None:
        lanes = metrics.counter("k5.lanes", dev)
    tally = metrics.counter("k5.tally", dev)
    if lanes is not None:
        _check(lanes, "lanes", torch.int64, (3,), dev)
    if grid is not None and grid < 1:
        raise ValueError(f"grid {grid}: at least one block")
    tbl = _table(scene, dev)
    b = _scene_args(scene, dev)
    if len(cam_params) != 19:
        raise ValueError("render_unidirectional: 19 camera floats")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r}: one of {sorted(SCHEDULES)}")
    # the mega schedule reads the BVH8 table on every scene
    eng = _engine_args(scene, dev, bvh8_only=schedule == "mega")
    li = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rays = torch.empty(n, dtype=torch.int32, device=dev)
    rows = _counts(with_rows or tally is not None, n, dev)
    cparams = (ctypes.c_float * 19)(*cam_params)
    lib = _load()
    scratch = lib.tpt_render_unidirectional_scratch(k, SCHEDULES[schedule],
                                                    max_depth)
    if scratch < 0:
        raise ValueError(f"render_unidirectional: max_depth {max_depth}")
    with torch.cuda.device(dev):
        _launch("naive" if schedule == "naive" else "render_unidirectional",
                lib, lib.tpt_render_unidirectional, tbl.data_ptr(),
                b["tri_f32"].data_ptr(), b["tri_f32"].shape[1],
                b["shade"].data_ptr(), b["mat_f32"].data_ptr(),
                b["light_f32"].data_ptr(), scene.num_lights,
                b["textures"].data_ptr(), b["medium"].data_ptr(),
                px.data_ptr(), py.data_ptr(), n, ctypes.addressof(cparams),
                base_key[0] & 0xFFFFFFFF, base_key[1] & 0xFFFFFFFF, s0, k,
                max_depth, int(use_mis), int(sample_environment),
                SCHEDULES[schedule], air_priority, *eng, li.data_ptr(),
                rays.data_ptr(), _ptr(rows),
                _persistent_scratch(dev, (scratch + 7) // 8).data_ptr(),
                grid or 0, _ptr(lanes), _stream(dev), engine=eng[0])
    if tally is not None:
        tally += torch.stack([rows.sum(), rays.sum()])
    return (li, rays, rows) if with_rows else (li, rays)


def render_unidirectional_grid(scene, n: int, schedule: str) -> int:
    """K5's resident grid for n pixels (_resident_grid)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    eng = _engine_args(scene, dev, bvh8_only=schedule == "mega")[0]
    return _resident_grid("tpt_render_unidirectional_grid", eng, n)


@_entry
def shade_eval(scene, o, d, t, tri, u, v, ids, eta_i, keys: list):
    """Test entry of uni_mega.cu: the K2-K4 device functions once per hit
    (o, d [N,3]; t, u, v, eta_i [N] f32; tri, ids [N] i32) with the mega
    draw keys (18 uint32 words, draws 0-8) -> [N, SHADE_EVAL_COLS] f32, the
    columns of models/unidirectional_mega.shade_eval_plain."""
    dev = _cuda_device(o)
    n = o.shape[0]
    _check(o, "o", torch.float32, (n, 3), dev)
    _check(d, "d", torch.float32, (n, 3), dev)
    for name, x, dt in (("t", t, torch.float32), ("tri", tri, torch.int32),
                        ("u", u, torch.float32), ("v", v, torch.float32),
                        ("ids", ids, torch.int32),
                        ("eta_i", eta_i, torch.float32)):
        _check(x, name, dt, (n,), dev)
    b = _scene_args(scene, dev)
    if len(keys) != 18:
        raise ValueError("shade_eval: 18 key words")
    out = torch.empty((n, SHADE_EVAL_COLS), dtype=torch.float32, device=dev)
    ckeys = _u32s(keys)
    lib = _load()
    with torch.cuda.device(dev):
        _launch("shade_eval", lib, lib.tpt_shade_eval,
                b["shade"].data_ptr(), b["mat_f32"].data_ptr(),
                b["light_f32"].data_ptr(), scene.num_lights,
                b["textures"].data_ptr(), b["medium"].data_ptr(),
                o.data_ptr(), d.data_ptr(), t.data_ptr(), tri.data_ptr(),
                u.data_ptr(), v.data_ptr(), ids.data_ptr(),
                eta_i.data_ptr(), n, ctypes.addressof(ckeys), out.data_ptr(),
                _stream(dev))
    return out


def packing_roundtrip(vec, beta, is_delta, backface, light_ind, mat_id):
    """K10 codecs (packing.cu) over a batch: vec, beta [N,3] f32; is_delta,
    backface [N] bool; light_ind, mat_id [N] i32 -> dict of oct [N] i32
    (uint32 bits), dec [N,3] f32, half3 [N,3] f16, beta_dec [N,3] f32,
    flags [N] i32 (uint32 bits), unflags [N,4] i32 (is_delta, backface,
    light_ind, mat_id)."""
    dev = _cuda_device(vec)
    n = vec.shape[0]
    _check(vec, "vec", torch.float32, (n, 3), dev)
    _check(beta, "beta", torch.float32, (n, 3), dev)
    _check(is_delta, "is_delta", torch.bool, (n,), dev)
    _check(backface, "backface", torch.bool, (n,), dev)
    _check(light_ind, "light_ind", torch.int32, (n,), dev)
    _check(mat_id, "mat_id", torch.int32, (n,), dev)
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=dev)
    out = dict(oct=e(n, dt=torch.int32), dec=e(n, 3),
               half3=e(n, 3, dt=torch.float16), beta_dec=e(n, 3),
               flags=e(n, dt=torch.int32), unflags=e(n, 4, dt=torch.int32))
    lib = _load()
    with torch.cuda.device(dev):
        _launch("packing_roundtrip", lib, lib.tpt_packing_roundtrip,
                vec.data_ptr(), beta.data_ptr(), is_delta.data_ptr(),
                backface.data_ptr(), light_ind.data_ptr(), mat_id.data_ptr(),
                n, *(out[k].data_ptr() for k in ("oct", "dec", "half3",
                                                 "beta_dec", "flags",
                                                 "unflags")),
                _stream(dev))
    return out


# --- the BDPT kernels (K11-K13) ----------------------------------------------

_BUF_DTYPES = {"pt": torch.float32, "n_oct": torch.int32,
               "wo_oct": torch.int32, "uv_h": torch.float16,
               "beta_h": torch.float16, "pdf_fwd": torch.float32,
               "d_vcm": torch.float32, "d_vc": torch.float32,
               "d_vm": torch.float32, "flags": torch.int32,
               "valid": torch.bool}
_BUF_TAIL = {"pt": (3,), "uv_h": (2,), "beta_h": (3,)}


def _check_bufs(bufs, name: str, depth: int, n: int, dev) -> list:
    """Check a PathBuffers [depth, n]; returns its 11 field addresses."""
    ptrs = []
    for field in _BUF_DTYPES:
        t = getattr(bufs, field)
        _check(t, f"{name}.{field}", _BUF_DTYPES[field],
               (depth, n) + _BUF_TAIL.get(field, ()), dev)
        ptrs.append(t.data_ptr())
    return ptrs


def _bdpt_scene(scene, dev, bvh8_only: bool = False) -> dict:
    """The scene blocks of the BDPT and photon kernels, checked, and the
    engine fields that end their launch arrays (engine: the threaded
    tables' address for ptrs, then engine, their nodes and slots for
    iv)."""
    tbl = _table(scene, dev)
    b = _scene_args(scene, dev)
    eng, bin_ptr, nodes, slots = _engine_args(scene, dev, bvh8_only)
    return dict(table=tbl, tri_f32=b["tri_f32"], light_f32=b["light_f32"],
                textures=b["textures"], mat_f32=b["mat_f32"],
                shade=b["shade"], bin=bin_ptr, engine_iv=[eng, nodes, slots])


def _i64s(values):
    return (ctypes.c_int64 * len(values))(*(int(v) for v in values))


def _f32s(values):
    return (ctypes.c_float * len(values))(*values)


def _u32s(values):
    return (ctypes.c_uint32 * len(values))(*(v & 0xFFFFFFFF for v in values))


@_entry
def bdpt_walk(scene, px, py, keys: list, *, mode: str, max_depth: int,
              rays, camera=None, eta_vcm=None, key_table=None,
              with_rows: bool = False, grid: int | None = None, lanes=None):
    """K12 (bdpt_walk.cu): one eye or light walk per pixel (px, py) [N]
    int32; keys: 12 words (models/paths.walk_keys); camera: eye mode only.
    Adds each walk's closest rays to rays [N] i32. eta_vcm turns on the
    VCM d_vm chain (light mode). The bounce draws read their key pairs
    from a table (paths.walk_key_table(key, max_depth)) that the launch's
    prologue folds on the card from the walk key; key_table selects the
    table mode (counted under "bdpt_walk_table", BVH8 on every scene):
    [max_depth * 8 + 10] int32 words on the device, that table folded on
    the host (the keyed walk's rng.draw_key_table(key, range(max_depth),
    range(4)), then the endpoint's draws 100..104 of key), read in its
    place. -> dict(bufs=PathBuffers
    [max_depth-1, N], v0=vertex-0 dict, escape=Escape (eye) or None,
    rows=[N] i32 rows visited on the scene's engine or None).
    Test arguments (the results do not depend on them): grid, a number of
    blocks in place of the resident grid; lanes, an int64 [3] tensor on
    the device to which the walk adds (bounces stepped, the sum over warps
    of the warp's busiest lane's bounces, the warps' calls of the bounce
    code), as K5's; while this thread traces, a light walk's lanes default
    to the RenderMetrics' counter k12.lanes."""
    from cudapathtracer_tpu_torch.models import paths
    dev = _cuda_device(px)
    n = px.shape[0]
    _check(px, "px", torch.int32, (n,), dev)
    _check(py, "py", torch.int32, (n,), dev)
    _check(rays, "rays", torch.int32, (n,), dev)
    if mode not in ("eye", "light"):
        raise ValueError(f"mode {mode!r}: 'eye' or 'light'")
    if mode == "eye" and camera is None:
        raise ValueError("the eye walk needs the camera")
    if max_depth < 1 or len(keys) != 12:
        raise ValueError("bdpt_walk: max_depth >= 1 and 12 key words")
    if lanes is None and mode == "light":
        lanes = metrics.counter("k12.lanes", dev)
    build = key_table is None
    if build:
        key_table = torch.empty(KEY_PAIR_WORDS * (max_depth * 4 + 5),
                                dtype=torch.int32, device=dev)
    else:
        key_table = _words32(key_table)
        _check(key_table, "key_table", torch.int32, (max_depth * 8 + 10,),
               dev)
    if lanes is not None:
        _check(lanes, "lanes", torch.int64, (3,), dev)
    if grid is not None and grid < 1:
        raise ValueError(f"grid {grid}: at least one block")
    # the table mode stands for the JAX keyed walk's fused BVH8 step
    sc = _bdpt_scene(scene, dev, bvh8_only=not build)
    depth = max_depth - 1
    bufs = paths.PathBuffers.empty(depth, n, dev)
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=dev)
    v0 = dict(pt=e(n, 3))
    esc = None
    if mode == "light":
        v0.update(n=e(n, 3), beta=e(n, 3), pdf_fwd=e(n),
                  light_ind=e(n, dt=torch.int32), mat_id=e(n, dt=torch.int32),
                  tri=e(n, dt=torch.int32))
    else:
        esc = paths.Escape(valid=e(n, dt=torch.bool), d=e(n, 3), beta=e(n, 3))
    rows = torch.zeros(n, dtype=torch.int32, device=dev) if with_rows \
        else None
    # the light walk's start: each path's emitted direction and its |cos|,
    # written by the prologue, read by the walk
    start = e(n, 4) if mode == "light" else None
    g = lambda d, k: _ptr(d.get(k)) or 0
    ptrs = ([sc[k].data_ptr() for k in ("table", "tri_f32", "light_f32",
                                        "textures")]
            + [px.data_ptr(), py.data_ptr()]
            + _check_bufs(bufs, "bufs", depth, n, dev)
            + [g(v0, k) for k in ("pt", "n", "beta", "pdf_fwd", "light_ind",
                                  "mat_id", "tri")]
            + [_ptr(esc.valid) if esc else 0, _ptr(esc.d) if esc else 0,
               _ptr(esc.beta) if esc else 0, rays.data_ptr(),
               _ptr(rows) or 0, key_table.data_ptr(), sc["bin"],
               _persistent_scratch(dev).data_ptr(), _ptr(lanes) or 0,
               _ptr(start) or 0, sc["shade"].data_ptr(),
               sc["mat_f32"].data_ptr()])
    cam = camera.kernel_params() if camera is not None else [0.0] * 19
    area = camera.plane_area() if camera is not None else 0.0
    iv = [n, sc["tri_f32"].shape[1], scene.num_lights,
          0 if mode == "eye" else 1, max_depth, int(mode == "eye"),
          int(eta_vcm is not None)] + sc["engine_iv"] + [grid or 0,
                                                          int(build)]
    fv = cam + [area, 0.0 if eta_vcm is None else float(eta_vcm)]
    args = (_i64s(ptrs), _i64s(iv), _f32s(fv), _u32s(keys))  # kept alive
    lib = _load()
    with torch.cuda.device(dev):
        _launch("bdpt_walk" if build else "bdpt_walk_table",
                lib, lib.tpt_bdpt_walk,
                *(ctypes.addressof(a) for a in args), _stream(dev),
                engine=sc["engine_iv"][0])
    if mode == "eye":
        # no host sync: the copy leaves pinned memory without blocking
        v0["n"] = torch.tensor(camera.forward, dtype=torch.float32) \
            .pin_memory().to(dev, non_blocking=True).expand(n, 3)
    return dict(bufs=bufs, v0=v0, escape=esc, rows=rows)


def bdpt_walk_grid(scene, n: int, table: bool = False) -> int:
    """K12's resident grid for n paths (_resident_grid; table: the table
    mode, BVH8 on every scene)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    eng = _engine_args(scene, dev, bvh8_only=table)[0]
    return _resident_grid("tpt_bdpt_walk_grid", eng, n)


@_entry
def bdpt_splat(scene, camera, lbufs, lv0: dict, fb, rays, cfg, *,
               n_live: int | None = None, with_rows: bool = False):
    """K11 (bdpt_splat.cu): the t=1 light-trace splat of light paths [N]
    (lbufs [L-1, N], the endpoint lv0) added into the raster-indexed frame
    buffer fb [P,3] f32 in place with atomics; rays [N] i32 += the shadow
    rays to the lens. cfg: a BDPTConfig (do_mis, paint_weight); n_live:
    only paths i < n_live splat (a mega chunk's pads do not). Its two
    stages (SplatPass.bin, SplatPass.trace) count under bdpt_splat_bin and
    bdpt_splat_trace. -> rows [N] i32 (rows visited on the scene's engine)
    with with_rows, else None."""
    sp = splat_pass(scene, camera, lbufs, lv0, fb, rays, cfg, n_live=n_live,
                    with_rows=with_rows)
    sp.bin()
    sp.trace()
    return sp.rows


@_entry
def vcm_splat(scene, camera, lbufs, fb, rays, cfg, eta_vcm: float, *,
              n_live: int | None = None, with_rows: bool = False):
    """K11's VCM form (bdpt_splat.cu's VCM mode): every stored light vertex
    of lbufs [L, N] (not the endpoint) to the lens, w_light with eta_vcm,
    added into the raster-indexed frame buffer fb [P,3] f32 in place with
    atomics; rays [N] i32 += the shadow rays to the lens. cfg: a VCMConfig
    (do_mis, paint_weight); n_live as bdpt_splat's. Its stages count under
    vcm_splat_bin and vcm_splat_trace. -> rows [N] i32 (rows visited on
    the scene's engine) with with_rows."""
    sp = splat_pass(scene, camera, lbufs, None, fb, rays, cfg,
                    eta_vcm=eta_vcm, n_live=n_live, with_rows=with_rows)
    sp.bin()
    sp.trace()
    return sp.rows


_BIN_THREADS = 512      # bdpt_splat.cu kBinThreads
_BIN_RANKS = 2 ** 18    # a bin code's ranks (kTileBits = 13 of 31 bits)


def _bin_blocks(dev, n_live: int, rows: int) -> int:
    """K11's classify grid: two blocks a SM, more where a block would hold
    2^18 entries or more, at most one a _BIN_THREADS paths."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_thread = max(1, (_BIN_RANKS - 1) // (_BIN_THREADS * max(rows, 1)))
    need = -(-max(n_live, 1) // _BIN_THREADS)
    return min(need, max(2 * sms, -(-need // per_thread)))


class SplatPass:
    """One splat set up for bdpt_splat.cu (splat_pass): its launch arrays,
    its scratch and, after bin(), the queue of the light vertices that
    trace, as entries r N + i (row r of path i: vertex r of the BDPT form,
    stored row r of VCM's), grouped by the screen tile of their pixel
    (models/bdpt.splat_tiling), in no order inside a tile: tile t's
    entries are queue[offsets[t]:offsets[t + 1]], offsets [tiles + 1]
    i32, and offsets[-1] is the queue's length (queue [rows N] i32 holds
    it). rows: [N] i32 rows visited (with_rows) or None."""

    def __init__(self, name, scene, camera, lbufs, n, v0_ptrs, fb, rays,
                 cfg, eta_vcm, with_rows, n_live):
        from cudapathtracer_tpu_torch.models import bdpt
        dev = _cuda_device(rays)
        p = camera.width * camera.height
        _check(fb, "fb", torch.float32, (p, 3), dev)
        _check(rays, "rays", torch.int32, (n,), dev)
        sc = _bdpt_scene(scene, dev)
        depth = lbufs.pt.shape[0]
        n_live = n if n_live is None else n_live
        if not 0 <= n_live <= n:
            raise ValueError(f"n_live {n_live} of {n} light paths")
        rows_n = (depth + (0 if eta_vcm is not None else 1)) * n
        if rows_n >= 2 ** 31:
            raise ValueError(f"{rows_n} light vertices: the queue holds "
                             "int32 entries")
        tile, tiles_x, tiles = bdpt.splat_tiling(camera.width, camera.height)
        blocks = _bin_blocks(dev, n_live, rows_n // n)
        self.rows = torch.zeros(n, dtype=torch.int32, device=dev) \
            if with_rows else None
        # tile_of [rows N], queue [rows N], the tile counts, offsets [tiles
        # + 1], each classify block's first slot in each tile
        scratch = torch.empty(2 * rows_n + (2 + blocks) * tiles + 1,
                              dtype=torch.int32, device=dev)
        tables = 2 * rows_n
        self.queue = scratch[rows_n:tables]
        self.offsets = scratch[tables + tiles:tables + 2 * tiles + 1]
        self._scratch = scratch
        ptrs = ([sc[k].data_ptr() for k in ("table", "tri_f32", "mat_f32",
                                            "textures")]
                + _check_bufs(lbufs, "lbufs", depth, n, dev) + v0_ptrs
                + [fb.data_ptr(), rays.data_ptr(), _ptr(self.rows) or 0,
                   sc["bin"], scratch.data_ptr(), self.queue.data_ptr(),
                   scratch[tables:].data_ptr(),
                   scratch[tables + 2 * tiles + 1:].data_ptr()])
        iv = [n, sc["tri_f32"].shape[1], depth, camera.width, camera.height,
              int(cfg.do_mis), int(cfg.paint_weight),
              int(eta_vcm is not None), n_live] + sc["engine_iv"] \
            + [tile, tiles_x, tiles, blocks]
        fv = camera.kernel_params() + [
            camera.plane_area(), 0.0 if eta_vcm is None else float(eta_vcm)]
        self._args = {stage: (_i64s(ptrs), _i64s(iv + [stage]), _f32s(fv))
                      for stage in (1, 2)}
        self.name, self.dev, self.engine = name, dev, sc["engine_iv"][0]

    def _run(self, stage: int, tag: str, engine: int) -> None:
        lib = _load()
        with torch.cuda.device(self.dev):
            _launch(f"{self.name}_{tag}", lib, lib.tpt_bdpt_splat,
                    *(ctypes.addressof(a) for a in self._args[stage]),
                    _stream(self.dev), engine=engine)

    def bin(self) -> None:
        """Stage 1: classify and bin (adds each path's traced count to
        rays); it traces nothing: one build, not a threaded
        instantiation."""
        self._run(1, "bin", 0)

    def trace(self) -> None:
        """Stage 2: one shadow ray a thread over the queue of the last
        bin(), in tile order, each added into fb."""
        self._run(2, "trace", self.engine)


def splat_pass(scene, camera, lbufs, lv0, fb, rays, cfg, *, eta_vcm=None,
               n_live: int | None = None,
               with_rows: bool = False) -> SplatPass:
    """Set up K11 on light paths [N] without launching: the BDPT form
    (lv0, the endpoint; counted under bdpt_splat_*) or, with eta_vcm and
    lv0 None, VCM's (vcm_splat_*). Arguments as bdpt_splat's and
    vcm_splat's."""
    dev = _cuda_device(rays)
    n = rays.shape[0]
    if eta_vcm is not None:
        return SplatPass("vcm_splat", scene, camera, lbufs, n, [0] * 5, fb,
                         rays, cfg, eta_vcm, with_rows, n_live)
    for k, dt, tail in (("pt", torch.float32, (3,)),
                        ("n", torch.float32, (3,)),
                        ("beta", torch.float32, (3,)),
                        ("pdf_fwd", torch.float32, ()),
                        ("mat_id", torch.int32, ())):
        _check(lv0[k], f"lv0.{k}", dt, (n,) + tail, dev)
    return SplatPass("bdpt_splat", scene, camera, lbufs, n,
                     [lv0[k].data_ptr() for k in ("pt", "n", "beta",
                                                  "pdf_fwd", "mat_id")],
                     fb, rays, cfg, None, with_rows, n_live)


def _connect_launch(name: str, entry: str, scene, camera, key_c, eye: dict,
                    light, fb, rays, cfg, *, px, py, terms, out, rows,
                    per: int = 1):
    """One launch of K13's stage `entry` (bdpt_pairs.cu or bdpt_gather.cu,
    one argument layout), counted under name. light, rays, px, py (the
    pairs' inputs) and fb, out (the gather's) may be None; per: the pairs'
    pairs a thread."""
    dev = terms.device
    n = eye["bufs"].pt.shape[1]
    for t, nm in ((px, "px"), (py, "py")):
        if t is not None:
            _check(t, nm, torch.int32, (n,), dev)
    if rays is not None:
        _check(rays, "rays", torch.int32, (n,), dev)
    if fb is not None:
        _check(fb, "fb", torch.float32, (n, 3), dev)
    if cfg.eye_depth < 2 or cfg.light_depth < 1:
        raise ValueError("K13: eye_depth >= 2 and light_depth >= 1")
    _check(terms, "terms", torch.float32,
           (cfg.eye_depth - 1, cfg.light_depth, n, 3), dev)
    sc = _bdpt_scene(scene, dev)
    esc = eye["escape"]
    _check(eye["v0"]["pt"], "ev0.pt", torch.float32, (n, 3), dev)
    _check(esc.valid, "escape.valid", torch.bool, (n,), dev)
    _check(esc.d, "escape.d", torch.float32, (n, 3), dev)
    _check(esc.beta, "escape.beta", torch.float32, (n, 3), dev)
    lptrs = ([0] * 11 if light is None else
             _check_bufs(light["bufs"], "light bufs", cfg.light_depth - 1, n,
                         dev))
    # the pairs' s=1 key table, folded on the card from key_c
    nee_keys = (torch.empty(KEY_PAIR_WORDS * (cfg.eye_depth + 1) * 3,
                            dtype=torch.int32, device=dev)
                if name == "bdpt_pairs" else None)
    ptrs = ([sc[k].data_ptr() for k in ("table", "tri_f32", "light_f32",
                                        "mat_f32", "textures")]
            + [_ptr(px) or 0, _ptr(py) or 0]
            + _check_bufs(eye["bufs"], "eye bufs", cfg.eye_depth - 1, n, dev)
            + [eye["v0"]["pt"].data_ptr(), esc.valid.data_ptr(),
               esc.d.data_ptr(), esc.beta.data_ptr()]
            + lptrs
            + [_ptr(fb) or 0, _ptr(out) or 0, _ptr(rays) or 0,
               _ptr(rows) or 0, sc["bin"], terms.data_ptr(),
               sc["shade"].data_ptr(), _ptr(nee_keys) or 0])
    iv = [n, sc["tri_f32"].shape[1], scene.num_lights, cfg.eye_depth,
          cfg.light_depth, int(cfg.naive), int(cfg.nee), int(cfg.connection),
          int(cfg.do_mis), int(cfg.paint_weight),
          int(cfg.sample_environment)] + sc["engine_iv"] + [per]
    fv = camera.kernel_params() + [camera.plane_area()]
    args = (_i64s(ptrs), _i64s(iv), _f32s(fv), _u32s(list(key_c)))
    lib = _load()
    with torch.cuda.device(dev):
        # the gather traces nothing: one build, not a threaded instantiation
        _launch(name, lib, getattr(lib, entry),
                *(ctypes.addressof(a) for a in args), _stream(dev),
                engine=sc["engine_iv"][0] if name == "bdpt_pairs" else 0)


def bdpt_pairs(scene, camera, key_c, eye: dict, light: dict, rays, cfg, *,
               px, py, rows=None, per: int | None = None):
    """K13's first stage (bdpt_pairs.cu): one thread per (eye depth t =
    2..eye_depth, slot, pixel) of the pixels (px, py) [N] i32; slot 0 is
    s = 1 (NEE, keys fold_in(key_c, t)), slot 1 + j the connection to
    stored light vertex j. eye, light: bdpt_walk's results; rays [N] i32 +=
    the shadow rays traced, rows [N] i32 += the rows they visited (or
    None). per: the pairs a thread takes in (t, slot) order, a divisor of
    (eye_depth - 1) x light_depth; None, the engine's: one on BVH8, all of
    a pixel's on the threaded engine (terms, rays and rows do not depend
    on it). -> terms [eye_depth - 1, light_depth, N, 3] f32: each pair's
    weighted contribution, +0 where nothing was traced or the ray was
    blocked."""
    dev = _cuda_device(px)
    n = px.shape[0]
    terms = torch.empty((cfg.eye_depth - 1, cfg.light_depth, n, 3),
                        dtype=torch.float32, device=dev)
    if per is None:
        # K1's short row walks gain from one ray a thread (no lane waits
        # for its pixel's longest list); K15's walks vary more from ray to
        # ray, and a thread's sum over its pixel's rays evens them out
        per = (terms.shape[0] * terms.shape[1]
               if scene.traversal == "threaded" else 1)
    if per < 1 or terms.shape[0] * terms.shape[1] % per:
        raise ValueError(f"per {per}: a divisor of the "
                         f"{terms.shape[0] * terms.shape[1]} pairs a pixel")
    _connect_launch("bdpt_pairs", "tpt_bdpt_pairs", scene, camera, key_c, eye,
                    light, None, rays, cfg, px=px, py=py, terms=terms,
                    out=None, rows=rows, per=per)
    return terms


def bdpt_gather(scene, camera, eye: dict, terms, fb, cfg):
    """K13's second stage (bdpt_gather.cu): per pixel, from zero, the sky
    term, then per eye depth s = 0 and the terms of bdpt_pairs in slot
    order, then fb [N,3] f32 (or None). -> radiance [N,3] f32."""
    dev = _cuda_device(terms)
    out = torch.empty((terms.shape[2], 3), dtype=torch.float32, device=dev)
    _connect_launch("bdpt_gather", "tpt_bdpt_gather", scene, camera, (0, 0),
                    eye, None, fb, None, cfg, px=None, py=None, terms=terms,
                    out=out, rows=None)
    return out


@_entry
def bdpt_connect(scene, camera, key_c, eye: dict, light: dict, fb, rays, cfg,
                 *, px, py, with_rows: bool = False):
    """K13: the connection stage of each pixel (px, py) [N] i32 as two
    launches, bdpt_pairs then bdpt_gather; eye: bdpt_walk's eye result
    (bufs [E-1, N], v0, escape), light: its light result (bufs [L-1, N]);
    fb: [N,3] f32 added to the result, or None; key_c: the sample's
    connection key pair; rays [N] i32 += the shadow rays traced. cfg: a
    BDPTConfig. -> (radiance [N,3] f32, rows [N] i32 rows visited on the
    scene's engine or None)."""
    dev = _cuda_device(px)
    rows = torch.zeros(px.shape[0], dtype=torch.int32, device=dev) \
        if with_rows else None
    terms = bdpt_pairs(scene, camera, key_c, eye, light, rays, cfg, px=px,
                       py=py, rows=rows)
    return bdpt_gather(scene, camera, eye, terms, fb, cfg), rows


# --- the photon family (K8, K9, K11's and K13's VCM forms) -------------------

def _pack_launch(lbufs, scene_min, cell_size: float, table_size: int,
                 with_bucket: bool):
    """One photon_pack launch over lbufs [L, N] -> (rows [P, 8], then bucket
    [P] and cell_se [T+1, 2] with with_bucket, else the validity [P] u8)."""
    dev = _cuda_device(lbufs.pt)
    depth, n = lbufs.pt.shape[0], lbufs.pt.shape[1]
    p = depth * n
    if p <= 0 or (with_bucket and not 0 < table_size < 2 ** 32):
        raise ValueError(f"photon_pack: {p} photons, table {table_size}")
    e = lambda *sh, dt=torch.float32: torch.empty(sh, dtype=dt, device=dev)
    rows = e(p, 8)
    if with_bucket:
        outs = (e(p, dt=torch.int32), e(table_size + 1, 2, dt=torch.int32))
        tail = [outs[0].data_ptr(), outs[1].data_ptr(), 0]
    else:
        outs = (e(p, dt=torch.uint8),)
        tail = [0, 0, outs[0].data_ptr()]
    ptrs = (_check_bufs(lbufs, "lbufs", depth, n, dev)
            + [rows.data_ptr()] + tail)
    iv = [n, depth, table_size if with_bucket else 0]
    fv = [float(x) for x in scene_min] + [float(cell_size)]
    args = (_i64s(ptrs), _i64s(iv), _f32s(fv))
    lib = _load()
    with torch.cuda.device(dev):
        _launch("photon_pack", lib, lib.tpt_photon_pack,
                *(ctypes.addressof(a) for a in args), _stream(dev))
    return (rows,) + outs


@_entry
def photon_pack(lbufs, scene_min, cell_size: float, table_size: int):
    """K8's first half (photon_grid.cu): one photon per stored light vertex
    of lbufs [L, N], in the flat order row * N + lane. -> (rows [P, 8] f32
    with uint32 words 3-5, bucket [P] i32 (table_size for a photon that is
    invalid or delta), cell_se [T+1, 2] i32 filled with (P, 0))."""
    return _pack_launch(lbufs, scene_min, cell_size, table_size, True)


@_entry
def photon_rows(lbufs):
    """photon_pack's pack-only mode (counted under photon_pack): the photon
    rows of lbufs [L, N] and their validity, which the ranks of a tile axis
    all-gather. -> (rows [P, 8] f32, valid [P] u8: 1 where the vertex is
    valid and not delta). Plain version: ops/hashgrid.photon_rows."""
    return _pack_launch(lbufs, (0.0, 0.0, 0.0), 0.0, 0, False)


@_entry
def photon_bucket(rows, valid, scene_min, cell_size: float, table_size: int):
    """K8's rows mode (photon_grid.cu): each packed photon row's bucket
    from its position and its validity, and the (start, end) table filled
    for photon_table. rows [P, 8] f32, valid [P] u8 (the union a tile axis
    gathered). -> (bucket [P] i32, table_size where valid is 0; cell_se
    [T+1, 2] i32 filled with (P, 0)): photon_pack's on the same photons,
    bit for bit. Plain version: ops/hashgrid.photon_bucket_plain."""
    dev = _cuda_device(rows)
    p = rows.shape[0]
    _check(rows, "rows", torch.float32, (p, 8), dev)
    _check(valid, "valid", torch.uint8, (p,), dev)
    if not 0 < p < 2 ** 31 or not 0 < table_size < 2 ** 32:
        raise ValueError(f"photon_bucket: {p} photons, table {table_size}")
    bucket = torch.empty(p, dtype=torch.int32, device=dev)
    cell_se = torch.empty((table_size + 1, 2), dtype=torch.int32, device=dev)
    args = (_i64s([rows.data_ptr(), valid.data_ptr(), bucket.data_ptr(),
                   cell_se.data_ptr()]), _i64s([p, table_size]),
            _f32s([float(x) for x in scene_min] + [float(cell_size)]))
    lib = _load()
    with torch.cuda.device(dev):
        _launch("photon_bucket", lib, lib.tpt_photon_bucket,
                *(ctypes.addressof(a) for a in args), _stream(dev))
    return bucket, cell_se


@_entry
def photon_sort(bucket, bits: int, salt=None):
    """K8's sort (radix_sort.cu): the stable order of the photons' sort
    keys, each derived from its bucket [P] (i32 holding uint32 values) and
    index as hashgrid.sort_keys does (salted with salt, or the bucket
    itself when salt is None), of which only the low `bits` may be
    nonzero, by an LSD radix sort of 8-bit digits: one histogram launch
    for every pass, then one launch a digit that can be nonzero. ->
    (order [P] i32, sorted slot -> photon; bucket[order] [P] i32). bucket
    is left as it is; counted once a sort."""
    dev = _cuda_device(bucket)
    p = bucket.shape[0]
    _check(bucket, "bucket", torch.int32, (p,), dev)
    if not 0 < p < 2 ** 30 or not 1 <= bits <= 32:
        raise ValueError(f"photon_sort: {p} keys of {bits} bits")
    e = lambda m: torch.empty(m, dtype=torch.int32, device=dev)
    lib = _load()
    order, gathered = e(p), e(p)
    # (bucket, index) pairs between passes; the histograms, tile counters
    # and tiles' flagged counts (zeroed by the sort)
    scratch = [e(2 * p), e(2 * p), e(lib.tpt_radix_sort32_scratch(p))]
    with torch.cuda.device(dev):
        _launch("photon_sort", lib, lib.tpt_radix_sort32, bucket.data_ptr(),
                p, bits, int(salt is not None),
                0 if salt is None else int(salt) & 0xFFFFFFFF,
                *(t.data_ptr() for t in scratch), order.data_ptr(),
                gathered.data_ptr(), _stream(dev))
    return order, gathered


@_entry
def photon_table(rows, bucket, order, cell_se):
    """K8's second half (photon_grid.cu): the rows [P, 8] gathered into
    sorted order (order [P] i32 and the buckets in that order, bucket [P]
    i32, from photon_sort) and padded by (-P) % 8 + 8 zero rows, and each
    bucket's (start, end) made with atomicMin / atomicMax into cell_se
    [T+1, 2] in place. -> sorted rows [P8, 8] f32."""
    dev = _cuda_device(rows)
    p = rows.shape[0]
    _check(rows, "rows", torch.float32, (p, 8), dev)
    _check(bucket, "bucket", torch.int32, (p,), dev)
    _check(order, "order", torch.int32, (p,), dev)
    _check(cell_se, "cell_se", torch.int32, cell_se.shape, dev)
    if cell_se.dim() != 2 or cell_se.shape[1] != 2:
        raise ValueError(f"cell_se must be [T+1, 2], got "
                         f"{tuple(cell_se.shape)}")
    p8 = p + (-p) % 8 + 8
    out = torch.empty((p8, 8), dtype=torch.float32, device=dev)
    args = (_i64s([rows.data_ptr(), bucket.data_ptr(), order.data_ptr(),
                   out.data_ptr(), cell_se.data_ptr()]), _i64s([p, p8]))
    lib = _load()
    with torch.cuda.device(dev):
        _launch("photon_table", lib, lib.tpt_photon_table,
                *(ctypes.addressof(a) for a in args), _stream(dev))
    return out


# --- the VCM eye passes as three stages (eye.cuh) ---------------------------

class EyePass:
    """One VCM eye pass, classic (vcm_eye) or mega (mega_eye), set up for
    its three stage launches (eye_walk, eye_connect, eye_gather): eye.cuh's
    argument block (kept alive here) and the buffers the stages hand on.
    rec: the walk's models.vcm.EyeRecords [eye_depth, n]; conn: the
    connections' contributions [eye_depth, light_rows, n, 3] f32 (written
    where the eye record ran its strategies), or None where the pass has no
    connection stage; queue, queued: the connection stage's scratch, its
    queue of pair slots (t light_rows + j) n + i [eye_depth light_rows n]
    i32 (uint32 values; its first queued[0] entries written, in no fixed
    order) and that length [1] i32, or None with conn; out, rays, dropped,
    rows: the pass's outputs (rows None without with_rows); key_table: the
    classic walk's key table (scratch its walk launch folds and reads; None
    for mega); tallies: stage -> the int64 counter its launch adds into
    (eye.cuh EyeLaunch tally: walk [rows, rays], connect [rows, rays, warp
    calls, pairs queued, slots]), the tracing RenderMetrics'
    eye_walk.tally and eye_connect.tally, or None; lanes: the walk's lane
    counters (the tracing RenderMetrics' eye_walk.lanes, or None)."""

    def __init__(self, name, dev, args, engine, rec, conn, queue, queued,
                 out, rays, dropped, rows, key_table, tallies, lanes):
        self.name, self.dev, self.args, self.engine = name, dev, args, engine
        self.rec, self.conn = rec, conn
        self.queue, self.queued = queue, queued
        self.out, self.rays, self.dropped, self.rows = out, rays, dropped, \
            rows
        self.key_table = key_table
        self.tallies = tallies
        self.lanes = lanes


def _eye_pass(name: str, scene, camera, keys: list, lbufs, grid, fb, out,
              rays, cfg, *, px, py, n: int, flavor: str, merge: bool,
              gbase: int, merge_radius: float, eta_vcm: float,
              merge_norm: float, one_brick: bool, reweight: bool,
              with_rows: bool, dropped) -> EyePass:
    """Check the inputs of an eye pass over the first n paths of px, py
    (the light buffers' lanes), allocate its stage buffers and build
    eye.cuh's argument block."""
    from cudapathtracer_tpu_torch.models.vcm import EyeRecords
    dev = px.device
    n_buf = px.shape[0]
    light_rows = lbufs.pt.shape[0]
    sc = _bdpt_scene(scene, dev, bvh8_only=flavor != "classic")
    gptrs, table, p8, geom = [0, 0], 0, 0, [0.0] * 4
    if merge:
        gptrs, table, p8, geom = _grid_args(grid, dev)
    depth = cfg.eye_depth
    rec = EyeRecords.empty(depth, n, dev)
    conn = queue = queued = None
    if cfg.connection and light_rows > 0:
        slots = depth * light_rows * n
        if slots >= 2 ** 32 or light_rows > 64:
            raise ValueError(f"{name}: the connections take at most 64 light "
                             f"rows and fewer than 2^32 slots (eye depth x "
                             f"light rows x paths), not {light_rows} and "
                             f"{slots}")
        conn = torch.empty((depth, light_rows, n, 3), dtype=torch.float32,
                           device=dev)
        queue = torch.empty(slots, dtype=torch.int32, device=dev)
        queued = torch.empty(1, dtype=torch.int32, device=dev)
    rows = torch.zeros(n_buf, dtype=torch.int32, device=dev) if with_rows \
        else None
    # the classic walk's key table, folded on the card from the eye key
    key_table = (torch.empty(KEY_PAIR_WORDS * depth * 7, dtype=torch.int32,
                             device=dev) if flavor == "classic" else None)
    ptrs = ([sc[k].data_ptr() for k in ("table", "tri_f32", "light_f32",
                                        "mat_f32", "textures")]
            + [px.data_ptr(), py.data_ptr()]
            + _check_bufs(lbufs, "light bufs", light_rows, n_buf, dev)
            + gptrs + [_ptr(fb) or 0, out.data_ptr(), rays.data_ptr(),
                       dropped.data_ptr(), _ptr(rows) or 0, sc["bin"]]
            + [t.data_ptr() for t in rec] + [_ptr(conn) or 0,
                                             sc["shade"].data_ptr(),
                                             _ptr(key_table) or 0, 0,
                                             _ptr(queue) or 0,
                                             _ptr(queued) or 0, 0, 0])
    iv = [n, n_buf, sc["tri_f32"].shape[1], scene.num_lights, depth,
          light_rows, EYE_FLAVORS[flavor], int(cfg.naive), int(cfg.nee),
          int(cfg.connection), int(cfg.do_mis), int(cfg.paint_weight),
          int(cfg.sample_environment), int(merge), int(cfg.do_sppm), table,
          cfg.max_per_cell, int(one_brick), int(reweight), p8, gbase] \
        + sc["engine_iv"] + [0]
    fv = (camera.kernel_params()
          + [camera.plane_area(), float(eta_vcm), float(merge_norm)]
          + geom + [_r2(merge_radius)])
    words = list(keys) + [0] * (22 - len(keys))
    args = (_i64s(ptrs), _i64s(iv), _f32s(fv), _u32s(words))
    tallies = {st: metrics.counter(f"eye_{st}.tally", dev)
               for st in ("walk", "connect")}
    return EyePass(name, dev, args, sc["engine_iv"][0], rec, conn, queue,
                   queued, out, rays, dropped, rows, key_table, tallies,
                   metrics.counter("eye_walk.lanes", dev))


def vcm_eye_pass(scene, camera, keys: list, lbufs, grid, fb, rays, cfg, *,
                 px, py, merge_radius: float, eta_vcm: float,
                 merge_norm: float, one_brick: bool, reweight: bool,
                 with_rows: bool = False) -> EyePass:
    """The classic VCM / SPPM eye pass (vcm_eye's arguments), set up for
    its stage launches."""
    dev = _cuda_device(px)
    n = px.shape[0]
    _check(px, "px", torch.int32, (n,), dev)
    _check(py, "py", torch.int32, (n,), dev)
    _check(rays, "rays", torch.int32, (n,), dev)
    if fb is not None:
        _check(fb, "fb", torch.float32, (n, 3), dev)
    if cfg.eye_depth < 1 or cfg.light_depth < 1 or len(keys) != 12:
        raise ValueError("vcm_eye: eye_depth >= 1, light_depth >= 1 and 12 "
                         "key words")
    if lbufs.pt.shape[0] != cfg.light_depth:
        raise ValueError(f"vcm_eye: {lbufs.pt.shape[0]} light rows for "
                         f"light_depth {cfg.light_depth}")
    merge = cfg.do_merge
    if merge and grid is None:
        raise ValueError("vcm_eye: do_merge needs the photon grid")
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dropped = torch.empty(n, dtype=torch.int32, device=dev)
    return _eye_pass("vcm_eye", scene, camera, keys, lbufs, grid, fb, out,
                     rays, cfg, px=px, py=py, n=n, flavor="classic",
                     merge=merge, gbase=0, merge_radius=merge_radius,
                     eta_vcm=eta_vcm, merge_norm=merge_norm,
                     one_brick=one_brick, reweight=reweight,
                     with_rows=with_rows, dropped=dropped)


EYE_IV_MERGE = 13   # eye.cuh eye_launch: iv[13] is the merge switch
EYE_IV_BLOCKS = 24  # iv[24]: the walk's blocks (0: the resident grid)
EYE_PTR_TALLY = 42  # eye.cuh eye_launch: ptrs[42] is the stage's tally
EYE_PTR_COUNTER = 45  # ptrs[45]: the walk's path counter
EYE_PTR_LANES = 46    # ptrs[46]: the walk's lane counters


def _eye_stage(ep: EyePass, stage: str, args=None) -> None:
    lib = _load()
    (args or ep.args)[0][EYE_PTR_TALLY] = _ptr(ep.tallies.get(stage)) or 0
    with torch.cuda.device(ep.dev):
        _launch(f"{ep.name}_{stage}", lib, getattr(lib, f"tpt_eye_{stage}"),
                *(ctypes.addressof(a) for a in (args or ep.args)),
                _stream(ep.dev),
                engine=0 if stage == "gather" else ep.engine)


def eye_walk(ep: EyePass, grid: int | None = None, lanes=None) -> None:
    """Stage 1 (eye_walk.cu): the eye walk with s=0 and NEE into ep.rec,
    the rays traced added into the pass's rays, on persistent lanes that
    take the next path when theirs ends. grid (a test argument): that many
    blocks in place of the resident grid (the outputs do not depend on
    it); lanes: an int64 [3] tensor on the device to which the walk adds
    its lane counters (bounces, the sum over warps of the busiest lane's
    bounces, the warps' calls of the bounce code), default ep.lanes."""
    if lanes is None:
        lanes = ep.lanes
    if lanes is not None:
        _check(lanes, "lanes", torch.int64, (3,), ep.dev)
    if grid is not None and grid < 1:
        raise ValueError(f"eye_walk: grid {grid}, expected >= 1 blocks")
    ptrs, iv = ep.args[0], ep.args[1]
    iv[EYE_IV_BLOCKS] = grid or 0
    ptrs[EYE_PTR_LANES] = _ptr(lanes) or 0
    with torch.cuda.device(ep.dev):
        ptrs[EYE_PTR_COUNTER] = _persistent_scratch(ep.dev).data_ptr()
    _eye_stage(ep, "walk")


def eye_connect(ep: EyePass) -> None:
    """Stage 2 (eye_connect.cu): every (eye depth, light row, path) pair's
    resolved connection into ep.conn, its shadow rays added atomically:
    the pairs that can trace queued into ep.queue on the card, then
    traced from the queue."""
    if ep.conn is None:
        raise ValueError(f"{ep.name}: this pass has no connection stage")
    _eye_stage(ep, "connect")


def eye_gather(ep: EyePass, merge: bool = True) -> None:
    """Stage 3 (eye_gather.cu): the terms summed in the flavour's JAX
    order with the merge folded in, into ep.out and ep.dropped. merge=False
    (a measurement argument) sums the same terms without the merge, so the
    difference of the two launches' times is the merge query's (K9's)
    share of the gather."""
    args = None
    if not merge:
        iv = type(ep.args[1])(*ep.args[1])
        iv[EYE_IV_MERGE] = 0
        args = (ep.args[0], iv, ep.args[2], ep.args[3])
    _eye_stage(ep, "gather", args)


def run_eye_pass(ep: EyePass) -> None:
    """The three stages of a pass (two without connections)."""
    eye_walk(ep)
    if ep.conn is not None:
        eye_connect(ep)
    eye_gather(ep)


@_entry
def vcm_eye(scene, camera, keys: list, lbufs, grid, fb, rays, cfg, *, px,
            py, merge_radius: float, eta_vcm: float, merge_norm: float,
            one_brick: bool, reweight: bool, with_rows: bool = False):
    """K13's VCM form with the K9 merge, as three stage launches (eye.cuh
    classic flavour): the eye pass of each pixel (px, py) [N] i32. keys:
    the 12 eye walk words (models/paths.walk_keys(key_e, "eye")); lbufs:
    the VCM light walk's buffers [light_depth, N]; grid: a
    hashgrid.PhotonGrid, or None without the merge; fb: [N,3] f32 added to
    the result, or None; rays [N] i32 += the rays traced. cfg: a
    VCMConfig. one_brick, reweight: the merge's estimator switches
    (ops/hashgrid.merge_switches). -> (radiance [N,3] f32, the merge cap's
    dropped photons [N] i32, rows [N] i32 rows visited or None)."""
    ep = vcm_eye_pass(scene, camera, keys, lbufs, grid, fb, rays, cfg,
                      px=px, py=py, merge_radius=merge_radius,
                      eta_vcm=eta_vcm, merge_norm=merge_norm,
                      one_brick=one_brick, reweight=reweight,
                      with_rows=with_rows)
    run_eye_pass(ep)
    return ep.out, ep.dropped, ep.rows


# --- the mega engines (K14) and the materialised K9, RGB9E5 (K10) -----------

def rgb9e5_roundtrip(c):
    """K10's RGB9E5 (packing.cu's RGB9E5 mode) over a batch: c [N,3] f32
    -> (packed [N] i32 (uint32 bits), the packed words decoded [N,3]
    f32)."""
    dev = _cuda_device(c)
    n = c.shape[0]
    _check(c, "c", torch.float32, (n, 3), dev)
    packed = torch.empty(n, dtype=torch.int32, device=dev)
    dec = torch.empty((n, 3), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        _launch("rgb9e5", lib, lib.tpt_rgb9e5_roundtrip, c.data_ptr(), n,
                packed.data_ptr(), dec.data_ptr(), _stream(dev))
    return packed, dec


def _grid_args(grid, dev):
    """Check a hashgrid.PhotonGrid; -> (its two addresses, table size,
    P8, scene_min + [cell_size])."""
    _check(grid.rows, "grid.rows", torch.float32, grid.rows.shape, dev)
    _check(grid.cell_se, "grid.cell_se", torch.int32,
           (grid.table_size + 1, 2), dev)
    p8 = grid.rows.shape[0]
    if grid.rows.dim() != 2 or grid.rows.shape[1] != 8 or p8 % 8 or p8 < 16:
        raise ValueError("grid.rows must be [P8, 8], P8 a multiple of 8")
    return ([grid.rows.data_ptr(), grid.cell_se.data_ptr()], grid.table_size,
            p8, [float(x) for x in grid.scene_min] + [float(grid.cell_size)])


def _r2(merge_radius: float) -> float:
    mr = torch.tensor(float(merge_radius), dtype=torch.float32)
    return float(mr * mr)


def neighbor_slots(grid, query, merge_radius: float, max_per_cell: int, *,
                   mode: str, cap_q: int = 0, active=None, one_brick: bool,
                   reweight: bool):
    """K9's materialised forms (neighbor_slots.cu) for queries [N,3] f32
    (active [N] bool or None): mode "slots" (M = 64 one-brick, else 8 x
    cap), "compact" (M = cap_q) or "gather" (M = 8 x cap). -> (rows
    [M,N,8] f32, ok [M,N] bool, wgt [M,N] f32 or None, dropped [N] i32 or
    None), the tensors of ops/hashgrid.py's plain versions (gather: the
    slots of gather_neighbors stacked)."""
    dev = _cuda_device(query)
    n = query.shape[0]
    _check(query, "query", torch.float32, (n, 3), dev)
    if active is not None:
        _check(active, "active", torch.bool, (n,), dev)
    if mode not in SLOT_MODES:
        raise ValueError(f"mode {mode!r}: one of {sorted(SLOT_MODES)}")
    if mode == "slots" and not 1 <= max_per_cell <= 8:
        raise ValueError("slots mode needs 1 <= max_per_cell <= 8")
    if mode == "compact" and cap_q < 1:
        raise ValueError("compact mode needs cap_q >= 1")
    gptrs, table, p8, geom = _grid_args(grid, dev)
    m = {"slots": 64 if one_brick else 8 * max_per_cell, "compact": cap_q,
         "gather": 8 * max_per_cell}[mode]
    rows = torch.empty((m, n, 8), dtype=torch.float32, device=dev)
    ok = torch.empty((m, n), dtype=torch.bool, device=dev)
    gather = mode == "gather"
    wgt = None if gather else torch.empty((m, n), dtype=torch.float32,
                                          device=dev)
    dropped = None if gather else torch.empty(n, dtype=torch.int32,
                                              device=dev)
    ptrs = gptrs + [query.data_ptr(), _ptr(active) or 0, rows.data_ptr(),
                    ok.data_ptr(), _ptr(wgt) or 0, _ptr(dropped) or 0]
    iv = [n, SLOT_MODES[mode], table, max_per_cell, cap_q, int(one_brick),
          int(reweight), p8]
    args = (_i64s(ptrs), _i64s(iv), _f32s(geom + [_r2(merge_radius)]))
    lib = _load()
    with torch.cuda.device(dev):
        _launch("neighbor_slots", lib, lib.tpt_neighbor_slots,
                *(ctypes.addressof(a) for a in args), _stream(dev))
    return rows, ok, wgt, dropped


def mega_eye_pass(scene, camera, keys: list, lbufs, grid, out, rays, cfg, *,
                  px, py, cnt: int, gbase: int, flavor: str,
                  merge_radius: float = 0.0, eta_vcm: float = 0.0,
                  merge_norm: float = 0.0, one_brick: bool = False,
                  reweight: bool = True, with_rows: bool = False) -> EyePass:
    """K14's eye pass of a chunk (mega_eye's arguments), set up for its
    stage launches."""
    dev = _cuda_device(px)
    c_pix = px.shape[0]
    _check(px, "px", torch.int32, (c_pix,), dev)
    _check(py, "py", torch.int32, (c_pix,), dev)
    _check(rays, "rays", torch.int32, (c_pix,), dev)
    p_total = out.shape[0]
    _check(out, "out", torch.float32, (p_total, 3), dev)
    if flavor not in ("vcm", "bdpt"):
        raise ValueError(f"flavor {flavor!r}: 'vcm' or 'bdpt'")
    if not 0 <= cnt <= c_pix or gbase < 0 or gbase + cnt > p_total:
        raise ValueError(f"mega_eye: {cnt} pixels at {gbase} of a chunk of "
                         f"{c_pix} in a frame of {p_total}")
    if cfg.eye_depth < 1 or len(keys) != 22:
        raise ValueError("mega_eye: eye_depth >= 1 and 22 key words")
    merge = flavor == "vcm" and cfg.do_merge
    if merge and grid is None:
        raise ValueError("mega_eye: do_merge needs the photon grid")
    dropped = torch.zeros(c_pix, dtype=torch.int32, device=dev)
    return _eye_pass("mega_eye", scene, camera, keys, lbufs, grid, None, out,
                     rays, cfg, px=px, py=py, n=cnt, flavor=flavor,
                     merge=merge, gbase=gbase, merge_radius=merge_radius,
                     eta_vcm=eta_vcm, merge_norm=merge_norm,
                     one_brick=one_brick, reweight=reweight,
                     with_rows=with_rows, dropped=dropped)


@_entry
def mega_eye(scene, camera, keys: list, lbufs, grid, out, rays, cfg, *, px,
             py, cnt: int, gbase: int, flavor: str, merge_radius: float = 0.0,
             eta_vcm: float = 0.0, merge_norm: float = 0.0,
             one_brick: bool = False, reweight: bool = True,
             with_rows: bool = False):
    """K14 as three stage launches (eye.cuh, mega flavours): the mega eye
    pass of a chunk's first cnt pixels (px, py [c_pix] i32, the chunk's
    pixels) paired with its light paths (lbufs [L, c_pix]: every row is a
    connection candidate); path l writes its radiance, retired through
    RGB9E5, into out [P,3] f32 row gbase + l (its index in the pixel list,
    which keys its draws) and adds its rays into rays [c_pix] i32. keys:
    models/vcm_mega.eye_keys (22 words); flavor: "vcm" (VCM and SPPM) or
    "bdpt"; grid: a hashgrid.PhotonGrid under VCM with do_merge, else None;
    cfg: a VCMConfig; one_brick, reweight: the merge's estimator switches.
    -> (the merge cap's dropped photons [c_pix] i32 (lanes >= cnt 0), rows
    [c_pix] i32 BVH8 rows visited or None)."""
    ep = mega_eye_pass(scene, camera, keys, lbufs, grid, out, rays, cfg,
                       px=px, py=py, cnt=cnt, gbase=gbase, flavor=flavor,
                       merge_radius=merge_radius, eta_vcm=eta_vcm,
                       merge_norm=merge_norm, one_brick=one_brick,
                       reweight=reweight, with_rows=with_rows)
    run_eye_pass(ep)
    return ep.dropped, ep.rows
