"""The port's hand-written CUDA kernels: build, load, launch, count.

Sources live in kernels/csrc/*.cu (sm_90a). They are compiled on first use
with nvcc into one shared library with a plain C interface,
build/torch_ext/libtpt_torch_kernels.so, and called through ctypes on
PyTorch's current stream; the library is rebuilt whenever a source is newer.
Nothing is compiled when this module is imported. The traversal's stack
depth is fixed at build time: the default 16 is the library above, and any
other depth (stack_d=) builds its own libtpt_torch_kernels_stack<d>.so.

Each wrapper below checks its tensors (device, dtype, shape, contiguity),
allocates the outputs, launches, raises if the launch was refused, and then
adds one to its entry of `launches`. The launch counters are the package's
only global state; `reset_launches()` zeroes them.

Compile flags: -O3 and -fmad=false, no --use_fast_math. -fmad=false keeps
every a*b+c rounded twice, as the plain PyTorch versions (one operator per
op) and XLA:CPU round it, so the traversal kernel returns the same triangle
ids and t values as its plain version instead of differing at triangle
edges; the kernels are bound by memory latency, not by FMA throughput.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("rng.cu", "camera.cu", "traverse8.cu")
HEADERS = ("threefry.cuh",)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_ext")
LIBRARY = os.path.join(BUILD_DIR, "libtpt_torch_kernels.so")
STACK_D = 16      # traverse8.cu's default stack depth
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launches()
launches = {"closest_hit8": 0, "shadow_factor8": 0, "uniform_id": 0,
            "generate_rays": 0}

_lock = threading.Lock()
_libs = {}        # stack depth -> loaded library


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    """Compile the kernel library if it is missing or older than a source.
    Returns its path."""
    if not 7 <= stack_d <= 64:
        raise ValueError(f"stack_d {stack_d}: a row pushes up to 7 entries, "
                         "and the stack lives in local memory (<= 64)")
    lib = _library(stack_d)
    srcs = [os.path.join(CSRC, f) for f in SOURCES + HEADERS]
    if (os.path.exists(lib) and all(
            os.path.getmtime(lib) >= os.path.getmtime(s) for s in srcs)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, f"-DTPT_STACK_D={stack_d}", "-o", tmp,
           *(os.path.join(CSRC, f) for f in SOURCES)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    if verbose:
        print(res.stdout + res.stderr)
    os.replace(tmp, lib)
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
        lib.tpt_generate_rays.restype = ctypes.c_int
        lib.tpt_generate_rays.argtypes = [p, p, p, p, p, i64, p, p, p]
        lib.tpt_closest_hit8.restype = ctypes.c_int
        lib.tpt_closest_hit8.argtypes = [p, p, p, p, p, p, i64,
                                         p, p, p, p, p, p]
        lib.tpt_shadow_factor8.restype = ctypes.c_int
        lib.tpt_shadow_factor8.argtypes = [p, p, i32, p, p, p, p, p, i64,
                                           p, p]
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


def _launch(name: str, lib, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.tpt_error_string(err).decode()}")
    launches[name] += 1


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
    dev = _cuda_device(o)
    n = o.shape[0]
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


def closest_hit8(table, o, d, max_t, skip_tri, active, stack_d=STACK_D,
                 with_restarts=False):
    """K1 closest (traverse8.cu) -> (t, tri, u, v), each [N]; with
    with_restarts, also each ray's number of restarts from the root."""
    dev, n = _ray_args(table, o, d, max_t, skip_tri, active)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    restarts = (torch.empty(n, dtype=torch.int32, device=dev)
                if with_restarts else None)
    lib = _load(stack_d)
    with torch.cuda.device(dev):
        _launch("closest_hit8", lib, lib.tpt_closest_hit8, table.data_ptr(),
                o.data_ptr(), d.data_ptr(), max_t.data_ptr(),
                skip_tri.data_ptr(),
                None if active is None else active.data_ptr(), n,
                t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                None if restarts is None else restarts.data_ptr(),
                _stream(dev))
    return (t, tri, u, v, restarts) if with_restarts else (t, tri, u, v)


def shadow_factor8(table, tri_f32, o, d, max_t, skip_tri, active,
                   stack_d=STACK_D):
    """K1 shadow (traverse8.cu) -> transmission scale [N,3]."""
    dev, n = _ray_args(table, o, d, max_t, skip_tri, active)
    if tri_f32.dim() != 2 or tri_f32.shape[1] not in (78, 94):
        raise ValueError(f"tri_f32 must be [T,78|94], got "
                         f"{tuple(tri_f32.shape)}")
    _check(tri_f32, "tri_f32", torch.float32, tri_f32.shape, dev)
    scale = torch.empty((n, 3), dtype=torch.float32, device=dev)
    lib = _load(stack_d)
    with torch.cuda.device(dev):
        _launch("shadow_factor8", lib, lib.tpt_shadow_factor8,
                table.data_ptr(), tri_f32.data_ptr(), tri_f32.shape[1],
                o.data_ptr(), d.data_ptr(), max_t.data_ptr(),
                skip_tri.data_ptr(),
                None if active is None else active.data_ptr(), n,
                scale.data_ptr(), _stream(dev))
    return scale
