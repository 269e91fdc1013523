"""Packed path-vertex codecs (kernel K10, codec part): plain versions.

Counterpart of cudapathtracer_tpu/utils/packing.py:23-141, bit for bit:
the octahedral unit-vector codec (one 32-bit word, 2 x snorm16), the
half-precision beta/uv codec, the half2 word (two float16 in one 32-bit
word: the photon row's beta, ops/hashgrid.py), the packed flag word
(isDelta | backface | lightInd + 1 | matID) and the RGB9E5 word (three
9-bit mantissas under a shared 5-bit exponent: the mega engines' per-path
retirement). The device forms live in kernels/csrc/packing.cuh (half2:
hashgrid.cuh); the BDPT kernels (K11-K13) encode and decode every path
vertex through them, the mega kernels round every retired path through
RGB9E5, and kernels.packing_roundtrip / kernels.rgb9e5_roundtrip launch
them over a batch for the comparison with these functions.

Words are held as int32 tensors carrying the uint32 bit patterns (PyTorch
has no full uint32 arithmetic); `.numpy().view(np.uint32)` gives the JAX
package's arrays. Three points of bit parity:
  * rounding to snorm16 is round-half-even (torch.round, like jnp.round);
  * float32 -> float16 is round-to-nearest-even (like XLA's convert);
  * unpack_oct's norm is XLA:CPU's sum with both adds contracted,
    fma(z, z, fma(y, y, x * x)), taken here in float64 and rounded once
    per step (`_norm3`), which the device code does with __fmaf_rn.
RGB9E5 follows XLA's arithmetic: log2(x) is log(x) / 0.6931472f and
exp2(x) is exp(x * 0.6931472f), so 2^k is not exact for most |k| > 12.
Both are taken here in float64 and rounded to float32 once (`_log_f32`,
`_exp2_f32`), which gives XLA:CPU's shared exponent on every value of the
codec's range and its exact 2^k for every integer k the codec uses; the
device code computes the same in double.
"""

from __future__ import annotations

import torch

from reference.tpt.utils.math import true_div

_MASK16 = 0xFFFF


def _oct_wrap(p):
    # fold the lower hemisphere over the diamond edges
    x, y = p[..., 0], p[..., 1]
    wx = (1.0 - torch.abs(y)) * torch.where(x >= 0.0, 1.0, -1.0)
    wy = (1.0 - torch.abs(x)) * torch.where(y >= 0.0, 1.0, -1.0)
    return torch.stack([wx, wy], dim=-1)


def pack_oct(n: torch.Tensor) -> torch.Tensor:
    """Unit vectors [..., 3] f32 -> [...] int32 (uint32 bits), octahedral
    2 x snorm16: x in the low half, y in the high half."""
    denom = torch.abs(n[..., 0]) + torch.abs(n[..., 1]) + torch.abs(n[..., 2])
    p = n[..., :2] / torch.clamp(denom, min=1e-20)[..., None]
    p = torch.where((n[..., 2] < 0.0)[..., None], _oct_wrap(p), p)
    q = torch.clamp(torch.round(p * 32767.0), -32767.0, 32767.0)
    u = q.to(torch.int64) & _MASK16
    return (u[..., 0] | (u[..., 1] << 16)).to(torch.int32)


def _norm3(v):
    """|v| for [..., 3] f32 as fma(z, z, fma(y, y, x * x)) then sqrt, each
    step rounded to float32 (float64 holds the products exactly)."""
    x, y, z = (v[..., k].double() for k in range(3))
    s = (x * x).float().double()
    s = (y * y + s).float().double()
    s = (z * z + s).float().double()
    return torch.sqrt(s).float()


def unpack_oct(u: torch.Tensor) -> torch.Tensor:
    """[...] int32 (uint32 bits) -> unit vectors [..., 3] f32."""
    w = u.to(torch.int64)
    ux = w & _MASK16
    uy = (w >> 16) & _MASK16
    ux = torch.where(ux > 32767, ux - 65536, ux)    # sign-extend 16 bits
    uy = torch.where(uy > 32767, uy - 65536, uy)
    f = true_div(torch.stack([ux, uy], dim=-1).to(torch.float32), 32767.0)
    z = 1.0 - torch.abs(f[..., 0]) - torch.abs(f[..., 1])
    t = torch.clamp(-z, min=0.0)
    xy = f - torch.where(f >= 0.0, t[..., None], -t[..., None])
    v = torch.cat([xy, z[..., None]], dim=-1)
    return v / torch.clamp(_norm3(v), min=1e-20)[..., None]


def to_half3(c: torch.Tensor) -> torch.Tensor:
    """float32 [..., 3] -> float16 (round to nearest even)."""
    return c.to(torch.float16)


def from_half3(c: torch.Tensor) -> torch.Tensor:
    return c.to(torch.float32)


def pack_half2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float32 [...] -> one word [...] int32 (uint32 bits): a as
    float16 in the low 16 bits, b in the high."""
    lo = a.to(torch.float16).view(torch.int16).to(torch.int64) & _MASK16
    hi = b.to(torch.float16).view(torch.int16).to(torch.int64) & _MASK16
    return (lo | (hi << 16)).to(torch.int32)


def unpack_half2(u: torch.Tensor):
    """[...] int32 (uint32 bits) -> (a, b) float32."""
    w = u.to(torch.int64)
    half = lambda x: x.to(torch.int16).view(torch.float16).to(torch.float32)
    return half(w & _MASK16), half((w >> 16) & _MASK16)


# Packed flag word: bit 31 isDelta, bit 30 backface, bits 29..10 lightInd+1
# (20 bits, 0 = none), bits 9..0 materialID (10 bits).
def pack_flags(is_delta, backface, light_ind, mat_id) -> torch.Tensor:
    """-> [...] int32 (uint32 bits)."""
    li = torch.clamp(light_ind.to(torch.int64) + 1, 0, (1 << 20) - 1)
    w = ((is_delta.to(torch.int64) << 31) | (backface.to(torch.int64) << 30)
         | (li << 10) | torch.clamp(mat_id.to(torch.int64), 0, 1023))
    return w.to(torch.int32)


def unpack_flags(w: torch.Tensor):
    """-> (is_delta bool, backface bool, light_ind int32 (-1 none),
    mat_id int32)."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    is_delta = ((w >> 31) & 1).to(torch.bool)
    backface = ((w >> 30) & 1).to(torch.bool)
    light_ind = (((w >> 10) & ((1 << 20) - 1)) - 1).to(torch.int32)
    mat_id = (w & 1023).to(torch.int32)
    return is_delta, backface, light_ind, mat_id


# RGB9E5: bits 0-8 r, 9-17 g, 18-26 b (mantissas), 27-31 exponent + 15
RGB9E5_MAX = 65408.0
LN2_F32 = 0.693147182464599609375   # float32(ln 2), XLA's log(2)


def _log_f32(x):
    return torch.log(x.double()).float()


def _exp2_f32(k):
    """XLA's exp2 of float32 k: exp(k * float32(ln 2)), rounded once."""
    return torch.exp((k * LN2_F32).double()).float()


def pack_rgb9e5_cols(c: torch.Tensor) -> torch.Tensor:
    """RGB [3, ...] (channel-major) -> [...] int32 (uint32 bits)."""
    c = torch.clamp(c, 0.0, RGB9E5_MAX)
    maxc = torch.maximum(torch.maximum(c[0], c[1]), c[2])
    e = torch.ceil(true_div(_log_f32(torch.clamp(maxc, min=1e-10)),
                            LN2_F32))
    e = torch.clamp(e, -15.0, 16.0)
    m = torch.clamp(torch.round(c * _exp2_f32(9.0 - e)[None]), 0, 511)
    m = m.to(torch.int64)
    eb = (e + 15.0).to(torch.int64)
    return (m[0] | (m[1] << 9) | (m[2] << 18) | (eb << 27)).to(torch.int32)


def pack_rgb9e5(c: torch.Tensor) -> torch.Tensor:
    """RGB [..., 3] (non-negative) -> [...] int32 (uint32 bits)."""
    return pack_rgb9e5_cols(torch.movedim(c, -1, 0))


def unpack_rgb9e5(u: torch.Tensor) -> torch.Tensor:
    """[...] int32 (uint32 bits) -> RGB [..., 3] f32."""
    w = u.to(torch.int64) & 0xFFFFFFFF
    rgb = torch.stack([w & 0x1FF, (w >> 9) & 0x1FF, (w >> 18) & 0x1FF],
                      dim=-1).to(torch.float32)
    e = ((w >> 27) & 0x1F).to(torch.float32) - 15.0
    return rgb * _exp2_f32(e - 9.0)[..., None]


def round_rgb9e5(c: torch.Tensor) -> torch.Tensor:
    """unpack_rgb9e5(pack_rgb9e5(c)) for RGB [..., 3]: the mega engines'
    retirement of a path's radiance."""
    return unpack_rgb9e5(pack_rgb9e5(c))
