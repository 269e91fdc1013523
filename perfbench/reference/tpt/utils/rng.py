"""Counter-based Threefry-2x32 streams, bit-compatible with the JAX package.

Counterpart of cudapathtracer_tpu/utils/rng.py. Keys are plain pairs of
Python ints (two uint32 words). The key chain (seed -> sample -> bounce ->
draw) is a handful of scalar Threefry calls, so it runs on the host; the
per-lane draws keyed by stable ids (pixel ids) run as kernel K6
(kernels/csrc/rng.cu) on CUDA tensors and as the plain version below on
CPU tensors. Both reproduce jax.random (threefry, partitionable) bit for
bit:

  PRNGKey(s)      = (0, s)
  fold_in(k, x)   = threefry2x32(k, (0, x))
  uniform_id(k, d, ids) = (threefry2x32(fold_in(k, d), (ids, 0)).x0 >> 9) * 2^-23

Only the id-keyed streams are ported: every draw of the integrators in this
package is keyed by pixel id. The positional streams (`uniform`,
`uniform2`) of the JAX package are not. `draw_key_table` folds the key
pairs of every (bounce, draw) on the host once, and `uniform_keyed` draws
with a key pair per lane (K6's keyed mode on CUDA tensors): the keyed
light walk (models/light_mega.py) reads its draws that way. `fold_table`
is the plain version of the key tables the kernels' prologues fold on the
card (kernels/csrc/keys.cuh), in their order.
"""

from __future__ import annotations

import torch


DEFAULT_SEED = 103033  # the reference's fixed seed

Key = tuple  # (k0, k1) uint32 words as Python ints

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: Key, x0: int, x1: int) -> tuple[int, int]:
    """20-round Threefry-2x32 on one block of two uint32 words (host)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _TF_ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    return (0, seed & _MASK)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key, 0, data & _MASK)


def base_key(seed: int = DEFAULT_SEED, stream: int = 0) -> Key:
    """Root key of a render; `stream` separates logical streams."""
    return fold_in(prng_key(seed), stream)


def sample_key(key: Key, sample_idx: int) -> Key:
    return fold_in(key, sample_idx)


def bounce_key(skey: Key, bounce: int) -> Key:
    return fold_in(skey, bounce)


def draw_key(key: Key, draw_id: int) -> Key:
    """The (k0, k1) pair a labelled per-lane draw is keyed by."""
    return fold_in(key, draw_id)


def pixel_ids(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Stable sampling ids from pixel coordinates (width-independent)."""
    return (py.to(torch.int32) << 14) + px.to(torch.int32)


# --- the per-lane draw: kernel K6 and its plain version --------------------

def _threefry_lanes(k0, k1, ids: torch.Tensor):
    """Plain version of K6's cipher: Threefry-2x32 over (ids, 0) per lane,
    in int64 arithmetic masked to 32 bits, under the key (k0, k1): Python
    ints, or int64 tensors of per-lane words (the keyed mode). Returns
    (x0, x1) int64."""
    x0 = ids.to(torch.int64) & _MASK
    return _threefry_words(k0, k1, x0, torch.zeros_like(x0))


def _threefry_words(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the blocks (x0, x1) (int64 tensors of uint32
    words) under the key (k0, k1), Python ints or int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _TF_ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
    return x0, x1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    # 23 mantissa bits -> [0, 1)
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


def uniform_draw_key_plain(k0: int, k1: int, ids: torch.Tensor, two=False):
    """Plain version of kernel K6 (any device)."""
    x0, x1 = _threefry_lanes(k0, k1, ids)
    if two:
        return _bits_to_unit(x0), _bits_to_unit(x1)
    return _bits_to_unit(x0)


def uniform_draw_key(k0: int, k1: int, ids: torch.Tensor, two=False):
    """K6: one (or two) uniforms in [0, 1) per id under the draw key
    (k0, k1). CPU tensors take the plain version, CUDA tensors the kernel."""
    return uniform_draw_key_plain(k0, k1, ids, two)


def uniform_id(key: Key, draw_id: int, ids: torch.Tensor) -> torch.Tensor:
    """One labelled uniform in [0,1) per lane, keyed by stable ids."""
    k0, k1 = draw_key(key, draw_id)
    return uniform_draw_key(k0, k1, ids)


def uniform2_id(key: Key, draw_id: int, ids: torch.Tensor):
    """Two independent uniforms per lane, keyed by stable ids."""
    k0, k1 = draw_key(key, draw_id)
    return uniform_draw_key(k0, k1, ids, two=True)


def uniform_any(key: Key, draw_id: int, n: int, ids=None) -> torch.Tensor:
    """Signature-compatible with the JAX package; only the id-keyed
    stream is ported (every draw of the ported integrators has ids)."""
    if ids is None:
        raise NotImplementedError(
            "positional (lane-keyed) streams are not ported; pass ids")
    if ids.shape[0] != n:
        raise ValueError(f"ids has {ids.shape[0]} lanes, expected {n}")
    return uniform_id(key, draw_id, ids)


# --- the keyed draws: per-(bounce, draw) key tables and per-lane keys -------

def draw_key_table(key: Key, bounces, draw_ids) -> torch.Tensor:
    """The (k0, k1) pairs of uniform_id for every (bounce, draw_id): uint32
    [len(bounces), len(draw_ids), 2], row b keyed by bounce_key(key, b);
    bounces=None gives one row keyed by `key` itself. Folded on the host,
    once per table."""
    rows = []
    for b in (bounces if bounces is not None else [None]):
        bkey = key if b is None else bounce_key(key, b)
        rows.append([list(draw_key(bkey, d)) for d in draw_ids])
    return torch.tensor(rows, dtype=torch.uint32)


def fold_table(key: Key, draws: int, rows: int = 0, samples: int = 0,
               s0: int = 0, mid: int = -1, draw0: int = 0) -> torch.Tensor:
    """Plain version of one KeyTableSpec of kernels/csrc/keys.cuh: the
    pairs draw_key(., draw0 + j) of fold_in(fold_in(fold_in(key, s0 + s),
    r), mid), the sample level only when samples > 0, the row level only
    when rows > 0, the mid level only when mid >= 0, in (s, r, j) order ->
    int32 [max(samples, 1) * max(rows, 1) * draws, 2] (uint32 words)."""
    ns, nr = max(samples, 1), max(rows, 1)
    s = torch.arange(ns, dtype=torch.int64).repeat_interleave(nr * draws)
    r = torch.arange(nr, dtype=torch.int64).repeat_interleave(draws) \
        .repeat(ns)
    j = torch.arange(draws, dtype=torch.int64).repeat(ns * nr)
    k0 = torch.full_like(s, key[0] & _MASK)
    k1 = torch.full_like(s, key[1] & _MASK)

    def fold(k0, k1, data):
        return _threefry_words(k0, k1, torch.zeros_like(data),
                               data & _MASK)
    if samples > 0:
        k0, k1 = fold(k0, k1, s + s0)
    if rows > 0:
        k0, k1 = fold(k0, k1, r)
    if mid >= 0:
        k0, k1 = fold(k0, k1, torch.full_like(s, mid))
    k0, k1 = fold(k0, k1, j + draw0)
    w = torch.stack([k0, k1], 1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _words(k: torch.Tensor) -> torch.Tensor:
    """uint32 words (a uint32 or int32 tensor) as int64 values."""
    if k.dtype == torch.uint32:
        k = k.view(torch.int32)
    return k.to(torch.int64) & _MASK


def uniform_keyed_plain(k0: torch.Tensor, k1: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """Plain version of K6's keyed mode (any device): uniform_id with a key
    pair per lane (k0, k1 [N] uint32 words, or broadcastable to ids)."""
    return _bits_to_unit(_threefry_lanes(_words(k0), _words(k1), ids)[0])


def uniform_keyed(k0: torch.Tensor, k1: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """One uniform in [0,1) per lane under that lane's key pair (k0, k1
    [N]): bit-equal to uniform_id(key, d, ids) when every pair is
    draw_key(key, d). CPU tensors take the plain version, CUDA tensors
    K6's keyed mode."""
    return uniform_keyed_plain(k0, k1, ids)
