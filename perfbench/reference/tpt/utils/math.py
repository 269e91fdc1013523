"""Vector math over batched [..., 3] float32 tensors.

Counterpart of cudapathtracer_tpu/utils/math.py. Dot products are written
as explicit left-to-right component sums, the order XLA uses for its
size-3 reductions, so both packages round the same way.
"""

from __future__ import annotations

import numpy as np
import torch

EPSILON = 1e-5
RAY_EPSILON = 1e-4
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
MAX_FIREFLY_LUM = 5.0   # the BDPT/VCM firefly clamp of a contribution


def true_div(a, b):
    """a / b correctly rounded on every device, for a Python number on
    either side: PyTorch turns `tensor / number` on CUDA into a product
    with the number's reciprocal, and `number / tensor` everywhere into the
    tensor's reciprocal times the number, each rounded twice. The kernels
    divide once (IEEE), as XLA does."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    elif not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return a / b


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3] x [..., 3] -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dot3(a, b):
    """Like dot() but keeps the last axis: [...] -> [..., 1]."""
    return dot(a, b)[..., None]


def length_sq(a):
    return dot(a, a)


def normalize(a, eps: float = 1e-20):
    """a * rsqrt(max(|a|^2, eps)); zero vectors stay ~zero."""
    return a * torch.rsqrt(torch.clamp(dot3(a, a), min=eps))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def luminance(c):
    """Rec.709 luminance."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def build_frame(n):
    """Orthonormal tangent frame (t, b) around unit normals [..., 3]."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = torch.abs(nx) > torch.abs(nz)
    inv_a = torch.rsqrt(torch.clamp(nx * nx + ny * ny, min=1e-20))
    zero = torch.zeros_like(nx)
    ta = torch.stack([-ny * inv_a, nx * inv_a, zero], dim=-1)
    inv_b = torch.rsqrt(torch.clamp(ny * ny + nz * nz, min=1e-20))
    tb = torch.stack([zero, -nz * inv_b, ny * inv_b], dim=-1)
    t = torch.where(use_x[..., None], ta, tb)
    return t, cross(n, t)


def to_local(v, n):
    """World -> shading space where z = n."""
    t, b = build_frame(n)
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(v, n):
    """Shading space -> world."""
    t, b = build_frame(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def is_prime(n: int) -> bool:
    """Host-side primality test for hash-table sizing."""
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def next_prime(n: int) -> int:
    """Smallest prime >= n."""
    while not is_prime(n):
        n += 1
    return n


def merge_radius(initial_radius: float, sample_idx: int,
                 alpha: float) -> float:
    """The VCM/SPPM progressive merge radius r_i = r0 sqrt((1/(i+1))^alpha),
    in float32 in the JAX package's operation order; returns the float32
    value as a Python float. The power is exp(alpha ln x) in float64,
    rounded once: XLA:CPU's float32 power gives the same value on 99.94%
    of sample indices and differs by one ulp on the rest (numpy's float32
    power differs on more)."""
    f = np.float32
    x = f(1.0) / (f(sample_idx) + f(1.0))
    xa = f(np.exp(np.float64(f(alpha)) * np.log(np.float64(x))))
    return float(f(initial_radius) * np.sqrt(xa))
