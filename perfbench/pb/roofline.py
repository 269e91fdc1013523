"""The card's peaks and the least time a kernel's counted work could take.

A copy of chip_smoke.py's bound_ms arithmetic and constants (frozen here,
so that a change to the program's tools cannot move the yardstick). The
peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W: 3.35
TB/s of HBM and 67 TFLOP/s of float32 outside the tensor cores. The
kernels are built with -fmad=false, so one scalar instruction is one
operation.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# One Threefry draw in float32-equivalent operations: the cipher's 59
# INT32-pipe SASS instructions (cuobjdump of rng.cu's keyed kernel) at 64
# lanes x 132 SMs x 1980 MHz, against PEAK_OPS_S (PERF.md, PR 14).
OPS_PER_DRAW = 59 * PEAK_OPS_S / (64 * 132 * 1.98e9)
# Counted from the kernels' sources (chip_smoke.py): one BVH8 row visited
# (8 slab tests x 27, the 19-comparator sort x 2, 7 pushes x 3, 4
# Moller-Trumbore tests x 52, the leaf fold 7); one camera ray (4 draws
# and ~60 float ops); a stored walk vertex (2 draws and ~360 float ops of
# shading, BSDF sample, MIS step and encoding); a decoded light vertex.
OPS_PER_ROW = 490
OPS_PER_CAMERA_RAY = 4 * OPS_PER_DRAW + 60
OPS_PER_WALK_VERTEX = 2 * OPS_PER_DRAW + 360
OPS_PER_DECODE = 40
# one eye record (eye.cuh) and one K12 light vertex, in bytes
RECORD_BYTES = 108
VERTEX_BYTES = 64


def bound_s(nbytes: float, ops: float) -> tuple:
    """(the least seconds the card could take, what bounds it)."""
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (tb, "bytes") if tb >= to else (to, "operations")
