#!/usr/bin/env python3
"""A copy of a checkout whose K12 walk, or whose VCM eye walk, writes no
path vertex or record, to time what those stores cost.

K12 (kernels/csrc/bdpt_walk.cu) writes every vertex a walk reaches into
the depth-major PathBuffers [max_depth-1, N] (11 fields, 51 B a vertex),
and the dead pattern into the rows it does not reach. With one thread a
path (the design before path regeneration) a warp wrote one depth row of
32 consecutive paths; under regeneration the lanes of a warp hold paths
at different depths, so their stores scatter over the rows. With --kernel
k12 (the default) this tool copies the checkout --root (without .git and
build/) to --out and makes bdpt.cuh's store_vertex return before it
writes unless the buffers' path count is negative, which it never is.
Every vertex store and every dead row goes through store_vertex, so the
copy's walks write no buffer field and keep everything else: the rays
traced, v0, the escape record and the counts. The arithmetic that only the
stores read (the octahedral and half packing) may be left out with them.

The VCM eye walk (kernels/csrc/eye_walk.cu) writes the [D, N] eye records
the same way, 108 B a bounce: with --kernel eye, eye.cuh's store_record
and store_escape return before they write, under the same never-true
test on the records' stride, and the walk's store of NEE's term is made
under it; the flags of the depths a walk does not reach (the start
kernel's zeros, or the one-thread-a-path walk's tail loop) are still
written, and the rays and counts are kept.

Time the copy against the checkout in turns (K12: tools/eye_attribution.py
--root DIR --walks; the eye walk: --eye-walks); the difference is the
stores' cost in that design. The copy's buffers hold whatever the
allocator left, so its outputs' digests differ. Run from the repository
root:

    python3 tools/walk_store_cost.py --root DIR --out DIR [--kernel k12|eye]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys

CSRC = os.path.join("cudapathtracer_tpu_torch", "kernels", "csrc")
# kernel -> (header, [(pattern, replacement, matches)])
PATCHES = {
    "k12": ("bdpt.cuh", [
        (r"(void store_vertex\(const PathBufs& b,[^{]*\{\n)",
         r"\1  if (b.n >= 0) return;  // no stores: tools/walk_store_cost.py\n",
         1)]),
    "eye": ("eye.cuh", [
        (r"(void store_(?:record|escape)\(const EyeRecs& r,[^{]*\{\n)",
         r"\1  if (r.stride >= 0) return;  // no stores: "
         r"tools/walk_store_cost.py\n", 2),
        (r"put3\(c\.rec\.nee, k, ne\);",
         r"if (c.rec.stride < 0) put3(c.rec.nee, k, ne);", 1)]),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="the checkout to copy")
    ap.add_argument("--out", required=True, help="the copy (must not "
                    "exist)")
    ap.add_argument("--kernel", default="k12", choices=tuple(PATCHES))
    args = ap.parse_args()
    shutil.copytree(args.root, args.out, ignore=shutil.ignore_patterns(
        ".git", "build", "__pycache__"))
    header, patches = PATCHES[args.kernel]
    path = os.path.join(args.out, CSRC, header)
    with open(path) as f:
        src = f.read()
    for pattern, repl, want in patches:
        src, n = re.subn(pattern, repl, src)
        if n != want:
            print(f"FAIL: {n} matches of {pattern!r} in {path}, not {want}")
            return 1
    with open(path, "w") as f:
        f.write(src)
    print(f"{args.out}: the {args.kernel} walk's stores write nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
