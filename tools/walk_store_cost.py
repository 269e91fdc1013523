#!/usr/bin/env python3
"""A copy of a checkout whose K12 walk writes no path vertex, to time what
the vertex stores cost.

K12 (kernels/csrc/bdpt_walk.cu) writes every vertex a walk reaches into
the depth-major PathBuffers [max_depth-1, N] (11 fields, 51 B a vertex),
and the dead pattern into the rows it does not reach. With one thread a
path (the design before path regeneration) a warp wrote one depth row of
32 consecutive paths; under regeneration the lanes of a warp hold paths
at different depths, so their stores scatter over the rows. This tool
copies the checkout --root (without .git and build/) to --out and makes
bdpt.cuh's store_vertex return before it writes unless the buffers' path
count is negative, which it never is. Every vertex
store and every dead row goes through store_vertex, so the copy's walks
write no buffer field and keep everything else: the rays traced, v0, the
escape record and the counts. The arithmetic that only the stores read
(the octahedral and half packing) may be left out with them.

Time the copy against the checkout in turns with
tools/eye_attribution.py --root DIR --walks; the difference is the
stores' cost in that design. The copy's buffers hold whatever the
allocator left, so its outputs' digests differ. Run from the repository
root:

    python3 tools/walk_store_cost.py --root DIR --out DIR
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys

HEADER = os.path.join("cudapathtracer_tpu_torch", "kernels", "csrc",
                      "bdpt.cuh")
STORE = re.compile(r"(void store_vertex\(const PathBufs& b,[^{]*\{\n)")
GATE = "  if (b.n >= 0) return;  // no stores: tools/walk_store_cost.py\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="the checkout to copy")
    ap.add_argument("--out", required=True, help="the copy (must not "
                    "exist)")
    args = ap.parse_args()
    shutil.copytree(args.root, args.out, ignore=shutil.ignore_patterns(
        ".git", "build", "__pycache__"))
    path = os.path.join(args.out, HEADER)
    with open(path) as f:
        src = f.read()
    src, n = STORE.subn(lambda m: m.group(1) + GATE, src)
    if n != 1:
        print(f"FAIL: {n} definitions of store_vertex in {path}, not 1")
        return 1
    with open(path, "w") as f:
        f.write(src)
    print(f"{args.out}: store_vertex writes nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
