#!/usr/bin/env python3
"""The K1 attribution: K1's (the BVH8 traversal's) time in its batch
entries and in every kernel it runs in, for copies of the tree that each
carry one change to K1 or its hosts, timed in turns on one GPU.

Each variant is a patch this file carries as text (PATCHES), applied to a
copy of the tree (the package, configs, tools and chip_smoke.py) under
--out; each one is a candidate cause of the registers and local memory K1
costs its hosts, tried against the tree's design:
  stack     the ring stack in shared memory, one [kStackD][128] slab a
            block (each thread its column, so a warp's 32 lanes hit 32
            banks whatever their stack pointers), not a local array;
  noinline  trace8 a call with its own register allocation, not inlined;
  blocks    each host kernel's minimum resident blocks an SM those its
            threaded instantiation gets (K5 4, the eye walk 4, K11's
            trace 8; the other hosts already ask for theirs);
  connect4  the VCM eye pass's connection stage at 4 blocks an SM, as
            before the design, not 5;
names joined by + apply several (stack+blocks). "design" is the tree
itself, and with --parent DIR that checkout is timed as it is (e.g. a
`git archive` of the parent commit unpacked under build/: K1 before its
row was consumed in stages). Then it runs tools/eye_attribution.py --k1
on every tree in turns (first turn in the order given, the next
reversed, ...; --turns), each in its own process, which builds that
tree's kernels (and prints ptxas' registers, stack frame, spills and
shared memory of each kernel), and prints a table of each host's mean
milliseconds and ptxas numbers per tree. Every line names the card and
its power limit. Run from the repository root:

    python3 tools/k1_attribution.py --out build/k1 [--parent DIR]
        [--variants stack noinline blocks connect4 design] [--turns 2]
        [--reps 3] [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("cudapathtracer_tpu_torch", "kernels", "csrc")
COPY = ("cudapathtracer_tpu_torch", "configs", "tools", "chip_smoke.py")
# Each variant: (file under CSRC, text, replacement, times it occurs).
PATCHES = {
    "stack": [
        ("traverse8.cuh", "// tri_f32 / tri_cols: the scene's triangle",
         "// Every kernel that traces a BVH8 ray runs blocks of 128 threads.\n"
         "__device__ __forceinline__ int32_t* stack_column() {\n"
         "  __shared__ int32_t slab[kStackD * 128];\n"
         "  return slab + threadIdx.x;\n"
         "}\n\n"
         "// tri_f32 / tri_cols: the scene's triangle", 1),
        ("traverse8.cuh", "  int32_t stack[kStackD];\n",
         "  int32_t* const stack = stack_column();\n", 1),
        ("traverse8.cuh", "stack[sp % kStackD]",
         "stack[(sp % kStackD) * 128]", 2),
    ],
    "noinline": [
        ("traverse8.cuh", "__device__ __forceinline__ Trace8 trace8(",
         "__device__ __noinline__ Trace8 trace8(", 1),
    ],
    "blocks": [
        ("uni_mega.cu", "__launch_bounds__(kThreads, 1)",
         "__launch_bounds__(kThreads, 4)", 1),
        ("eye_walk.cu", "__launch_bounds__(kThreads)\n",
         "__launch_bounds__(kThreads, 4)\n", 1),
        ("bdpt_splat.cu", "__launch_bounds__(kThreads)\nsplat_trace_kernel",
         "__launch_bounds__(kThreads, 8)\nsplat_trace_kernel", 1),
    ],
    "connect4": [
        ("eye_connect.cu", "__launch_bounds__(kThreads, 5)",
         "__launch_bounds__(kThreads, 4)", 1),
    ],
}
# the BVH8 instantiations of the kernels K1 runs in, by host
HOSTS = {"K1 closest entry": "traverse8_kernelILb0E",
         "K1 shadow entry": "traverse8_kernelILb1E",
         "K5 mega": "uni_mega_kernelILi0E",
         "K5 classic": "uni_mega_kernelILi0E",
         "K12 light walk": "bdpt_walk_kernelILi0E",
         "K12 eye walk": "bdpt_walk_kernelILi0E",
         "K11 trace": "splat_trace_kernelILi0E",
         "K13 pairs": "bdpt_pairs_kernelILi0E",
         "eye walk": "eye_walk_kernelILi0ELi0E",
         "eye connect": "eye_connect_kernelILi0ELi0E"}


def make_variant(out: str, name: str) -> str:
    """A copy of the tree with the patches of variant `name` applied."""
    dst = os.path.join(out, name)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    for item in COPY:
        src = os.path.join(ROOT, item)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, item),
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(src, dst)
    for part in name.split("+"):
        if part not in PATCHES:
            raise SystemExit(f"FAIL: no variant {part!r} (have "
                             f"{', '.join(PATCHES)})")
        for fname, old, new, times in PATCHES[part]:
            path = os.path.join(dst, CSRC, fname)
            with open(path) as f:
                src = f.read()
            if src.count(old) != times:
                raise SystemExit(f"FAIL: {part}: {src.count(old)} of "
                                 f"{old!r} in {path}, not {times}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="where the copies go (a "
                    "directory .gitignore lists, e.g. build/k1)")
    ap.add_argument("--parent", default=None, help="an earlier checkout, "
                    "timed as it is")
    ap.add_argument("--variants", nargs="+", default=[*PATCHES, "design"])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    trees = {}
    if args.parent:
        trees["parent"] = os.path.abspath(args.parent)
    for name in args.variants:
        trees[name] = ROOT if name == "design" else make_variant(out, name)
    tool = os.path.join(ROOT, "tools", "eye_attribution.py")
    runs = {name: [] for name in trees}
    order = list(trees)
    for turn in range(args.turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            res = os.path.join(out, f"{name}.{turn}.json")
            cmd = [sys.executable, tool, "--root", trees[name], "--k1",
                   "--reps", str(args.reps), "--json", res]
            if turn > 0:
                cmd.append("--reuse-build")
            print(f"[k1] turn {turn}: {name} ({trees[name]})", flush=True)
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1800)
            for line in p.stdout.splitlines():
                if line.startswith(("[k1]", "FAIL")) or (
                        turn == 0 and line.startswith("[attribution] ptxas")
                        and any(h in line for h in HOSTS.values())):
                    print(f"  {line}", flush=True)
            if p.returncode != 0:
                print(p.stdout[-4000:], p.stderr[-4000:])
                raise SystemExit(f"FAIL: {name}, turn {turn}: exit "
                                 f"{p.returncode}")
            with open(res) as f:
                runs[name].append(json.load(f))
    card = runs[order[0]][0]["card"]
    table = {}
    print(f"[k1] mean ms over {args.turns} turns (registers / stack bytes / "
          f"spill stores / shared bytes of the host's BVH8 kernel); {card}")
    for host, kname in HOSTS.items():
        row = {}
        for name in order:
            ms = [r["k1"][host] for r in runs[name]]
            regs = next((v for k, v in runs[name][0]["ptxas"].items()
                         if kname in k), None)
            row[name] = dict(ms=ms, mean=sum(ms) / len(ms), ptxas=regs)
        table[host] = row
        print(f"[k1] {host}: " + "; ".join(
            f"{name} {v['mean']:.3f}"
            + (f" ({v['ptxas'][0]}/{v['ptxas'][1]}/{v['ptxas'][2]}/"
               f"{v['ptxas'][4]})" if v["ptxas"] else "")
            for name, v in row.items()), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, trees=trees, table=table), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
