#!/usr/bin/env python3
"""The K8-sort and K15 attribution: K8's sort against torch.sort on the
1080p VCM keys, and K15's (the threaded traversal's) time in its batch
entries and in every kernel it runs in, for copies of the tree that each
carry one change, timed in turns on one GPU.

Each variant is a patch this file carries as text (PATCHES), applied to a
copy of the tree (the package, configs, tools and chip_smoke.py) under
--out, or to a copy of --parent (the variants marked so); each is a
design the tree's was measured against:

  K8's sort (tools/eye_attribution.py --sort):
    items16   16 keys a thread (a tile of 4096), not 12 (3072);
    items8    8 keys a thread (a tile of 2048);
    match     ranking by __match_any_sync, not eight ballots;
    inloop    each key loaded inside the ranking loop, not all loads in
              flight before it (the __syncwarp between chunks keeps the
              compiler from hoisting them);
    look32    the look-back warp-cooperative: a warp reads 32 tiles back
              at once for its 32 digits, not one tile a step a digit;
    hist1     the histogram one block a chunk of 4096 keys (3038 blocks
              at 1080p, each adding its counts into device memory), not 4
              blocks an SM looping over the chunks;
  K15 (tools/eye_attribution.py --k15):
    links     the parent's walk of node_packed, its octant's hit link,
              miss link and leaf count loaded with the box, so that the
              next cursor is a select (parent);
    octant    a table of 32-byte records per octant ([8, M]: the box and
              that octant's hit word and miss link, one sector a visit),
              not one 96-byte record a node with every octant's links
              (two sectors a visit);
    scalar    a leaf triangle's record read by 12 scalar loads, not three
              16-byte ones;
    block128  the batch entries at 128 threads a block, not 64;
    block256  at 256.

"design" is the tree itself, and --parent DIR (a `git archive` of the
parent commit unpacked under build/) is timed as it is. Then it runs
tools/eye_attribution.py --sort and/or --k15 (as the variant needs; the
design and the parent both) on every tree in turns (first turn in the
order given, the next reversed, ...; --turns), each in its own process,
which builds that tree's kernels, and prints the mean milliseconds per
tree and measurement. Every line names the card and its power limit. Run
from the repository root:

    python3 tools/k8_k15_attribution.py --out build/k8k15 [--parent DIR]
        [--variants design items16 ... links ...] [--turns 2] [--reps 5]
        [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "cudapathtracer_tpu_torch"
CSRC = os.path.join(PKG, "kernels", "csrc")
COPY = (PKG, "configs", "tools", "chip_smoke.py")

_RANK_BALLOTS = """  unsigned peers = __ballot_sync(0xffffffffu, live);
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? m : ~m;
  }
  return peers;"""
_RANK_MATCH = """  const unsigned m =
      __match_any_sync(0xffffffffu, live ? d : 0xffffffffu);
  return live ? m : 0u;"""
_LOADS_FIRST = """#pragma unroll
  for (int c = 0; c < kItems; ++c) {  // every load in flight at once
    const int64_t i = key_index(tile, warp, c, lane);
    const bool live = i < a.n;
    if (a.pairs_in == nullptr) {
      hv[c] = live ? a.bucket[i] : 0u;
      val[c] = static_cast<uint32_t>(i);
    } else {
      const uint2 p = live ? a.pairs_in[i] : make_uint2(0u, 0u);
      hv[c] = p.x;
      val[c] = p.y;
    }
  }
  const unsigned below_me = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const bool live = key_index(tile, warp, c, lane) < a.n;
"""
_LOADS_IN_LOOP = """  const unsigned below_me = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = key_index(tile, warp, c, lane);
    const bool live = i < a.n;
    if (a.pairs_in == nullptr) {
      hv[c] = live ? a.bucket[i] : 0u;
      val[c] = static_cast<uint32_t>(i);
    } else {
      const uint2 p = live ? a.pairs_in[i] : make_uint2(0u, 0u);
      hv[c] = p.x;
      val[c] = p.y;
    }
"""
_LOOK_SERIAL = """      before = 0;
      for (int64_t j = tile - 1;; --j) {
        const uint32_t* s = a.status + j * kDigits + t;
        uint32_t v;
        do {
          v = load_status(s);
        } while ((v & ~kValueMask) == 0u);
        before += v & kValueMask;
        if (v & kFlagPrefix) break;
      }
"""
_LOOK_WARP = """      // the warp's 32 digits together: lane l reads the tile l + 1
      // before the window's start, all 32 digits (8 x 16 B)
      const int d0 = warp * 32;
      uint32_t sum = 0;   // lane l: digit d0 + l's sum so far
      bool done = false;  // lane l: digit d0 + l resolved
      int64_t start = tile - 1;
      while (__any_sync(0xffffffffu, !done)) {
        const int64_t j = start - lane;
        uint32_t w[32];
        if (j >= 0) {
          const uint4* src =
              reinterpret_cast<const uint4*>(a.status + j * kDigits + d0);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            uint4 x;
            asm volatile(
                "ld.relaxed.gpu.global.v4.u32 {%0,%1,%2,%3}, [%4];"
                : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                : "l"(src + q)
                : "memory");
            w[4 * q] = x.x;
            w[4 * q + 1] = x.y;
            w[4 * q + 2] = x.z;
            w[4 * q + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 32; ++q) w[q] = kFlagPrefix;
        }
        bool retry = false, found = false;
        uint32_t add = 0;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const unsigned pre =
              __ballot_sync(0xffffffffu, (w[q] & kFlagPrefix) != 0u);
          const unsigned zero =
              __ballot_sync(0xffffffffu, (w[q] & ~kValueMask) == 0u);
          const unsigned upto =
              pre ? ((2u << (__ffs(pre) - 1)) - 1u) : 0xffffffffu;
          const uint32_t s = __reduce_add_sync(
              0xffffffffu, ((upto >> lane) & 1u) ? (w[q] & kValueMask) : 0u);
          if (lane == q) {
            retry = (zero & upto) != 0u;
            add = s;
            found = pre != 0u;
          }
        }
        if (__any_sync(0xffffffffu, retry && !done)) continue;
        if (!done) {
          sum += add;
          done = found;
        }
        start -= 32;
      }
      before = sum;
"""
_BIN_LOADS = """      const float4 q0 = __ldg(tr), q1 = __ldg(tr + 1), q2 = __ldg(tr + 2);"""
_BIN_SCALAR = """      const float* f = reinterpret_cast<const float*>(tr);
      const float4 q0 = make_float4(__ldg(f), __ldg(f + 1), __ldg(f + 2),
                                    __ldg(f + 3));
      const float4 q1 = make_float4(__ldg(f + 4), __ldg(f + 5), __ldg(f + 6),
                                    __ldg(f + 7));
      const float4 q2 = make_float4(__ldg(f + 8), __ldg(f + 9),
                                    __ldg(f + 10), __ldg(f + 11));"""
_SORT = os.path.join(CSRC, "radix_sort.cu")
_BIN = os.path.join(CSRC, "traverse_bin.cuh")
_BIN_CU = os.path.join(CSRC, "traverse_bin.cu")
_OPS = os.path.join(PKG, "ops", "traverse.py")
_KERNELS = os.path.join(PKG, "kernels", "__init__.py")
# Each variant: (base tree, what it times, [(file, text, replacement,
# times it occurs)]).
PATCHES = {
    "items16": ("design", "sort", [
        (_SORT, "constexpr int kItems = 12;", "constexpr int kItems = 16;",
         1)]),
    "items8": ("design", "sort", [
        (_SORT, "constexpr int kItems = 12;", "constexpr int kItems = 8;",
         1)]),
    "match": ("design", "sort", [(_SORT, _RANK_BALLOTS, _RANK_MATCH, 1)]),
    "inloop": ("design", "sort", [(_SORT, _LOADS_FIRST, _LOADS_IN_LOOP, 1)]),
    "look32": ("design", "sort", [(_SORT, _LOOK_SERIAL, _LOOK_WARP, 1)]),
    "hist1": ("design", "sort", [
        (_SORT, "std::min<int64_t>(chunks, kHistBlocksPerSm * sms)",
         "chunks", 1)]),
    "links": ("parent", "k15", [
        (_BIN, """    const float4 b1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
""", """    const float4 b1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
    const int32_t hit_link = __ldg(irow + 6 + oct);
    const int32_t miss_link = __ldg(irow + 14 + oct);
    const int32_t count = __ldg(irow + 22);
""", 1),
        (_BIN, """    const int32_t count = __ldg(irow + 22);
    if (!hit || count == 0) {
      cur = __ldg(irow + (hit ? 6 : 14) + oct);""",
         """    if (!hit || count == 0) {
      cur = hit ? hit_link : miss_link;""", 1),
        (_BIN, "    cur = __ldg(irow + 14 + oct);\n",
         "    cur = miss_link;\n", 1)]),
    "octant": ("design", "k15", [
        (_OPS, """    head = torch.zeros((m, kernels.BIN_HEAD), dtype=torch.int32,
                       device=dev)
    head[:, 0:6] = ir[:, 0:6]
    head[:, 8::2] = hit
    head[:, 9::2] = ir[:, 14:22]
""", """    head = torch.zeros((8, m, 8), dtype=torch.int32, device=dev)
    head[:, :, 0:6] = ir[None, :, 0:6]
    head[:, :, 6] = hit.t()
    head[:, :, 7] = ir[:, 14:22].t()
""", 1),
        (_KERNELS, "BIN_HEAD = 24 ", "BIN_HEAD = 64 ", 1),
        (_BIN, "constexpr int kBinQuads = 6;", "constexpr int kBinQuads = 16;",
         1),
        (_BIN, "  const int pair = 2 + (oct >> 1);  // the float4 of the "
               "octant's links\n",
         "  head += 2 * static_cast<int64_t>(oct) * nodes;\n", 1),
        (_BIN, "head + kBinQuads * static_cast<int64_t>(cur);",
         "head + 2 * static_cast<int64_t>(cur);", 1),
        (_BIN, "    const float4 lk = __ldg(rec + pair);\n", "", 1),
        (_BIN, "__float_as_int((oct & 1) ? lk.w : lk.y)",
         "__float_as_int(b1.w)", 1),
        (_BIN, "__float_as_int((oct & 1) ? lk.z : lk.x)",
         "__float_as_int(b1.z)", 1)]),
    "scalar": ("design", "k15", [(_BIN, _BIN_LOADS, _BIN_SCALAR, 1)]),
    "block128": ("design", "k15", [
        (_BIN_CU, "constexpr int kThreads = 64;",
         "constexpr int kThreads = 128;", 1)]),
    "block256": ("design", "k15", [
        (_BIN_CU, "constexpr int kThreads = 64;",
         "constexpr int kThreads = 256;", 1)]),
}
# the ptxas lines printed: the sort's kernels, K15's batch entries and the
# threaded instantiations of K5 and the eye walk
THREADED_PTXAS = ("radix_", "traverse_bin", "uni_mega_kernelILi1E",
                  "eye_walk_kernelILi1E")
K15_HOSTS = ("K15 closest entry", "K15 shadow entry", "K5 classic",
             "K12 light walk", "K12 eye walk", "K11 trace", "K13 pairs",
             "eye walk", "eye connect")


def make_variant(out: str, name: str, parent: str | None) -> str:
    """A copy of the variant's base tree with its patches applied."""
    base, _, patches = PATCHES[name]
    if base == "parent" and parent is None:
        raise SystemExit(f"FAIL: {name} patches the parent: give --parent")
    src_root = parent if base == "parent" else ROOT
    dst = os.path.join(out, name)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    for item in COPY:
        src = os.path.join(src_root, item)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, item),
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(src, dst)
    for fname, old, new, times in patches:
        path = os.path.join(dst, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != times:
            raise SystemExit(f"FAIL: {name}: {text.count(old)} of {old!r} "
                             f"in {path}, not {times}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="where the copies go (a "
                    "directory .gitignore lists, e.g. build/k8k15)")
    ap.add_argument("--parent", default=None, help="an earlier checkout, "
                    "timed as it is and the base of the variants marked so")
    ap.add_argument("--variants", nargs="+", default=["design", *PATCHES])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    parent = os.path.abspath(args.parent) if args.parent else None
    trees, parts = {}, {}
    if parent:
        trees["parent"], parts["parent"] = parent, ("sort", "k15")
    for name in args.variants:
        if name == "design":
            trees[name], parts[name] = ROOT, ("sort", "k15")
        else:
            trees[name] = make_variant(out, name, parent)
            parts[name] = (PATCHES[name][1],)
    tool = os.path.join(ROOT, "tools", "eye_attribution.py")
    runs = {name: [] for name in trees}
    order = list(trees)
    for turn in range(args.turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            res = os.path.join(out, f"{name}.{turn}.json")
            cmd = [sys.executable, tool, "--root", trees[name], "--reps",
                   str(args.reps), "--json", res,
                   *(f"--{p}" for p in parts[name])]
            if turn > 0:
                cmd.append("--reuse-build")
            print(f"[k8k15] turn {turn}: {name} ({trees[name]})", flush=True)
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1800)
            for line in p.stdout.splitlines():
                if line.startswith(("[sort]", "[k15]", "FAIL")) or (
                        turn == 0 and line.startswith("[attribution] ptxas")
                        and any(k in line for k in THREADED_PTXAS)):
                    print(f"  {line}", flush=True)
            if p.returncode != 0:
                print(p.stdout[-4000:], p.stderr[-4000:])
                raise SystemExit(f"FAIL: {name}, turn {turn}: exit "
                                 f"{p.returncode}")
            with open(res) as f:
                runs[name].append(json.load(f))
    card = runs[order[0]][0]["card"]
    table = {}
    print(f"[k8k15] mean ms over {args.turns} turns; {card}")
    for name in order:
        row = {}
        if "sort" in parts[name]:
            for key in ("sort", "torch.sort int32"):
                ms = [r["sort"][key] for r in runs[name]]
                row[f"K8 {key}"] = sum(ms) / len(ms)
            row["K8 equal"] = all(r["sort"]["equal"] for r in runs[name])
            row["K8 digest"] = runs[name][0]["sort"]["digest"][:16]
            row["K8 launches"] = runs[name][0]["sort"]["launches"]
        if "k15" in parts[name]:
            for host in K15_HOSTS:
                ms = [r["k15"][host] for r in runs[name]]
                row[host] = sum(ms) / len(ms)
        table[name] = row
        print(f"[k8k15] {name}: " + "; ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, trees=trees, table=table), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
