#!/usr/bin/env python3
"""The Threefry attribution: what K6's draws (and K7's lens) cost the
kernels they run in, on copies of a tree that each carry one change, timed
in turns on one GPU.

Each variant is a patch this file carries as text (PATCHES), applied to a
copy of this tree (the design) or, named parent:<patch>, of the --parent
checkout (e.g. a `git archive` of the parent commit unpacked under
build/); "design" is this tree and "parent" the --parent checkout as they
are:
  lanefold  (a) no key table: every host folds its keys in the lane, as
            before the tables (K5's classic and naive bounce key a event
            and a fold a draw; K12's, the classic eye walk's and K13's
            bounce / NEE keys), the tables still written;
  cut16     the depth cut: K5's classic and naive events lit < 16 read the
            table, later ones fold in the lane;
  smem      K5's draw-key table copied into shared memory at the kernel's
            start and read from there;
  lens      (b) no pinhole skip: K7 draws and computes the lens at every
            aperture (time it with --aperture0);
  trig      K7's lens through cosf and sinf, not one sincosf;
  inter     (c) the three draws of NEE's light point (K5's nee_sample, the
            BDPT / VCM light_point) as one interleaved three-lane cipher
            where their pairs come from a device table;
  pre12     K12's bounce loads its four BSDF pairs right after its closest
            ray, beside the shading record's loads, not at each draw, as
            K5's naive events do;
  atdraw    K5's naive events load each pair at its draw;
  naivefold K5's naive events fold their keys in the lane (the form before
            the tables),
            its classic and mega events keep the table;
  k12fold   K12's bounces fold their keys in the lane (the form before
            the tables);
  triple    (d) a table entry is (k0, k1, k0 ^ k1 ^ parity): 16 bytes, the
            cipher's key schedule not computed (breaks the keyed walk's
            host table: not timed here);
  hash      (e) the ceiling: the cipher replaced by a hash of both input
            words (two multiplies and a murmur3 finaliser, ~12 instructions;
            not bit-equal: timing only), on the design and as parent:hash
            on the parent: what any K6 design could still give in each
            host;
names joined by + apply several (lanefold+hash). Then it runs
tools/eye_attribution.py --shade --rng (every host, K6's and K7's
entries; with --aperture0 through a camera of aperture 0) on every tree in
turns (first turn in the order given, the next reversed, ...), each in its
own process, which builds that tree's kernels and prints ptxas' registers,
stack frame, spills and shared memory of each kernel, and prints a table
of each host's mean milliseconds and ptxas numbers per tree. --sass counts
each tree's SASS with cuobjdump: the instructions of rng.cu's keyed draw
kernel by opcode (one cipher), of K7's kernel, and the SHF.L.W rotations
(20 a cipher) and instructions of every host. Every line names the card
and its power limit. Run from the repository root:

    python3 tools/rng_attribution.py --parent DIR --out build/rng
        [--variants parent:hash design lanefold cut16 smem inter triple
         trig hash pre12 atdraw naivefold k12fold] [--aperture0]
        [--turns 2] [--reps 3] [--sass]
        [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import shade_attribution as sa  # noqa: E402

ROOT = sa.ROOT
CSRC = sa.CSRC

# keys.cuh: in-lane draws from a key (the hosts before the tables)
_FOLD_DRAWS = r'''// The draws of one key folded in the lane: draw(d) = uniform of
// draw_key(key, d) keyed by id (two ciphers a draw).
struct FoldDraws {
  uint32_t k0, k1, id;
  __device__ __forceinline__ float operator()(int d) const {
    uint32_t a, b;
    fold_in(k0, k1, static_cast<uint32_t>(d), a, b);
    return uniform_draw_key(a, b, id);
  }
};

__device__ __forceinline__ FoldDraws fold_draws(uint32_t k0, uint32_t k1,
                                               uint32_t data, uint32_t id) {
  FoldDraws f;
  fold_in(k0, k1, data, f.k0, f.k1);
  f.id = id;
  return f;
}

}  // namespace tpt
'''

# uni_mega.cu: K5's events with draws from the table or folded in the lane
# from the sample key, which the camera row keeps again (words 8, 9)
_K5_FOLD = [
    (CSRC + "/keys.cuh", "}  // namespace tpt\n", _FOLD_DRAWS, 1),
    (CSRC + "/uni_mega.cu", "constexpr int kKeyWords = 8;\n",
     "constexpr int kKeyWords = 10;\n", 1),
    (CSRC + "/uni_mega.cu",
     "    fold_in(c0, c1, d, row[2 * d], row[2 * d + 1]);\n}\n",
     "    fold_in(c0, c1, d, row[2 * d], row[2 * d + 1]);\n"
     "  row[8] = s0;\n  row[9] = s1;\n}\n", 1),
    (CSRC + "/uni_mega.cu", "using EventDraws = RowDraws;\n",
     r'''struct EventDraws {
  const KeyPair* row;
  uint32_t id;
  uint32_t b0 = 0u, b1 = 0u;
  bool fold = false;
  __device__ __forceinline__ float operator()(int d) const {
    if (fold) {
      uint32_t a, b;
      fold_in(b0, b1, static_cast<uint32_t>(d), a, b);
      return uniform_draw_key(a, b, id);
    }
    const KeyPair k = __ldg(row + d);
    return uniform_draw_key(k.x, k.y, id);
  }
};

// event lit's draws folded in the lane: fold_in(skey, lit), then a fold a
// draw (keys: the sample's camera row, skey in words 8, 9)
__device__ __forceinline__ EventDraws lane_fold(const uint32_t* keys, int lit,
                                                uint32_t id) {
  EventDraws e;
  e.row = nullptr;
  e.id = id;
  e.fold = true;
  fold_in(keys[8], keys[9], static_cast<uint32_t>(lit), e.b0, e.b1);
  return e;
}
''', 1),
    (CSRC + "/uni_mega.cu",
     "                                           const Params& p,\n"
     "                                           const KeyPair* table,\n",
     "                                           const Params& p,\n"
     "                                           const uint32_t* keys,\n"
     "                                           const KeyPair* table,\n", 1),
    (CSRC + "/uni_mega.cu",
     "                                            const Params& p,\n"
     "                                            const KeyPair* table,\n",
     "                                            const Params& p,\n"
     "                                            const uint32_t* keys,\n"
     "                                            const KeyPair* table,\n",
     1),
    (CSRC + "/uni_mega.cu",
     "tpt::naive_event<kEngine>(sc, p, trow,",
     "tpt::naive_event<kEngine>(sc, p, row, trow,", 1),
    (CSRC + "/uni_mega.cu",
     "tpt::path_event<kEngine>(sc, p, trow,",
     "tpt::path_event<kEngine>(sc, p, row, trow,", 1),
]


# uni_mega.cu: K5's naive event loading its four pairs after the trace
_NAIVE_HELD = ("  HeldDraws e;\n  e.id = pix_id;\n#pragma unroll\n"
               "  for (int j = 0; j < 4; ++j)\n"
               "    e.k[j] = __ldg(table + st.lit * kUniKeyDraws + j);\n")


def _k5_draws(classic: str, naive: str) -> list:
    """K5's classic and naive draws built by the given expressions (the
    naive ones drawn at their use)."""
    return [(CSRC + "/uni_mega.cu",
             "classic ? EventDraws{table + lit * kUniKeyDraws, pix_id}",
             f"classic ? {classic}", 1),
            (CSRC + "/uni_mega.cu", _NAIVE_HELD,
             f"  const EventDraws e = {naive};\n", 1),
            (CSRC + "/uni_mega.cu", "  const BasedDraws<HeldDraws> bd{&e, 0};",
             "  const BasedDraws<EventDraws> bd{&e, 0};", 1)]


# keys.cuh, uni_mega.cu: the three draws of a light point as one
# interleaved cipher where their pairs are a table row's
_DRAWS3 = r'''// Three ciphers, round by round interleaved.
__device__ __forceinline__ void threefry2x32_x3(const KeyPair* k,
                                                uint32_t id, float* u) {
  uint32_t ks[3][3], x0[3], x1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const KeyPair p = __ldg(k + j);
    ks[j][0] = p.x;
    ks[j][1] = p.y;
    ks[j][2] = p.x ^ p.y ^ kThreefryParity;
    x0[j] = id + ks[j][0];
    x1[j] = ks[j][1];
  }
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        x0[j] += x1[j];
        x1[j] = rotl32(x1[j], rot[i & 1][r]);
        x1[j] ^= x0[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      x0[j] += ks[j][(i + 1) % 3];
      x1[j] += ks[j][(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) u[j] = bits_to_unit(x0[j]);
}

template <class D>
__device__ __forceinline__ void draws3(const D& draw, float* u) {
  u[0] = draw(0);
  u[1] = draw(1);
  u[2] = draw(2);
}

__device__ __forceinline__ void draws3(const RowDraws& draw, float* u) {
  threefry2x32_x3(draw.row, draw.id, u);
}

}  // namespace tpt
'''

# keys.cuh: four pairs held in registers
_HELD4 = r'''// Four pairs of a table row, loaded at once and held.
struct HeldDraws4 {
  KeyPair k[4];
  uint32_t id;
  __device__ __forceinline__ float operator()(int d) const {
    return uniform_draw_key(k[d].x, k[d].y, id);
  }
};

}  // namespace tpt
'''

PATCHES = {
    "lanefold": _K5_FOLD + _k5_draws(
        "lane_fold(keys, lit, pix_id)",
        "lane_fold(keys, st.lit, pix_id)") + [
        (CSRC + "/bdpt.cuh",
         "  const RowDraws bd{p.key_table + kWalkKeyDraws * depth, st.id};",
         "  const FoldDraws bd = fold_draws(p.key0, p.key1,\n"
         "                                  static_cast<uint32_t>(depth), "
         "st.id);", 1),
        (CSRC + "/bdpt.cuh",
         "    const RowDraws kk{p.nee_keys + kNeeKeyDraws * t, id};",
         "    const FoldDraws kk = fold_draws(p.key_c0, p.key_c1,\n"
         "                                    static_cast<uint32_t>(t), id);",
         1),
        (CSRC + "/eye.cuh",
         "    const KeyPair* krow =\n"
         "        kMega ? nullptr : p.key_table + kEyeKeyDraws * depth;",
         "    const FoldDraws bd =\n"
         "        fold_draws(p.key_e0, p.key_e1, static_cast<uint32_t>(depth),"
         " id);", 1),
        (CSRC + "/eye.cuh", "bsdf_sample(RowDraws{krow, id}, ",
         "bsdf_sample(bd, ", 1),
        (CSRC + "/eye.cuh", "RowDraws{krow + kEyeNeeDraw, id}",
         "fold_draws(bd.k0, bd.k1, 7u, id)", 1),
    ],
    "cut16": _K5_FOLD + _k5_draws(
        "(lit < 16 ? EventDraws{table + lit * kUniKeyDraws, pix_id}\n"
        "                          : lane_fold(keys, lit, pix_id))",
        "st.lit < 16\n"
        "      ? EventDraws{table + st.lit * kUniKeyDraws, pix_id}\n"
        "      : lane_fold(keys, st.lit, pix_id)"),
    "smem": [
        (CSRC + "/uni_mega.cu", "using EventDraws = RowDraws;\n",
         r'''struct EventDraws {
  const KeyPair* row;  // shared memory
  uint32_t id;
  __device__ __forceinline__ float operator()(int d) const {
    const KeyPair k = row[d];
    return uniform_draw_key(k.x, k.y, id);
  }
};
''', 1),
        (CSRC + "/uni_mega.cu",
         "  int32_t events = 0, calls = 0;\n"
         "  int64_t i = tpt::next_id(counter);\n",
         r'''  int32_t events = 0, calls = 0;
  extern __shared__ tpt::KeyPair s_keys[];
  {
    const int32_t nr = tpt::key_rows(p.schedule, p.max_depth);
    const int64_t m = int64_t{k} * (nr > 0 ? nr : 1) * tpt::kUniKeyDraws;
    for (int64_t j = threadIdx.x; j < m; j += kThreads) s_keys[j] = table[j];
    __syncthreads();
    table = s_keys;
  }
  int64_t i = tpt::next_id(counter);
''', 1),
        (CSRC + "/uni_mega.cu",
         "            unsigned long long* ln) {\n  if (wide)\n",
         "            unsigned long long* ln) {\n"
         "  const int32_t nr = tpt::key_rows(p.schedule, p.max_depth);\n"
         "  const size_t smem = sizeof(tpt::KeyPair) * k * (nr > 0 ? nr : 1)"
         " *\n                      tpt::kUniKeyDraws;\n  if (wide)\n", 1),
        (CSRC + "/uni_mega.cu", "<<<grid, kThreads, 0, st>>>",
         "<<<grid, kThreads, smem, st>>>", 2),
    ],
    "lens": [(CSRC + "/camera.cuh",
              "  if (lens_on) {\n    const float r_rnd",
              "  {\n    const float r_rnd", 1)],
    "trig": [(CSRC + "/camera.cuh", "    sincosf(theta, &sn, &cs);\n",
              "    sn = sinf(theta);\n    cs = cosf(theta);\n", 1)],
    "inter": [
        (CSRC + "/keys.cuh", "}  // namespace tpt\n", _DRAWS3, 1),
        (CSRC + "/uni_mega.cu",
         "    return (*e)(base + k);\n  }\n};\n",
         "    return (*e)(base + k);\n  }\n};\n\n"
         "__device__ __forceinline__ void draws3(\n"
         "    const BasedDraws<RowDraws>& draw, float* u) {\n"
         "  threefry2x32_x3(draw.e->row + draw.base, draw.e->id, u);\n}\n",
         1),
        (CSRC + "/nee.cuh",
         "  const float ul = draw(0);\n  const float u = sqrtf(draw(1));\n"
         "  const float v = draw(2);\n",
         "  float u3[3];\n  draws3(draw, u3);\n  const float ul = u3[0];\n"
         "  const float u = sqrtf(u3[1]);\n  const float v = u3[2];\n", 1),
        (CSRC + "/bdpt.cuh",
         "  int32_t idx = static_cast<int32_t>(draw(0) * num);\n",
         "  float u3[3];\n  draws3(draw, u3);\n"
         "  int32_t idx = static_cast<int32_t>(u3[0] * num);\n", 1),
        (CSRC + "/bdpt.cuh",
         "  const float u = sqrtf(draw(1));\n  const float v = draw(2);\n",
         "  const float u = sqrtf(u3[1]);\n  const float v = u3[2];\n", 1),
    ],
    "triple": [
        (CSRC + "/keys.cuh", "using KeyPair = uint2;",
         "using KeyPair = uint4;", 1),
        (CSRC + "/keys.cuh", "  return make_uint2(k0, k1);",
         "  return make_uint4(k0, k1, k0 ^ k1 ^ kThreefryParity, 0u);", 1),
        (CSRC + "/keys.cuh", "    return uniform_draw_key(k.x, k.y, id);\n",
         "    uint32_t x0 = id, x1 = 0u;\n"
         "    threefry2x32_ks(k.x, k.y, k.z, x0, x1);\n"
         "    return bits_to_unit(x0);\n", 1),
        ("cudapathtracer_tpu_torch/kernels/__init__.py",
         "KEY_PAIR_WORDS = 2 ", "KEY_PAIR_WORDS = 4 ", 1),
    ],
    # both trees' cipher starts with these two lines
    "hash": [(CSRC + "/threefry.cuh", "  x0 += ks[0];\n  x1 += ks[1];\n",
              "  {\n    uint32_t h = (x0 ^ ks[0]) * 0x9E3779B1u;\n"
              "    h ^= (x1 + ks[1]) * 0x85EBCA77u;\n"
              "    h ^= h >> 15;\n    h *= 0xC2B2AE35u;\n"
              "    h ^= h >> 13;\n    x0 = h;\n"
              "    x1 = (h * 0x27D4EB2Fu) ^ ks[2];\n    return;\n  }\n"
              "  x0 += ks[0];\n  x1 += ks[1];\n", 1)],
    "pre12": [
        (CSRC + "/keys.cuh", "}  // namespace tpt\n", _HELD4, 1),
        (CSRC + "/bdpt.cuh",
         "  const ShadeHit s = shade_fetch(sc.shade, h.tri, h.u, h.v, st.o, "
         "st.d, h.t);\n",
         "  HeldDraws4 bd;\n  bd.id = st.id;\n#pragma unroll\n"
         "  for (int d = 0; d < 4; ++d)\n"
         "    bd.k[d] = __ldg(p.key_table + kWalkKeyDraws * depth + d);\n"
         "  const ShadeHit s = shade_fetch(sc.shade, h.tri, h.u, h.v, st.o, "
         "st.d, h.t);\n", 1),
        (CSRC + "/bdpt.cuh",
         "  const RowDraws bd{p.key_table + kWalkKeyDraws * depth, st.id};\n",
         "", 1),
    ],
    "atdraw": _k5_draws(
        "EventDraws{table + lit * kUniKeyDraws, pix_id}",
        "EventDraws{table + st.lit * kUniKeyDraws, pix_id}"),
    "naivefold": _K5_FOLD + _k5_draws(
        "EventDraws{table + lit * kUniKeyDraws, pix_id}",
        "lane_fold(keys, st.lit, pix_id)"),
    "k12fold": [
        (CSRC + "/keys.cuh", "}  // namespace tpt\n", _FOLD_DRAWS, 1),
        (CSRC + "/bdpt.cuh",
         "  const RowDraws bd{p.key_table + kWalkKeyDraws * depth, st.id};",
         "  const FoldDraws bd = fold_draws(p.key0, p.key1,\n"
         "                                  static_cast<uint32_t>(depth), "
         "st.id);", 1),
    ],
}
# the kernels of each host (shade_attribution.HOSTS) and the entries
HOSTS = dict(sa.HOSTS)
ENTRIES = {"K6 uniform_id": "uniform_id_kernel",
           "K6 keyed": "uniform_keyed_kernel",
           "K7 reference pinhole": "generate_rays_kernel",
           "K7 aperture 0": "generate_rays_kernel",
           "K7 thin lens": "generate_rays_kernel"}


def sass(lib: str) -> dict:
    """{kernel name: {opcode: count}} of every kernel in the library
    (cuobjdump -sass)."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=600).stdout
    res, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = res.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)", line)
        if cur is not None and m:
            op = m.group(1) + (".L.W" if m.group(1) == "SHF"
                               and ".L.W" in m.group(2) else "")
            cur[op] = cur.get(op, 0) + 1
    return res


def sass_report(trees: dict, log=print) -> dict:
    """Each tree's SASS numbers: rng.cu's keyed draw kernel and K7's by
    opcode, every host's rotations (SHF.L.W: 20 a cipher) and
    instructions."""
    rep = {}
    lib_of = lambda root: os.path.join(root, "build", "torch_ext",
                                       "libtpt_torch_kernels.so")
    for name, root in trees.items():
        kern = sass(lib_of(root))
        pick = lambda sub: next(((k, v) for k, v in kern.items()
                                 if sub in k), (None, {}))
        row = {}
        for tag, sub in (("K6 keyed", "uniform_keyed_kernel"),
                         ("K6 uniform_id", "uniform_id_kernel"),
                         ("K7", "generate_rays_kernel")):
            k, v = pick(sub)
            row[tag] = dict(ops=v, total=sum(v.values()),
                            cipher=sum(v.get(o, 0) for o in
                                       ("IADD3", "SHF", "SHF.L.W", "LOP3")))
            log(f"[sass] {name} {tag}: {row[tag]['total']} instructions, "
                f"{row[tag]['cipher']} IADD3/SHF/LOP3: " + ", ".join(
                    f"{o} {c}" for o, c in sorted(v.items())))
        for host, kname in HOSTS.items():
            cands = (kname,) if isinstance(kname, str) else kname
            k, v = next((pick(c) for c in cands if pick(c)[0]), (None, {}))
            row[host] = dict(rotations=v.get("SHF.L.W", 0),
                             total=sum(v.values()))
            log(f"[sass] {name} {host}: {row[host]['rotations']} SHF.L.W "
                f"({row[host]['rotations'] / 20:.1f} ciphers), "
                f"{row[host]['total']} instructions")
        rep[name] = row
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", required=True, help="the parent checkout, "
                    "timed as it is and patched as parent:<patch>")
    ap.add_argument("--out", required=True, help="where the copies go (a "
                    "directory .gitignore lists, e.g. build/rng)")
    ap.add_argument("--variants", nargs="+", default=[
        "parent:hash", "design", "lanefold", "cut16", "smem", "inter",
        "triple", "trig", "hash", "pre12", "atdraw", "naivefold",
        "k12fold"])
    ap.add_argument("--aperture0", action="store_true", help="every host "
                    "through a camera of aperture 0")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only-make", action="store_true", help="make the "
                    "copies and stop (needs no GPU)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    parent = os.path.abspath(args.parent)
    trees = {"parent": parent}
    for name in args.variants:
        if name == "design":
            trees[name] = ROOT
        elif name.startswith("parent:"):
            trees[name] = sa.make_variant(parent, os.path.join(out, "parent"),
                                          name[7:], PATCHES)
        else:
            trees[name] = sa.make_variant(ROOT, out, name, PATCHES)
    if args.only_make:
        print("\n".join(f"{k}: {v}" for k, v in trees.items()))
        return 0
    tool = os.path.join(ROOT, "tools", "eye_attribution.py")
    runs = {name: [] for name in trees}
    order = list(trees)
    tag = "a0" if args.aperture0 else "ref"
    for turn in range(args.turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            res = os.path.join(out, f"{name.replace(':', '.')}.{tag}."
                               f"{turn}.json")
            cmd = [sys.executable, tool, "--root", trees[name], "--shade",
                   "--rng", "--reps", str(args.reps), "--json", res]
            if args.aperture0:
                cmd.append("--aperture0")
            if turn > 0:
                cmd.append("--reuse-build")
            print(f"[rng] turn {turn}: {name} ({trees[name]})", flush=True)
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1800)
            for line in p.stdout.splitlines():
                if line.startswith(("[shade]", "[rng]", "FAIL")) or (
                        turn == 0 and line.startswith("[attribution] ptxas")
                        and any(h in line for h in sa._names())):
                    print(f"  {line}", flush=True)
            if p.returncode != 0:
                print(p.stdout[-4000:], p.stderr[-4000:])
                raise SystemExit(f"FAIL: {name}, turn {turn}: exit "
                                 f"{p.returncode}")
            with open(res) as f:
                runs[name].append(json.load(f))
    card = runs[order[0]][0]["card"]
    table = {}
    print(f"[rng] mean ms over {args.turns} turns (registers / stack bytes "
          f"/ spill stores / shared bytes of the host's kernel); camera "
          f"{'aperture 0' if args.aperture0 else 'reference pinhole'}; "
          f"{card}")
    for host, kname in {**HOSTS, **ENTRIES}.items():
        part = "rng" if host in ENTRIES else "shade"
        row = {}
        for name in order:
            ms = [r[part][host] for r in runs[name]]
            cands = (kname,) if isinstance(kname, str) else kname
            regs = next((v for c in cands
                         for k, v in runs[name][0]["ptxas"].items()
                         if c in k), None)
            row[name] = dict(ms=ms, mean=sum(ms) / len(ms), ptxas=regs)
        table[host] = row
        print(f"[rng] {host}: " + "; ".join(
            f"{name} {v['mean']:.4f}"
            + (f" ({v['ptxas'][0]}/{v['ptxas'][1]}/{v['ptxas'][2]}/"
               f"{v['ptxas'][4]})" if v["ptxas"] else "")
            for name, v in row.items()), flush=True)
    result = dict(card=card, trees=trees, table=table,
                  camera="aperture 0" if args.aperture0 else
                  "reference pinhole")
    if args.sass:
        result["sass"] = sass_report(trees, lambda m: print(f"{m} ({card})",
                                                           flush=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
