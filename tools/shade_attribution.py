#!/usr/bin/env python3
"""The shading attribution: what the shading transition (K2-K4) and the
merge query (K9) cost the kernels they run in, on copies of a tree that
each carry one change, timed in turns on one GPU.

Each variant is a patch this file carries as text (PATCHES), applied to a
copy of a tree (--parent: the package, configs, tools and chip_smoke.py of
a checkout, e.g. a `git archive` of the parent commit unpacked under
build/); each one tries one candidate cause of the registers and latency
the shading transition costs its hosts:
  aligned   (a) shade_fetch reads its 192-byte row as twelve 16-byte
            loads from a copy of tri_f32 padded to 80 or 96 columns (so
            every row starts 16-byte aligned), not 47 scalar loads;
  matref    (b) the material read field by field from its row at each use
            (Mat holds the row's address, its fields are accessors), not
            carried as 19 words;
  frame     (c) one shading frame per hit in K5 (to_local / to_world of
            the hit and NEE's to_local take it) and one per merge query
            (merge_term takes the vertex's frame), not one per call;
  early     (d) K5's BSDF sample drawn before the NEE shadow trace, not
            after it;
  nomerge   (e) the merge gone: fold_neighbors and the mega merge return
            at once (their share of the two gathers);
and, on the design (--base .), its hosts' blocks of 128 threads an SM
(the design runs K5, the eye walk, K13's pairs and the connections at
kMinBlocks 8, <= 64 registers, and K12's walks at 6, <= 80): occ4 (each
as before the design: K5 and the eye walk at ptxas' own count, K13's
pairs at 4, the others at 5), occ5 ... occ12 (all five at 5, 6, 7, 8, 10
or 12), gatherat4 (the gathers at 4, up to 128 registers); names joined
by + apply several (matref+early).
"design" is this tree, "parent" the --parent checkout as it is. Then it runs
tools/eye_attribution.py --shade (every host) on every tree in turns
(first turn in the order given, the next reversed, ...; --turns), each in
its own process, which builds that tree's kernels and prints ptxas'
registers, stack frame, spills and shared memory of each kernel, and
prints a table of each host's mean milliseconds and ptxas numbers per
tree. Every line names the card and its power limit. Run from the
repository root:

    python3 tools/shade_attribution.py --parent DIR --out build/shade
        [--base DIR] [--variants aligned matref frame early nomerge design]
        [--turns 2] [--reps 3] [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("cudapathtracer_tpu_torch", "kernels", "csrc")
COPY = ("cudapathtracer_tpu_torch", "configs", "tools", "chip_smoke.py")
MAT_FIELDS = ("type|albedo|roughness|eta|k|ior|transmission|is_specular|"
              "boundary|priority|tex_start|tex_width|tex_height|"
              "trans_tex_start|trans_tex_width|trans_tex_height")

_ALIGNED_FETCH = r'''
// The material fields of a shade row already in registers (row[0] is
// column 20).
__device__ __forceinline__ Mat read_mat_regs(const float* r) {
  Mat m;
  m.type = __float_as_int(r[0]);
  m.albedo = v3(r[1], r[2], r[3]);
  m.roughness = r[4];
  m.eta = v3(r[5], r[6], r[7]);
  m.k = v3(r[8], r[9], r[10]);
  m.ior = r[11];
  m.transmission = r[12];
  m.is_specular = __float_as_int(r[13]) != 0;
  m.boundary = __float_as_int(r[14]) != 0;
  m.priority = __float_as_int(r[19]);
  m.tex_start = __float_as_int(r[20]);
  m.tex_width = __float_as_int(r[21]);
  m.tex_height = __float_as_int(r[22]);
  m.trans_tex_start = __float_as_int(r[23]);
  m.trans_tex_width = __float_as_int(r[24]);
  m.trans_tex_height = __float_as_int(r[25]);
  return m;
}

// The shading record of a closest hit, its row read as twelve float4s
// (tri_cols 80 or 96: the row starts 16-byte aligned).
__device__ __forceinline__ ShadeHit shade_fetch(const float* __restrict__ tri_f32,
                                                int tri_cols, int32_t tri,
                                                float u, float v, V3 o, V3 d,
                                                float t) {
  const float4* q = reinterpret_cast<const float4*>(
      tri_f32 + static_cast<int64_t>(tri > 0 ? tri : 0) * tri_cols + 28);
  float row[48];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float4 x = __ldg(q + j);
    row[4 * j] = x.x;
    row[4 * j + 1] = x.y;
    row[4 * j + 2] = x.z;
    row[4 * j + 3] = x.w;
  }
  ShadeHit s;
  const float w0 = 1.0f - u - v;
  const V3 na = v3(row[0], row[1], row[2]), nb = v3(row[3], row[4], row[5]),
           nc = v3(row[6], row[7], row[8]);
  V3 nrm = normalize(add(add(scale(na, w0), scale(nb, u)), scale(nc, v)));
  s.backface = dot(nrm, d) > 0.0f;
  s.normal = s.backface ? neg(nrm) : nrm;
  s.uv0 = row[9] * w0 + row[11] * u + row[13] * v;
  s.uv1 = row[10] * w0 + row[12] * u + row[14] * v;
  s.point = add(o, scale(d, t));
  s.emission = v3(row[15], row[16], row[17]);
  s.light_ind = __float_as_int(row[18]);
  s.mat_id = __float_as_int(row[19]);
  s.normal_a = na;
  s.area = row[46];
  s.mat = read_mat_regs(row + 20);
  return s;
}

}  // namespace tpt
'''

_MAT_REF = r'''struct Mat {
  const float* r;  // the material's fields (shade-row columns 20:46)
  __device__ __forceinline__ int32_t type() const {
    return __float_as_int(__ldg(r));
  }
  __device__ __forceinline__ V3 albedo() const {
    return v3(__ldg(r + 1), __ldg(r + 2), __ldg(r + 3));
  }
  __device__ __forceinline__ float roughness() const { return __ldg(r + 4); }
  __device__ __forceinline__ V3 eta() const {
    return v3(__ldg(r + 5), __ldg(r + 6), __ldg(r + 7));
  }
  __device__ __forceinline__ V3 k() const {
    return v3(__ldg(r + 8), __ldg(r + 9), __ldg(r + 10));
  }
  __device__ __forceinline__ float ior() const { return __ldg(r + 11); }
  __device__ __forceinline__ float transmission() const {
    return __ldg(r + 12);
  }
  __device__ __forceinline__ bool is_specular() const {
    return __float_as_int(__ldg(r + 13)) != 0;
  }
  __device__ __forceinline__ bool boundary() const {
    return __float_as_int(__ldg(r + 14)) != 0;
  }
  __device__ __forceinline__ int32_t priority() const {
    return __float_as_int(__ldg(r + 19));
  }
  __device__ __forceinline__ int32_t tex_start() const {
    return __float_as_int(__ldg(r + 20));
  }
  __device__ __forceinline__ int32_t tex_width() const {
    return __float_as_int(__ldg(r + 21));
  }
  __device__ __forceinline__ int32_t tex_height() const {
    return __float_as_int(__ldg(r + 22));
  }
  __device__ __forceinline__ int32_t trans_tex_start() const {
    return __float_as_int(__ldg(r + 23));
  }
  __device__ __forceinline__ int32_t trans_tex_width() const {
    return __float_as_int(__ldg(r + 24));
  }
  __device__ __forceinline__ int32_t trans_tex_height() const {
    return __float_as_int(__ldg(r + 25));
  }
};'''

_OLD_MAT = '''struct Mat {
  int32_t type;
  V3 albedo;
  float roughness;
  V3 eta, k;
  float ior, transmission;
  bool is_specular, boundary;
  int32_t priority;
  int32_t tex_start, tex_width, tex_height;
  int32_t trans_tex_start, trans_tex_width, trans_tex_height;
};'''

_OLD_READ_MAT = '''__device__ __forceinline__ Mat read_mat(const float* r) {
  Mat m;
  m.type = row_i32(r, 0);
  m.albedo = row_v3(r, 1);
  m.roughness = __ldg(r + 4);
  m.eta = row_v3(r, 5);
  m.k = row_v3(r, 8);
  m.ior = __ldg(r + 11);
  m.transmission = __ldg(r + 12);
  m.is_specular = row_i32(r, 13) != 0;
  m.boundary = row_i32(r, 14) != 0;
  m.priority = row_i32(r, 19);
  m.tex_start = row_i32(r, 20);
  m.tex_width = row_i32(r, 21);
  m.tex_height = row_i32(r, 22);
  m.trans_tex_start = row_i32(r, 23);
  m.trans_tex_width = row_i32(r, 24);
  m.trans_tex_height = row_i32(r, 25);
  return m;
}'''

_OLD_FETCH_START = '''// The shading record of a closest hit (tri >= 0; a miss reads row 0, as the
// plain version's clamp does, and its record is not used).'''

_K5_SAMPLE = '''  // BSDF sampling
  const BasedDraws bd{&e, kDBsdf};
  const Sample bs =
      bsdf_sample(bd, m, albedo, neg(wi_local), s.backface, st.eta_i, trans);
  const float pdf = fmaxf(bs.pdf, 0.01f);
'''

# Each variant: a list of (file under the copy, text, replacement, times it
# occurs); a text starting with "re:" is a regular expression applied to
# every file under CSRC whose name matches the file glob (times: at least).
PATCHES = {
    "aligned": [
        ("cudapathtracer_tpu_torch/scene/scene.py",
         "tri_f32=put(host.tri_f32)",
         "tri_f32=put(np.pad(host.tri_f32, ((0, 0), (0, 2))))", 1),
        ("cudapathtracer_tpu_torch/kernels/__init__.py",
         "tri_f32.shape[1] not in (78, 94)",
         "tri_f32.shape[1] not in (78, 80, 94, 96)", 1),
        ("cudapathtracer_tpu_torch/kernels/__init__.py",
         '"tri_f32": (78, 94)', '"tri_f32": (78, 80, 94, 96)', 1),
        (CSRC + "/shade.cuh", _OLD_FETCH_START,
         "#if 0\n" + _OLD_FETCH_START, 1),
        (CSRC + "/shade.cuh", "  return s;\n}\n\n}  // namespace tpt\n",
         "  return s;\n}\n#endif\n" + _ALIGNED_FETCH, 1),
    ],
    "matref": [
        (CSRC + "/shade.cuh", _OLD_MAT, _MAT_REF, 1),
        (CSRC + "/shade.cuh", _OLD_READ_MAT,
         "__device__ __forceinline__ Mat read_mat(const float* r) {\n"
         "  Mat m;\n  m.r = r;\n  return m;\n}", 1),
        ("re:*.cu*", r"\b(m|me|ml|e\.m|s\.mat)\.(" + MAT_FIELDS + r")\b",
         r"\1.\2()", 40),
    ],
    "frame": [
        (CSRC + "/shade.cuh", "// ---- the hit fetch ---",
         "__device__ __forceinline__ V3 to_local_f(V3 v, V3 t, V3 b, V3 n) {\n"
         "  return v3(dot(v, t), dot(v, b), dot(v, n));\n}\n\n"
         "__device__ __forceinline__ V3 to_world_f(V3 v, V3 t, V3 b, V3 n) {\n"
         "  return add(add(scale(t, v.x), scale(b, v.y)), scale(n, v.z));\n"
         "}\n\n// ---- the hit fetch ---", 1),
        (CSRC + "/nee.cuh",
         "    const Mat& m, V3 albedo, float eta_i, bool active, "
         "float transmission) {",
         "    const Mat& m, V3 albedo, float eta_i, bool active, "
         "float transmission,\n    V3 ft, V3 fb) {", 1),
        (CSRC + "/nee.cuh", "  ns.wo_local = to_local(wi, normal);",
         "  ns.wo_local = to_local_f(wi, ft, fb, normal);", 1),
        (CSRC + "/uni_mega.cu",
         "  const Mat& m = s.mat;\n  const V3 wi_local = to_local(d, s.normal);",
         "  const Mat& m = s.mat;\n  V3 ft, fb;\n"
         "  build_frame(s.normal, ft, fb);\n"
         "  const V3 wi_local = to_local_f(d, ft, fb, s.normal);", 2),
        (CSRC + "/uni_mega.cu", "wi_local, m, albedo, st.eta_i, true,\n"
         "                                      trans);",
         "wi_local, m, albedo, st.eta_i, true,\n"
         "                                      trans, ft, fb);", 1),
        (CSRC + "/uni_mega.cu",
         "h.t);\n  const V3 wi_local = to_local(d, s.normal);",
         "h.t);\n  V3 ft, fb;\n  build_frame(s.normal, ft, fb);\n"
         "  const V3 wi_local = to_local_f(d, ft, fb, s.normal);", 1),
        (CSRC + "/uni_mega.cu", "  d = to_world(bs.wo, s.normal);",
         "  d = to_world_f(bs.wo, ft, fb, s.normal);", 1),
        (CSRC + "/uni_mega.cu",
         "    d = normalize(to_world(bs.wo, s.normal));",
         "    d = normalize(to_world_f(bs.wo, ft, fb, s.normal));", 1),
        (CSRC + "/uni_mega.cu",
         "tri >= 0 && !emissive && !m.is_specular, trans);",
         "tri >= 0 && !emissive && !m.is_specular, trans, ft,"
         " fb);", 1),
        (CSRC + "/vcm.cuh",
         "                                         const Photon& ph, float eta,\n"
         "                                         float& weight) {\n"
         "  const V3 wi_loc = to_local(ph.wi, e.n);",
         "                                         const Photon& ph, float eta,\n"
         "                                         float& weight, V3 ft, V3 fb) {\n"
         "  const V3 wi_loc = to_local_f(ph.wi, ft, fb, e.n);", 1),
        (CSRC + "/eye.cuh",
         "        const V3 prev_loc = to_local(e.to_prev, e.n);\n",
         "        const V3 prev_loc = to_local(e.to_prev, e.n);\n"
         "        V3 ft, fb;\n        build_frame(e.n, ft, fb);\n", 1),
        (CSRC + "/eye.cuh",
         "merge_term(e, prev_loc, ph, eta, weight);",
         "merge_term(e, prev_loc, ph, eta, weight, ft, fb);", 1),
        (CSRC + "/mega.cuh",
         "  const V3 prev_loc = to_local(e.to_prev, e.n);\n",
         "  const V3 prev_loc = to_local(e.to_prev, e.n);\n"
         "  V3 ft, fb;\n  build_frame(e.n, ft, fb);\n", 1),
        (CSRC + "/mega.cuh", "merge_term(e, prev_loc, ph, eta, weight);",
         "merge_term(e, prev_loc, ph, eta, weight, ft, fb);", 1),
    ],
    "early": [
        (CSRC + "/uni_mega.cu", _K5_SAMPLE, "", 1),
        (CSRC + "/uni_mega.cu", "  if (p.use_mis) {\n",
         _K5_SAMPLE + "  if (p.use_mis) {\n", 1),
    ],
    # the hosts' blocks of 128 threads an SM on the design (--base: the
    # tree they patch), which runs K5, the eye walk, K13's pairs and the
    # connections at kMinBlocks 8 (<= 64 registers) and K12's walks at 6:
    # each as before the design (occ4: K5 and the eye walk at ptxas' own
    # count, K13's pairs at 4, the others at 5), or all five at 5 ... 12
    "occ4": [("re:" + f, r"kMinBlocks = \d+", f"kMinBlocks = {b}", 1)
             for f, b in (("uni_mega.cu", 1), ("eye_walk.cu", 1),
                          ("bdpt_pairs.cu", 4), ("eye_connect.cu", 5),
                          ("bdpt_walk.cu", 5))],
    **{f"occ{b}": [("re:" + f, r"kMinBlocks = \d+", f"kMinBlocks = {b}", 1)
                   for f in ("uni_mega.cu", "eye_walk.cu", "bdpt_pairs.cu",
                             "eye_connect.cu", "bdpt_walk.cu")]
       for b in (5, 6, 7, 8, 10, 12)},
    "gatherat4": [(CSRC + "/eye_gather.cu", "__launch_bounds__(kThreads)\n",
                   "__launch_bounds__(kThreads, 4)\n", 1)],
    "nomerge": [
        (CSRC + "/hashgrid.cuh",
         "                                                  Fold&& fold) {\n",
         "                                                  Fold&& fold) {\n"
         "  if (g.cap > 0) return 0;\n", 1),
        (CSRC + "/mega.cuh",
         "                                         int32_t& dropped) {\n",
         "                                         int32_t& dropped) {\n"
         "  if (g.cap > 0) return v3(0.0f, 0.0f, 0.0f);\n", 1),
    ],
}
# the kernels of each host (substrings of their mangled names, or the
# first of several found: K5's wide build, or its one build before; the
# BVH8 instantiation unless the host says threaded)
HOSTS = {"K2-K4 entry (shade_eval)": "shade_eval_kernel",
         "K5 mega": ("uni_mega_kernelILi0ELi8E", "uni_mega_kernelILi0EE"),
         "K5 classic": ("uni_mega_kernelILi0ELi8E", "uni_mega_kernelILi0EE"),
         "K5 naive": ("uni_mega_kernelILi0ELi8E", "uni_mega_kernelILi0EE"),
         "K5 classic threaded": ("uni_mega_kernelILi1ELi8E",
                                 "uni_mega_kernelILi1EE"),
         "K12 light walk": "bdpt_walk_kernelILi0E",
         "K12 eye walk": "bdpt_walk_kernelILi0E",
         "K11 trace": "splat_trace_kernelILi0E",
         "K13 pairs": "bdpt_pairs_kernelILi0E",
         "eye walk": "eye_walk_kernelILi0ELi0E",
         "eye connect": "eye_connect_kernelILi0ELi0E",
         "eye gather": "eye_gather_kernelILi0E",
         "K14 walk (chunk 0)": "eye_walk_kernelILi1ELi0E",
         "K14 connect (chunk 0)": "eye_connect_kernelILi1ELi0E",
         "K14 gather (chunk 0)": "eye_gather_kernelILi1E",
         "K9 entry (neighbor_slots)": "slots_kernel"}


def _names():
    for v in HOSTS.values():
        yield from ((v,) if isinstance(v, str) else v)


def _apply(dst: str, part: str, patches: dict | None = None) -> None:
    for fname, old, new, times in (patches or PATCHES)[part]:
        if fname.startswith("re:"):
            glob = re.compile(fname[3:].replace(".", r"\.")
                              .replace("*", ".*") + "$")
            total = 0
            cdir = os.path.join(dst, CSRC)
            for name in sorted(os.listdir(cdir)):
                if not glob.match(name):
                    continue
                path = os.path.join(cdir, name)
                with open(path) as f:
                    src = f.read()
                src, k = re.subn(old, new, src)
                total += k
                with open(path, "w") as f:
                    f.write(src)
            if total < times:
                raise SystemExit(f"FAIL: {part}: {total} matches of {old!r}, "
                                 f"fewer than {times}")
            continue
        path = os.path.join(dst, fname)
        with open(path) as f:
            src = f.read()
        if src.count(old) != times:
            raise SystemExit(f"FAIL: {part}: {src.count(old)} of {old!r} in "
                             f"{path}, not {times}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))


def make_variant(parent: str, out: str, name: str,
                 patches: dict | None = None) -> str:
    """A copy of the tree `parent` with the patches of variant `name`
    (names joined by + apply several) from `patches` (PATCHES)."""
    patches = patches or PATCHES
    dst = os.path.join(out, name)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    for item in COPY:
        src = os.path.join(parent, item)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, item),
                            ignore=shutil.ignore_patterns("__pycache__",
                                                          "build"))
        else:
            shutil.copy2(src, dst)
    for part in name.split("+"):
        if part not in patches:
            raise SystemExit(f"FAIL: no variant {part!r} (have "
                             f"{', '.join(patches)})")
        _apply(dst, part, patches)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", required=True, help="the checkout the "
                    "patches apply to, also timed as it is")
    ap.add_argument("--out", required=True, help="where the copies go (a "
                    "directory .gitignore lists, e.g. build/shade)")
    ap.add_argument("--base", default=None, help="the checkout the patches "
                    "apply to (default: --parent)")
    ap.add_argument("--variants", nargs="+", default=[
        "aligned", "matref", "frame", "early", "nomerge"])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only-make", action="store_true", help="make the "
                    "copies and stop (needs no GPU)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    parent = os.path.abspath(args.parent)
    base = os.path.abspath(args.base) if args.base else parent
    trees = {"parent": parent}
    for name in args.variants:
        trees[name] = (ROOT if name == "design"
                       else make_variant(base, out, name))
    if args.only_make:
        print("\n".join(f"{k}: {v}" for k, v in trees.items()))
        return 0
    tool = os.path.join(ROOT, "tools", "eye_attribution.py")
    runs = {name: [] for name in trees}
    order = list(trees)
    for turn in range(args.turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            res = os.path.join(out, f"{name}.{turn}.json")
            cmd = [sys.executable, tool, "--root", trees[name], "--shade",
                   "--reps", str(args.reps), "--json", res]
            if turn > 0:
                cmd.append("--reuse-build")
            print(f"[shade] turn {turn}: {name} ({trees[name]})", flush=True)
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1800)
            for line in p.stdout.splitlines():
                if line.startswith(("[shade]", "FAIL")) or (
                        turn == 0 and line.startswith("[attribution] ptxas")
                        and any(h in line for h in _names())):
                    print(f"  {line}", flush=True)
            if p.returncode != 0:
                print(p.stdout[-4000:], p.stderr[-4000:])
                raise SystemExit(f"FAIL: {name}, turn {turn}: exit "
                                 f"{p.returncode}")
            with open(res) as f:
                runs[name].append(json.load(f))
    card = runs[order[0]][0]["card"]
    table = {}
    print(f"[shade] mean ms over {args.turns} turns (registers / stack "
          f"bytes / spill stores / shared bytes of the host's kernel); "
          f"{card}")
    for host, kname in HOSTS.items():
        row = {}
        for name in order:
            ms = [r["shade"][host] for r in runs[name]]
            cands = (kname,) if isinstance(kname, str) else kname
            regs = next((v for c in cands
                         for k, v in runs[name][0]["ptxas"].items()
                         if c in k), None)
            row[name] = dict(ms=ms, mean=sum(ms) / len(ms), ptxas=regs)
        table[host] = row
        print(f"[shade] {host}: " + "; ".join(
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
