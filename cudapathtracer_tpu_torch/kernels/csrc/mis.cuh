// K12 device code: one step of the recursive MIS bookkeeping (d_vcm, d_vc,
// d_vm) of a BDPT or VCM walk.
//
// Replaces cudapathtracer_tpu/models/mis.py:advance (line 41), the
// three-case recursion (first vertex after the endpoint: the seeds;
// previous vertex delta: only the pdf_rev * d_vc chain; general). use_vm
// turns on the VCM extension, the d_vm chain and the eta_vcm term of d_vc;
// without it d_vm stays zero (pure BDPT). The walk kernel (bdpt_walk.cu)
// calls it once per vertex, in registers.
//
// Arithmetic in the order of models/mis.py (built with -fmad=false).
#pragma once

namespace tpt {

struct MisState {
  float d_vcm, d_vc, d_vm;
  float pdf_rev_prev;  // reverse solid-angle pdf at the previous vertex
  bool prev_was_delta;
};

// Advances `s` in place past this vertex and returns the vertex's values
// (d_vcm, d_vc, d_vm in the returned state).
__device__ __forceinline__ MisState mis_advance(
    MisState& s, bool first, float pdf_fwd_area, float g, float pdf_rev_sa,
    bool cur_is_delta, float first_d_vcm, float first_d_vc,
    float first_d_vm, bool use_vm, float eta_vcm) {
  const float inv_fwd = 1.0f / fmaxf(pdf_fwd_area, 1e-20f);
  const float gof = g * inv_fwd;
  const float eta = use_vm ? eta_vcm : 0.0f;
  MisState v;
  if (first) {
    v.d_vcm = first_d_vcm;
    v.d_vc = first_d_vc;
    v.d_vm = first_d_vm;
  } else if (s.prev_was_delta) {
    v.d_vcm = 0.0f;
    v.d_vc = gof * (s.pdf_rev_prev * s.d_vc);
    v.d_vm = gof * (s.pdf_rev_prev * s.d_vm);
  } else {
    v.d_vcm = inv_fwd;
    v.d_vc = gof * (eta + s.d_vcm + s.pdf_rev_prev * s.d_vc);
    v.d_vm = use_vm ? gof * (1.0f + s.d_vcm / fmaxf(eta, 1e-30f) +
                             s.pdf_rev_prev * s.d_vm)
                    : 0.0f;
  }
  v.pdf_rev_prev = pdf_rev_sa;
  v.prev_was_delta = cur_is_delta;
  s = v;
  return v;
}

}  // namespace tpt
