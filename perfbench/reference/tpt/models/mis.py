"""Recursive MIS bookkeeping (d_vcm / d_vc / d_vm) of the BDPT and VCM walks.

Counterpart of cudapathtracer_tpu/models/mis.py: one step of the
three-case recursion (first bounce, previous vertex delta, general) over
[N] lanes. The device form is kernels/csrc/mis.cuh, which the walk kernel
(K12, bdpt_walk.cu) runs once per vertex.

  pdf_fwd_area  area pdf of generating this vertex from the previous one
  g             prev_cos / distance^2 (conversion to area at the previous)
  pdf_rev_sa    solid-angle pdf of scattering from this vertex back toward
                the previous one

eta_vcm (the VCM merge/connect ratio n_paths pi r^2) enables the d_vm chain
and the eta term of d_vc; None is pure BDPT, where d_vm stays zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MisState(NamedTuple):
    """Per-lane [N] carry of the recursion."""
    d_vcm: torch.Tensor
    d_vc: torch.Tensor
    d_vm: torch.Tensor
    pdf_rev_prev: torch.Tensor   # reverse solid-angle pdf at the previous vertex
    prev_was_delta: torch.Tensor

    @staticmethod
    def zeros(n: int, device="cpu") -> "MisState":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return MisState(z, z, z, z,
                        torch.zeros(n, dtype=torch.bool, device=device))


def advance(state: MisState, depth_is_first, pdf_fwd_area, g, pdf_rev_sa,
            cur_is_delta, first_d_vcm, first_d_vc, first_d_vm=None,
            eta_vcm=None):
    """One step; returns (d_vcm, d_vc, d_vm, new_state). depth_is_first:
    [N] bool or a Python bool; first_*: the seeds of lanes at their first
    vertex after the endpoint."""
    inv_fwd = 1.0 / torch.clamp(pdf_fwd_area, min=1e-20)
    gof = g * inv_fwd
    eta = 0.0 if eta_vcm is None else eta_vcm

    gen_vcm = inv_fwd
    gen_vc = gof * (eta + state.d_vcm + state.pdf_rev_prev * state.d_vc)
    if eta_vcm is not None:
        eta_t = torch.as_tensor(eta, dtype=torch.float32,
                                device=pdf_fwd_area.device)
        gen_vm = gof * (1.0 + state.d_vcm / torch.clamp(eta_t, min=1e-30)
                        + state.pdf_rev_prev * state.d_vm)
    else:
        gen_vm = torch.zeros_like(gen_vcm)

    del_vc = gof * (state.pdf_rev_prev * state.d_vc)
    del_vm = gof * (state.pdf_rev_prev * state.d_vm)

    prev_delta = state.prev_was_delta
    d_vcm = torch.where(prev_delta, 0.0, gen_vcm)
    d_vc = torch.where(prev_delta, del_vc, gen_vc)
    d_vm = torch.where(prev_delta, del_vm, gen_vm)

    first = torch.as_tensor(depth_is_first, device=pdf_fwd_area.device)
    if first_d_vm is None:
        first_d_vm = torch.zeros_like(d_vm)
    d_vcm = torch.where(first, first_d_vcm, d_vcm)
    d_vc = torch.where(first, first_d_vc, d_vc)
    d_vm = torch.where(first, first_d_vm, d_vm)

    new_state = MisState(d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vm,
                         pdf_rev_prev=pdf_rev_sa,
                         prev_was_delta=cur_is_delta)
    return d_vcm, d_vc, d_vm, new_state
