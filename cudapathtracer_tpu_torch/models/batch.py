"""Samples per dispatch: k samples of an integrator in one dispatch.

Counterpart of cudapathtracer_tpu/models/batch.py:make_batched. The JAX
package runs k samples of the per-sample step in one jitted fori_loop, so
that a small frame pays the dispatch floor once per k samples; the
reference batches its CUDA-graph replays for the same reason. The image
is the k single samples summed: every draw is keyed by (sample index,
pixel id), so sample s computes the same floats alone or inside a batch.

On the card there are two forms, both without a host sync inside the
batch:
  * an integrator whose sample is ONE launch of K5 (UNIDIRECTIONAL with
    either engine, NAIVE_UNIDIRECTIONAL) gives its step a `k_sample`
    attribute: the batch is one launch of K5 with k samples
    (kernels/csrc/uni_mega.cu), never k launches;
  * the multi-launch integrators (BIDIRECTIONAL, VCM and SPPM with either
    engine) queue the k samples' launches on the current stream one after
    the other. Their steps return the ray and dropped counts as 0-d int64
    tensors on the card, so nothing waits for the card, and each sample's
    buffers are freed before the next sample allocates its own (the
    caching allocator reuses them): peak memory stays at one sample's.
On CPU tensors the loop below is the plain version of both.

The radiance is summed in sample order from zeros, as the JAX fori_loop
sums it (so K5 with k samples is bit-equal to k launches of one sample
summed in that order). The counters are summed as int64: the JAX loop's int32
totals wrap above 2^31 (a 1080p VCM sample alone drops ~1.2 x 10^10 merge
candidates).
"""

from __future__ import annotations

import torch


def make_batched(inner):
    """Wrap a per-sample step into a k-sample dispatch.

    inner(scene, camera, base_key, sample_idx, px, py) -> (li [P,3], rays,
    *counters), the counts as Python ints or 0-d int64 tensors; optionally
    inner.k_sample(scene, camera, base_key, s0, px, py, k) -> (li_sum,
    rays), the step's one-launch batch on CUDA tensors.

    Returns batched(scene, camera, base_key, s0, px, py, k) -> (li_sum
    [P,3] f32, rays, *counters) over samples s0 .. s0+k-1, each count a 0-d
    int64 tensor on the pixels' device."""
    k_sample = getattr(inner, "k_sample", None)

    def batched(scene, camera, base_key, s0: int, px, py, k: int):
        if k < 1:
            raise ValueError(f"a batch holds k >= 1 samples, got {k}")
        if k_sample is not None and px.device.type != "cpu":
            return k_sample(scene, camera, base_key, s0, px, py, k)
        return batched_loop(inner, scene, camera, base_key, s0, px, py, k)

    return batched


def batched_loop(inner, scene, camera, base_key, s0: int, px, py, k: int):
    """The k samples one after the other: acc = acc + li_s from zeros, in
    sample order, and each counter summed as an int64 tensor. The plain
    version on CPU tensors; on CUDA tensors the multi-launch form."""
    acc = torch.zeros((px.shape[0], 3), dtype=torch.float32,
                      device=px.device)
    totals = None
    for s in range(s0, s0 + k):
        out = inner(scene, camera, base_key, s, px, py)
        acc = acc + out[0]
        if totals is None:
            totals = [torch.zeros((), dtype=torch.int64, device=px.device)
                      for _ in out[1:]]
        totals = [t + c for t, c in zip(totals, out[1:])]
        del out   # this sample's buffers go back before the next allocates
    return (acc, *totals)
