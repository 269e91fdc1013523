#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (cudapathtracer_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

needs one card; `python3 chip_smoke.py --sharded` builds the kernels and
runs phase 35b-c alone, over every visible card (on a machine with n >= 2
cards it adds (n,1) and (n/2,2) meshes, one card a rank).

Phases (one line each; any failure exits non-zero before the result line):
  1. a CUDA card is required; print nvidia-smi's name and power limit;
  2. build the kernels from kernels/csrc into build/torch_ext (one nvcc per
     source, all at once); print the build seconds and each kernel's
     registers, stack frame and spill bytes (ptxas), those of the kernels
     K1 runs in also on K1's rows of the kernels line;
  3. K6 (rng.cu) against its plain version on 2,073,600 ids: bit-equal;
     timed by CUDA graph replay (graph_ms: the device's time; a call from
     the host, by CUDA events, is printed beside it); the bound's INT32
     rate (64 lanes x the SMs x clocks.max.sm) and the
     cipher's SASS (cuobjdump of rng.cu's keyed draw kernel) are printed
     first; 3b. each key table the hosts' prologues fold on the card
     (keys.cuh: K5's draw-key tables of its three schedules, K12's, the
     classic eye walk's, K13's s=1 table) bit-equal to its plain builder;
  4. K7 (camera.cu) against its plain version at 1920x1080 on the
     reference pinhole (aperture 1e-6, the lens live), a camera of aperture
     0 (no lens; every origin the camera's) and a thin lens: max abs
     <= 1e-6, each timed as K6;
  5. K1 (traverse8.cu) against its plain version on the ~82k-triangle
     Cornell + bunny scene: closest hits of the 1080p primary rays and of
     random secondary rays (ids equal on >= 99.99% of rays, every mismatch
     an edge tie with |dt| <= 1e-5 t; t/u/v within 1e-5 where ids match),
     shadow factors of NEE-like rays on that scene and on its MAT_LEAF
     variant (within 1e-5); restart counts equal the plain version's, and
     a 7-entry-stack build of traverse8.cu must overflow and restart on
     grazing rays and still match the plain version at that depth;
  6. shade_eval (the K2-K4 device code of uni_mega.cu) against the plain
     K2-K4 functions on ~1M hits of the 1080p bunny scene and of its
     MAT_LEAF variant, under tests/test_torch_bsdf.py's per-element bounds
     (see compare_shade_eval); the worst error of each output is printed;
  7. K5, the megakernel (uni_mega.cu), against its plain version
     (models/unidirectional.render_plain, whose traversal and draws go
     through K1 and K6, held to their own plain versions above) at
     1920x1080, 1 spp, both draw schedules (the mega one retiring each path
     through RGB9E5 in both versions), and at 256x256 on the mirror +
     glass spheres scene (the medium stack): rays within 0.1%, image mean
     ratio within 1e-3, >= 99% of pixels within rtol 1e-3; 7b. K5's path
     regeneration: the resident grid (SMs x the blocks that fit on one)
     bit-equal to one block per SM (li, rays, rows) at 1080p for the
     three schedules, and the lane use and event balance the card
     counted;
  8. the goldens on the card through the megakernel (16x16, 8 spp): mega
     against tests/golden/cornell_mega_16x16_8spp.npy and classic against
     cornell_uni_16x16_8spp.npy, each at rmse < 1e-3;
  9. the main path: driver.Renderer on configs/cornell.rendertron as
     shipped (the default mega engine), the bunny scene, 1920x1080, depth
     8, 4 spp; the image must be finite, free of NaN/Inf/negative pixels
     and > 90% non-black, and the megakernel must have launched during it;
     then the same with Engine classic (its path, with its own counts);
 10. K10 (packing.cu) against the plain codecs on 2,073,600 unit vectors,
     betas and flag words: bit-equal both ways;
 11. K12 (bdpt_walk.cu), the light and eye walks of the 1080p bunny scene
     at the config's depths (eye 8, light 6), against the plain walks
     (compare_walk: at most 0.1% of lanes diverged, printed; `valid` and
     flags equal on the rest, each other field within its bound on >=
     99.9% of the vertices); ray counts within 0.1%; K12's path
     regeneration (walk_grids): the resident grid bit-equal, in every
     output (the buffers' dead rows included, v0, the escape record, rays,
     rows), to one block per SM, and the lane use and event balance the
     card counted;
 12. K11 (bdpt_splat.cu) and 13. K13 (bdpt_pairs.cu, bdpt_gather.cu) on
     the kernel walk's buffers against their plain versions on the same
     buffers (compare_image: rays within 0.1%, image mean within 1e-3, >=
     99.9% / 99.5% of pixels within rtol 1e-3; K11's rays equal the plain
     count; K11's first stage against its twin, splat_queue_plain, with
     every path and with n_live < N: the same entries in every screen
     tile (splat_stages), each stage timed; compare_k13: the pairs'
     terms over the valid non-delta eye vertices and the gather on the
     kernel's terms against their plain twins, the composed pass with the
     splat's frame buffer against connect_plain, each at 99.5%; the pairs
     at one and at all of a pixel's pairs a thread bit-equal); the splat
     twice, to print the spread from atomicAdd's order; each K13 stage
     timed; then K12, K11 and K13 again on the 256x256 mirror + glass
     spheres scene with each strategy flag of BDPT_FLAGS set in turn, and
     the light walk with VCM's d_vm chain (eta_vcm) on (compare_bdpt);
 14. the BDPT golden through the four kernels: rmse < 1e-3 against
     tests/golden/cornell_bdpt_16x16_8spp.npy, mean ratio printed;
 15. the BDPT main path: Renderer on the same config with Integrator
     BIDIRECTIONAL and Engine classic at its own depths, the bunny scene,
     1920x1080, 4 spp: rays, render-phase seconds, Mrays/s, peak memory,
     5 launches per sample (K12 twice, K11, K13's two stages), finite,
     non-negative and > 90% non-black; then one sample's five launches
     timed with CUDA events;
 16. the photon family (compare_vcm) on the VCM main path's sample
     (1920x1080 bunny, eye 8, light 6: 12,441,600 candidate photons, a
     table above 2^24 buckets): K12's light walk with eta_vcm, then
     vcm_splat (K11's VCM form, its rays equal the plain count, its first
     stage against its twin as in phase 12) and vcm_eye (K13's VCM form
     with the K9 merge, three stage kernels) against their plain versions
     on the same
     buffers and grid (rays within 0.1%, image mean within 1e-3, >= 99.9% /
     99.5% of pixels within rtol 1e-3, dropped photons equal), then each
     stage against its plain twin on the same inputs (compare_eye_stages:
     the walk's records under compare_records, its lane counters (a bounce
     a record; the lane use and event balance printed beside K12's), the
     connections over the live pairs and the gather under compare_image at
     99.5%, rays and dropped photons equal), K8 (photon_pack, the hand-written stable
     radix sort photon_sort on the buckets, which derives each photon's
     key, photon_table) bit-equal to build_grid, the sort's order and
     sorted buckets equal to torch.sort's on the same keys (int64 and
     sign-flipped int32, both timed as its library calls) and its twin's
     (compare_photon_sort); the same for SPPM, and for VCM
     on the 512x512 mirror + glass spheres at the caustics config's depths
     (samples 0 and 1); each kernel and stage timed at the 1080p shapes,
     the 1080p splat twice to print the spread from atomicAdd's order;
 17. the VCM and SPPM goldens through the kernels (rmse < 1e-3);
 18. the photon main paths through Renderer: Integrator VCM and SPPM with
     Engine classic on the same config (1080p bunny, 4 spp), then
     configs/vcm_caustics.rendertron with Engine classic at 4 spp: rays,
     render-phase seconds, Mrays/s, peak memory, launches per sample (K12,
     vcm_splat, photon_pack, photon_sort, photon_table, vcm_eye; SPPM
     without the splat), merge-cap dropped photons; finite,
     non-negative, > 90% non-black;
 19. one 1080p VCM sample's launches timed with CUDA events (the eye
     pass stage by stage);
 20. K10's RGB9E5 mode (packing.cu) bit-equal to the plain codec on
     2,073,600 colours, edge values included;
 21. K14 (its three stages, eye_walk.cu, eye_connect.cu, eye_gather.cu)
     against its plain version (compare_mega) on both chunks of the 1080p
     sample in the VCM, SPPM and BDPT flavours, on the kernels' light
     walks and grids (rays and dropped photons equal, >= 99.9% of pixels
     within rtol 1e-3, the bit-equal share printed), each stage against
     its plain twin as in phase 16; K9's
     materialised forms (neighbor_slots.cu: neighbor_slots,
     neighbor_slots_compact, gather_neighbors) bit-equal to their plain
     versions on chunk 0's grid and first-bounce hit points, one-brick and
     standard; K14 on the caustics config as shipped (512x512, one chunk
     with 10,016 pad paths), samples 0 and 1;
 22. the naive integrator (uni_mega.cu's naive schedule) against its plain
     version at 1080p, depth 8 (as phase 7);
 23. the default-engine main paths through Renderer: Integrator VCM, SPPM
     and BIDIRECTIONAL with no Engine line on the same config (1080p bunny,
     4 spp, two chunks a sample: per chunk K12, the splat, photon_pack,
     photon_sort, photon_table and mega_eye; SPPM without the splat; BDPT
     K12, bdpt_splat, mega_eye), configs/vcm_caustics.rendertron as shipped
     at 4 spp (one chunk), and NAIVE_UNIDIRECTIONAL at depth 8 (one launch
     a sample; > 5% non-black, its image being sparse): rays, render-phase
     Mrays/s, peak memory, launches per sample;
 24. one 1080p VCM-mega and one BDPT-mega sample's launches timed with
     CUDA events (K14 stage by stage);
 25. K5 with k samples a launch (samples per dispatch, models/batch.py)
     bit-equal to k launches of one sample summed in sample order and to
     the launch of k on one block per SM: the bunny scene at 512x512 with
     k = 8 for the mega, classic and naive schedules and at 1080p with k =
     4 for mega; CUDA events of the batch against the singles;
 26. K6's keyed mode bit-equal to uniform_keyed's plain version on
     2,073,600 ids with per-lane key pairs; K12's table mode (the keyed
     light walk of models/light_mega.py, its table folded on the host)
     bit-equal to the walk on the table its prologue folds, on
     chunk 0 of the 1080p mega partition (1,036,800 light paths), VCM and
     BDPT flavours, both timed, and against its plain version (the classic
     walk drawing from the same tables; compare_walk, rays within 0.1%),
     and its path regeneration as in phase 11 (walk_grids);
 27. the batched main path: configs/vcm_caustics.rendertron as shipped
     (512x512, VCM-mega, 256 samples, 8 per dispatch by the auto rule)
     through cli.main with the checks on and a 1 s save interval, so
     that the checks run at the progressive saves (Mrays/s, K14
     launches, the checks summary); the same at 16 samples, 1 against 8 per dispatch
     (rays and dropped photons equal, the int64 dropped total against its
     int32 wrap; pixels within 1e-5 + 1e-5 |x|); VCM-mega at 1080p, 2
     samples, 1 against 2 per dispatch (the same equalities, and a batched
     dropped total above 2^31); UNIDIRECTIONAL-mega and
     NAIVE at 256x256 on cornell_blocks, 256 samples, 1 against 8 per
     dispatch (256 against 32 K5 launches), and there B1: one K5 launch of
     8 samples timed, its bound, and held against the plain batch
     (batch.py's loop over K5's plain version, compared as phase 7
     compares K5); one batch of every integrator
     and engine under torch.cuda's sync debug mode "error" (no host sync
     inside a batch, int64 counts on the card);
 28. TPT_MEGA_LIGHT=1: BDPT-mega and VCM-mega at 1080p, 1 sample each,
     routed through light_mega (K12's table mode), against the toggle-off
     render (rays equal, pixels within the splat's atomic spread);
 29. BDPT_DRAWPATH on the 1080p BIDIRECTIONAL render: the overlay from
     K12's eye walk equals the one drawn from the plain walk's paths, and
     the image changes only under it;
 30. K15, the threaded binary engine (traverse_bin.cu), against its plain
     version on the bunny scene built with traversal="threaded" (no SBVH,
     93k binary nodes; the tables it walks, derived from node_packed at
     upload, and their size printed): the 1080p primary rays, random
     secondary rays (max_t, skip_tri) and NEE-like shadow rays, and shadow
     rays on its MAT_LEAF variant, under phase 5's criteria; the kernel's rows a ray
     equal to the plain walk's on >= 99.99% of the rays, printed against
     K1's on the same rays, and the plain walk's triangle tests, which
     with the rows make the bound's operations;
 31. K5's classic and naive schedules on that scene (their threaded
     instantiations) against their plain versions at 1080p, 1 spp, under
     phase 7's criteria; 31b. K12's threaded instantiation (the light walk
     with and without eta_vcm, the eye walk) under phase 11's walk_grids;
 32. the threaded main path: each classic integrator (UNIDIRECTIONAL,
     NAIVE_UNIDIRECTIONAL, BIDIRECTIONAL, VCM, SPPM at the config's
     depths) through its render_sample on the threaded 1080p scene, 4 spp,
     and the same on the BVH8 engine of the same scene: rays, Mrays/s,
     peak memory, launches per sample (every launch a threaded
     instantiation), rows a ray on each engine and one sample of each
     timed with CUDA events; the two images under compare_image (99% of
     the pixels; VCM and SPPM by rays and mean, since their capped merge
     windows shift with any photon that differs; their light walks at the
     same points on >= 99.999% of the vertices, and on the same light
     buffers the VCM splat at 99% of the pixels and the eye pass at 99.5%
     on the same grid);
 33. the unidirectional golden through K5's threaded instantiation (16x16,
     8 spp, threaded cornell_with_blocks) at rmse < 1e-3;
 34. the attribution of the eye passes (tools/eye_attribution.py): one
     1080p sample's classic VCM and SPPM passes and K14's VCM and BDPT
     flavours, and (34b, after phase 33) the classic VCM pass on the
     threaded scene, timed with the connections, the merge and NEE off in
     turn and with the connections and merge off together (timed only:
     each toggle changes the estimator);
 35. tile x spp rendering over a mesh of ranks (parallel/sharding.py) and
     K8's rows mode: on the 1080p VCM sample's photons the pack-only
     photon_pack (rows, validity) against hashgrid.photon_rows,
     photon_bucket (K8-rows) against its plain version and against
     photon_pack's buckets and table, the rows-mode grid against the
     lbufs mode's and build_grid, and on the union of four tiles' photons
     gathered tile-major against build_grid, all bit-equal, photon_bucket
     timed; then naive (depth 8), BDPT and VCM with merging (eye 4, light
     3) at 256x256 on cornell_with_blocks on a (1,1) mesh over
     cuda:0, on (4,1) and (2,2) meshes with every rank on cuda:0
     and, where n >= 2 cards are visible, on (n,1) and (n/2,2)
     meshes, one card a rank, against the unsharded calls on cuda:0,
     each of which is timed as the sharded calls are (host clock, median
     of 5, every card synchronised): naive against the per-shard calls
     composed (each shard's key and sample, summed over the spp axis),
     BDPT and VCM against the single-rank render (the spp ranks' samples
     summed) within rtol 2e-4 + atol 2e-5, rays equal, no photon dropped;
     each sharded call's kernels launched, photon_bucket only where the
     tile axis has 2 or more ranks; each call's time and Mrays/s printed
     beside the direct call's.
Then one JSON line with each kernel's launches on its main path (the
BDPT kernels on the BDPT path, the photon kernels on the VCM path, mega_eye
on the VCM-mega path, naive on the naive path, the others on the mega
path; bdpt_walk_table on the TPT_MEGA_LIGHT VCM-mega path;
photon_bucket on the (4,1) mesh's sharded VCM sample; K15's two
entries on the threaded UNIDIRECTIONAL path, where they launch 0 times as
K1's entries do on the mega path: their device code runs inside K5's
threaded instantiation, whose launches there the two entries carry in
"launches_of_the_kernel_it_runs_in"; rgb9e5, neighbor_slots and
uniform_keyed are the test entries of device code that runs inside K5,
K14 and K12, so 0), error and times against its plain version, its
bound on this card and the library call's time (null: no PyTorch call
computes these functions; photon_sort's is torch.sort's, the faster of
library_ms_int64 and library_ms_int32), the card's name and power limit,
and as the
last line {"ok": true, "device": {...}}. The eye passes have a row each
(vcm_eye, mega_eye: the pass, counted once a pass and timed as its
three launches) and a row per stage (<pass>_walk, _connect, _gather);
K13 a row per stage (bdpt_pairs, bdpt_gather), K11 a row per stage of
each form (bdpt_splat_bin, _trace; vcm_splat_bin, _trace); K1's two
rows the ptxas numbers of each kernel it runs in ("ptxas") and its
traversals on the mega path (the rays of its 4 samples, inside K5's
launches, "launches_of_the_kernel_it_runs_in"); K5
(render_unidirectional, naive) its lane use and event balance on the
1080p sample (phase 7b), K12 (bdpt_walk, bdpt_walk_table) theirs over
the 1080p walks (phase 11) and the table mode's chunk (phase 26), the eye
walks (vcm_eye_walk, mega_eye_walk) theirs over the 1080p passes (phases
16 and 21).
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
WIDTH, HEIGHT, SPP, DEPTH = 1920, 1080, 4, 8
# --sharded: the build, then phase 35b-c alone (on a machine with several
# cards, its meshes over all of them)
SHARDED_ONLY = sys.argv[1:] == ["--sharded"]
CSRC = "cudapathtracer_tpu_torch/kernels/csrc/"
KERNELS = (  # name, source, the JAX function it replaces
    ("uniform_id", CSRC + "rng.cu", "cudapathtracer_tpu/utils/rng.py:106"),
    ("generate_rays", CSRC + "camera.cu",
     "cudapathtracer_tpu/scene/camera.py:81"),
    ("closest_hit8", CSRC + "traverse8.cu",
     "cudapathtracer_tpu/ops/traverse8.py:288"),
    ("shadow_factor8", CSRC + "traverse8.cu",
     "cudapathtracer_tpu/ops/traverse8.py:354"),
    ("render_unidirectional", CSRC + "uni_mega.cu",
     "cudapathtracer_tpu/models/unidirectional_mega.py:222"),
    ("shade_eval", CSRC + "uni_mega.cu",
     "cudapathtracer_tpu/ops/lanemajor.py:125"),
    ("packing_roundtrip", CSRC + "packing.cu",
     "cudapathtracer_tpu/utils/packing.py:23"),
    ("bdpt_walk", CSRC + "bdpt_walk.cu",
     "cudapathtracer_tpu/models/paths.py:129"),
    ("bdpt_splat", CSRC + "bdpt_splat.cu",
     "cudapathtracer_tpu/models/bdpt.py:93"),
    ("bdpt_pairs", CSRC + "bdpt_pairs.cu",
     "cudapathtracer_tpu/models/bdpt.py:175"),
    ("bdpt_gather", CSRC + "bdpt_gather.cu",
     "cudapathtracer_tpu/models/bdpt.py:226"),
    ("vcm_splat", CSRC + "bdpt_splat.cu",
     "cudapathtracer_tpu/models/vcm.py:87"),
    ("bdpt_splat_bin", CSRC + "bdpt_splat.cu",
     "cudapathtracer_tpu/models/bdpt.py:93"),
    ("bdpt_splat_trace", CSRC + "bdpt_splat.cu",
     "cudapathtracer_tpu/models/bdpt.py:93"),
    ("vcm_splat_bin", CSRC + "bdpt_splat.cu",
     "cudapathtracer_tpu/models/vcm.py:87"),
    ("vcm_splat_trace", CSRC + "bdpt_splat.cu",
     "cudapathtracer_tpu/models/vcm.py:87"),
    ("photon_pack", CSRC + "photon_grid.cu",
     "cudapathtracer_tpu/ops/hashgrid.py:151"),
    ("photon_table", CSRC + "photon_grid.cu",
     "cudapathtracer_tpu/ops/hashgrid.py:151"),
    ("photon_sort", CSRC + "radix_sort.cu",
     "cudapathtracer_tpu/ops/hashgrid.py:151"),
    ("photon_bucket", CSRC + "photon_grid.cu",
     "cudapathtracer_tpu/ops/hashgrid.py:151"),
    ("vcm_eye", CSRC + "eye.cuh", "cudapathtracer_tpu/models/vcm.py:150"),
    ("vcm_eye_walk", CSRC + "eye_walk.cu",
     "cudapathtracer_tpu/models/vcm.py:150"),
    ("vcm_eye_connect", CSRC + "eye_connect.cu",
     "cudapathtracer_tpu/models/vcm.py:150"),
    ("vcm_eye_gather", CSRC + "eye_gather.cu",
     "cudapathtracer_tpu/ops/hashgrid.py:240"),
    ("rgb9e5", CSRC + "packing.cu", "cudapathtracer_tpu/utils/packing.py:53"),
    ("neighbor_slots", CSRC + "neighbor_slots.cu",
     "cudapathtracer_tpu/ops/hashgrid.py:412"),
    ("mega_eye", CSRC + "eye.cuh",
     "cudapathtracer_tpu/models/vcm_mega.py:322"),
    ("mega_eye_walk", CSRC + "eye_walk.cu",
     "cudapathtracer_tpu/models/vcm_mega.py:322"),
    ("mega_eye_connect", CSRC + "eye_connect.cu",
     "cudapathtracer_tpu/models/vcm_mega.py:148"),
    ("mega_eye_gather", CSRC + "eye_gather.cu",
     "cudapathtracer_tpu/models/vcm_mega.py:322"),
    ("naive", CSRC + "uni_mega.cu", "cudapathtracer_tpu/models/naive.py:41"),
    ("uniform_keyed", CSRC + "rng.cu", "cudapathtracer_tpu/utils/rng.py:140"),
    ("bdpt_walk_table", CSRC + "bdpt_walk.cu",
     "cudapathtracer_tpu/models/light_mega.py:108"),
    ("closest_hit_bin", CSRC + "traverse_bin.cu",
     "cudapathtracer_tpu/ops/traverse.py:132"),
    ("shadow_factor_bin", CSRC + "traverse_bin.cu",
     "cudapathtracer_tpu/ops/traverse.py:203"),
)
# the kernels K1 (traverse8.cuh) runs in, BVH8 instantiations: its batch
# entries, K5, K12, K11's trace, K13's pairs, the eye passes' walk and
# connections (classic, mega VCM, mega BDPT)
K1_HOSTS = ("traverse8_kernelILb0E", "traverse8_kernelILb1E",
            "uni_mega_kernelILi0ELi8E", "bdpt_walk_kernelILi0E",
            "splat_trace_kernelILi0E", "bdpt_pairs_kernelILi0E",
            *(k + f + "Li0E" for k in ("eye_walk_kernel",
                                       "eye_connect_kernel_trace")
              for f in ("ILi0E", "ILi1E", "ILi2E")))
# launch counters (kernels.launches) by path: a splat counts its two stages
# and an eye pass its three, never itself (STAGE_OF)
BDPT_KERNELS = ("bdpt_walk", "bdpt_splat_bin", "bdpt_splat_trace",
                "bdpt_pairs", "bdpt_gather")
PHOTON_KERNELS = ("vcm_splat_bin", "vcm_splat_trace", "photon_pack",
                  "photon_sort", "photon_table", "vcm_eye_walk",
                  "vcm_eye_connect", "vcm_eye_gather")
# a kernel table row whose launches are one of its stage's: one splat is
# one trace stage, one eye pass one walk stage
STAGE_OF = {"bdpt_splat": "bdpt_splat_trace", "vcm_splat": "vcm_splat_trace",
            "vcm_eye": "vcm_eye_walk", "mega_eye": "mega_eye_walk"}
# the mega engines' launches per chunk of a sample (K12, the splat, K8's
# two launches, K14 and its stages; SPPM has no connection stage), by
# integrator
MEGA_KERNELS = {
    "VCM": ("bdpt_walk", "vcm_splat_bin", "vcm_splat_trace",
            "photon_pack", "photon_sort", "photon_table",
            "mega_eye_walk", "mega_eye_connect", "mega_eye_gather"),
    "SPPM": ("bdpt_walk", "photon_pack", "photon_sort", "photon_table",
             "mega_eye_walk", "mega_eye_gather"),
    "BIDIRECTIONAL": ("bdpt_walk", "bdpt_splat_bin", "bdpt_splat_trace",
                      "mega_eye_walk", "mega_eye_connect",
                      "mega_eye_gather")}
EYE_STAGES = ("walk", "connect", "gather")
# The card's peaks (H100 SXM data sheet) for the
# bound: bytes over memory bandwidth, scalar operations (one per
# instruction: the kernels are built with -fmad=false) over the float32
# rate outside the tensor cores, and Threefry's integer instructions over
# the INT32 rate. All are lower bounds on time.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# The INT32 rate: 64 lanes a clock on each SM (half the FP32 pipe's),
# times the SMs and the SM clock nvidia-smi reports as the card's maximum
# (clocks.max.sm), set in main() from this card (int32_rate). A Threefry
# draw is SASS_PER_CIPHER integer instructions (IADD3, SHF.L.W, LOP3),
# counted in rng.cu's keyed draw kernel of this build by cuobjdump
# (sass_counts), and enters a bound as OPS_PER_DRAW float32-equivalent
# operations: SASS_PER_CIPHER x PEAK_OPS_S / PEAK_INT32_S (set_draw_ops).
INT32_LANES_PER_SM = 64
PEAK_INT32_S = 64 * 132 * 1.98e9      # replaced by int32_rate() in main()
SASS_PER_CIPHER = 72                  # replaced by the build's count
# scalar operations, counted from the sources: one BVH8 row visited in
# traverse8.cuh (8 slab tests x 27, the 19-comparator sort x 2, 7 pushes
# x 3, 4 Moller-Trumbore tests x 52, the leaf fold 7); one K7 pixel (2
# draws at aperture 0, 4 with the lens, and ~60 float ops).
OPS_PER_ROW = 490
# one threaded node row in traverse_bin.cuh: the slab test (~27) and the
# link select (~5); each triangle test of a hit leaf one Moller-Trumbore
# test (52), counted by the plain walk on the same rays
OPS_PER_BIN_ROW = 32
OPS_PER_TRI_TEST = 52
OPS_PER_DRAW = SASS_PER_CIPHER * PEAK_OPS_S / PEAK_INT32_S
OPS_PER_CAMERA_RAY = 4 * OPS_PER_DRAW + 60      # the lens on
OPS_PER_PINHOLE_RAY = 2 * OPS_PER_DRAW + 60     # aperture 0
# BDPT (bdpt.cuh), counted the same way: a stored walk vertex (two draws,
# one cipher each under the walk's key table, and ~300 float ops of
# shading, BSDF sample and MIS step; encoding ~60); one decoded vertex
# (two oct decodes, ~40); one codec round trip in packing.cu (~120)
OPS_PER_WALK_VERTEX = 2 * OPS_PER_DRAW + 360
OPS_PER_DECODE = 40
# K11's first stage: a vertex's flag test, world_to_raster (~25) and its
# tile (~10)
OPS_PER_RASTER = 40
OPS_PER_CODEC = 120
# the photon grid (hashgrid.cuh, photon_grid.cu): one photon's oct decode
# and encode (~70), half2 codes (~10), cell, hash and key (~20)
OPS_PER_PHOTON = 100
# RGB9E5 (packing.cuh): its kernel's SASS arithmetic (the double log and
# exps, clamps, rounding and packing), each instruction at its pipe's
# rate (sass_ops_ms)
# K9's slots (hashgrid.cuh): a query's 8 cell hashes and table reads
# (~200), each slot's index and distance test (~20)
OPS_PER_QUERY = 200
# the kernels K2-K4 run in (both engines where they trace) and K9's hosts
SHADE_HOSTS = ("shade_eval_kernel", "uni_mega_kernelILi0ELi8E",
               "uni_mega_kernelILi0ELi1E", "uni_mega_kernelILi1ELi8E",
               "uni_mega_kernelILi1ELi1E", "bdpt_walk_kernelILi0E",
               "bdpt_walk_kernelILi1E", "splat_trace_kernelILi0E",
               "bdpt_pairs_kernelILi0E", "eye_walk_kernelILi0ELi0E",
               "eye_walk_kernelILi1ELi0E", "eye_walk_kernelILi2ELi0E",
               "eye_connect_kernel_traceILi0ELi0E",
               "eye_connect_kernel_traceILi1ELi0E",
               "eye_gather_kernelILi0E", "eye_gather_kernelILi1E",
               "slots_kernel")
OPS_PER_SLOT = 20
# one eye record (kernels/csrc/eye.cuh): pos, n, to_prev, thr, albedo 60,
# trans, mat_id, d_vcm, d_vc, d_vm, flags 24, the s=0 and NEE terms 24
RECORD_BYTES = 108
VERTEX_BYTES = 51   # one packed vertex: pt 12, two oct 8, uv 4, beta 6,
#                     pdf_fwd/d_vcm/d_vc/d_vm 16, flags 4, valid 1
K_ULP = 32 * 2.0 ** -24   # tests/test_torch_bsdf.py's K u
# BDPTConfig's strategy flags, each set away from its default in turn
# (light_depth_1: no stored light vertex, eye depth 2: one connection row)
BDPT_FLAGS = {
    "no_light_trace": dict(light_trace=False),
    "no_nee": dict(nee=False),
    "no_naive": dict(naive=False),
    "no_connection": dict(connection=False),
    "no_mis": dict(do_mis=False),
    "paint_weight": dict(paint_weight=True),
    "environment": dict(sample_environment=True),
    "light_depth_1": dict(light_depth=1, eye_depth=2),
}
# eta_vcm of a VCM light walk (n_paths pi r^2: 65,536 paths at r = 0.005)
VCM_ETA = 5.1471854


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call: `reps` calls captured in one CUDA
    graph, replayed between CUDA events. A short kernel's wrapper (its
    checks, allocations and, for K7, the host's key folds) can take longer
    than the kernel, and cuda_ms then times the host; the replay leaves it
    out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def compare_hits(k, p, what: str, tag: str = "K1") -> float:
    """The closest-hit criterion of K1 and K15; returns max |dt| where the
    ids match."""
    import torch
    ids_eq = k.tri == p.tri
    frac = ids_eq.float().mean().item()
    check(frac >= 0.9999, f"{what}: ids equal on only {frac:.6f} of rays")
    bad = ~ids_eq
    if bool(bad.any()):
        dt = torch.abs(k.t[bad] - p.t[bad])
        tie = dt <= 1e-5 * torch.minimum(k.t[bad], p.t[bad])
        check(bool(tie.all()), f"{what}: {int((~tie).sum())} id mismatches "
              "are not edge ties")
    m = ids_eq & (k.tri >= 0)
    errs = [torch.abs(a[m] - b[m]).max().item() if bool(m.any()) else 0.0
            for a, b in ((k.t, p.t), (k.u, p.u), (k.v, p.v))]
    check(max(errs) <= 1e-5, f"{what}: t/u/v differ by {max(errs):.3g}")
    say(tag, f"{what}: {k.tri.numel()} rays, ids equal on {frac:.6f}, "
        f"{int(bad.sum())} edge ties, max |dt| {errs[0]:.3g} "
        f"|du| {errs[1]:.3g} |dv| {errs[2]:.3g}")
    return errs[0]


def grazing_rays(n=2000, seed=3):
    """Rays near the floor and nearly parallel to it (the rays of
    tests/test_torch_traverse8.py::test_stack_overflow_restart, whose plain
    version at a 7-entry stack matches the JAX traversal's)."""
    import numpy as np
    gen = np.random.default_rng(seed)
    o = gen.uniform(-0.49, 0.49, (n, 3))
    o[:, 1] = gen.uniform(-0.5, -0.2, n)
    d = gen.normal(size=(n, 3))
    d[:, 1] *= 0.05
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def nee_rays(scene, hit_o, hit_d, hit, ids):
    """Shadow rays from the hit points to light samples (as NEE makes)."""
    import torch
    from cudapathtracer_tpu_torch.models import common
    from cudapathtracer_tpu_torch.utils import rng
    from cudapathtracer_tpu_torch.utils.math import (EPSILON, length_sq,
                                                     normalize)
    sel = torch.nonzero(hit.valid)[:, 0]
    p = hit_o[sel] + hit_d[sel] * hit.t[sel, None]
    ls = common.sample_light_point(scene, rng.base_key(11), 0, sel.numel(),
                                   ids[sel])
    stl = ls.point - p
    wi = normalize(stl)
    dist = torch.sqrt(torch.clamp(length_sq(stl), min=0.0))
    return (p + wi * EPSILON).contiguous(), wi.contiguous(), \
        ((dist - EPSILON) * (1.0 - EPSILON)).contiguous()


def peak_gib(base: int) -> str:
    """The peak allocated since the last reset, and how far it rose above
    `base` (what was allocated before the measured run)."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    return (f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
            "what was allocated before the render)")


def int32_rate(card_clock_mhz: float, sms: int) -> float:
    """The INT32 pipe's instructions a second: 64 lanes a clock an SM."""
    return INT32_LANES_PER_SM * sms * card_clock_mhz * 1e6


def set_draw_ops(sass_per_cipher: float, peak_int32: float) -> None:
    """A draw's cost in float32-equivalent operations from this build's
    cipher and this card's INT32 rate, and the counts built on it."""
    global SASS_PER_CIPHER, PEAK_INT32_S, OPS_PER_DRAW, OPS_PER_CAMERA_RAY
    global OPS_PER_PINHOLE_RAY, OPS_PER_WALK_VERTEX
    SASS_PER_CIPHER, PEAK_INT32_S = sass_per_cipher, peak_int32
    OPS_PER_DRAW = SASS_PER_CIPHER * PEAK_OPS_S / PEAK_INT32_S
    OPS_PER_CAMERA_RAY = 4 * OPS_PER_DRAW + 60
    OPS_PER_PINHOLE_RAY = 2 * OPS_PER_DRAW + 60
    OPS_PER_WALK_VERTEX = 2 * OPS_PER_DRAW + 360


def sass_counts(lib: str, kernel: str) -> dict:
    """{opcode (without modifiers): count} of the SASS of the first kernel
    in the library whose name contains `kernel` (cuobjdump -sass), or {}
    when cuobjdump is missing or finds none."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def cipher_sass(counts: dict) -> int:
    """The integer instructions of one Threefry cipher (and the few of
    its kernel's addresses) in a kernel that runs one: IADD3, SHF, LOP3."""
    return sum(counts.get(k, 0) for k in ("IADD3", "SHF", "LOP3"))


# lanes a clock an SM of the pipes sass_ops_ms times (H100: FP64 64, the
# special-function unit 16, INT32 64); float32 instructions at PEAK_OPS_S
SASS_PIPES = {"fp64": 64, "mufu": 16, "int32": INT32_LANES_PER_SM}


def sass_pipe(op: str) -> str | None:
    """The pipe an arithmetic SASS opcode issues to, or None for memory,
    control and conversion instructions (not counted)."""
    if op in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"):
        return "fp64"
    if op == "MUFU":
        return "mufu"
    if op.startswith(("IADD", "IMAD", "ISETP", "IMNMX", "IABS", "LEA", "SHF",
                      "LOP", "SEL", "PRMT", "FLO", "POPC", "BREV")):
        return "int32"
    if op in ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET",
              "FCHK", "FRND"):
        return "fp32"
    return None


def sass_ops_ms(counts: dict, threads: int, clock_mhz: float,
                sms: int) -> float:
    """The least ms `threads` threads each running the instructions of
    `counts` once could take: each pipe's lanes-instructions over its rate,
    the slowest pipe."""
    per = {}
    for op, c in counts.items():
        pipe = sass_pipe(op)
        if pipe is not None:
            per[pipe] = per.get(pipe, 0) + c
    ms = [per.get("fp32", 0) * threads / PEAK_OPS_S * 1e3]
    for pipe, lanes in SASS_PIPES.items():
        ms.append(per.get(pipe, 0) * threads
                  / (lanes * sms * clock_mhz * 1e6) * 1e3)
    return max(ms)


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(the least time in ms the card could take, what bounds it)."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ptxas_of(log: str, kernel: str) -> dict:
    """Registers, stack and spill bytes ptxas reported for a kernel."""
    m = re.search(r"Compiling entry function '[^']*" + kernel + r"[^']*'"
                  r".*?(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads.*?Used (\d+) registers", log,
                  re.S)
    check(m is not None, f"build: no ptxas report for {kernel}")
    stack, st, ld, regs = (int(x) for x in m.groups())
    return dict(registers=regs, stack_bytes=stack, spill_store_bytes=st,
                spill_load_bytes=ld)


def compare_render(k, p, what: str) -> float:
    """K5 against its plain version: ((li, rays), (li, rays)); rays within
    0.1%, image mean ratio within 1e-3, >= 99% of pixels within rtol 1e-3
    (atol 1e-6) on every channel. Returns the max abs pixel error."""
    import torch
    (kl, kr), (pl, pr) = k, p
    kr, pr = int(kr), int(pr)
    rays = abs(kr - pr) / pr
    ratio = (kl.double().mean() / pl.double().mean()).item()
    close = torch.isclose(kl, pl, rtol=1e-3, atol=1e-6).all(dim=1)
    frac = close.float().mean().item()
    err = (kl - pl).abs().max().item()
    say("K5", f"{what}: rays kernel {kr} plain {pr} (diff {rays:.3g}), mean "
        f"ratio {ratio:.7f}, pixels within rtol 1e-3 {frac:.6f}, max abs "
        f"{err:.3g}")
    check(bool(torch.isfinite(kl).all()), f"K5 {what}: non-finite radiance")
    check(rays <= 1e-3, f"K5 {what}: rays differ by {rays:.3g}")
    check(abs(ratio - 1.0) <= 1e-3, f"K5 {what}: mean ratio {ratio:.7f}")
    check(frac >= 0.99, f"K5 {what}: only {frac:.5f} of pixels within rtol "
          "1e-3")
    return err


def _half_z(wi, wo):
    h = wi + wo
    h = h / h.norm(dim=1, keepdim=True).clamp(min=1e-300)
    return h[:, 2].abs()


def _peak(h_z, alpha):
    a2 = alpha * alpha
    return 2.0 * (1.0 - a2) / (1.0 - h_z * h_z * (1.0 - a2))


def _schlick(cos_t, eta_i, eta_t):
    r0 = ((eta_i - eta_t) / (eta_i + eta_t)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_t.abs()) ** 5


def shade_eval_bounds(scene, d, hit, p, eta_i, u_sel, u1):
    """Per-element bounds of shade_eval against its plain version p
    ([N, 38], columns in models/unidirectional_mega.shade_eval_plain): the
    bounds of tests/test_torch_bsdf.py, |k - p| <= 1e-6 + 1e-5 |p| +
    K u (A_rel |p| + A_abs), with the lane's condition A from float64:
    GGX lanes (metal, leaf) carry D's peak 2 (1 - a^2) / den at the NEE
    and the sampled directions' half vectors, the sample's cancellations
    (1 + 1/s) and 3 (1 + 1/s) / sin_t; dielectric lanes 1 / cos_t^2. Lanes
    at a branch edge (leaf u_sel < F, dielectric u < F, TIR, F >= 0.99999,
    within 1e-5, and the shading frame's |n_x| > |n_z| choice within 1e-6
    unless both are 0) are left out, at most 1%. Returns (bound [N,38], keep [N])."""
    import torch
    from cudapathtracer_tpu_torch.utils.math import to_local
    q = p.double()
    row = scene.tri_shade_row[hit.tri.clamp(min=0)].double()
    mtype = scene.tri_shade_row[hit.tri.clamp(min=0), 20].contiguous().view(
        torch.int32)
    alpha = row[:, 24] ** 2
    ior = row[:, 31]
    wi = -to_local(d.double(), q[:, 3:6])
    ggx = (mtype == 1) | (mtype == 4)
    s = 1.0 + (alpha * alpha - 1.0) * u1.double()
    cos2 = ((1.0 - u1.double()) / s).clamp(0.0, 1.0)
    amp = 1.0 + 1.0 / s
    sin_t = (1.0 - cos2).clamp(min=1e-300).sqrt()
    zero = torch.zeros_like(alpha)
    nee_rel = torch.where(ggx, _peak(_half_z(wi, q[:, 17:20]), alpha), zero)
    bs_rel = torch.where(ggx, _peak(_half_z(wi, q[:, 29:32]), alpha) * amp,
                         zero)
    bs_abs = torch.where(ggx, 3.0 * amp / sin_t, zero)
    bf = q[:, 8] > 0.5
    eta_a = torch.where(bf, ior, torch.ones_like(ior))
    eta_b = torch.where(bf, torch.ones_like(ior), ior)
    cos_i = wi[:, 2].clamp(1e-5, 1.0)
    eta = eta_a / eta_b
    cos_t2 = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    fres = _schlick(cos_i, eta_a, eta_b)
    diel = mtype == 2
    refr = 1.0 / cos_t2.abs().clamp(min=1e-300)
    bs_rel = torch.where(diel, refr, bs_rel)
    bs_abs = torch.where(diel, refr, bs_abs)
    u = u_sel.double()
    edge = (diel & (((u - fres).abs() < 1e-5) | (cos_t2.abs() < 1e-5)
                    | ((fres - 0.99999).abs() < 1e-5)))
    edge |= (mtype == 4) & ((u - _schlick(wi[:, 2], eta_i.double(), ior))
                            .abs() < 1e-5)
    nx, nz = q[:, 3].abs(), q[:, 5].abs()
    edge |= ((nx - nz).abs() < 1e-6) & (nx + nz > 1e-6)
    a_rel = torch.zeros_like(q)
    a_abs = torch.zeros_like(q)
    for c in (13, 14, 15, 28):            # NEE contrib, the NEE pdf
        a_rel[:, c] = nee_rel
    for c in range(29, 36):               # BSDF sample wo, f, pdf
        a_rel[:, c] = bs_rel
        a_abs[:, c] = bs_abs
    bound = 1e-6 + 1e-5 * q.abs() + K_ULP * (a_rel * q.abs() + a_abs)
    keep = hit.valid & ~edge
    check(edge.float().mean().item() < 0.01, "shade_eval: more than 1% of "
          "lanes at a branch edge")
    return bound, keep


SHADE_COLS = (("point", 0, 3), ("normal", 3, 6), ("uv", 6, 8),
              ("backface", 8, 9), ("albedo", 9, 12), ("trans", 12, 13),
              ("nee_contrib", 13, 16), ("light_pdf", 16, 17),
              ("nee_wo", 17, 20), ("shadow_o", 20, 23), ("shadow_d", 23, 26),
              ("max_t", 26, 27), ("nee_active", 27, 28), ("nee_bpdf", 28, 29),
              ("wo", 29, 32), ("f", 32, 35), ("pdf", 35, 36),
              ("mat_id", 36, 37), ("emissive", 37, 38))


def compare_shade_eval(scene, d, hit, k, p, eta_i, u_sel, u1,
                       what: str) -> float:
    """shade_eval (k) against shade_eval_plain (p) on the same hits. The
    discrete columns (backface, active, mat_id, emissive) equal on >=
    99.99% of hits; light_pdf = dist^2 / (cos_l n A) through
    x = dist^2 / light_pdf = cos_l n A, which stays well conditioned where
    the light is seen edge-on (cos_l -> 0, the pdf -> inf), within
    1e-6 + 1e-5 |x| (dist from the plain shadow ray's max_t); every other
    column under shade_eval_bounds. The NEE outputs are compared where the
    plain NEE is active: elsewhere nothing reads them, and on a light's own
    surface the light sample lies in the hit's plane, where the shadow
    direction is one ulp of cancellation. Returns the worst abs error over
    the compared elements."""
    bound, keep = shade_eval_bounds(scene, d, hit, p, eta_i, u_sel, u1)
    kd, pd = k.double(), p.double()
    err = (kd - pd).abs()
    dist2 = (pd[:, 26] / (1.0 - 1e-5) + 1e-5) ** 2
    x_k, x_p = dist2 / kd[:, 16], dist2 / pd[:, 16]
    err[:, 16] = (x_k - x_p).abs()
    bound[:, 16] = 1e-6 + 1e-5 * x_p.abs()
    worst, parts = 0.0, []
    nee = keep & (pd[:, 27] > 0.5)
    for name, c0, c1 in SHADE_COLS:
        rows = nee if 13 <= c0 < 29 and name != "nee_active" else keep
        e = err[rows, c0:c1]
        if name in ("backface", "nee_active", "mat_id", "emissive"):
            frac = (e == 0).all(dim=1).float().mean().item()
            check(frac >= 0.9999, f"shade_eval {what}: {name} equal on only "
                  f"{frac:.6f} of hits")
            parts.append(f"{name} {1.0 - frac:.2g}")
            continue
        over = (e > bound[rows, c0:c1]).any(dim=1)
        check(not bool(over.any()), f"shade_eval {what}: {name} over its "
              f"bound on {int(over.sum())} hits")
        m = e.max().item() if e.numel() else 0.0
        worst = max(worst, m)
        parts.append(f"{name} {m:.3g}")
    say("shade", f"{what}: {int(keep.sum())} hits compared; worst error "
        "per output (discrete: share unequal): " + ", ".join(parts))
    return worst


def compare_codecs(k: dict, p: dict, what: str) -> None:
    """K10 (packing_roundtrip) against the plain codecs: bit-equal."""
    import torch
    for name in k:
        a, b = k[name], p[name]
        if a.dtype in (torch.float32, torch.float16):
            a, b = (a.view(torch.int32) if a.dtype == torch.float32
                    else a.view(torch.int16)), \
                (b.view(torch.int32) if b.dtype == torch.float32
                 else b.view(torch.int16))
        bad = int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())
        check(bad == 0, f"K10 {what}: {name} differs from the plain codec "
              f"on {bad} of {a.shape[0]} vectors")


def _oct_steps(a, b):
    """Per element, the larger snorm16 step between two oct words."""
    import torch
    out = None
    for shift in (0, 16):
        x = ((a.long() >> shift) & 0xFFFF).to(torch.int16).long()
        y = ((b.long() >> shift) & 0xFFFF).to(torch.int16).long()
        d = (x - y).abs()
        out = d if out is None else torch.maximum(out, d)
    return out


def compare_walk(k, p, what: str) -> tuple:
    """K12 against the plain walk on the same pixels and keys; k and p are
    (PathBuffers, v0 dict, Escape or None). A lane diverged where `valid`
    differs at some depth, or the flag word or the point (by > 1e-3)
    where valid: at most 0.1% of lanes may. On the others, over the valid
    vertices: `valid` and flags equal (by the definition), points within
    1e-3 (by the definition) and within 1e-4, pdf_fwd / d_vcm / d_vc within
    / d_vm rtol 1e-3 (atol 1e-6), the oct words within one snorm16 step
    and float16 beta / uv within 2^-10 relative, each on >= 99.9% of the
    vertices (one ulp of a direction moves a grazing hit far along the
    surface it hits); the light endpoint's ids
    equal and its floats within rtol 1e-5 on >= 99.9% of lanes; the escape
    flag equal, and where a walk escaped its direction within 1e-5 and its
    throughput within rtol 1e-4 on >= 99.9% of those lanes. Returns the
    worst point error."""
    import torch
    (kb, kv0, kesc), (pb, pv0, pesc) = k, p
    kv, pv = kb.valid, pb.valid
    both = kv & pv
    div = ((kv != pv) | ((kb.flags != pb.flags) & both)
           | (((kb.pt - pb.pt).abs().amax(dim=-1) > 1e-3) & both)).any(0)
    ndiv = int(div.sum())
    n = kv.shape[1]
    m = both & ~div[None]
    nv = int(m.sum())
    check(ndiv <= 1e-3 * n, f"K12 {what}: {ndiv} of {n} lanes diverged")
    parts = []
    ept = (kb.pt - pb.pt).abs().amax(dim=-1)[m]
    worst_pt = ept.max().item() if nv else 0.0
    shares = {"pt": (ept <= 1e-4).float().mean()}
    for f in ("pdf_fwd", "d_vcm", "d_vc", "d_vm"):
        a, b = getattr(kb, f)[m], getattr(pb, f)[m]
        shares[f] = torch.isclose(a, b, rtol=1e-3, atol=1e-6).float().mean()
    for f in ("n_oct", "wo_oct"):
        shares[f] = (_oct_steps(getattr(kb, f)[m], getattr(pb, f)[m])
                     <= 1).float().mean()
    for f in ("beta_h", "uv_h"):
        a, b = getattr(kb, f)[m].float(), getattr(pb, f)[m].float()
        shares[f] = torch.isclose(a, b, rtol=2.0 ** -10,
                                  atol=1e-7).all(dim=-1).float().mean()
    for f, sh in shares.items():
        sh = sh.item() if nv else 1.0
        check(sh >= 0.999, f"K12 {what}: {f} within its bound on only "
              f"{sh:.5f} of the vertices")
        parts.append(f"{f} {sh:.6f}")
    if "light_ind" in kv0:
        ok = ~div
        for f in ("light_ind", "mat_id", "tri"):
            sh = (kv0[f] == pv0[f])[ok].float().mean().item()
            check(sh >= 0.9999, f"K12 {what}: endpoint {f} equal on {sh}")
        for f in ("pt", "n", "beta", "pdf_fwd"):
            a, b = kv0[f][ok], pv0[f][ok]
            c = torch.isclose(a, b, rtol=1e-5, atol=1e-6)
            sh = (c.all(dim=-1) if c.dim() > 1 else c).float().mean().item()
            check(sh >= 0.999, f"K12 {what}: endpoint {f} within rtol 1e-5 "
                  f"on {sh}")
    if kesc is not None:
        check(torch.equal(kesc.valid[~div], pesc.valid[~div]),
              f"K12 {what}: escape flags differ")
        e = kesc.valid & ~div
        ne = int(e.sum())
        for f, tol in (("d", dict(rtol=0.0, atol=1e-5)),
                       ("beta", dict(rtol=1e-4, atol=1e-7))):
            c = torch.isclose(getattr(kesc, f)[e], getattr(pesc, f)[e], **tol)
            sh = c.all(dim=-1).float().mean().item() if ne else 1.0
            check(sh >= 0.999, f"K12 {what}: escape {f} within its bound on "
                  f"only {sh:.5f} of {ne} escaped lanes")
            parts.append(f"escape {f} {sh:.6f}")
        parts.append(f"{ne} escaped")
    say("K12", f"{what}: {n} paths, {ndiv} diverged; {nv} valid vertices "
        f"compared, max |dpt| {worst_pt:.3g}; share within bounds: "
        + ", ".join(parts))
    return worst_pt


def bits(t):
    """A tensor's bits, as integers of its width (bool as is)."""
    import torch
    width = {4: torch.int32, 2: torch.int16, 1: torch.uint8, 8: torch.int64}
    return t if t.dtype == torch.bool else t.view(width[t.element_size()])


def walk_outputs(w, rays) -> dict:
    """Every output of a K12 walk as bits: the buffers (dead rows
    included), vertex 0, the escape record, rays and rows."""
    out = {f"bufs.{f}": getattr(w["bufs"], f) for f in w["bufs"]._fields}
    out.update({f"v0.{k}": v for k, v in w["v0"].items()})
    if w["escape"] is not None:
        out.update({f"escape.{f}": getattr(w["escape"], f)
                    for f in ("valid", "d", "beta")})
    out.update(rays=rays, rows=w["rows"])
    return {k: bits(v) for k, v in out.items()}


def walk_grids(scene, px, py, keys, what: str, sms: int, **kw) -> list:
    """K12's path regeneration: the walk on its resident grid against the
    walk on `sms` blocks (one a SM: each lane walks many more paths), every
    output bit-equal (walk_outputs). kw: bdpt_walk's mode, max_depth,
    camera, eta_vcm, key_table. Returns the resident run's lane counts
    (bounces, the warps' busiest lanes, the warps' calls)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    n, dev = px.shape[0], px.device
    runs = {}
    for grid in (None, sms):
        lanes = torch.zeros(3, dtype=torch.int64, device=dev)
        rays = torch.zeros(n, dtype=torch.int32, device=dev)
        w = kernels.bdpt_walk(scene, px, py, keys, rays=rays, with_rows=True,
                              lanes=lanes, grid=grid, **kw)
        runs[grid] = (walk_outputs(w, rays), lanes.tolist())
        del w
    ref = runs[None][0]
    diff = [k for k in ref if not torch.equal(ref[k], runs[sms][0][k])]
    check(not diff, f"K12 {what}: the resident grid and {sms} blocks differ "
          f"in {diff}")
    (ev, busy, calls), (evs, busys, callss) = runs[None][1], runs[sms][1]
    table = kw.get("key_table") is not None
    say("K12", f"{what}: the resident grid "
        f"({kernels.bdpt_walk_grid(scene, n, table)} blocks of 128) and "
        f"{sms} blocks bit-equal in {len(ref)} outputs; {ev} bounces in "
        f"{calls} warp calls: lane use {ev / (32 * calls):.4f}, event "
        f"balance {ev / (32 * busy):.4f} (on {sms} blocks "
        f"{evs / (32 * callss):.4f} and {evs / (32 * busys):.4f})")
    return runs[None][1]


def lane_stats(*lane_counts) -> dict:
    """The kernel line's lane use and event balance over walks' lane
    counts (bounces, busiest, calls) summed."""
    ev, busy, calls = (sum(c[k] for c in lane_counts) for k in range(3))
    return dict(lane_use=ev / (32 * calls), event_balance=ev / (32 * busy))


def splat_stages(scene, cam, lbufs, lv0, cfg, what: str, eta_vcm=None,
                 n_live=None) -> dict:
    """K11's first stage (SplatPass.bin) against its plain twin
    (bdpt.splat_queue_plain on the same buffers): the tile offsets equal,
    and the same entries r N + i in every tile (the kernel's queue sorted
    inside each tile equals the twin's); the rays it adds equal the
    queue's length. Each stage timed by CUDA events, and the twin. ->
    dict(bin_ms, trace_ms, twin_ms, queued, tiles, used tiles)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import bdpt
    n, dev = lbufs.pt.shape[1], lbufs.pt.device
    rays = torch.zeros(n, dtype=torch.int32, device=dev)
    fb = torch.zeros((cam.width * cam.height, 3), device=dev)
    sp = kernels.splat_pass(scene, cam, lbufs, lv0, fb, rays, cfg,
                            eta_vcm=eta_vcm, n_live=n_live)
    sp.bin()
    offs = sp.offsets.long()
    count, tiles = int(offs[-1]), offs.numel() - 1
    q = sp.queue[:count].long()
    tile_of = torch.repeat_interleave(torch.arange(tiles, device=dev),
                                      offs[1:] - offs[:-1])
    span = (lbufs.pt.shape[0] + (lv0 is not None)) * n
    kq = q[torch.argsort(tile_of * span + q)]
    pq, poffs = bdpt.splat_queue_plain(cam, lbufs, lv0, n_live)
    same = torch.equal(offs, poffs) and torch.equal(kq, pq)
    if not same:
        say("K11", f"{what}: stage 1 {count} entries, twin {pq.numel()}; "
            f"{int((~torch.isin(kq, pq)).sum())} only in the kernel's, "
            f"{int((~torch.isin(pq, kq)).sum())} only in the twin's; tiles "
            f"with other counts {int((offs != poffs).sum())}")
    check(same, f"K11 {what}: stage 1's queue differs from its twin's")
    check(int(rays.sum()) == count, f"K11 {what}: stage 1 added "
          f"{int(rays.sum())} rays for {count} queued vertices")
    out = dict(queued=count, tiles=tiles,
               used=int((offs[1:] > offs[:-1]).sum()),
               bin_ms=cuda_ms(sp.bin, 5), trace_ms=cuda_ms(sp.trace, 5),
               twin_ms=cuda_ms(lambda: bdpt.splat_queue_plain(
                   cam, lbufs, lv0, n_live), 1))
    say("K11", f"{what}: stage 1 bit-equal to its twin ({count} of {span} "
        f"vertices queued in {out['used']} of {tiles} tiles, rays equal); "
        f"classify and bin {out['bin_ms']:.3f} ms (twin "
        f"{out['twin_ms']:.3f}), trace and splat {out['trace_ms']:.3f} ms")
    return out


def compare_image(k, p, what: str, tag: str, share: float) -> float:
    """Radiance or a frame buffer ((img, rays), (img, rays)) on the same
    inputs: rays within 0.1%, image mean within 1e-3, >= share of the
    pixels within rtol 1e-3 (atol 1e-5) on every channel. Returns the max
    abs pixel error."""
    import torch
    (kl, kr), (pl, pr) = k, p
    kr, pr = int(kr), int(pr)
    rays = abs(kr - pr) / max(pr, 1)
    ratio = (kl.double().mean() / pl.double().mean()).item()
    close = torch.isclose(kl, pl, rtol=1e-3, atol=1e-5).all(dim=1)
    frac = close.float().mean().item()
    err = (kl - pl).abs().max().item()
    say(tag, f"{what}: rays kernel {kr} plain {pr} (diff {rays:.3g}), mean "
        f"ratio {ratio:.7f}, pixels within rtol 1e-3 {frac:.6f}, max abs "
        f"{err:.3g}")
    check(bool(torch.isfinite(kl).all()), f"{tag} {what}: non-finite")
    check(rays <= 1e-3, f"{tag} {what}: rays differ by {rays:.3g}")
    check(abs(ratio - 1.0) <= 1e-3, f"{tag} {what}: mean ratio {ratio:.7f}")
    check(frac >= share, f"{tag} {what}: only {frac:.5f} of pixels within "
          "rtol 1e-3")
    return err


def compare_bdpt(scene, cam, px, py, cfg, keys, what: str,
                 eta_vcm=None) -> tuple:
    """K12 (both walks; eta_vcm turns on the light walk's VCM d_vm chain,
    then held bit-equal to the plain walk's),
    then K11 and K13 on the kernel walks' buffers, against their plain
    versions on the same inputs (compare_walk, compare_image); cfg is a
    BDPTConfig, keys the sample's (key_l, key_e, key_c). Returns the
    (K12, K11, K13) errors."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import bdpt, paths
    from cudapathtracer_tpu_torch.utils import rng
    key_l, key_e, key_c = keys
    n, dev = px.shape[0], px.device
    rays = {m: torch.zeros(n, dtype=torch.int32, device=dev)
            for m in ("light", "eye", "splat")}
    lw = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_l, "light"),
                           mode="light", max_depth=cfg.light_depth,
                           rays=rays["light"], eta_vcm=eta_vcm)
    ew = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_e, "eye"),
                           mode="eye", max_depth=cfg.eye_depth,
                           rays=rays["eye"], camera=cam)
    pl = paths.generate_light_path(scene, key_l, px, py, cfg.light_depth,
                                   eta_vcm)
    pe = paths.generate_eye_path(scene, cam, key_e, px, py, cfg.eye_depth)
    if eta_vcm is not None:
        check(bool((pl[0].d_vm != 0).any()), f"K12 {what}: eta_vcm set but "
              "the plain light walk's d_vm is all zero")
        # the plain seed divides in IEEE (true_div) as the kernel does
        both = lw["bufs"].valid & pl[0].valid
        kv, pv = (b.d_vm[both].view(torch.int32) for b in (lw["bufs"], pl[0]))
        check(torch.equal(kv, pv), f"K12 {what}: d_vm differs from the "
              f"plain walk's on {int((kv != pv).sum())} vertices")
        say("K12", f"{what}: d_vm bit-equal on {kv.numel()} vertices")
    err12 = max(compare_walk((lw["bufs"], lw["v0"], None),
                             (pl[0], pl[1], None), f"{what} light"),
                compare_walk((ew["bufs"], ew["v0"], ew["escape"]),
                             (pe[0], pe[1], pe[2]), f"{what} eye"))
    for m, prays in (("light", pl[2]), ("eye", pe[3])):
        krays = int(rays[m].sum())
        check(abs(krays - prays) <= 1e-3 * prays, f"K12 {what} {m}: rays "
              f"{krays} vs plain {prays}")
    fbk = torch.zeros((n, 3), device=dev)
    kernels.bdpt_splat(scene, cam, lw["bufs"], lw["v0"], fbk, rays["splat"],
                       cfg)
    fbp = torch.zeros((n, 3), device=dev)
    _, prays_s = bdpt.light_trace_splat(scene, cam, lw["bufs"], lw["v0"],
                                        cfg, fbp)
    err11 = compare_image((fbk, int(rays["splat"].sum())), (fbp, prays_s),
                          f"{what} splat", "K11", 0.999)
    err13 = compare_k13(scene, cam, key_c, ew, lw, fbk, cfg, px, py, what)
    return err12, err11, max(err13.values())


def compare_k13(scene, cam, key_c, ew, lw, fb, cfg, px, py, what: str,
                rows=None) -> dict:
    """K13's two stages against their plain twins on the same inputs (the
    kernel walks' buffers ew, lw): bdpt_pairs against connect_pairs_plain
    over the pairs of valid non-delta eye vertices (compare_image, 99.5%;
    rays within 0.1%; where the plain terms are all zero, the kernel's must
    be too); bdpt_gather against connect_gather_plain on the kernel's terms
    (compare_image, 99.5%; the bit-equal share printed); then the composed
    pass kernels.bdpt_connect with the splat's frame buffer fb against
    connect_plain (compare_image, 99.5%). rows: [N] i32 += the pairs' rows,
    or None. Returns each comparison's max abs error."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import bdpt
    from cudapathtracer_tpu_torch.utils import rng
    n, dev = px.shape[0], px.device
    pid = rng.pixel_ids(px, py)
    rays = torch.zeros(n, dtype=torch.int32, device=dev)
    terms = kernels.bdpt_pairs(scene, cam, key_c, ew, lw, rays, cfg, px=px,
                               py=py, rows=rows)
    pterms, prays = bdpt.connect_pairs_plain(scene, key_c, ew["bufs"],
                                             lw["bufs"], cfg, pid)
    eb = ew["bufs"]
    live = (eb.valid & ~eb.is_delta)[:, None, :].expand(-1, cfg.light_depth,
                                                        -1)
    err = {}
    if bool((pterms[live] != 0).any()):
        err["pairs"] = compare_image(
            (terms[live], int(rays.sum())), (pterms[live], prays),
            f"{what} pairs ({int(live.sum())} of {live.numel()})", "K13",
            0.995)
    else:
        check(not bool((terms != 0).any()) and int(rays.sum()) == prays,
              f"K13 {what}: the plain pairs add nothing, the kernel's do")
        err["pairs"] = 0.0
    gk = kernels.bdpt_gather(scene, cam, ew, terms, None, cfg)
    gp = bdpt.connect_gather_plain(scene, cam, eb, ew["v0"], ew["escape"],
                                   terms, cfg)
    same = (gk.view(torch.int32) == gp.view(torch.int32)).all(dim=1)
    say("K13", f"{what} gather on the kernel's terms: bit-equal on "
        f"{same.float().mean().item():.6f} of the pixels")
    err["gather"] = compare_image((gk, 0), (gp, 0), f"{what} gather", "K13",
                                  0.995)
    crays = torch.zeros(n, dtype=torch.int32, device=dev)
    out, _ = kernels.bdpt_connect(scene, cam, key_c, ew, lw, fb, crays, cfg,
                                  px=px, py=py)
    outp, prays_c = bdpt.connect_plain(scene, cam, key_c, eb, ew["v0"],
                                       ew["escape"], lw["bufs"], lw["v0"],
                                       cfg, pid, fb)
    err["composed"] = compare_image((out, int(crays.sum())),
                                    (outp, prays_c), f"{what} connect",
                                    "K13", 0.995)
    return err


def compare_grid(k, p, what: str) -> None:
    """K8 (photon_pack, sort, photon_table) against build_grid on the same
    photons: sorted rows and the (start, end) table bit-equal."""
    import torch
    check(k.table_size == p.table_size and k.rows.shape == p.rows.shape,
          f"K8 {what}: grid shapes differ")
    bad_rows = int((k.rows.view(torch.int32) != p.rows.view(torch.int32))
                   .any(dim=1).sum())
    bad_se = int((k.cell_se != p.cell_se).any(dim=1).sum())
    check(bad_rows == 0 and bad_se == 0, f"K8 {what}: {bad_rows} rows and "
          f"{bad_se} (start, end) entries differ from the plain version")
    t = k.table_size
    invalid = int(k.cell_se[t, 1] - k.cell_se[t, 0])
    say("K8", f"{what}: {k.rows.shape[0]} sorted rows ({invalid} invalid in "
        f"the sentinel bucket), table of {t + 1} buckets (key wraps: "
        f"{t > 2 ** 24}): rows and (start, end) bit-equal")


def compare_photon_sort(bucket, salt, table_size: int, stats: dict,
                        what: str) -> tuple:
    """K8's sort (kernels.photon_sort) on photon_pack's buckets against its
    plain twin (hashgrid.radix_sort_plain) and torch.sort (stable) on the
    same keys (hashgrid.sort_keys of the buckets) as int64 and as
    sign-flipped int32: the order and the sorted buckets equal. Fills
    stats["photon_sort"] (the library times are the two torch.sort calls)
    and returns (order, bucket[order])."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.ops import hashgrid
    n = bucket.shape[0]
    bits = hashgrid.key_bits(table_size, hashgrid.REWEIGHT)
    order, sorted_h = kernels.photon_sort(bucket, bits, salt)
    k64 = hashgrid.sort_keys(bucket.to(torch.int64), salt)
    k32 = (k64 - 2 ** 31).to(torch.int32)      # uint32 order as int32
    lib64 = torch.sort(k64, stable=True).indices
    lib32 = torch.sort(k32, stable=True).indices
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    twin, twin_h = hashgrid.radix_sort_plain(k64, bits, bucket)
    t1.record()
    torch.cuda.synchronize()
    o64 = order.to(torch.int64)
    check(torch.equal(o64, lib64) and torch.equal(o64, lib32)
          and torch.equal(o64, twin), f"K8 sort {what}: the order differs "
          "from torch.sort's or the twin's")
    check(torch.equal(sorted_h, bucket[lib64]) and torch.equal(
        sorted_h, twin_h), f"K8 sort {what}: the sorted buckets differ")
    passes = -(-bits // hashgrid.RADIX_BITS)
    # input the buckets; outputs the order and bucket[order]; per photon
    # its key (~8 operations), and per pass and photon a digit, a match
    # and a rank (~10)
    stats["photon_sort"].update(
        bound=bound_ms(12 * n, (8 + 10 * passes) * n), max_abs_err=0.0,
        plain_ms=t0.elapsed_time(t1),
        ms=cuda_ms(lambda: kernels.photon_sort(bucket, bits, salt), 5),
        library_ms_int64=cuda_ms(lambda: torch.sort(k64, stable=True), 5),
        library_ms_int32=cuda_ms(lambda: torch.sort(k32, stable=True), 5))
    st = stats["photon_sort"]
    st["library_ms"] = min(st["library_ms_int64"], st["library_ms_int32"])
    say("K8", f"{what}: sort of {n} keys ({bits} bits, {passes} passes) "
        f"equal to torch.sort's order (int64 and int32 keys) and the twin's; "
        f"kernel {st['ms']:.4f} ms, torch.sort int64 "
        f"{st['library_ms_int64']:.4f} ms, int32 {st['library_ms_int32']:.4f}"
        f" ms, twin {st['plain_ms']:.1f} ms, bound {st['bound'][0]:.4f} ms")
    return order, sorted_h


def compare_records(k, p, what: str, tag: str) -> float:
    """The eye walk stage's records (models.vcm.EyeRecords [D, N]) against
    its plain twin's on the same pixels and keys. A path diverged where
    its flag words differ at some depth, or its points by > 1e-3 at a hit
    both made (the twin's traversal took another triangle, phase 5's edge
    ties): at most 0.1% of paths may. On the others, over the hit records:
    the material ids equal, the points, normals and directions within
    1e-4, thr, albedo and transmission within rtol 1e-4, d_vcm / d_vc /
    d_vm within rtol 1e-3 (atol 1e-6), the s=0 and NEE terms (and the sky
    term at escapes) within rtol 1e-3 (atol 1e-5), each on >= 99.9% of the
    records; the bit-equal share of the terms printed. Returns the worst
    term error."""
    import torch
    from cudapathtracer_tpu_torch.models import vcm
    kf, pf = k.flags, p.flags
    hit = (pf != 0) & ((pf & vcm.REC_ESCAPED) == 0)
    div = ((kf != pf) | (((k.pos - p.pos).abs().amax(dim=-1) > 1e-3)
                         & hit)).any(0)
    n = kf.shape[1]
    ndiv = int(div.sum())
    check(ndiv <= 1e-3 * n, f"{tag} {what}: {ndiv} of {n} paths diverged")
    m = hit & ~div[None]
    esc = ((pf & vcm.REC_ESCAPED) != 0) & ~div[None]
    nrec = int(m.sum())
    shares = {"mat_id": (k.mat_id[m] == p.mat_id[m]).float().mean()}
    close = lambda a, b, **tol: torch.isclose(a, b, **tol).reshape(
        a.shape[0], -1).all(dim=1).float().mean()
    for f in ("pos", "n", "to_prev"):
        shares[f] = close(getattr(k, f)[m], getattr(p, f)[m], rtol=0.0,
                          atol=1e-4)
    for f in ("thr", "albedo", "trans"):
        shares[f] = close(getattr(k, f)[m], getattr(p, f)[m], rtol=1e-4,
                          atol=1e-7)
    for f in ("d_vcm", "d_vc", "d_vm"):
        shares[f] = close(getattr(k, f)[m], getattr(p, f)[m], rtol=1e-3,
                          atol=1e-6)
    terms = {"implicit": (m | esc), "nee": m}
    worst = 0.0
    parts = []
    for f, mm in terms.items():
        a, b = getattr(k, f)[mm], getattr(p, f)[mm]
        shares[f] = close(a, b, rtol=1e-3, atol=1e-5)
        if a.numel():
            worst = max(worst, (a - b).abs().max().item())
            parts.append(f"{f} bit-equal "
                         f"{(a.view(torch.int32) == b.view(torch.int32)).all(dim=1).float().mean().item():.6f}")
    for f, sh in shares.items():
        sh = sh.item() if nrec else 1.0
        check(sh >= 0.999, f"{tag} {what}: {f} within its bound on only "
              f"{sh:.5f} of the records")
        parts.append(f"{f} {sh:.6f}")
    say(tag, f"{what} walk records: {n} paths, {ndiv} diverged; {nrec} hit "
        f"records and {int(esc.sum())} escapes compared, worst term error "
        f"{worst:.3g}; share within bounds: " + ", ".join(parts))
    return worst


def compare_eye_stages(ep, walk_plain, connect_plain, gather_plain,
                       out_rows, what: str, tag: str) -> dict:
    """The three stage kernels of a set-up eye pass (kernels.vcm_eye_pass
    or mega_eye_pass, rays zero) against their plain twins on the same
    inputs: the walk's records from the same pixels and keys
    (compare_records; rays equal); the connections on the kernel walk's
    records, over the pairs whose eye record ran its strategies
    (compare_image, 99.5%; rays equal); the gather on the kernel's records
    and connections (compare_image, 99.5%; dropped photons equal).
    walk_plain() -> (records, rays); connect_plain(records) -> (conn,
    rays); gather_plain(records, conn) -> (radiance, dropped); out_rows:
    the rows of ep.out the pass writes. Returns per stage (max abs error,
    plain CUDA-event ms), the stages' rays and rows (ep.rows, if set), the
    live record and pair counts and the walk's lane counts (bounces, the
    warps' busiest lanes, the warps' calls)."""
    import torch
    from cudapathtracer_tpu_torch import kernels

    def timed(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return res, ev[0].elapsed_time(ev[1])

    def counts():
        torch.cuda.synchronize()
        return (int(ep.rays.sum()),
                int(ep.rows.sum()) if ep.rows is not None else 0)
    res = {}
    r0, w0 = counts()
    lanes = torch.zeros(3, dtype=torch.int64, device=ep.rays.device)
    kernels.eye_walk(ep, lanes=lanes)
    r1, w1 = counts()
    (prec, prays), pms = timed(walk_plain)
    check(r1 - r0 == prays, f"{tag} {what}: walk rays kernel {r1 - r0} vs "
          f"plain {prays}")
    res["walk"] = (compare_records(ep.rec, prec, what, tag), pms)
    del prec
    flags = ep.rec.flags
    live = (flags & 3) == 3
    res.update(rays={"walk": r1 - r0}, rows={"walk": w1 - w0},
               records=int((flags != 0).sum()), live=int(live.sum()),
               pairs=0, lanes=lanes.tolist())
    check(res["lanes"][0] == res["records"], f"{tag} {what}: the walk's "
          f"{res['lanes'][0]} bounces vs {res['records']} records")
    if ep.conn is not None:
        kernels.eye_connect(ep)
        r2, w2 = counts()
        (pconn, prays), pms = timed(lambda: connect_plain(ep.rec))
        pairs = live[:, None, :].expand(-1, ep.conn.shape[1], -1)
        res["connect"] = (compare_image(
            (ep.conn[pairs], r2 - r1), (pconn[pairs], prays),
            f"{what} connections ({int(pairs.sum())} pairs)", tag, 0.995),
            pms)
        check(r2 - r1 == prays, f"{tag} {what}: connection rays kernel "
              f"{r2 - r1} vs plain {prays}")
        res["rays"]["connect"], res["rows"]["connect"] = r2 - r1, w2 - w1
        res["pairs"] = int(pairs.sum())
        del pconn
    kernels.eye_gather(ep)
    (pli, pdrop), pms = timed(lambda: gather_plain(ep.rec, ep.conn))
    res["gather"] = (compare_image((ep.out[out_rows], 0), (pli, 0),
                                   f"{what} gather", tag, 0.995), pms)
    kd = int(ep.dropped.sum())
    check(kd == pdrop, f"{tag} {what}: gather dropped kernel {kd} vs plain "
          f"{pdrop}")
    return res


def compare_vcm(scene, cam, px, py, cfg, sample_idx: int, what: str) -> dict:
    """One VCM/SPPM sample's kernels against their plain versions on the
    same inputs: K12's light walk with eta_vcm (the kernel's buffers feed
    both sides), then vcm_splat against vcm_light_splat (compare_image,
    99.9%), K8 against build_grid (compare_grid), and vcm_eye against
    eye_pass_plain on the same buffers and grid (compare_image, 99.5%;
    dropped photons equal), then its three stage kernels against their
    plain twins (compare_eye_stages). Returns the errors, the inputs, the
    plain versions' CUDA-event milliseconds, the stages' results and the
    set-up pass (eps)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    n, dev = px.shape[0], px.device
    key_l, key_e = vcm.sample_keys(rng.base_key(), sample_idx)
    mr, eta, norm = vcm.sample_scalars(scene, cfg, sample_idx, n)
    salt = hashgrid.photon_salt(sample_idx)
    z = lambda: torch.zeros(n, dtype=torch.int32, device=dev)
    lw = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_l, "light"),
                           mode="light", max_depth=cfg.light_depth + 1,
                           rays=z(), eta_vcm=eta)
    lb = lw["bufs"]
    out = dict(lbufs=lb, mr=mr, eta=eta, norm=norm, salt=salt, keys_e=key_e,
               err_splat=0.0, plain_ms={})

    def timed(name, fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = fn()
        ev[1].record()
        torch.cuda.synchronize()
        out["plain_ms"][name] = ev[0].elapsed_time(ev[1])
        return res
    if cfg.light_trace:
        fbk, srays = torch.zeros((n, 3), device=dev), z()
        kernels.vcm_splat(scene, cam, lb, fbk, srays, cfg, eta)
        fbp = torch.zeros((n, 3), device=dev)
        _, prays = timed("vcm_splat", lambda: vcm.vcm_light_splat(
            scene, cam, lb, cfg, eta, fbp))
        out["err_splat"] = compare_image((fbk, int(srays.sum())),
                                         (fbp, prays), f"{what} vcm splat",
                                         "K11", 0.999)
        check(int(srays.sum()) == prays, f"K11 {what}: vcm splat rays "
              f"{int(srays.sum())} vs plain {prays}")
    kgrid = hashgrid.build_grid_kernel(lb, scene.scene_min, mr, salt)
    def pack_plain():
        rows, valid = hashgrid.photon_rows(lb)
        return (rows, valid) + hashgrid.grid_keys(
            rows, valid, scene.scene_min, 2.0 * mr, kgrid.table_size, salt)
    rows, valid, h, key = timed("photon_pack", pack_plain)
    order = torch.sort(key, stable=True).indices
    prows, pse = timed("photon_table", lambda: hashgrid.grid_table(
        rows, h, order, kgrid.table_size))
    pgrid = hashgrid.PhotonGrid(prows, pse, tuple(scene.scene_min), 2.0 * mr,
                                kgrid.table_size)
    compare_grid(kgrid, pgrid, what)
    grid = kgrid if cfg.do_merge else None
    erays = z()
    outk, dropk, _ = kernels.vcm_eye(
        scene, cam, paths.walk_keys(key_e, "eye"), lb, grid, None, erays,
        cfg, px=px, py=py, merge_radius=mr, eta_vcm=eta, merge_norm=norm,
        **hashgrid.merge_switches(cfg.max_per_cell))
    outp, prays_e, dropp = timed("vcm_eye", lambda: vcm.eye_pass_plain(
        scene, cam, key_e, lb, grid, cfg, px, py, mr, eta, norm))
    out["err_eye"] = compare_image((outk, int(erays.sum())),
                                   (outp, prays_e), f"{what} eye pass",
                                   "K13v", 0.995)
    dk = int(dropk.sum())
    check(dk == dropp, f"K9 {what}: dropped photons kernel {dk} vs plain "
          f"{dropp}")
    say("K9", f"{what}: merge cap dropped {dk} candidate photons (plain "
        f"{dropp})")
    # the three stages, each against its plain twin on the same inputs
    ep = kernels.vcm_eye_pass(
        scene, cam, paths.walk_keys(key_e, "eye"), lb, grid, None, z(), cfg,
        px=px, py=py, merge_radius=mr, eta_vcm=eta, merge_norm=norm,
        with_rows=True, **hashgrid.merge_switches(cfg.max_per_cell))
    out["stages"] = compare_eye_stages(
        ep, lambda: vcm.eye_walk_plain(scene, cam, key_e, cfg, px, py, eta),
        lambda rec: vcm.eye_connect_plain(scene, rec, lb, cfg, eta),
        lambda rec, conn: vcm.eye_gather_plain(scene, rec, conn, grid, cfg,
                                               mr, eta, norm),
        slice(None), what, "K13v")
    out.update(grid=kgrid, photons=int(valid.sum()), dropped=dk, eps=[ep])
    return out


def stage_errs(stats: dict, name: str, st: dict) -> None:
    """Fold a stage comparison's errors into the kernel line's rows."""
    for stage in EYE_STAGES:
        if stage in st:
            row = stats[f"{name}_{stage}"]
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0),
                                     st[stage][0])


def add_stages(acc: dict, res: dict) -> dict:
    """Sum compare_eye_stages' results over chunks or runs: the worst
    error and the summed plain ms per stage, the counts summed."""
    for k in ("walk", "connect", "gather"):
        if k in res:
            e, ms = res[k]
            pe, pms = acc.get(k, (0.0, 0.0))
            acc[k] = (max(pe, e), pms + ms)
    for k in ("records", "live", "pairs"):
        acc[k] = acc.get(k, 0) + res[k]
    acc["lanes"] = [a + b for a, b in zip(acc.get("lanes", (0, 0, 0)),
                                          res["lanes"])]
    for k in ("rays", "rows"):
        d = acc.setdefault(k, {})
        for st, v in res[k].items():
            d[st] = d.get(st, 0) + v
    return acc


def rgb9e5_inputs(n: int, seed: int = 17):
    """[n,3] float32 colours for K10's RGB9E5: zeros, negatives, tiny and
    subnormal values, values above the 9e5 maximum and infinities, values
    within 64 ulps of every power of two the exponent meets, values on the
    mantissa's rounding edges ((m + 1/2) 2^(e-9)), then lognormal values
    over the codec's whole range."""
    import numpy as np
    import torch
    gen = np.random.default_rng(seed)
    edge = [np.array([0.0, -0.0, -1.0, -1e30, 1e-45, 1e-38, 1e-30, 1e-10,
                      3e-5, 65408.0, 65409.0, 1e5, 1e30, np.inf],
                     np.float32)]
    for k in range(-26, 18):
        b = np.float32(2.0 ** k).view(np.int32)
        edge.append((b + np.arange(-64, 65)).astype(np.int32)
                    .view(np.float32))
    m = np.arange(512, dtype=np.float64) + 0.5
    for e in range(-15, 17):
        edge.append((m * 2.0 ** (e - 9)).astype(np.float32))
    edge = np.concatenate(edge)
    k = edge.size
    c = np.empty((n, 3), np.float32)
    c[:k, 0] = edge
    c[:k, 1] = gen.permutation(edge) * gen.uniform(0, 1, k)
    c[:k, 2] = gen.permutation(edge)
    c[k:] = gen.lognormal(-2.0, 4.0, (n - k, 3))
    return torch.as_tensor(c)


def compare_rgb9e5(k, c, what: str) -> None:
    """K10's RGB9E5 (rgb9e5_roundtrip's (packed, decoded)) against the plain
    codec on the same colours c: both bit-equal."""
    import torch
    from cudapathtracer_tpu_torch.utils import packing
    pp = packing.pack_rgb9e5(c)
    pd = packing.unpack_rgb9e5(pp)
    bad = int(((k[0] != pp) | (k[1].view(torch.int32) != pd.view(torch.int32))
               .any(dim=1)).sum())
    check(bad == 0, f"K10 RGB9E5 {what}: {bad} of {c.shape[0]} colours "
          "differ from the plain codec")


def compare_slots(grid, q, active, mr: float, cap: int, what: str,
                  cap_q: int = 16) -> int:
    """K9's materialised forms (neighbor_slots.cu) against the plain
    neighbor_slots, neighbor_slots_compact and gather_neighbors on the same
    grid and queries q [N,3] (active [N]): rows, ok and weights bit-equal,
    dropped counts equal, in the mode TPT_GRID_ONE_BRICK selects. Returns
    the slots in range."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.ops import hashgrid
    sw = dict(one_brick=hashgrid.one_brick_active(cap),
              reweight=hashgrid.REWEIGHT)
    bits = lambda t: t.view(torch.int32)
    found = 0
    for mode in ("slots", "compact", "gather"):
        k = kernels.neighbor_slots(grid, q, mr, cap, mode=mode, cap_q=cap_q,
                                   active=active, **sw)
        if mode == "slots":
            p = hashgrid.neighbor_slots(grid, q, mr, cap, active=active)
        elif mode == "compact":
            p = hashgrid.neighbor_slots_compact(grid, q, mr, cap, cap_q,
                                                active=active)
        else:
            rows, ok = zip(*hashgrid.gather_neighbors(grid, q, mr, cap,
                                                      active=active))
            p = (torch.stack(rows), torch.stack(ok), None, None)
        bad = [int((bits(k[0]) != bits(p[0])).any(dim=-1).sum()),
               int((k[1] != p[1]).sum())]
        if p[2] is not None:
            bad.append(int((bits(k[2]) != bits(p[2])).sum()))
            kd = int(k[3].sum())
            check(kd == p[3], f"K9 {what} {mode}: dropped {kd} vs plain "
                  f"{p[3]}")
        check(sum(bad) == 0, f"K9 {what} {mode}: {bad} slots differ "
              "(rows, ok, wgt)")
        found += int(k[1].sum())
        say("K9", f"{what} {mode}: {k[0].shape[0]} slots x {q.shape[0]} "
            f"queries bit-equal (rows, ok{'' if p[2] is None else ', wgt'}"
            f"), {int(k[1].sum())} in range"
            + ("" if p[3] is None else f", dropped {p[3]}"))
    return found


def first_hits(scene, cam, px, py, sample_idx: int):
    """The eye paths' first hit points (pixels px, py; the mega engine's
    primary rays) and whether each ray hit: (points [N,3], hit [N])."""
    from cudapathtracer_tpu_torch.models import vcm
    from cudapathtracer_tpu_torch.ops import traverse8
    from cudapathtracer_tpu_torch.utils import rng
    _, key_e = vcm.sample_keys(rng.base_key(), sample_idx)
    o, d = cam.generate_rays(rng.fold_in(key_e, 2 ** 20), px.float(),
                             py.float(), rng.pixel_ids(px, py))
    h = traverse8.closest_hit8(scene, o, d)
    return (o + d * h.t[:, None]).contiguous(), h.valid.contiguous()


def mega_inputs(scene, px, py, cfg, flavor: str, sample_idx: int,
                chunks) -> list:
    """Per chunk of the mega engines' partition, the inputs its eye pass
    reads, from the kernels: the light walk (K12, pads masked) and, under
    VCM with the merge, the grid (K8). -> list of dicts (pxc, pyc, cnt,
    gbase, lbufs, grid, mr, eta, norm)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm, vcm_mega
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    key_l, _ = vcm.sample_keys(rng.base_key(), sample_idx)
    out = []
    for ci in range(chunks.n_chunks):
        pxc, pyc, cnt = vcm_mega.chunk_pixels_of(px, py, ci, chunks.c_pix)
        rays = torch.zeros(chunks.c_pix, dtype=torch.int32, device=px.device)
        if flavor == "vcm":
            mr, eta, norm = vcm_mega.chunk_scalars(scene, cfg, sample_idx, cnt)
            lw = kernels.bdpt_walk(scene, pxc, pyc,
                                   paths.walk_keys(key_l, "light"),
                                   mode="light",
                                   max_depth=cfg.light_depth + 1, rays=rays,
                                   eta_vcm=eta)
        else:
            mr = eta = norm = 0.0
            lw = kernels.bdpt_walk(scene, pxc, pyc,
                                   paths.walk_keys(key_l, "light"),
                                   mode="light", max_depth=cfg.light_depth,
                                   rays=rays)
        lb = vcm_mega.mask_pads(lw["bufs"], cnt)
        grid = None
        if flavor == "vcm" and cfg.do_merge:
            grid = hashgrid.build_grid_kernel(
                lb, scene.scene_min, mr, hashgrid.photon_salt(sample_idx))
        out.append(dict(pxc=pxc, pyc=pyc, cnt=cnt, gbase=ci * chunks.c_pix,
                        lbufs=lb, grid=grid, mr=mr, eta=eta, norm=norm))
    return out


def mega_eye_kernel(scene, cam, cfg, flavor, sample_idx, ch, out, rays,
                    with_rows=False):
    """K14 over one chunk's inputs ch (mega_inputs) into out [P,3] and rays
    [c_pix]; -> (dropped [c_pix], rows or None)."""
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import vcm, vcm_mega
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    _, key_e = vcm.sample_keys(rng.base_key(), sample_idx)
    sw = (hashgrid.merge_switches(cfg.max_per_cell) if flavor == "vcm"
          else {})
    return kernels.mega_eye(
        scene, cam, vcm_mega.eye_keys(key_e), ch["lbufs"], ch["grid"], out,
        rays, cfg, px=ch["pxc"], py=ch["pyc"], cnt=ch["cnt"],
        gbase=ch["gbase"], flavor=flavor, merge_radius=ch["mr"],
        eta_vcm=ch["eta"], merge_norm=ch["norm"], with_rows=with_rows, **sw)


def mega_eye_plain(scene, cam, cfg, flavor, sample_idx, ch):
    """The plain K14 over one chunk's inputs: (radiance [cnt,3], rays,
    dropped)."""
    from cudapathtracer_tpu_torch.models import vcm, vcm_mega
    from cudapathtracer_tpu_torch.utils import rng
    _, key_e = vcm.sample_keys(rng.base_key(), sample_idx)
    cnt = ch["cnt"]
    return vcm_mega.eye_pass_plain(
        scene, cam, key_e, ch["lbufs"], ch["grid"], cfg, ch["pxc"][:cnt],
        ch["pyc"][:cnt], ch["gbase"], flavor=flavor, mr=ch["mr"],
        eta_vcm=ch["eta"], merge_norm=ch["norm"])


def compare_mega(scene, cam, px, py, cfg, flavor: str, sample_idx: int,
                 what: str, width: int = 0, chunk_pixels: int = 0) -> dict:
    """K14 (mega_eye) against its plain version on every chunk of a sample,
    on the same inputs (mega_inputs: the kernels' light walk and grid):
    rays and dropped photons equal, >= 99.9% of pixels within rtol 1e-3
    (the share bit-equal printed). cfg: a VCMConfig (BDPT's via
    bdpt_mega.as_machine_cfg). Returns the error, the chunks' inputs and
    the plain version's CUDA-event milliseconds summed over the chunks."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import vcm, vcm_mega
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    p_total, dev = px.shape[0], px.device
    chunks = vcm_mega.mega_chunks(p_total, chunk_pixels, width)
    inputs = mega_inputs(scene, px, py, cfg, flavor, sample_idx, chunks)
    outk = torch.zeros((p_total, 3), device=dev)
    outp = torch.zeros((p_total, 3), device=dev)
    rk = rp = dk = dp = 0
    plain_ms = 0.0
    for ch in inputs:
        rays = torch.zeros(ch["pxc"].shape[0], dtype=torch.int32, device=dev)
        drop, _ = mega_eye_kernel(scene, cam, cfg, flavor, sample_idx, ch,
                                  outk, rays)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        li, r, d = mega_eye_plain(scene, cam, cfg, flavor, sample_idx, ch)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms += ev[0].elapsed_time(ev[1])
        outp[ch["gbase"]:ch["gbase"] + ch["cnt"]] = li
        rk, rp = rk + int(rays.sum()), rp + r
        dk, dp = dk + int(drop.sum()), dp + d
    same = (outk.view(torch.int32) == outp.view(torch.int32)).all(dim=1)
    say("K14", f"{what}: {chunks.n_chunks} chunk(s) of {chunks.c_pix} "
        f"({chunks.n_chunks * chunks.c_pix - p_total} pad), bit-equal pixels "
        f"{same.float().mean().item():.6f}, dropped kernel {dk} plain {dp}")
    check(rk == rp, f"K14 {what}: rays kernel {rk} vs plain {rp}")
    check(dk == dp, f"K14 {what}: dropped kernel {dk} vs plain {dp}")
    err = compare_image((outk, rk), (outp, rp), what, "K14", 0.999)
    # the three stages of each chunk, each against its plain twin on the
    # same inputs
    _, key_e = vcm.sample_keys(rng.base_key(), sample_idx)
    outs = torch.zeros((p_total, 3), device=dev)
    sw = (hashgrid.merge_switches(cfg.max_per_cell) if flavor == "vcm"
          else {})
    stages, eps = {}, []
    for ci, ch in enumerate(inputs):
        cnt, g0, lb = ch["cnt"], ch["gbase"], ch["lbufs"]
        ep = kernels.mega_eye_pass(
            scene, cam, vcm_mega.eye_keys(key_e), lb, ch["grid"], outs,
            torch.zeros(ch["pxc"].shape[0], dtype=torch.int32, device=dev),
            cfg, px=ch["pxc"], py=ch["pyc"], cnt=cnt, gbase=g0,
            flavor=flavor, merge_radius=ch["mr"], eta_vcm=ch["eta"],
            merge_norm=ch["norm"], with_rows=True, **sw)
        add_stages(stages, compare_eye_stages(
            ep, lambda: vcm_mega.eye_walk_plain(
                scene, cam, key_e, cfg, ch["pxc"][:cnt], ch["pyc"][:cnt], g0,
                flavor=flavor, eta_vcm=ch["eta"]),
            lambda rec: vcm_mega.eye_connect_plain(
                scene, rec, lb, cfg, flavor=flavor, eta_vcm=ch["eta"]),
            lambda rec, conn: vcm_mega.eye_gather_plain(
                scene, rec, conn, ch["grid"], cfg, flavor=flavor,
                mr=ch["mr"], eta_vcm=ch["eta"], merge_norm=ch["norm"]),
            slice(g0, g0 + cnt), f"{what} chunk {ci}", "K14"))
        eps.append(ep)
    return dict(err=err, inputs=inputs, plain_ms=plain_ms, chunks=chunks,
                same=same.float().mean().item(), stages=stages, eps=eps)


def time_mega(scene, cam, cfg, flavor: str, sample_idx: int, inputs):
    """K14 over every chunk's inputs (mega_inputs): (CUDA-event ms of one
    sample's eye pass, summed over the chunks; BVH8 rows its rays
    visited)."""
    import torch
    p_total = sum(ch["cnt"] for ch in inputs)
    dev = inputs[0]["pxc"].device
    out = torch.zeros((p_total, 3), device=dev)
    ms, rows = 0.0, 0
    for ch in inputs:
        rays = torch.zeros(ch["pxc"].shape[0], dtype=torch.int32, device=dev)
        _, r = mega_eye_kernel(scene, cam, cfg, flavor, sample_idx, ch, out,
                               rays, with_rows=True)
        rows += int(r.sum())
        ms += cuda_ms(lambda: mega_eye_kernel(scene, cam, cfg, flavor,
                                              sample_idx, ch, out, rays), 2)
    return ms, rows


def render_path(cfg, tag: str, card: str, want: dict,
                min_lit: float = 0.9) -> tuple:
    """One main path through Renderer(device="cuda") with the launch
    counters zeroed just before its render: prints the time to Renderer
    ready, rays, the render phase, Mrays/s (per second of the render phase,
    as RenderMetrics counts it; the wall time also holds the final image's
    host tonemap), peak memory, launches per sample and the merge-cap
    dropped photons; checks a finite, non-negative image of the configured
    shape, more than min_lit of it non-black, and the launch counts in
    `want`; saves the BMP under OUT_DIR. Returns (the Renderer, its
    launches)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.driver import Renderer
    t0 = time.perf_counter()
    r = Renderer(cfg, device="cuda")
    c = r.cfg
    say(tag, f"Renderer ready in {time.perf_counter() - t0:.1f} s: "
        f"{r.scene.num_triangles} triangles, {c.integrator}, engine "
        f"{c.engine}, {c.width}x{c.height}, depth {c.max_depth}, eye / light "
        f"depth {c.bdpt_eye_depth} / {c.bdpt_light_depth}, "
        f"{c.sample_count} spp")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    r.render(progressive=False, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    acc = r.accum
    bad = int((~torch.isfinite(acc)).any(dim=1).sum()
              + (acc < 0).any(dim=1).sum())
    fb = r.framebuffer()
    nonblack = float((fb.max(axis=-1) > 0.0).mean())
    rays, phase = r.metrics.rays_traced, r.metrics.render_seconds
    per_sample = {k: v / c.sample_count for k, v in launches.items() if v}
    say(tag, f"{rays} rays in a {phase:.3f} s render phase = "
        f"{rays / phase / 1e6:.3f} Mrays/s ({card}); {secs:.3f} s with the "
        f"final image; peak memory {peak_gib(base)}; launches per sample "
        f"{per_sample}; merge-cap dropped photons "
        f"{r.metrics.merge_dropped}; non-black {nonblack:.4f}; bad pixels "
        f"{bad}")
    check(fb.shape == (c.height, c.width, 3), f"{tag}: framebuffer shape "
          f"{fb.shape}")
    check(bad == 0, f"{tag}: {bad} NaN/Inf/negative pixels")
    check(nonblack > min_lit, f"{tag}: only {nonblack:.3f} of pixels "
          "non-black")
    check(all(launches[k] == v for k, v in want.items()),
          f"{tag}: launches {launches}, expected {want}")
    r.finish().save_bmp(os.path.join(OUT_DIR, f"{c.name}.bmp"))
    return r, launches


def rows_of_sample(integ: str, scene, cam, px, py, cfg) -> tuple:
    """One sample of a classic integrator launched as its render_kernel
    launches it, with each launch's rows counted: (rows visited, rays
    traced), both summed over the frame. cfg: the max depth
    (UNIDIRECTIONAL, NAIVE_UNIDIRECTIONAL), a BDPTConfig or a VCMConfig."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import (bdpt, paths, unidirectional,
                                                 vcm)
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    base, n, dev = rng.base_key(), px.shape[0], px.device
    if integ in ("UNIDIRECTIONAL", "NAIVE_UNIDIRECTIONAL"):
        classic = integ == "UNIDIRECTIONAL"
        _, rays, rows = kernels.render_unidirectional(
            scene, px, py, cam.kernel_params(), base, 0, 1, max_depth=cfg,
            use_mis=classic, sample_environment=False,
            schedule="classic" if classic else "naive",
            air_priority=scene.air_priority, with_rows=True)
        return int(rows.sum()), int(rays.sum())
    rays = torch.zeros(n, dtype=torch.int32, device=dev)
    fb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if integ == "BIDIRECTIONAL":
        key_l, key_e, key_c = bdpt.sample_keys(base, 0)
        lw = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_l, "light"),
                               mode="light", max_depth=cfg.light_depth,
                               rays=rays, with_rows=True)
        rows = [lw["rows"], kernels.bdpt_splat(
            scene, cam, lw["bufs"], lw["v0"], fb, rays, cfg, with_rows=True)]
        ew = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_e, "eye"),
                               mode="eye", max_depth=cfg.eye_depth, rays=rays,
                               camera=cam, with_rows=True)
        rows += [ew["rows"], kernels.bdpt_connect(
            scene, cam, key_c, ew, lw, fb, rays, cfg, px=px, py=py,
            with_rows=True)[1]]
        return sum(int(r.sum()) for r in rows), int(rays.sum())
    key_l, key_e = vcm.sample_keys(base, 0)
    mr, eta, norm = vcm.sample_scalars(scene, cfg, 0, n)
    lw = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_l, "light"),
                           mode="light", max_depth=cfg.light_depth + 1,
                           rays=rays, eta_vcm=eta, with_rows=True)
    rows = [lw["rows"]]
    if cfg.light_trace:
        rows.append(kernels.vcm_splat(scene, cam, lw["bufs"], fb, rays, cfg,
                                      eta, with_rows=True))
    grid = (hashgrid.build_grid_kernel(lw["bufs"], scene.scene_min, mr,
                                       hashgrid.photon_salt(0))
            if cfg.do_merge else None)
    rows.append(kernels.vcm_eye(
        scene, cam, paths.walk_keys(key_e, "eye"), lw["bufs"], grid, fb,
        rays, cfg, px=px, py=py, merge_radius=mr, eta_vcm=eta,
        merge_norm=norm, with_rows=True,
        **hashgrid.merge_switches(cfg.max_per_cell))[2])
    return sum(int(r.sum()) for r in rows), int(rays.sum())


def same_input_eye(tsc, s8, cam, px, py, cfg) -> None:
    """The photon kernels on both engines of one scene (tsc threaded, s8
    its BVH8 view): K12's light walk (with the VCM chain) at the same point
    on >= 99.999% of its valid vertices (the rest exact ties); on the same
    light buffers (the threaded walk of sample 0) the VCM splat (K11) under
    compare_image at 99% of the pixels and K13's VCM form on the same
    photon grid at 99.5%, as phase 16 holds the eye kernel."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    n, dev = px.shape[0], px.device
    key_l, key_e = vcm.sample_keys(rng.base_key(), 0)
    mr, eta, norm = vcm.sample_scalars(tsc, cfg, 0, n)
    walks = [kernels.bdpt_walk(
        sc, px, py, paths.walk_keys(key_l, "light"), mode="light",
        max_depth=cfg.light_depth + 1,
        rays=torch.zeros(n, dtype=torch.int32, device=dev),
        eta_vcm=eta)["bufs"] for sc in (tsc, s8)]
    v = walks[0].valid | walks[1].valid
    same = ((walks[0].pt == walks[1].pt).all(dim=-1) & walks[0].valid
            & walks[1].valid)[v].float().mean().item()
    say("threaded", f"light walks of the two engines: {int(v.sum())} "
        f"vertices valid on either, {same:.7f} of them valid on both at the "
        "same point")
    check(same >= 0.99999, f"threaded light walk: only {same:.7f} of the "
          "vertices at the same point on both engines")
    if cfg.light_trace:
        fbs = []
        for sc in (tsc, s8):
            fb = torch.zeros((n, 3), device=dev)
            rays = torch.zeros(n, dtype=torch.int32, device=dev)
            kernels.vcm_splat(sc, cam, walks[0], fb, rays, cfg, eta)
            fbs.append((fb, rays.sum()))
        compare_image(fbs[0], fbs[1], "VCM splat (K11), threaded vs BVH8 "
                      "on the same light buffers", "threaded", 0.99)
        del fbs
    grid = (hashgrid.build_grid_kernel(walks[0], tsc.scene_min, mr,
                                       hashgrid.photon_salt(0))
            if cfg.do_merge else None)
    out = []
    for sc in (tsc, s8):
        rays = torch.zeros(n, dtype=torch.int32, device=dev)
        li, dropped, _ = kernels.vcm_eye(
            sc, cam, paths.walk_keys(key_e, "eye"), walks[0], grid, None,
            rays, cfg, px=px, py=py, merge_radius=mr, eta_vcm=eta,
            merge_norm=norm, **hashgrid.merge_switches(cfg.max_per_cell))
        out.append((li, rays.sum(), int(dropped.sum())))
    say("threaded", f"dropped photons on the same grid {out[0][2]} and "
        f"{out[1][2]}")
    check(out[0][2] == out[1][2], "threaded eye pass: dropped photons differ "
          "on the same grid")
    compare_image(out[0][:2], out[1][:2], "eye pass (K13 VCM form), threaded "
                  "vs BVH8 on the same light buffers and grid", "threaded",
                  0.995)


def eye_stage_stats(stats: dict, name: str, st: dict, eps: list,
                    depth: int, lrows: int, n: int, tbytes: int,
                    lbytes: int, gbytes: int, fb_bytes: int = 0) -> None:
    """Each stage's row of the kernels line for the eye pass `name` from
    compare_eye_stages' results st (summed over the pass's set-up chunks
    eps): its CUDA-event ms (the stage relaunched on every chunk), its
    plain twin's ms, its error and its bound. Bytes: the scene tables once
    per stage that traces, the records (RECORD_BYTES a vertex the walk
    reached, 4 a depth it did not) written by the walk and read by the
    others (84 bytes of a vertex by the connections), K12's light vertices
    and the pair contributions (12 bytes), the grid, the pixels, rays and
    outputs; operations: the rows the stage visited (ptxas-counted
    OPS_PER_ROW), the camera rays and walk vertices, the decoded light
    vertices, the merge queries."""
    from cudapathtracer_tpu_torch import kernels
    recs, live, pairs = st["records"], st["live"], st["pairs"]
    dead = depth * n - recs
    bounds = {
        "walk": (tbytes + n * 16 + recs * RECORD_BYTES + dead * 4,
                 st["rows"]["walk"] * OPS_PER_ROW + n * OPS_PER_CAMERA_RAY
                 + recs * OPS_PER_WALK_VERTEX),
        "connect": (tbytes + live * 84 + lbytes + pairs * 12 + n * 8,
                    st["rows"].get("connect", 0) * OPS_PER_ROW
                    + pairs * OPS_PER_DECODE),
        "gather": (live * RECORD_BYTES + pairs * 12 + gbytes + n * 16
                   + fb_bytes, live * OPS_PER_QUERY),
    }
    for stage, (nbytes, ops) in bounds.items():
        row = f"{name}_{stage}"
        if stage not in st:
            stats[row].update(bound=bound_ms(nbytes, ops), max_abs_err=0.0,
                              ms=0.0, plain_ms=0.0)
            continue
        fn = getattr(kernels, f"eye_{stage}")
        stats[row].update(
            bound=bound_ms(nbytes, ops),
            max_abs_err=max(stats[row].get("max_abs_err", 0.0),
                            st[stage][0]),
            plain_ms=st[stage][1],
            ms=sum(cuda_ms(lambda: fn(ep), 2) for ep in eps))
        if stage == "gather" and gbytes:
            # K9's share: the same gather with the merge switched off
            bare = sum(cuda_ms(lambda: kernels.eye_gather(ep, merge=False), 2)
                       for ep in eps)
            stats[row]["merge_ms"] = stats[row]["ms"] - bare
            stats[row]["merge_bound"] = bound_ms(gbytes + live * 16,
                                                 live * OPS_PER_QUERY)
            say(name, f"K9 (the merge query) in the gather: "
                f"{stats[row]['merge_ms']:.3f} of {stats[row]['ms']:.3f} ms "
                f"(bound {stats[row]['merge_bound'][0]:.4f} ms, "
                f"{stats[row]['merge_bound'][1]})")
    stats[f"{name}_walk"].update(lane_stats(st["lanes"]))
    k12 = stats["bdpt_walk"].get("lane_use")
    say(name, f"walk on persistent lanes: lane use "
        f"{stats[f'{name}_walk']['lane_use']:.4f}, event balance "
        f"{stats[f'{name}_walk']['event_balance']:.4f} (K12's walks "
        + (f"{k12:.4f})" if k12 is not None else "not run)"))
    say(name, "stages: " + ", ".join(
        f"{stage} {stats[f'{name}_{stage}']['ms']:.3f} ms (bound "
        f"{stats[f'{name}_{stage}']['bound'][0]:.4f}, "
        f"{stats[f'{name}_{stage}']['bound'][1]}; plain "
        f"{stats[f'{name}_{stage}']['plain_ms']:.3f})"
        for stage in bounds if stage in st)
        + f"; {recs} records ({live} with strategies), {pairs} pairs, rays "
        f"{st['rays']}, rows {st['rows']}")


def b1_batch(r, stats: dict, card: str) -> None:
    """B1, samples per dispatch, at the batched main path's shape (r: the
    256x256 UNIDIRECTIONAL Renderer at 8 per dispatch): one launch of K5
    with k = 8 timed by CUDA events, held against the plain batch
    (models/batch.py's loop over K5's plain version) under compare_render,
    and its bound from the rows that launch visited."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import unidirectional
    from cudapathtracer_tpu_torch.models.batch import make_batched
    k, sc, n = 8, r.scene, r.px.shape[0]
    kw = dict(max_depth=r.cfg.max_depth, use_mis=True,
              sample_environment=r.cfg.sample_environment)
    bli, brays = r.render_batch(0, k)[:2]
    ms = cuda_ms(lambda: r.render_batch(0, k), 5)
    pbatch = []
    plain_ms = cuda_ms(lambda: pbatch.append(make_batched(
        lambda sc_, c_, k_, s_, x_, y_: unidirectional.render_plain(
            sc_, c_, k_, s_, x_, y_, schedule="mega", **kw))(
                sc, r.camera, r.key, 0, r.px, r.py, k)), 1, warmup=0)
    err = compare_render((bli, brays), pbatch[0][:2],
                         f"256x256 blocks, k = {k} batch (B1) against the "
                         "plain batch")
    stats["render_unidirectional"]["max_abs_err"] = max(
        stats["render_unidirectional"]["max_abs_err"], err)
    rows = kernels.render_unidirectional(
        sc, r.px, r.py, r.camera.kernel_params(), r.key, 0, k, schedule="mega",
        air_priority=sc.air_priority, with_rows=True, **kw)[2]
    tbytes = sum(t.numel() * 4 for t in (sc.bvh8_table, sc.tri_f32,
                                          sc.light_f32, sc.textures,
                                          sc.medium_f32))
    bb = bound_ms(tbytes + n * (8 + 12 + 4),
                  int(rows.sum()) * OPS_PER_ROW + k * n * OPS_PER_CAMERA_RAY)
    say("B1", f"256x256 blocks, k = {k} in one K5 launch: {ms:.3f} ms, plain "
        f"batch {plain_ms:.3f} ms, bound {bb[0]:.4f} ms ({bb[1]}); "
        f"{int(rows.sum())} BVH8 rows ({card})")


def threaded_phases(card: str, stats: dict, cam, px, py, ids, cfg0) -> int:
    """Phases 30-33 on the bunny scene built with traversal="threaded":
    K15 against its plain version, K5's threaded instantiation against its
    plain version, every classic integrator against the BVH8 engine of the
    same scene, the unidirectional golden. Returns the launch counts of the
    threaded UNIDIRECTIONAL path (4 spp)."""
    import numpy as np
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import (bdpt, naive, unidirectional,
                                                 vcm)
    from cudapathtracer_tpu_torch.ops import traverse
    from cudapathtracer_tpu_torch.scene import builtin
    from cudapathtracer_tpu_torch.scene.camera import Camera
    from cudapathtracer_tpu_torch.scene.materials import builtin_materials
    from cudapathtracer_tpu_torch.scene.scene import build_scene
    from cudapathtracer_tpu_torch.utils import rng
    from cudapathtracer_tpu_torch.utils.image import rmse
    dev, n, base = px.device, px.shape[0], rng.base_key()

    # --- 30. K15 against its plain version
    t0 = time.perf_counter()
    tsc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=6),
                         builtin_materials(), traversal="threaded", device=dev)
    table, nodes = tsc.bin_table, tsc.node_packed.shape[0]
    say("scene", f"threaded cornell_with_bunny(6): {tsc.num_triangles} "
        f"triangles, {nodes} binary nodes (node_packed rows of "
        f"{tsc.node_packed.shape[1]} floats, largest leaf "
        f"{tsc.max_leaf_size}; K15's tables {table.numel() * 4 / 2 ** 20:.3f}"
        f" MiB more: {nodes} node records of 96 B and "
        f"{(table.numel() - 24 * nodes) // 12} leaf triangles of 48 B), "
        f"{tsc.bvh8_table.shape[0]} BVH8 rows, built in "
        f"{time.perf_counter() - t0:.1f} s")
    ckey = rng.fold_in(rng.sample_key(base, 0), 2 ** 20)
    o, d = cam.generate_rays(ckey, px.float(), py.float(), ids)
    nomax = torch.full((n,), 999999.0, device=dev)
    noskip = torch.full((n,), -1, dtype=torch.int32, device=dev)
    kh = traverse.closest_hit(tsc, o, d)
    ph = traverse.closest_hit_bin_plain(table, nodes, o, d, nomax, noskip,
                                        None, with_counts=True)
    err15 = compare_hits(kh, traverse.Hit(*ph[:4]), "threaded primary "
                         "1080p", tag="K15")
    rows_b = kernels.closest_hit_bin(table, nodes, o, d, nomax, noskip, None,
                                     with_rows=True)[4]
    rows_8 = kernels.closest_hit8(tsc.bvh8_table, o, d, nomax, noskip, None,
                                  with_rows=True)[4]
    same_rows = (rows_b == ph[4]).float().mean().item()
    check(same_rows >= 0.9999, f"K15 closest: the kernel's rows equal the "
          f"plain walk's on only {same_rows:.6f} of the rays")
    nrows, ntests = int(rows_b.sum()), int(ph[5].sum())
    # inputs read once: the node table, o, d, max_t, skip_tri; outputs t,
    # tri, u, v; operations: the rows these rays visited and the triangle
    # tests of their hit leaves. (Each visit's two 32-byte sectors fetched
    # from memory would take nrows * 64 B / 3.35 TB/s, printed below: the
    # rows near the root stay in the caches.)
    tbytes = table.numel() * 4
    stats["closest_hit_bin"].update(
        bound=bound_ms(tbytes + n * (32 + 16), nrows * OPS_PER_BIN_ROW
                       + ntests * OPS_PER_TRI_TEST),
        ms=cuda_ms(lambda: traverse.closest_hit(tsc, o, d), 10),
        plain_ms=cuda_ms(lambda: traverse.closest_hit_bin_plain(
            table, nodes, o, d, nomax, noskip, None), 1, warmup=0))
    say("K15", f"rows a ray on the 1080p primaries: threaded "
        f"{rows_b.float().mean().item():.3f} (max {int(rows_b.max())}; "
        f"equal to the plain walk's on {same_rows:.6f} of the rays), BVH8 "
        f"{rows_8.float().mean().item():.3f} (max {int(rows_8.max())}) on "
        f"the same scene; triangle tests a ray {ntests / n:.3f} "
        f"({ntests / max(nrows, 1):.3f} a row); closest kernel "
        f"{stats['closest_hit_bin']['ms']:.3f} ms, plain "
        f"{stats['closest_hit_bin']['plain_ms']:.3f} ms, bound "
        f"{stats['closest_hit_bin']['bound'][0]:.4f} ms "
        f"({stats['closest_hit_bin']['bound'][1]}); every visited row from "
        f"memory {nrows * 64 / PEAK_BYTES_S * 1e3:.4f} ms "
        f"({card})")
    gen = np.random.default_rng(7)
    sel = torch.nonzero(kh.valid)[:, 0]
    rd = torch.as_tensor(gen.normal(size=(sel.numel(), 3)),
                         dtype=torch.float32, device=dev)
    rd = (rd / rd.norm(dim=1, keepdim=True)).contiguous()
    so = (o[sel] + d[sel] * kh.t[sel, None] - d[sel] * 1e-4).contiguous()
    mt = torch.as_tensor(gen.uniform(0.05, 3.0, sel.numel()),
                         dtype=torch.float32, device=dev)
    skip = kh.tri[sel].contiguous()
    ph2 = traverse.closest_hit_bin_plain(table, nodes, so, rd, mt, skip,
                                         None)
    err15 = max(err15, compare_hits(traverse.closest_hit(tsc, so, rd, mt,
                                                         skip),
                                    traverse.Hit(*ph2), "threaded secondary "
                                    "(max_t, skip_tri)", tag="K15"))
    stats["closest_hit_bin"]["max_abs_err"] = err15
    del ph, ph2, rd, so, mt, skip
    leaf_scene, _ = build_scene(builtin.cornell_with_bunny(subdivisions=6,
                                                           bunny_mat=13),
                                builtin_materials(), traversal="threaded",
                                device=dev)
    err_s = 0.0
    for label, sc in (("bunny", tsc), ("bunny MAT_LEAF", leaf_scene)):
        so, sd, smt = nee_rays(sc, o, d, traverse.closest_hit(sc, o, d), ids)
        m = so.shape[0]
        sk = torch.full((m,), -1, dtype=torch.int32, device=dev)
        ks = traverse.shadow_factor(sc, so, sd, smt)
        ps, psrows, pstests = traverse.shadow_factor_bin_plain(
            sc.bin_table, sc.node_packed.shape[0], sc.tri_f32, so, sd, smt,
            sk, None, with_counts=True)
        e = (ks - ps).abs().max().item()
        partial = ((ks > 0) & (ks < 1)).any(dim=1).float().mean().item()
        check(e <= 1e-5, f"K15 shadow ({label}): max abs error {e:.3g}")
        err_s = max(err_s, e)
        say("K15", f"shadow {label}: {m} rays, max abs err {e:.3g}, occluded "
            f"{(ks.amax(1) == 0).float().mean().item():.4f}, partly "
            f"transmitted {partial:.4f}")
        if label == "bunny":
            srows = kernels.shadow_factor_bin(table, nodes, sc.tri_f32, so,
                                              sd, smt, sk, None,
                                              with_rows=True)[1]
            srows8 = kernels.shadow_factor8(sc.bvh8_table, sc.tri_f32, so, sd,
                                            smt, sk, None, with_rows=True)[1]
            same_rows = (srows == psrows).float().mean().item()
            check(same_rows >= 0.9999, f"K15 shadow: the kernel's rows equal "
                  f"the plain walk's on only {same_rows:.6f} of the rays")
            nsr, nst = int(srows.sum()), int(pstests.sum())
            # no MAT_LEAF triangle: tri_f32 is not read
            stats["shadow_factor_bin"].update(
                bound=bound_ms(tbytes + m * (32 + 12),
                               nsr * OPS_PER_BIN_ROW
                               + nst * OPS_PER_TRI_TEST),
                ms=cuda_ms(lambda: traverse.shadow_factor(sc, so, sd, smt),
                           10),
                plain_ms=cuda_ms(lambda: traverse.shadow_factor_bin_plain(
                    table, nodes, sc.tri_f32, so, sd, smt, sk, None), 1,
                    warmup=0))
            say("K15", f"shadow rows a ray: threaded "
                f"{srows.float().mean().item():.3f} (equal to the plain "
                f"walk's on {same_rows:.6f} of the rays), BVH8 "
                f"{srows8.float().mean().item():.3f}; triangle tests a ray "
                f"{nst / m:.3f} ({nst / max(nsr, 1):.3f} a row); kernel "
                f"{stats['shadow_factor_bin']['ms']:.3f} ms, plain "
                f"{stats['shadow_factor_bin']['plain_ms']:.3f} ms, bound "
                f"{stats['shadow_factor_bin']['bound'][0]:.4f} ms "
                f"({stats['shadow_factor_bin']['bound'][1]}) ({card})")
        else:
            check(partial > 0.0, "K15 shadow: no ray crossed a MAT_LEAF "
                  "surface, transmission untested")
    stats["shadow_factor_bin"]["max_abs_err"] = err_s
    del leaf_scene, o, d, kh, so, sd, smt

    # --- 31. K5's classic and naive schedules on the threaded scene
    for sched in ("classic", "naive"):
        if sched == "classic":
            kw = dict(max_depth=DEPTH, use_mis=True, sample_environment=False,
                      schedule="classic")
            k5 = unidirectional.render_kernel(tsc, cam, base, 0, px, py, **kw)
            p5 = unidirectional.render_plain(tsc, cam, base, 0, px, py, **kw)
        else:
            k5 = naive.render_kernel(tsc, cam, base, 0, px, py,
                                     max_depth=DEPTH)
            p5 = naive.render_plain(tsc, cam, base, 0, px, py,
                                    max_depth=DEPTH)
        compare_render(k5, p5, f"threaded {WIDTH}x{HEIGHT} bunny, 1 spp, "
                       f"{sched}")
    del k5, p5

    # --- 31b. K12's threaded instantiation: the light walk (with and
    # without VCM's d_vm chain) and the eye walk, the resident grid
    # against one block per SM, bit-equal
    from cudapathtracer_tpu_torch.models import paths
    bcfg = bdpt.BDPTConfig.from_config(cfg0)
    key_l, key_e, _ = bdpt.sample_keys(base, 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for mode, eta in (("light", None), ("light", VCM_ETA), ("eye", None)):
        walk_grids(tsc, px, py,
                   paths.walk_keys(key_l if mode == "light" else key_e, mode),
                   f"threaded {mode} walk{' with eta_vcm' if eta else ''} "
                   f"{WIDTH}x{HEIGHT}", sms, mode=mode,
                   max_depth=bcfg.light_depth if mode == "light"
                   else bcfg.eye_depth, camera=cam, eta_vcm=eta)

    # --- 32. every classic integrator on the threaded scene, against the
    # BVH8 engine of the same scene (its table collapsed from the same tree)
    vcfg = {i: vcm.VCMConfig.from_config(dataclasses.replace(
        cfg0, integrator=i, engine="classic").normalized())
        for i in ("VCM", "SPPM")}
    cfgs = {"UNIDIRECTIONAL": DEPTH, "NAIVE_UNIDIRECTIONAL": DEPTH,
            "BIDIRECTIONAL": bcfg, **vcfg}
    render = {
        "UNIDIRECTIONAL": lambda sc, s: unidirectional.render_sample(
            sc, cam, base, s, px, py, max_depth=DEPTH),
        "NAIVE_UNIDIRECTIONAL": lambda sc, s: naive.render_sample(
            sc, cam, base, s, px, py, max_depth=DEPTH),
        "BIDIRECTIONAL": lambda sc, s: bdpt.render_sample(
            sc, cam, base, s, px, py, cfg=bcfg),
        "VCM": lambda sc, s: vcm.render_sample(sc, cam, base, s, px, py,
                                               cfg=vcfg["VCM"]),
        "SPPM": lambda sc, s: vcm.render_sample(sc, cam, base, s, px, py,
                                                cfg=vcfg["SPPM"])}
    # launches per sample of each integrator, all threaded instantiations
    # (the VCM eye pass: its walk and connection stages trace, the gather
    # does not)
    per_sample = {"UNIDIRECTIONAL": 1, "NAIVE_UNIDIRECTIONAL": 1,
                  "BIDIRECTIONAL": 3 + int(bcfg.light_trace),
                  **{i: 2 + int(c.light_trace) + int(c.connection)
                     for i, c in vcfg.items()}}
    s8 = dataclasses.replace(tsc, traversal="bvh8")
    uni_launches = {}
    for integ, fn in render.items():
        res = {}
        for eng, sc in (("threaded", tsc), ("bvh8", s8)):
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            acc = torch.zeros((n, 3), device=dev)
            rays = 0
            for s in range(SPP):
                out = fn(sc, s)
                acc += out[0]
                rays = rays + out[1]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rays = int(rays)
            launches = dict(kernels.launches)
            peak = peak_gib(mem0)
            rows, rays1 = rows_of_sample(integ, sc, cam, px, py, cfgs[integ])
            ms1 = cuda_ms(lambda: fn(sc, 0), 1)
            res[eng] = (acc, rays)
            say("threaded", f"{integ} on the {eng} engine, {WIDTH}x{HEIGHT} "
                f"bunny, {SPP} spp: {rays} rays in {secs:.3f} s = "
                f"{rays / secs / 1e6:.3f} Mrays/s ({card}); peak memory "
                f"{peak}; launches per sample "
                f"{ {k: v / SPP for k, v in launches.items() if v} }; rows a "
                f"ray {rows / rays1:.3f} ({rows} rows, {rays1} rays in sample "
                f"0); one sample by CUDA events {ms1:.3f} ms")
            want = per_sample[integ] * SPP if eng == "threaded" else 0
            check(launches["threaded_engine"] == want, f"threaded {integ} on "
                  f"{eng}: {launches['threaded_engine']} threaded launches, "
                  f"expected {want}")
            check(launches["closest_hit8"] + launches["closest_hit_bin"] == 0,
                  f"threaded {integ}: a batch traversal entry launched")
            if eng == "threaded" and integ == "UNIDIRECTIONAL":
                uni_launches = launches
        # The capped merge reads a cell through an 8-row window aligned in
        # the sorted photon array (ops/hashgrid.fold_neighbors, one_brick),
        # so one photon that differs anywhere (an exact tie taken by the
        # other triangle: BVH8's row winner keys t to 4 ulps, the threaded
        # walk keeps the strictly nearer) moves the windows of the cells
        # after it. The photon integrators' renders are held by rays and
        # mean; their walks, and their splat and eye pass on the same light
        # buffers and grid, below.
        photon = integ in ("VCM", "SPPM")
        compare_image(res["threaded"], res["bvh8"], f"{integ} threaded vs "
                      f"BVH8 engine, {SPP} spp", "threaded",
                      0.0 if photon else 0.99)
        if photon:
            same_input_eye(tsc, s8, cam, px, py, cfgs[integ])
        del res, acc

    # --- 33. the unidirectional golden through K5's threaded instantiation
    gsc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                         traversal="threaded", device=dev)
    gcam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    gy, gx = torch.meshgrid(torch.arange(16, dtype=torch.int32, device=dev),
                            torch.arange(16, dtype=torch.int32, device=dev),
                            indexing="ij")
    kernels.reset_launches()
    acc = torch.zeros((256, 3), device=dev)
    for s in range(8):
        acc += unidirectional.render_sample(gsc, gcam, base, s,
                                            gx.reshape(-1), gy.reshape(-1),
                                            max_depth=6)[0]
    check(kernels.launches["render_unidirectional"] == 8
          and kernels.launches["threaded_engine"] == 8,
          f"threaded golden: launches {kernels.launches}")
    img = (acc / 8).cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  "cornell_uni_16x16_8spp.npy"))
    err = rmse(img, golden)
    say("golden", f"cornell_uni_16x16_8spp.npy on the card through K5's "
        f"threaded instantiation: rmse {err:.3g} (bound 1e-3), mean ratio "
        f"{float(img.mean() / golden.mean()):.6f}")
    check(err < 1e-3, f"threaded golden: rmse {err:.3g}")

    # --- 34b. the attribution of the classic VCM eye pass on the threaded
    # scene (tools/eye_attribution.py: each strategy switch off in turn)
    from tools import eye_attribution
    eye_attribution.attribution(None, tsc, cam, px, py, cfg0,
                                log=lambda m: print(m, flush=True))
    return uni_launches


def sharded_phases(card: str, stats: dict, px, py, cfg0) -> int:
    """Phase 35, tile x spp rendering over a mesh of ranks
    (parallel/sharding.py), and K8's rows mode. Returns photon_bucket's
    launches on the sharded VCM path (the (4,1) mesh's sample)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.scene import builtin
    from cudapathtracer_tpu_torch.scene.materials import builtin_materials
    from cudapathtracer_tpu_torch.scene.scene import build_scene
    from cudapathtracer_tpu_torch.utils import rng
    dev, n, base = px.device, px.shape[0], rng.base_key()

    # --- 35a. K8's rows mode on the 1080p VCM sample's photons: the pack-only
    # photon_pack (rows and validity) against hashgrid.photon_rows,
    # photon_bucket against its plain version and against photon_pack's
    # buckets and table (the lbufs mode), the rows-mode grid against the
    # lbufs mode's and build_grid; then on the union of the 1080p frame cut
    # into 4 tiles (each tile's walk packed, gathered tile-major, as a (4,1)
    # mesh gathers them) against build_grid, bit for bit
    scene, _ = build_scene(builtin.cornell_with_bunny(subdivisions=6),
                           builtin_materials(), device=dev)
    vmain = vcm.VCMConfig.from_config(dataclasses.replace(
        cfg0, integrator="VCM", engine="classic").normalized())
    key_l, _ = vcm.sample_keys(base, 0)
    mr, eta, _ = vcm.sample_scalars(scene, vmain, 0, n)
    salt = hashgrid.photon_salt(0)
    salted = hashgrid.REWEIGHT
    lkeys = paths.walk_keys(key_l, "light")

    def walk(tx, ty):
        return kernels.bdpt_walk(
            scene, tx, ty, lkeys, mode="light",
            max_depth=vmain.light_depth + 1,
            rays=torch.zeros(tx.shape[0], dtype=torch.int32, device=dev),
            eta_vcm=eta)["bufs"]
    lb = walk(px, py)
    p = lb.pt.shape[0] * lb.pt.shape[1]
    tsize = hashgrid.photon_table_size(p)
    rows, valid = kernels.photon_rows(lb)
    prow, pval = hashgrid.photon_rows(lb)
    check(torch.equal(rows.view(torch.int32), prow.view(torch.int32))
          and torch.equal(valid.bool(), pval), "K8 rows mode: photon_pack's "
          "pack-only rows or validity differ from hashgrid.photon_rows")
    h, se = kernels.photon_bucket(rows, valid, scene.scene_min, 2.0 * mr,
                                  tsize)
    ph, pse = hashgrid.photon_bucket_plain(rows, valid, scene.scene_min,
                                           2.0 * mr, tsize)
    _, lh, lse = kernels.photon_pack(lb, scene.scene_min, 2.0 * mr, tsize)
    check(torch.equal(h, ph) and torch.equal(se, pse), "K8 rows mode: "
          "photon_bucket differs from its plain version")
    check(torch.equal(h, lh) and torch.equal(se, lse), "K8 rows mode: "
          "photon_bucket differs from photon_pack's buckets (lbufs mode)")
    g_rows = hashgrid.build_grid_rows_kernel(rows, valid, scene.scene_min,
                                             mr, salt)
    g_lbufs = hashgrid.build_grid_kernel(lb, scene.scene_min, mr, salt)
    compare_grid(g_rows, g_lbufs, f"rows mode against the lbufs mode, "
                 f"{WIDTH}x{HEIGHT}")
    compare_grid(g_rows, hashgrid.build_grid(prow, pval, scene.scene_min, mr,
                                             tsize, salt=salt),
                 f"rows mode against build_grid, {WIDTH}x{HEIGHT}")
    del g_lbufs, prow, pval, lh, lse, ph, pse
    parts = [kernels.photon_rows(walk(px[sl], py[sl]))
             for sl in (slice(t * n // 4, (t + 1) * n // 4)
                        for t in range(4))]
    urows = torch.cat([r for r, _ in parts])
    uvalid = torch.cat([v for _, v in parts])
    del parts
    g_union = hashgrid.build_grid_rows_kernel(urows, uvalid, scene.scene_min,
                                              mr, salt)
    compare_grid(g_union, hashgrid.build_grid(
        urows, uvalid.bool(), scene.scene_min, mr, tsize, salt=salt),
        f"rows mode on 4 tiles' photons gathered, {WIDTH}x{HEIGHT}")
    del g_union, g_rows
    stats["photon_bucket"].update(
        # a position (12 B) and a validity byte in, a bucket out, the table
        # written once; a cell, its hash and the bucket (~20 operations)
        bound=bound_ms(p * (12 + 1 + 4) + 8 * (tsize + 1), p * 20),
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.photon_bucket(
            urows, uvalid, scene.scene_min, 2.0 * mr, tsize), 10),
        plain_ms=cuda_ms(lambda: hashgrid.photon_bucket_plain(
            urows, uvalid, scene.scene_min, 2.0 * mr, tsize), 3),
        library_ms=None)
    st = stats["photon_bucket"]
    say("K8 rows", f"{p} photons, table of {tsize + 1} buckets: photon_bucket "
        f"{st['ms']:.4f} ms, plain {st['plain_ms']:.3f} ms, bound "
        f"{st['bound'][0]:.4f} ms ({st['bound'][1]}); pack-only rows, "
        f"buckets, table and grids bit-equal to the plain versions and the "
        f"lbufs mode (salted {salted}) ({card})")
    del urows, uvalid, rows, valid, h, se, lb, scene
    return sharded_renders(card, dev, 256)


def host_ms(fn, dev_list, reps: int = 5) -> float:
    """Median host milliseconds of fn() over `reps` calls, each ended by a
    synchronisation of every device in dev_list (after one warm-up)."""
    import torch
    cuda = [d for d in dev_list if d.type == "cuda"]
    fn()
    times = []
    for _ in range(reps):
        for d in cuda:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        for d in cuda:
            torch.cuda.synchronize(d)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def sharded_renders(card: str, dev, w: int) -> int:
    """Phase 35b-c: the sharded path at w x w on cornell_with_blocks,
    naive (depth 8), BDPT and VCM (eye 4, light 3; VCM with merging at r0
    0.005 of the scene radius and 64 photons a cell, where no 256x256 cell
    holds more, so the union's candidate set is the single rank's): an
    (1,1) mesh, (4,1) and (2,2) meshes with every rank on the one
    card and, where n >= 2 cards are visible, (n,1) and
    (n/2,2) meshes over all of them, each against the unsharded calls on
    `dev`. Each sharded call and the direct (unsharded) call of one sample
    of the whole frame are timed alike (host_ms). Returns photon_bucket's
    launches in the one-card (4,1) mesh's VCM sample."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import bdpt, naive, vcm
    from cudapathtracer_tpu_torch.parallel import sharding
    from cudapathtracer_tpu_torch.scene import builtin
    from cudapathtracer_tpu_torch.scene.camera import Camera
    from cudapathtracer_tpu_torch.scene.materials import builtin_materials
    from cudapathtracer_tpu_torch.scene.scene import build_scene
    from cudapathtracer_tpu_torch.utils import rng
    base = rng.base_key()
    bscene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                            device=dev)
    bcam = Camera.pinhole((0.0, 0.0, 1.0), w, w, 0.0, 0.0, 0.0, 60.0)
    gy, gx = torch.meshgrid(torch.arange(w, dtype=torch.int32, device=dev),
                            torch.arange(w, dtype=torch.int32, device=dev),
                            indexing="ij")
    bpx, bpy = gx.reshape(-1), gy.reshape(-1)
    nb = w * w
    bcfg = bdpt.BDPTConfig(eye_depth=4, light_depth=3)
    vcfg = vcm.VCMConfig(eye_depth=4, light_depth=3, max_per_cell=64,
                         r0_multiplier=0.005)
    cases = {
        "naive": (naive.render_sample, dict(max_depth=DEPTH), (
            "naive",)),
        "BDPT": (bdpt.render_sample, dict(splat=True, cfg=bcfg),
                 BDPT_KERNELS),
        "VCM": (vcm.render_sample, dict(splat=True, cfg=vcfg,
                                        photon_axis="tile"),
                ("bdpt_walk",) + PHOTON_KERNELS)}
    singles = {}

    def direct(name, si):
        """The unsharded call of sample si over the whole frame (naive:
        with the (0, 0) shard's key)."""
        fn, kw, _ = cases[name]
        if name == "naive":
            k = rng.fold_in(rng.fold_in(base, 0), 0)
            return fn(bscene, bcam, k, si, bpx, bpy, **kw)
        return fn(bscene, bcam, base, si, bpx, bpy, cfg=kw["cfg"])

    def single(name, si):
        """The single-rank render of sample si, kept."""
        if (name, si) not in singles:
            out = direct(name, si)
            check(name != "VCM" or int(out[2]) == 0, "sharded VCM: the "
                  "single-rank render dropped photons, so the union's "
                  "candidate set would differ from it")
            singles[(name, si)] = (out[0], int(out[1]))
        return singles[(name, si)]
    direct_ms = {}
    for name in cases:
        direct_ms[name] = host_ms(lambda: direct(name, 0), [dev])
        say("sharded", f"direct {name} {w}x{w}: one sample of the frame in "
            f"{direct_ms[name]:.4f} ms (median of 5, synchronised) ({card})")
    meshes = [((1, 1), [dev]), ((4, 1), [dev] * 4), ((2, 2), [dev] * 4)]
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    if n_cards >= 2:
        meshes.append(((n_cards, 1), cards))
    if n_cards >= 4 and n_cards % 2 == 0:
        meshes.append(((n_cards // 2, 2), cards))
    bucket_launches = 0
    for shape, devices in meshes:
        # a mesh that hangs prints every thread's stack and exits
        faulthandler.dump_traceback_later(240, exit=True)
        mesh = sharding.make_mesh(*shape, devices=devices)
        n_tile, n_spp = shape
        tag = f"{shape} on {len(set(devices))} card(s)"
        say("sharded", mesh.describe())
        nl = nb // n_tile
        for name, (fn, kw, names) in cases.items():
            call = sharding.make_sharded_sample_fn(fn, mesh, bscene, bcam,
                                                   **kw)
            call(base, 0, bpx, bpy)    # warm-up
            kernels.reset_launches()
            li, rays, *rest = call(base, 0, bpx, bpy)
            launches = dict(kernels.launches)
            rays, rest = int(rays), [int(c) for c in rest]
            want_names = names + (("photon_bucket",) if name == "VCM"
                                  and n_tile > 1 else ())
            missing = [k for k in want_names if launches[k] == 0]
            check(not missing, f"sharded {tag} {name}: {missing} launched "
                  "no time")
            if name == "VCM":
                check((launches["photon_bucket"] > 0) == (n_tile > 1),
                      f"sharded {tag} VCM: photon_bucket launched "
                      f"{launches['photon_bucket']} times")
                if shape == (4, 1) and len(set(devices)) == 1:
                    bucket_launches = launches["photon_bucket"]
            if name == "naive":
                # the JAX composition: each shard's own key and sample,
                # summed over the spp axis in its order
                want = torch.zeros((nb, 3), device=dev)
                want_rays = 0
                for ti in range(n_tile):
                    sl = slice(ti * nl, (ti + 1) * nl)
                    for si in range(n_spp):
                        k = rng.fold_in(rng.fold_in(base, ti), si)
                        s_li, s_rays = naive.render_sample(
                            bscene, bcam, k, si, bpx[sl], bpy[sl],
                            max_depth=DEPTH)
                        want[sl] += s_li
                        want_rays += int(s_rays)
                ok = bool((li.to(dev) - want).abs().le(
                    1e-7 + 1e-6 * want.abs()).all())
            else:
                # the spp ranks render samples 0 .. n_spp - 1: their sum
                want, want_rays = single(name, 0)
                for si in range(1, n_spp):
                    o_li, o_rays = single(name, si)
                    want, want_rays = want + o_li, want_rays + o_rays
                ok = bool(torch.isclose(li.to(dev), want, rtol=2e-4,
                                        atol=2e-5).all())
            diff = (li.to(dev) - want).abs()
            ref = "per-shard calls" if name == "naive" else \
                "single-rank render"
            ms = host_ms(lambda: call(base, 0, bpx, bpy), set(devices))
            say("sharded", f"{tag} {name} {w}x{w}: {rays} rays, {n_spp} "
                f"sample(s) a call in {ms:.4f} ms = "
                f"{rays / ms / 1e3:.3f} Mrays/s (median of 5); the direct "
                f"call {direct_ms[name]:.4f} ms a sample ({card}); against "
                f"the {ref}: rays {want_rays}, max |diff| "
                f"{diff.max().item():.3g}, bit-equal share "
                f"{(diff == 0).float().mean().item():.6f}"
                + (f", dropped {rest[0]}" if rest else ""))
            check(rays == want_rays and ok, f"sharded {tag} {name}: "
                  "differs from the unsharded render")
            if name == "VCM":
                check(rest[0] == 0, f"sharded {tag} VCM: {rest[0]} "
                      "dropped photons")
        faulthandler.cancel_dump_traceback_later()
    return bucket_launches


def main() -> int:
    if sys.argv[1:] not in ([], ["--sharded"]):
        print("usage: python3 chip_smoke.py [--sharded]")
        return 2
    if not os.path.isdir(os.path.join(ROOT, "cudapathtracer_tpu_torch")):
        print("FAIL: run chip_smoke.py from a checkout of the repository "
              "(cudapathtracer_tpu_torch/ not found beside it)")
        return 3
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU")
        return 2
    sys.path.insert(0, ROOT)
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import (bdpt, bdpt_mega,
                                                 light_mega, naive, paths,
                                                 unidirectional,
                                                 unidirectional_mega, vcm,
                                                 vcm_mega)
    from cudapathtracer_tpu_torch.scene.materials import TRANSPORT_IMPORTANCE
    from cudapathtracer_tpu_torch.ops import hashgrid, traverse8
    from cudapathtracer_tpu_torch.scene import builtin
    from cudapathtracer_tpu_torch.scene.camera import Camera
    from cudapathtracer_tpu_torch.scene.materials import builtin_materials
    from cudapathtracer_tpu_torch.scene.scene import build_scene
    from cudapathtracer_tpu_torch.utils import packing, rng
    from cudapathtracer_tpu_torch.utils.config import MeshConfig, load_config
    from cudapathtracer_tpu_torch.utils.image import rmse

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    # one line a card ("; " between them where several are visible)
    card = "; ".join(smi.stdout.strip().splitlines())
    say("card", card)
    say("card", f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    stats = {name: {} for name, _, _ in KERNELS}

    # --- 2. build
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    build_s = time.perf_counter() - t0
    if SHARDED_ONLY:
        say("build", f"{kernels.LIBRARY} built in {build_s:.1f} s")
        sharded_renders(card, dev, 256)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    with open(kernels.LIBRARY + ".ptxas.txt") as f:
        ptxas_log = f.read()
    say("build", f"{kernels.LIBRARY} built in {build_s:.1f} s "
        f"({len(kernels.SOURCES)} sources in parallel)")
    # the kernels that trace rays are built per engine: ILi0E BVH8 (K1),
    # ILi1E threaded (K15); K5 also per build (Li8E wide, Li1E narrow)
    # the eye stages per flavour (0 classic, 1 mega VCM, 2 mega BDPT) and
    # engine; the gathers trace nothing
    engines = ("ILi0E", "ILi1E")
    for kname in (*("uni_mega_kernel" + e + b for e in engines
                    for b in ("Li8E", "Li1E")),
                  *(k + e for k in ("bdpt_walk_kernel",
                                    "splat_trace_kernel", "bdpt_pairs_kernel")
                    for e in engines), "bdpt_gather_kernel",
                  "bdpt_walk_start_kernel", "splat_classify_kernel",
                  "splat_scan_kernel", "splat_scatter_kernel",
                  *(k + e for k in ("eye_walk_kernel",
                                    "eye_connect_kernel_trace")
                    for e in ("ILi0ELi0E", "ILi0ELi1E", "ILi1ELi0E",
                              "ILi2ELi0E")), "eye_connect_kernel_queue",
                  *("eye_gather_kernel" + e for e in ("ILi0E", "ILi1E",
                                                      "ILi2E")),
                  "traverse_bin_kernelILb0E", "traverse_bin_kernelILb1E",
                  "packing_kernel", "photon_pack_kernel",
                  "photon_bucket_kernel", "photon_table_kernel",
                  "radix_hist_kernel", "radix_pass_kernel", "slots_kernel",
                  "rgb9e5_kernel",
                  "shade_eval_kernel"):
        mk = ptxas_of(ptxas_log, kname)
        say("build", f"{kname}: {mk['registers']} registers, "
            f"{mk['stack_bytes']} bytes stack frame, "
            f"{mk['spill_store_bytes']} bytes spill stores, "
            f"{mk['spill_load_bytes']} bytes spill loads")
    # K2-K4 (the shading transition) run inside these kernels, K9 (the
    # merge query) inside the gathers
    say("build", "K2-K4 and K9 hosts (registers/stack/spill st/spill ld): "
        + "; ".join(
            f"{k} {m['registers']}/{m['stack_bytes']}/"
            f"{m['spill_store_bytes']}/{m['spill_load_bytes']}"
            for k, m in ((k, ptxas_of(ptxas_log, k)) for k in SHADE_HOSTS)))
    # K1 runs inside these kernels (their BVH8 instantiations): their
    # registers, stack frames and spills go on K1's rows of the kernels line
    k1_hosts = {k: ptxas_of(ptxas_log, k) for k in K1_HOSTS}
    stats["closest_hit8"]["ptxas"] = stats["shadow_factor8"]["ptxas"] = \
        k1_hosts
    # the INT32 rate of this card and the cipher's SASS in this build: the
    # bound of every count that holds Threefry draws
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    clk_mhz = float(clk.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    keyed_sass = sass_counts(kernels.LIBRARY, "uniform_keyed_kernel")
    check(cipher_sass(keyed_sass) > 0, "cuobjdump found no SASS of "
          "uniform_keyed_kernel in the library")
    set_draw_ops(cipher_sass(keyed_sass), int32_rate(clk_mhz, sms))
    say("bound", f"INT32 rate {INT32_LANES_PER_SM} lanes x {sms} SMs x "
        f"{clk_mhz:.0f} MHz = {PEAK_INT32_S:.4g} instructions/s; one "
        f"Threefry draw {SASS_PER_CIPHER} SASS integer instructions "
        f"(uniform_keyed_kernel: " + ", ".join(
            f"{k} {v}" for k, v in sorted(keyed_sass.items())) + ") = "
        f"{OPS_PER_DRAW:.1f} float32-equivalent operations ({card})")

    # --- 3. K6
    n = WIDTH * HEIGHT
    gy, gx = torch.meshgrid(torch.arange(HEIGHT, dtype=torch.int32,
                                         device=dev),
                            torch.arange(WIDTH, dtype=torch.int32,
                                         device=dev), indexing="ij")
    px, py = gx.reshape(-1).contiguous(), gy.reshape(-1).contiguous()
    ids = rng.pixel_ids(px, py).contiguous()
    k0, k1 = rng.draw_key(rng.bounce_key(rng.sample_key(rng.base_key(), 5),
                                         3), 4)
    ku0, ku1 = rng.uniform_draw_key(k0, k1, ids, two=True)
    pu0, pu1 = rng.uniform_draw_key_plain(k0, k1, ids, two=True)
    check(torch.equal(ku0.view(torch.int32), pu0.view(torch.int32))
          and torch.equal(ku1.view(torch.int32), pu1.view(torch.int32)),
          "K6: kernel draws are not bit-equal to the plain version")
    stats["uniform_id"].update(
        bound=bound_ms(n * 8, n * OPS_PER_DRAW),
        max_abs_err=0.0,
        ms=graph_ms(lambda: rng.uniform_draw_key(k0, k1, ids)),
        call_ms=cuda_ms(lambda: rng.uniform_draw_key(k0, k1, ids), 50),
        plain_ms=cuda_ms(lambda: rng.uniform_draw_key_plain(k0, k1, ids), 10))
    stats["uniform_id"]["sass_per_cipher"] = SASS_PER_CIPHER
    say("K6", f"{n} ids bit-equal (both words); kernel "
        f"{stats['uniform_id']['ms']:.4f} ms (graph replay; a call from "
        f"the host {stats['uniform_id']['call_ms']:.4f} ms), plain "
        f"{stats['uniform_id']['plain_ms']:.4f} ms, bound "
        f"{stats['uniform_id']['bound'][0]:.5f} ms "
        f"({stats['uniform_id']['bound'][1]}) ({card})")

    # --- 3b. the key tables the hosts' prologues fold on the card
    # (keys.cuh), each bit-equal to its plain builder: K5's draw-key tables
    # of its three schedules (4 samples from sample 3), K12's under key_l and
    # key_e, the classic eye walk's under key_e and K13's s=1 table under
    # key_c, at the main paths' depths
    cfg_k = load_config(os.path.join(ROOT, "configs", "cornell.rendertron"))
    bcfg_k = bdpt.BDPTConfig.from_config(cfg_k)
    key_l, key_e, key_c = bdpt.sample_keys(rng.base_key(), 2)
    vkey_l, vkey_e = vcm.sample_keys(rng.base_key(), 2)
    vcfg_k = vcm.VCMConfig.from_config(cfg_k)
    tables = []
    for sched in ("classic", "naive", "mega"):
        rows_ = kernels.uni_key_rows(sched, DEPTH)
        tables.append((f"K5 {sched} ({max(rows_, 1)} rows x 9, 4 samples)",
                       kernels.key_table("uni", rng.base_key(), [3, 4, rows_],
                                         dev),
                       unidirectional.sample_key_table(rng.base_key(), 3, 4,
                                                       rows_)))
    for tag, key_, depth_ in (("K12 light (BDPT)", key_l,
                               bcfg_k.light_depth),
                              ("K12 eye (BDPT)", key_e, bcfg_k.eye_depth),
                              ("K12 light (VCM)", vkey_l,
                               vcfg_k.light_depth + 1)):
        tables.append((f"{tag}, depth {depth_}",
                       kernels.key_table("walk", key_, [depth_], dev),
                       paths.walk_key_table(key_, depth_)))
    tables.append((f"classic eye walk, depth {vcfg_k.eye_depth}",
                   kernels.key_table("eye", vkey_e, [vcfg_k.eye_depth], dev),
                   vcm.eye_key_table(vkey_e, vcfg_k.eye_depth)))
    tables.append((f"K13 s=1, eye depth {bcfg_k.eye_depth}",
                   kernels.key_table("nee", key_c, [bcfg_k.eye_depth], dev),
                   bdpt.nee_key_table(key_c, bcfg_k.eye_depth)))
    for tag, got, want in tables:
        check(torch.equal(got.cpu(), want), f"key table {tag}: the card's "
              "pairs are not bit-equal to the plain builder")
    say("K6 tables", "; ".join(f"{tag}: {got.shape[0]} pairs"
                              for tag, got, _ in tables)
        + " bit-equal to the plain builders")

    # --- 4. K7 on the main paths' camera (the reference pinhole: aperture
    # 1e-6, its lens live), a camera of aperture 0 (no lens: two draws)
    # and a thin lens, each against its plain version (1e-6: cos, sin and
    # rsqrt of the two may differ in the last ulp); at aperture 0 every
    # origin is the camera's
    cam = Camera.pinhole((0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0, 60.0)
    lens = Camera.thin_lens((0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0,
                            60.0, 0.05, 1.5)
    hole = Camera.thin_lens((0.0, 0.0, 1.0), WIDTH, HEIGHT, 0.0, 0.0, 0.0,
                            60.0, 0.0, 1.0 / 60.0)
    ckey = rng.fold_in(rng.sample_key(rng.base_key(), 0), 2 ** 20)
    fx, fy = px.float(), py.float()
    err7, k7 = 0.0, {}
    for tag, c, ops in (("reference pinhole", cam, OPS_PER_CAMERA_RAY),
                        ("aperture 0", hole, OPS_PER_PINHOLE_RAY),
                        ("thin lens", lens, OPS_PER_CAMERA_RAY)):
        ko, kd = c.generate_rays(ckey, fx, fy, ids)
        po, pd = c.generate_rays_plain(ckey, fx, fy, ids)
        err = max((ko - po).abs().max().item(), (kd - pd).abs().max().item())
        check(err <= 1e-6, f"K7 {tag}: max abs error {err:.3g} > 1e-6")
        if c.aperture == 0.0:
            check(bool((ko == torch.tensor(c.origin, device=dev)).all()),
                  "K7 aperture 0: an origin is not the camera's")
        err7 = max(err7, err)
        k7[tag] = dict(
            ms=graph_ms(lambda: c.generate_rays(ckey, fx, fy, ids)),
            call_ms=cuda_ms(lambda: c.generate_rays(ckey, fx, fy, ids), 50),
            plain_ms=cuda_ms(lambda: c.generate_rays_plain(ckey, fx, fy,
                                                           ids), 10),
            bound=bound_ms(n * (12 + 24), n * ops), err=err)
        say("K7", f"{WIDTH}x{HEIGHT} {tag} (aperture {c.aperture:g}): max "
            f"abs err {err:.3g}; kernel {k7[tag]['ms']:.4f} ms (graph "
            f"replay; a call from the host, which folds the four draw keys, "
            f"{k7[tag]['call_ms']:.4f} ms), plain "
            f"{k7[tag]['plain_ms']:.4f} ms, bound {k7[tag]['bound'][0]:.4f} "
            f"ms ({k7[tag]['bound'][1]}) ({card})")
    stats["generate_rays"].update(
        bound=k7["reference pinhole"]["bound"], max_abs_err=err7,
        ms=k7["reference pinhole"]["ms"],
        plain_ms=k7["reference pinhole"]["plain_ms"],
        ms_aperture_0=k7["aperture 0"]["ms"],
        bound_ms_aperture_0=k7["aperture 0"]["bound"][0],
        ms_thin_lens=k7["thin lens"]["ms"],
        call_ms=k7["reference pinhole"]["call_ms"])

    # --- 5. K1
    t0 = time.perf_counter()
    scene, _ = build_scene(builtin.cornell_with_bunny(subdivisions=6),
                           builtin_materials(), device=dev)
    say("scene", f"cornell_with_bunny(6): {scene.num_triangles} triangles, "
        f"{scene.bvh8_table.shape[0]} BVH8 rows, built in "
        f"{time.perf_counter() - t0:.1f} s; shade_table "
        f"{scene.shade_table.numel() * 4} bytes on the device "
        f"({scene.shade_table.shape[1] * 4} a triangle; the JAX shade rows "
        f"{scene.num_triangles * 192} bytes)")
    o, d = cam.generate_rays(ckey, fx, fy, ids)
    tbl, nomax = scene.bvh8_table, torch.full((n,), 999999.0, device=dev)
    noskip = torch.full((n,), -1, dtype=torch.int32, device=dev)
    kh = traverse8.closest_hit8(scene, o, d)
    ph = traverse8.closest_hit8_plain(tbl, o, d, nomax, noskip, None,
                                      with_restarts=True)
    err1 = compare_hits(kh, traverse8.Hit(*ph[:4]), "primary 1080p")
    kr, krows = kernels.closest_hit8(tbl, o, d, nomax, noskip, None,
                                     with_restarts=True, with_rows=True)[4:]
    check(torch.equal(kr, ph[4]), "K1: restart counts differ from the "
          "plain version on the primary rays")
    # inputs: the table, o, d, max_t, skip_tri; outputs t, tri, u, v
    stats["closest_hit8"].update(
        bound=bound_ms(tbl.numel() * 4 + n * (32 + 16),
                       int(krows.sum()) * OPS_PER_ROW),
        ms=cuda_ms(lambda: traverse8.closest_hit8(scene, o, d), 10),
        plain_ms=cuda_ms(lambda: traverse8.closest_hit8_plain(
            tbl, o, d, nomax, noskip, None), 1, warmup=0))
    # random secondary rays leaving the primary hit points
    gen = np.random.default_rng(7)
    sel = torch.nonzero(kh.valid)[:, 0]
    p = o[sel] + d[sel] * kh.t[sel, None]
    rd = torch.as_tensor(gen.normal(size=(sel.numel(), 3)),
                         dtype=torch.float32, device=dev)
    rd = rd / rd.norm(dim=1, keepdim=True)
    so = (p - d[sel] * 1e-4).contiguous()
    mt = torch.as_tensor(gen.uniform(0.05, 3.0, sel.numel()),
                         dtype=torch.float32, device=dev)
    skip = kh.tri[sel].contiguous()
    kh2 = traverse8.closest_hit8(scene, so, rd, mt, skip)
    ph2 = traverse8.closest_hit8_plain(tbl, so, rd.contiguous(), mt, skip,
                                       None, with_restarts=True)
    err1 = max(err1, compare_hits(kh2, traverse8.Hit(*ph2[:4]),
                                  "secondary (max_t, skip_tri)"))
    kr2 = kernels.closest_hit8(tbl, so, rd.contiguous(), mt, skip, None,
                               with_restarts=True)[4]
    check(torch.equal(kr2, ph2[4]), "K1: restart counts differ from the "
          "plain version on the secondary rays")
    say("K1", f"16-entry stack: {int((kr > 0).sum())} primary and "
        f"{int((kr2 > 0).sum())} secondary rays restarted (counts equal "
        "the plain version's)")

    # the ring and the restart from the root, on a 7-entry build
    t0 = time.perf_counter()
    kernels.build(stack_d=7)
    bsc, _ = build_scene(builtin.cornell_with_bunny(subdivisions=4),
                         builtin_materials(), device=dev)
    go, gd = (torch.as_tensor(a, device=dev) for a in grazing_rays())
    gn = go.shape[0]
    gmt = torch.full((gn,), 999999.0, device=dev)
    gsk = torch.full((gn,), -1, dtype=torch.int32, device=dev)
    g16 = kernels.closest_hit8(bsc.bvh8_table, go, gd, gmt, gsk, None)
    g7 = kernels.closest_hit8(bsc.bvh8_table, go, gd, gmt, gsk, None,
                              stack_d=7, with_restarts=True)
    traverse8.STACK_D = 7
    try:
        p7 = traverse8.closest_hit8_plain(bsc.bvh8_table, go, gd, gmt, gsk,
                                          None, with_restarts=True)
        smt = torch.as_tensor(gen.uniform(0.1, 2.0, gn), dtype=torch.float32,
                              device=dev)
        ks7 = kernels.shadow_factor8(bsc.bvh8_table, bsc.tri_f32, go, gd,
                                     smt, gsk, None, stack_d=7)
        ps7 = traverse8.shadow_factor8_plain(bsc.bvh8_table, bsc.tri_f32, go,
                                             gd, smt, gsk, None)
    finally:
        traverse8.STACK_D = kernels.STACK_D
    restarted = int((g7[4] > 0).sum())
    check(restarted > 0, "K1 overflow: no grazing ray overflowed the "
          "7-entry stack")
    check(torch.equal(g7[4], p7[4]), "K1 overflow: restart counts differ "
          "from the plain version at 7 entries")
    check(torch.equal(g7[1], p7[1]) and torch.equal(g7[1], g16[1]),
          "K1 overflow: ids differ from the plain version at 7 entries or "
          "from the 16-entry kernel")
    m7 = g7[1] >= 0
    e7 = (g7[0][m7] - p7[0][m7]).abs().max().item()
    es7 = (ks7 - ps7).abs().max().item()
    check(e7 <= 1e-5 and es7 <= 1e-5, f"K1 overflow: t differs by {e7:.3g}, "
          f"shadow by {es7:.3g}")
    say("K1", f"7-entry stack (built in {time.perf_counter() - t0:.1f} s "
        f"with the scene): {restarted} of {gn} grazing rays restarted, "
        f"{int(g7[4].max())} restarts at most; ids and restart counts equal "
        f"the plain version's, ids equal the 16-entry kernel's; max |dt| "
        f"{e7:.3g}, shadow max abs err {es7:.3g}")
    err1 = max(err1, e7)
    stats["closest_hit8"]["max_abs_err"] = err1

    err_s = 0.0
    leaf_scene, _ = build_scene(builtin.cornell_with_bunny(subdivisions=6,
                                                           bunny_mat=13),
                                builtin_materials(), device=dev)
    for label, sc in (("bunny", scene), ("bunny MAT_LEAF", leaf_scene)):
        h = traverse8.closest_hit8(sc, o, d)
        so, sd, smt = nee_rays(sc, o, d, h, ids)
        m = so.shape[0]
        sk = torch.full((m,), -1, dtype=torch.int32, device=dev)
        ks = traverse8.shadow_factor8(sc, so, sd, smt)
        ps = traverse8.shadow_factor8_plain(sc.bvh8_table, sc.tri_f32, so,
                                            sd, smt, sk, None)
        e = (ks - ps).abs().max().item()
        partial = ((ks > 0) & (ks < 1)).any(dim=1).float().mean().item()
        check(e <= 1e-5, f"K1 shadow ({label}): max abs error {e:.3g}")
        err_s = max(err_s, e)
        say("K1", f"shadow {label}: {m} rays, max abs err {e:.3g}, "
            f"occluded {(ks.amax(1) == 0).float().mean().item():.4f}, "
            f"partly transmitted {partial:.4f}")
        if label == "bunny":
            srows = kernels.shadow_factor8(sc.bvh8_table, sc.tri_f32, so,
                                           sd, smt, sk, None,
                                           with_rows=True)[1]
            # inputs: the table, o, d, max_t, skip_tri (no MAT_LEAF
            # triangle, so no tri_f32 row is needed); output the scale
            stats["shadow_factor8"].update(
                bound=bound_ms(tbl.numel() * 4 + m * (32 + 12),
                               int(srows.sum()) * OPS_PER_ROW),
                ms=cuda_ms(lambda: traverse8.shadow_factor8(sc, so, sd, smt),
                           10),
                plain_ms=cuda_ms(lambda: traverse8.shadow_factor8_plain(
                    sc.bvh8_table, sc.tri_f32, so, sd, smt, sk, None), 1,
                    warmup=0))
        else:
            check(partial > 0.0, "K1 shadow: no ray crossed a MAT_LEAF "
                  "surface, transmission untested")
    stats["shadow_factor8"]["max_abs_err"] = max(err_s, es7)
    say("K1", f"closest kernel {stats['closest_hit8']['ms']:.3f} ms, plain "
        f"{stats['closest_hit8']['plain_ms']:.3f} ms; shadow kernel "
        f"{stats['shadow_factor8']['ms']:.3f} ms, plain "
        f"{stats['shadow_factor8']['plain_ms']:.3f} ms")

    # --- 6. shade_eval: the K2-K4 device code against the plain functions
    skey = rng.sample_key(rng.base_key(), 3)
    gen = np.random.default_rng(11)
    err_k24, shade_hits = 0.0, 0
    for label, sc in (("bunny", scene), ("bunny MAT_LEAF", leaf_scene)):
        # ~1M hits: the 1080p primary hits, then random rays from them
        h0 = traverse8.closest_hit8(sc, o, d)
        sel = torch.nonzero(h0.valid)[:, 0][: 1 << 19]
        p0 = o[sel] + d[sel] * h0.t[sel, None]
        rd = torch.as_tensor(gen.normal(size=(sel.numel(), 3)),
                             dtype=torch.float32, device=dev)
        rd = rd / rd.norm(dim=1, keepdim=True)
        eo = torch.cat([o[sel], (p0 - d[sel] * 1e-4)]).contiguous()
        ed = torch.cat([d[sel], rd]).contiguous()
        eh = traverse8.closest_hit8(sc, eo, ed)
        ne = eo.shape[0]
        lit = torch.as_tensor(gen.integers(0, 12, ne), dtype=torch.int32,
                              device=dev)
        eids = (torch.cat([sel, sel]).to(torch.int32) * 191 + lit)
        eta = torch.as_tensor(gen.choice([1e-5, 1.0, 1.333, 1.5], ne),
                              dtype=torch.float32, device=dev)
        ke = unidirectional_mega.shade_eval(sc, eo, ed, eh, eids, eta, skey)
        pe = unidirectional_mega.shade_eval_plain(sc, eo, ed, eh, eids, eta,
                                                  skey)
        u_sel = rng.uniform_id(skey, 4, eids)
        u1 = rng.uniform_id(skey, 6, eids)
        err_k24 = max(err_k24, compare_shade_eval(
            sc, ed, eh, ke, pe, eta, u_sel, u1, f"{label}, {ne} rays"))
        shade_hits += int(eh.valid.sum())
        if label == "bunny":
            keys = [w for dr in range(9) for w in rng.draw_key(skey, dr)]
            c = lambda x: x.contiguous()
            args = (sc, eo, ed, c(eh.t), c(eh.tri), c(eh.u), c(eh.v), eids,
                    c(eta), keys)
            # inputs: the hit records (48 B), the shading records of the
            # hit triangles (64 B: scene.shade_table), a light row (68 B),
            # the material table once; output 38 floats. The JAX layout's
            # bound read the 192-byte shade row a hit instead.
            nv = int(eh.valid.sum())
            ops = nv * 7 * OPS_PER_DRAW
            stats["shade_eval"].update(
                bound=bound_ms(ne * 48 + nv * (64 + 68)
                               + sc.mat_f32.numel() * 4 + ne * 38 * 4, ops),
                bound_row192=bound_ms(ne * 48 + nv * (192 + 68)
                                      + ne * 38 * 4, ops),
                ms=cuda_ms(lambda: kernels.shade_eval(*args), 10),
                plain_ms=cuda_ms(lambda: unidirectional_mega.shade_eval_plain(
                    sc, eo, ed, eh, eids, eta, skey), 3))
    stats["shade_eval"]["max_abs_err"] = err_k24
    say("shade", f"kernel {stats['shade_eval']['ms']:.4f} ms, plain "
        f"{stats['shade_eval']['plain_ms']:.4f} ms ({shade_hits} hits "
        "compared over both scenes); bound "
        f"{stats['shade_eval']['bound'][0]:.4f} ms on the 64-byte records "
        f"({stats['shade_eval']['bound_row192'][0]:.4f} ms on the 192-byte "
        "shade rows)")
    del leaf_scene

    # --- 7. K5 against its plain version
    def render(sc, c, sched, pxs, pys, plain=False):
        """Sample 0: K5 or, with plain, its plain version."""
        fn = unidirectional.render_plain if plain else \
            unidirectional.render_kernel
        return fn(sc, c, rng.base_key(), 0, pxs, pys, max_depth=DEPTH,
                  use_mis=True, sample_environment=False, schedule=sched)

    err5 = 0.0
    for sched in ("mega", "classic"):
        k5 = render(scene, cam, sched, px, py)
        p5 = render(scene, cam, sched, px, py, plain=True)
        err5 = max(err5, compare_render(
            k5, p5, f"{WIDTH}x{HEIGHT} bunny, 1 spp, {sched}"))
        if sched == "mega":
            mega_rays = k5[1]
            stats["render_unidirectional"].update(
                ms=cuda_ms(lambda: render(scene, cam, "mega", px, py), 5),
                plain_ms=cuda_ms(lambda: render(scene, cam, "mega", px, py,
                                                plain=True), 1, warmup=0))
    _, _, rows5 = kernels.render_unidirectional(
        scene, px, py, cam.kernel_params(), rng.base_key(), 0, 1,
        max_depth=DEPTH,
        use_mis=True, sample_environment=False, schedule="mega",
        air_priority=scene.air_priority, with_rows=True)
    # inputs read once: the tables, px, py; outputs li, rays. Operations:
    # the rows every ray of the sample visited and the camera draws; the
    # shading arithmetic is not counted, so the bound is low.
    tbytes = sum(t.numel() * 4 for t in (scene.bvh8_table, scene.tri_f32,
                                          scene.light_f32, scene.textures,
                                          scene.medium_f32))
    stats["render_unidirectional"].update(
        bound=bound_ms(tbytes + n * (8 + 12 + 4),
                       int(rows5.sum()) * OPS_PER_ROW
                       + n * OPS_PER_CAMERA_RAY))
    say("K5", f"{WIDTH}x{HEIGHT} mega sample: kernel "
        f"{stats['render_unidirectional']['ms']:.3f} ms "
        f"({mega_rays / stats['render_unidirectional']['ms'] / 1e3:.3f} "
        f"Mrays/s), plain {stats['render_unidirectional']['plain_ms']:.3f} "
        f"ms; {int(rows5.sum())} BVH8 rows visited; bound "
        f"{stats['render_unidirectional']['bound'][0]:.4f} ms "
        f"({stats['render_unidirectional']['bound'][1]})")
    sph, _ = build_scene(builtin.cornell_with_spheres(), builtin_materials(),
                         device=dev)
    scam = Camera.pinhole((0.0, 0.0, 1.0), 256, 256, 0.0, 0.0, 0.0, 60.0)
    sy, sx = torch.meshgrid(torch.arange(256, dtype=torch.int32, device=dev),
                            torch.arange(256, dtype=torch.int32, device=dev),
                            indexing="ij")
    sx, sy = sx.reshape(-1).contiguous(), sy.reshape(-1).contiguous()
    for sched in ("mega", "classic"):
        err5 = max(err5, compare_render(
            render(sph, scam, sched, sx, sy),
            render(sph, scam, sched, sx, sy, plain=True),
            f"256x256 mirror + glass spheres, 1 spp, {sched}"))
    stats["render_unidirectional"]["max_abs_err"] = err5

    # --- 7b. path regeneration: K5 on its resident grid bit-equal to K5 on
    # one block per SM (li, rays, rows), three schedules at 1080p; the lane
    # use the card counted (events / (32 x the warps' calls of the event
    # code)) and the event balance (events / (32 x the sum of each warp's
    # busiest lane's events))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for sched in ("mega", "classic", "naive"):
        runs = {}
        for grid in (None, sms):
            lanes = torch.zeros(3, dtype=torch.int64, device=dev)
            runs[grid] = kernels.render_unidirectional(
                scene, px, py, cam.kernel_params(), rng.base_key(), 0, 1,
                max_depth=DEPTH, use_mis=sched != "naive",
                sample_environment=False, schedule=sched,
                air_priority=scene.air_priority, with_rows=True, grid=grid,
                lanes=lanes) + (lanes.tolist(),)
        (la, ra, wa, (ev, busy, calls)), (lb, rb, wb, (evb, busyb, callsb)) \
            = runs[None], runs[sms]
        check(torch.equal(la.view(torch.int32), lb.view(torch.int32))
              and torch.equal(ra, rb) and torch.equal(wa, wb),
              f"K5 {sched}: the resident grid and {sms} blocks differ")
        use, balance = ev / (32 * calls), ev / (32 * busy)
        row = stats["naive" if sched == "naive" else
                    "render_unidirectional"]
        if sched != "classic":
            row.update(lane_use=use, event_balance=balance)
        say("K5", f"{sched} {WIDTH}x{HEIGHT}: the resident grid "
            f"({kernels.render_unidirectional_grid(scene, n, sched)} blocks "
            f"of 128) and {sms} blocks bit-equal (li, rays, rows); {ev} "
            f"events in {calls} warp calls of the event code: lane use "
            f"{use:.4f}, event balance {balance:.4f} (on {sms} blocks "
            f"{evb / (32 * callsb):.4f} and {evb / (32 * busyb):.4f})")
    del runs, la, ra, wa, lb, rb, wb

    # --- 8. goldens on the card, through the megakernel
    gscene, _ = build_scene(builtin.cornell_with_blocks(),
                            builtin_materials(), device=dev)
    gcam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    gyy, gxx = torch.meshgrid(torch.arange(16, dtype=torch.int32,
                                           device=dev),
                              torch.arange(16, dtype=torch.int32,
                                           device=dev), indexing="ij")
    for mod, gname in ((unidirectional_mega, "cornell_mega_16x16_8spp.npy"),
                       (unidirectional, "cornell_uni_16x16_8spp.npy")):
        kernels.reset_launches()
        acc = torch.zeros((256, 3), device=dev)
        for s in range(8):
            li, _ = mod.render_sample(gscene, gcam, rng.base_key(), s,
                                      gxx.reshape(-1), gyy.reshape(-1),
                                      max_depth=6)
            acc += li
        check(kernels.launches["render_unidirectional"] == 8,
              f"golden {gname}: not rendered by the megakernel")
        img = (acc / 8).cpu().numpy()
        golden = np.load(os.path.join(ROOT, "tests", "golden", gname))
        err = rmse(img, golden)
        say("golden", f"{gname} (16x16, 8 spp) on the card through the "
            f"megakernel: rmse {err:.3g} (bound 1e-3), mean ratio "
            f"{float(img.mean() / golden.mean()):.6f}")
        check(err < 1e-3, f"golden {gname}: rmse {err:.3g}")
    # --- 10. K10: the packed-vertex codecs, bit-equal to the plain ones
    gen = np.random.default_rng(13)
    vec = torch.as_tensor(gen.normal(size=(n, 3)), dtype=torch.float32,
                          device=dev)
    vec = (vec / vec.norm(dim=1, keepdim=True)).contiguous()
    cbeta = torch.as_tensor(gen.lognormal(0.0, 6.0, (n, 3)),
                            dtype=torch.float32, device=dev)
    cdl = torch.as_tensor(gen.uniform(size=n) < 0.5, device=dev)
    cbf = torch.as_tensor(gen.uniform(size=n) < 0.5, device=dev)
    cli = torch.as_tensor(gen.integers(-1, 1 << 20, n), dtype=torch.int32,
                          device=dev)
    cmi = torch.as_tensor(gen.integers(0, 1024, n), dtype=torch.int32,
                          device=dev)

    def codecs_plain():
        o = packing.pack_oct(vec)
        h = packing.to_half3(cbeta)
        f = packing.pack_flags(cdl, cbf, cli, cmi)
        return dict(oct=o, dec=packing.unpack_oct(o), half3=h,
                    beta_dec=packing.from_half3(h), flags=f,
                    unflags=torch.stack([x.to(torch.int32) for x in
                                         packing.unpack_flags(f)], dim=1))
    codec_args = (vec, cbeta, cdl, cbf, cli, cmi)
    compare_codecs(kernels.packing_roundtrip(*codec_args), codecs_plain(),
                   f"{n} vectors")
    stats["packing_roundtrip"].update(
        bound=bound_ms(n * (34 + 54), n * OPS_PER_CODEC), max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.packing_roundtrip(*codec_args), 20),
        plain_ms=cuda_ms(codecs_plain, 5))
    say("K10", f"{n} unit vectors, betas and flag words: oct, half and flag "
        "codecs bit-equal both ways; kernel "
        f"{stats['packing_roundtrip']['ms']:.4f} ms, plain "
        f"{stats['packing_roundtrip']['plain_ms']:.4f} ms")

    # --- 11-13. K12, K11, K13 against their plain versions: the 1080p
    # bunny scene at the config's depths, sample 0; K11 and K13 read the
    # kernel walk's buffers, so their parity does not rest on K12's
    cfg0 = load_config(os.path.join(ROOT, "configs", "cornell.rendertron"))
    bcfg = bdpt.BDPTConfig.from_config(cfg0)
    key_l, key_e, key_c = bdpt.sample_keys(rng.base_key(), 0)
    wkeys = {"light": paths.walk_keys(key_l, "light"),
             "eye": paths.walk_keys(key_e, "eye")}

    def walk(mode, rays=None, with_rows=False):
        return kernels.bdpt_walk(
            scene, px, py, wkeys[mode], mode=mode, camera=cam,
            max_depth=bcfg.light_depth if mode == "light" else bcfg.eye_depth,
            rays=torch.zeros(n, dtype=torch.int32, device=dev)
            if rays is None else rays, with_rows=with_rows)
    t0 = time.perf_counter()
    wrays = {m: torch.zeros(n, dtype=torch.int32, device=dev)
             for m in ("light", "eye")}
    kw = {m: walk(m, wrays[m], with_rows=True) for m in ("light", "eye")}
    pl = paths.generate_light_path(scene, key_l, px, py, bcfg.light_depth)
    pe = paths.generate_eye_path(scene, cam, key_e, px, py, bcfg.eye_depth)
    err12 = 0.0
    for mode, pw, prays in (("light", (pl[0], pl[1], None), pl[2]),
                            ("eye", (pe[0], pe[1], pe[2]), pe[3])):
        k = kw[mode]
        err12 = max(err12, compare_walk(
            (k["bufs"], k["v0"], k["escape"]), pw, f"{mode} walk "
            f"{WIDTH}x{HEIGHT}, depth {pw[0].valid.shape[0] + 1}"))
        krays = int(wrays[mode].sum())
        check(abs(krays - prays) <= 1e-3 * prays, f"K12 {mode}: rays "
              f"{krays} vs plain {prays}")
    # path regeneration: the resident grid bit-equal to one block per SM,
    # and the lanes the card counted
    k12_lanes = {m: walk_grids(
        scene, px, py, wkeys[m], f"{m} walk {WIDTH}x{HEIGHT}", sms, mode=m,
        max_depth=bcfg.light_depth if m == "light" else bcfg.eye_depth,
        camera=cam) for m in ("light", "eye")}
    stats["bdpt_walk"].update(lane_stats(*k12_lanes.values()))
    wrows = int(kw["light"]["rows"].sum() + kw["eye"]["rows"].sum())
    wverts = int(kw["light"]["bufs"].valid.sum() + kw["eye"]["bufs"].valid.sum())
    tbytes = sum(t.numel() * 4 for t in (scene.bvh8_table, scene.tri_f32,
                                          scene.light_f32, scene.textures,
                                          scene.mat_f32))
    stored = (bcfg.light_depth - 1 + bcfg.eye_depth - 1) * n
    stats["bdpt_walk"].update(
        bound=bound_ms(tbytes + n * 16 + stored * VERTEX_BYTES
                       + n * (52 + 12 + 25 + 8),
                       wrows * OPS_PER_ROW + wverts * OPS_PER_WALK_VERTEX
                       + n * (OPS_PER_CAMERA_RAY + 5 * OPS_PER_DRAW)),
        max_abs_err=err12,
        ms=cuda_ms(lambda: walk("light"), 3) + cuda_ms(lambda: walk("eye"),
                                                       3),
        plain_ms=cuda_ms(lambda: paths.generate_light_path(
            scene, key_l, px, py, bcfg.light_depth), 1, warmup=0)
        + cuda_ms(lambda: paths.generate_eye_path(
            scene, cam, key_e, px, py, bcfg.eye_depth), 1, warmup=0))
    say("K12", f"light + eye walks: kernel {stats['bdpt_walk']['ms']:.3f} ms, "
        f"plain {stats['bdpt_walk']['plain_ms']:.3f} ms; "
        f"{int(wrays['light'].sum()) + int(wrays['eye'].sum())} rays, "
        f"{wrows} BVH8 rows, {wverts} valid vertices; bound "
        f"{stats['bdpt_walk']['bound'][0]:.4f} ms "
        f"({stats['bdpt_walk']['bound'][1]}); "
        f"{time.perf_counter() - t0:.1f} s for the phase")
    del pl, pe

    lw, ew = kw["light"], kw["eye"]
    fbk = torch.zeros((n, 3), device=dev)
    srays = torch.zeros(n, dtype=torch.int32, device=dev)
    srows = kernels.bdpt_splat(scene, cam, lw["bufs"], lw["v0"], fbk, srays,
                               bcfg, with_rows=True)
    fbk2 = torch.zeros((n, 3), device=dev)
    kernels.bdpt_splat(scene, cam, lw["bufs"], lw["v0"], fbk2,
                       torch.zeros(n, dtype=torch.int32, device=dev), bcfg)
    fbp = torch.zeros((n, 3), device=dev)
    _, prays_s = bdpt.light_trace_splat(scene, cam, lw["bufs"], lw["v0"],
                                        bcfg, fbp)
    err11 = compare_image((fbk, int(srays.sum())), (fbp, prays_s),
                          f"splat {WIDTH}x{HEIGHT}, {bcfg.light_depth} "
                          "vertices per light path", "K11", 0.999)
    say("K11", "two kernel runs on the same buffers (atomicAdd order): max "
        f"abs difference {(fbk - fbk2).abs().max().item():.3g}")
    check(int(srays.sum()) == prays_s, f"K11: rays {int(srays.sum())} vs "
          f"plain {prays_s}")
    fbt = torch.zeros((n, 3), device=dev)
    rst = torch.zeros(n, dtype=torch.int32, device=dev)
    lverts = bcfg.light_depth * n
    # K11's stages: stage 1 against its twin, with every path and with
    # n_live < N (a mega chunk's pads), each stage timed
    st11 = splat_stages(scene, cam, lw["bufs"], lw["v0"], bcfg,
                        f"splat {WIDTH}x{HEIGHT}")
    splat_stages(scene, cam, lw["bufs"], lw["v0"], bcfg,
                 f"splat {WIDTH}x{HEIGHT}, n_live {n - 100000}",
                 n_live=n - 100000)
    srows_n = int(srows.sum())
    stats["bdpt_splat_bin"].update(
        bound=bound_ms((bcfg.light_depth - 1) * n * 17 + n * (12 + 8)
                       + st11["queued"] * 4 + st11["tiles"] * 8,
                       lverts * OPS_PER_RASTER),
        max_abs_err=0.0, ms=st11["bin_ms"], plain_ms=st11["twin_ms"])
    stats["bdpt_splat_trace"].update(
        bound=bound_ms(tbytes + st11["queued"] * (4 + VERTEX_BYTES + 12),
                       srows_n * OPS_PER_ROW
                       + st11["queued"] * OPS_PER_DECODE),
        max_abs_err=err11, ms=st11["trace_ms"])
    stats["bdpt_splat"].update(
        bound=bound_ms(tbytes + (bcfg.light_depth - 1) * n * VERTEX_BYTES
                       + n * 44 + n * 12 + n * 4,
                       int(srows.sum()) * OPS_PER_ROW
                       + lverts * OPS_PER_DECODE),
        max_abs_err=err11,
        ms=cuda_ms(lambda: kernels.bdpt_splat(scene, cam, lw["bufs"],
                                              lw["v0"], fbt, rst, bcfg), 5),
        plain_ms=cuda_ms(lambda: bdpt.light_trace_splat(
            scene, cam, lw["bufs"], lw["v0"], bcfg, fbt), 1, warmup=0))
    stats["bdpt_splat_trace"]["plain_ms"] = stats["bdpt_splat"]["plain_ms"]
    say("K11", f"kernel {stats['bdpt_splat']['ms']:.3f} ms, plain "
        f"{stats['bdpt_splat']['plain_ms']:.3f} ms; {int(srays.sum())} "
        f"shadow rays, {int(srows.sum())} BVH8 rows; bound "
        f"{stats['bdpt_splat']['bound'][0]:.4f} ms "
        f"({stats['bdpt_splat']['bound'][1]})")

    # K13: the pairs and the gather against their twins, the composed pass
    # (with the splat's frame buffer) against connect_plain
    crows = torch.zeros(n, dtype=torch.int32, device=dev)
    err13 = compare_k13(scene, cam, key_c, ew, lw, fbk, bcfg, px, py,
                        f"{WIDTH}x{HEIGHT}, t <= {bcfg.eye_depth}, s <= "
                        f"{bcfg.light_depth}", rows=crows)
    # the terms, rays and rows do not depend on the pairs a thread takes
    # (one, or all of a pixel's: the engines' two mappings)
    per_all = (bcfg.eye_depth - 1) * bcfg.light_depth
    by_per = {}
    for per in (1, per_all):
        prays_ = torch.zeros(n, dtype=torch.int32, device=dev)
        by_per[per] = (kernels.bdpt_pairs(
            scene, cam, key_c, ew, lw, prays_, bcfg, px=px, py=py,
            per=per).view(torch.int32), prays_)
    check(all(torch.equal(a, b) for a, b in zip(by_per[1], by_per[per_all])),
          f"K13 pairs: 1 and {per_all} pairs a thread differ")
    del by_per, prays_
    crays = torch.zeros(n, dtype=torch.int32, device=dev)
    terms = kernels.bdpt_pairs(scene, cam, key_c, ew, lw, crays, bcfg, px=px,
                               py=py)
    pid = rng.pixel_ids(px, py)
    everts = int(ew["bufs"].valid.sum())
    live = ew["bufs"].valid & ~ew["bufs"].is_delta
    nlive = int(live.sum())
    # the fused pass's counts; the pairs write every term, the gather
    # reads the terms of the live eye vertices
    tbytes_terms = terms.numel() * 4
    stats["bdpt_pairs"].update(
        bound=bound_ms(tbytes + stored * VERTEX_BYTES + n * (8 + 8)
                       + tbytes_terms,
                       int(crows.sum()) * OPS_PER_ROW
                       + everts * (bcfg.light_depth * OPS_PER_DECODE
                                   + 3 * OPS_PER_DRAW)),
        max_abs_err=err13["pairs"],
        ms=cuda_ms(lambda: kernels.bdpt_pairs(
            scene, cam, key_c, ew, lw, rst, bcfg, px=px, py=py), 3),
        plain_ms=cuda_ms(lambda: bdpt.connect_pairs_plain(
            scene, key_c, ew["bufs"], lw["bufs"], bcfg, pid), 1, warmup=0))
    # the gather reads the eye vertices up to each pixel's first invalid
    # one: every valid vertex whole, and the valid flag (1 B) that stops a
    # path short of the last depth
    stops = n - int(ew["bufs"].valid[-1].sum())
    stats["bdpt_gather"].update(
        bound=bound_ms(everts * VERTEX_BYTES + stops
                       + n * (12 + 25 + 12 + 12)
                       + nlive * bcfg.light_depth * 12,
                       everts * OPS_PER_DECODE),
        max_abs_err=max(err13["gather"], err13["composed"]),
        ms=cuda_ms(lambda: kernels.bdpt_gather(scene, cam, ew, terms, fbk,
                                               bcfg), 5),
        plain_ms=cuda_ms(lambda: bdpt.connect_gather_plain(
            scene, cam, ew["bufs"], ew["v0"], ew["escape"], terms, bcfg,
            fbk), 1, warmup=0))
    k13 = {k: stats[k] for k in ("bdpt_pairs", "bdpt_gather")}
    say("K13", f"pairs {k13['bdpt_pairs']['ms']:.3f} ms (plain "
        f"{k13['bdpt_pairs']['plain_ms']:.3f}, bound "
        f"{k13['bdpt_pairs']['bound'][0]:.4f} ms, "
        f"{k13['bdpt_pairs']['bound'][1]}), gather "
        f"{k13['bdpt_gather']['ms']:.3f} ms (plain "
        f"{k13['bdpt_gather']['plain_ms']:.3f}, bound "
        f"{k13['bdpt_gather']['bound'][0]:.4f} ms, "
        f"{k13['bdpt_gather']['bound'][1]}), the pass "
        f"{k13['bdpt_pairs']['ms'] + k13['bdpt_gather']['ms']:.3f} ms "
        f"({card}); {int(crays.sum())} shadow rays, {int(crows.sum())} BVH8 "
        f"rows, {everts} eye vertices ({nlive} valid non-delta), "
        f"{terms.numel() // 3} pairs, terms {tbytes_terms / 2**30:.3f} GiB; "
        f"1 and {per_all} pairs a thread bit-equal")
    del kw, lw, ew, fbk, fbk2, fbp, fbt, codec_args, vec, cbeta, terms, live
    del cdl, cbf, cli, cmi, wrays, srays, srows, crays, crows, pid, rst

    # --- 13b. every strategy flag, and the VCM light walk (eta_vcm), on the
    # mirror + glass spheres scene at 256x256: K12, K11, K13 against their
    # plain versions as above
    t0 = time.perf_counter()
    fkeys = bdpt.sample_keys(rng.base_key(), 1)
    compare_bdpt(sph, scam, sx, sy, bcfg, fkeys, "spheres 256x256 vcm walk",
                 eta_vcm=VCM_ETA)
    for fname, over in BDPT_FLAGS.items():
        compare_bdpt(sph, scam, sx, sy, dataclasses.replace(bcfg, **over),
                     fkeys, f"spheres 256x256 {fname}")
    say("flags", f"{len(BDPT_FLAGS)} strategy-flag settings and the VCM "
        "walk held to their plain versions in "
        f"{time.perf_counter() - t0:.1f} s")

    # --- 14. the BDPT golden on the card through K12, K11, K12, K13
    gcfg = bdpt.BDPTConfig(eye_depth=6, light_depth=4)
    kernels.reset_launches()
    acc = torch.zeros((256, 3), device=dev)
    for s in range(8):
        li, _ = bdpt.render_sample(gscene, gcam, rng.base_key(), s,
                                   gxx.reshape(-1), gyy.reshape(-1), cfg=gcfg)
        acc += li
    check(all(kernels.launches[k] == (16 if k == "bdpt_walk" else 8)
              for k in BDPT_KERNELS),
          f"BDPT golden: launches {kernels.launches}")
    img = (acc / 8).cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  "cornell_bdpt_16x16_8spp.npy"))
    err = rmse(img, golden)
    say("golden", f"cornell_bdpt_16x16_8spp.npy (16x16, 8 spp) on the card "
        f"through K12, K11, K12, K13: rmse {err:.3g} (bound 1e-3), mean "
        f"ratio {float(img.mean() / golden.mean()):.6f}")
    check(err < 1e-3, f"BDPT golden: rmse {err:.3g}")

    # --- 16. the photon family against its plain versions: the 1080p VCM
    # main path's sample (12.4M candidate photons, a table above 2^24
    # buckets), the same for SPPM, and VCM on the 512x512 mirror + glass
    # spheres (the caustics config's scene and depths)
    t0 = time.perf_counter()

    def photon_cfg(c, integ):
        return vcm.VCMConfig.from_config(dataclasses.replace(
            c, integrator=integ, engine="classic").normalized())
    vmain = photon_cfg(cfg0, "VCM")
    res = compare_vcm(scene, cam, px, py, vmain, 0,
                      f"vcm {WIDTH}x{HEIGHT}")
    check(res["grid"].table_size > 2 ** 24, "the 1080p VCM grid is expected "
          "to need more than 2^24 buckets")
    plain_ms = res["plain_ms"]
    err_splat, err_eye = res["err_splat"], res["err_eye"]
    lb, vgrid = res["lbufs"], res["grid"]
    mr, eta, norm = res["mr"], res["eta"], res["norm"]
    p = lb.pt.shape[0] * lb.pt.shape[1]
    p8, tsize = vgrid.rows.shape[0], vgrid.table_size
    ekeys = paths.walk_keys(res["keys_e"], "eye")
    srays = torch.zeros(n, dtype=torch.int32, device=dev)
    fbs = [torch.zeros((n, 3), device=dev) for _ in range(2)]
    srows = kernels.vcm_splat(scene, cam, lb, fbs[0], srays, vmain, eta,
                              with_rows=True)
    kernels.vcm_splat(scene, cam, lb, fbs[1],
                      torch.zeros(n, dtype=torch.int32, device=dev), vmain,
                      eta)
    say("K11", "vcm_splat, two kernel runs on the same buffers (atomicAdd "
        f"order): max abs difference "
        f"{(fbs[0] - fbs[1]).abs().max().item():.3g}")
    erays = torch.zeros(n, dtype=torch.int32, device=dev)
    switches = hashgrid.merge_switches(vmain.max_per_cell)
    _, _, erows = kernels.vcm_eye(scene, cam, ekeys, lb, vgrid, None, erays,
                                  vmain, px=px, py=py, merge_radius=mr,
                                  eta_vcm=eta, merge_norm=norm,
                                  with_rows=True, **switches)
    packed = kernels.photon_pack(lb, scene.scene_min, 2.0 * mr, tsize)
    order, sorted_h = compare_photon_sort(
        packed[1], res["salt"] if hashgrid.REWEIGHT else None, tsize, stats,
        f"vcm {WIDTH}x{HEIGHT}")
    tbytes = sum(t.numel() * 4 for t in (scene.bvh8_table, scene.tri_f32,
                                          scene.light_f32, scene.textures,
                                          scene.mat_f32))
    lbytes = vmain.light_depth * n * VERTEX_BYTES
    gbytes = 32 * p8 + 8 * (tsize + 1)
    fbt = torch.zeros((n, 3), device=dev)
    rst = torch.zeros(n, dtype=torch.int32, device=dev)
    stats["vcm_splat"].update(
        bound=bound_ms(tbytes + lbytes + n * (12 + 4),
                       int(srows.sum()) * OPS_PER_ROW
                       + vmain.light_depth * n * OPS_PER_DECODE),
        max_abs_err=err_splat, plain_ms=plain_ms["vcm_splat"],
        ms=cuda_ms(lambda: kernels.vcm_splat(scene, cam, lb, fbt, rst, vmain,
                                             eta), 5))
    st11 = splat_stages(scene, cam, lb, None, vmain,
                        f"vcm splat {WIDTH}x{HEIGHT}", eta_vcm=eta)
    stats["vcm_splat_bin"].update(
        bound=bound_ms(vmain.light_depth * n * 17 + n * 8
                       + st11["queued"] * 4 + st11["tiles"] * 8,
                       vmain.light_depth * n * OPS_PER_RASTER),
        max_abs_err=0.0, ms=st11["bin_ms"], plain_ms=st11["twin_ms"])
    stats["vcm_splat_trace"].update(
        bound=bound_ms(tbytes + st11["queued"] * (4 + VERTEX_BYTES + 12),
                       int(srows.sum()) * OPS_PER_ROW
                       + st11["queued"] * OPS_PER_DECODE),
        max_abs_err=err_splat, ms=st11["trace_ms"],
        plain_ms=plain_ms["vcm_splat"])
    stats["photon_pack"].update(
        bound=bound_ms(p * (35 + 40) + 8 * (tsize + 1),
                       p * OPS_PER_PHOTON),
        max_abs_err=0.0, plain_ms=plain_ms["photon_pack"],
        ms=cuda_ms(lambda: kernels.photon_pack(lb, scene.scene_min, 2.0 * mr,
                                               tsize), 5))
    touched = int((vgrid.cell_se[:, 1] > vgrid.cell_se[:, 0]).sum())
    stats["photon_table"].update(
        bound=bound_ms(p * (4 + 4 + 32) + 32 * p8 + 16 * touched, p * 4),
        max_abs_err=0.0, plain_ms=plain_ms["photon_table"],
        ms=cuda_ms(lambda: kernels.photon_table(packed[0], sorted_h, order,
                                                packed[2]), 5))
    sort_ms = stats["photon_sort"]["ms"]
    stats["vcm_eye"].update(
        bound=bound_ms(tbytes + lbytes + gbytes + n * (8 + 12 + 4 + 4),
                       int(erows.sum()) * OPS_PER_ROW
                       + n * OPS_PER_CAMERA_RAY),
        max_abs_err=err_eye, plain_ms=plain_ms["vcm_eye"],
        ms=cuda_ms(lambda: kernels.vcm_eye(
            scene, cam, ekeys, lb, vgrid, None, rst, vmain, px=px, py=py,
            merge_radius=mr, eta_vcm=eta, merge_norm=norm, **switches), 2))
    eye_stage_stats(stats, "vcm_eye", res["stages"], res["eps"],
                    vmain.eye_depth, vmain.light_depth, n, tbytes, lbytes,
                    gbytes, fb_bytes=12 * n)
    say("photon", f"vcm {WIDTH}x{HEIGHT} sample 0: {p} candidate photons "
        f"({res['photons']} valid) in {touched} of {tsize + 1} buckets, "
        f"merge radius {mr:.6g}, eta_vcm "
        f"{eta:.6g}; kernel / plain ms: vcm_splat "
        f"{stats['vcm_splat']['ms']:.3f} / {plain_ms['vcm_splat']:.3f}, "
        f"photon_pack {stats['photon_pack']['ms']:.3f} / "
        f"{plain_ms['photon_pack']:.3f}, sort {sort_ms:.3f}, photon_table "
        f"{stats['photon_table']['ms']:.3f} / {plain_ms['photon_table']:.3f}"
        f", vcm_eye {stats['vcm_eye']['ms']:.3f} / {plain_ms['vcm_eye']:.3f}"
        f"; {int(srows.sum())} + {int(erows.sum())} BVH8 rows (splat, eye)")
    del res, lb, vgrid, packed, order, sorted_h, srows, erows, fbt, rst, fbs
    sres = compare_vcm(scene, cam, px, py, photon_cfg(cfg0, "SPPM"), 0,
                       f"sppm {WIDTH}x{HEIGHT}")
    stage_errs(stats, "vcm_eye", sres["stages"])
    del sres
    ccfg = photon_cfg(load_config(os.path.join(
        ROOT, "configs", "vcm_caustics.rendertron")), "VCM")
    ccam = Camera.pinhole((0.0, 0.0, 1.0), 512, 512, 0.0, 0.0, 0.0, 60.0)
    cx, cy = (t.reshape(-1).contiguous() for t in reversed(torch.meshgrid(
        torch.arange(512, dtype=torch.int32, device=dev),
        torch.arange(512, dtype=torch.int32, device=dev), indexing="ij")))
    for s in (0, 1):
        cres = compare_vcm(sph, ccam, cx, cy, ccfg, s,
                           f"caustics 512x512 sample {s}")
        err_splat = max(err_splat, cres["err_splat"])
        err_eye = max(err_eye, cres["err_eye"])
        stage_errs(stats, "vcm_eye", cres["stages"])
        del cres
    stats["vcm_splat"]["max_abs_err"] = err_splat
    stats["vcm_splat_trace"]["max_abs_err"] = err_splat
    stats["vcm_eye"]["max_abs_err"] = err_eye
    say("photon", f"K8, K9, K11 and K13's VCM forms held to their plain "
        f"versions in {time.perf_counter() - t0:.1f} s")

    # --- 17. the VCM and SPPM goldens on the card through the kernels
    gvcm = vcm.VCMConfig(eye_depth=6, light_depth=4)
    for gname, gc in (("vcm", gvcm), ("sppm", dataclasses.replace(
            gvcm, light_trace=False, nee=False, naive=False,
            connection=False, do_mis=False, do_sppm=True))):
        kernels.reset_launches()
        acc = torch.zeros((256, 3), device=dev)
        for s in range(8):
            li, _, _ = vcm.render_sample(gscene, gcam, rng.base_key(), s,
                                         gxx.reshape(-1), gyy.reshape(-1),
                                         cfg=gc)
            acc += li
        want = {k: 8 for k in PHOTON_KERNELS + ("bdpt_walk",)}
        for k in ("vcm_splat_bin", "vcm_splat_trace"):
            want[k] = 8 if gc.light_trace else 0
        want["vcm_eye_connect"] = 8 if gc.connection else 0
        check(all(kernels.launches[k] == v for k, v in want.items()),
              f"{gname} golden: launches {kernels.launches}")
        img = (acc / 8).cpu().numpy()
        golden = np.load(os.path.join(ROOT, "tests", "golden",
                                      f"cornell_{gname}_16x16_8spp.npy"))
        err = rmse(img, golden)
        say("golden", f"cornell_{gname}_16x16_8spp.npy (16x16, 8 spp) on the "
            f"card through the photon kernels: rmse {err:.3g} (bound 1e-3), "
            f"mean ratio {float(img.mean() / golden.mean()):.6f}")
        check(err < 1e-3, f"{gname} golden: rmse {err:.3g}")

    # --- 20. K10's RGB9E5 mode, bit-equal to the plain codec (the mega
    # engines' retirement, inside uni_mega.cu's mega schedule and K14)
    rc = rgb9e5_inputs(n).to(dev)
    compare_rgb9e5(kernels.rgb9e5_roundtrip(rc), rc, f"{n} colours")
    # the bound: the bytes (a colour in, its code and the colour out), or
    # the kernel's SASS arithmetic at each pipe's rate, as K6's is counted
    rgb_sass = sass_counts(kernels.LIBRARY, "rgb9e5_kernel")
    rgb_ops_ms = sass_ops_ms(rgb_sass, n, clk_mhz, sms)
    check(rgb_sass != {}, "cuobjdump found no SASS of rgb9e5_kernel")
    rgb_bytes_ms = n * (12 + 4 + 12) / PEAK_BYTES_S * 1e3
    stats["rgb9e5"].update(
        bound=(max(rgb_bytes_ms, rgb_ops_ms),
               "bytes" if rgb_bytes_ms >= rgb_ops_ms else "operations"),
        max_abs_err=0.0,
        ms=graph_ms(lambda: kernels.rgb9e5_roundtrip(rc)),
        call_ms=cuda_ms(lambda: kernels.rgb9e5_roundtrip(rc), 20),
        plain_ms=cuda_ms(lambda: packing.unpack_rgb9e5(
            packing.pack_rgb9e5(rc)), 5))
    say("K10", f"RGB9E5: {n} colours (zeros, negatives, subnormals, values "
        "above 65408 and infinities, every power of two and rounding edge "
        "of the range) packed and decoded bit-equal; kernel "
        f"{stats['rgb9e5']['ms']:.4f} ms (graph replay; a call from the "
        f"host {stats['rgb9e5']['call_ms']:.4f} ms), plain "
        f"{stats['rgb9e5']['plain_ms']:.4f} ms; bound bytes "
        f"{rgb_bytes_ms:.4f} ms, SASS arithmetic {rgb_ops_ms:.4f} ms ("
        + ", ".join(f"{k} {v}" for k, v in sorted(rgb_sass.items())
                    if sass_pipe(k)) + f") ({card})")
    del rc

    # --- 21. K14, the mega eye pass, against its plain version on every
    # chunk of the 1080p sample (two chunks of 1,036,800 pixels) in the VCM,
    # SPPM and BDPT flavours, on the kernels' light walks and grids; then
    # K9's materialised forms on chunk 0's grid and first-bounce hit points
    # in both modes; then VCM on configs/vcm_caustics.rendertron as shipped
    # (512x512: one chunk of 272,160 with 10,016 pad paths)
    t0 = time.perf_counter()

    def mega_cfg(c, integ):
        c = dataclasses.replace(c, integrator=integ, engine="mega")
        c = c.normalized()
        if integ == "BIDIRECTIONAL":
            return bdpt_mega.as_machine_cfg(bdpt.BDPTConfig.from_config(c))
        return vcm.VCMConfig.from_config(c)
    mres, err14 = {}, 0.0
    for integ in ("VCM", "SPPM", "BIDIRECTIONAL"):
        flavor = "bdpt" if integ == "BIDIRECTIONAL" else "vcm"
        mres[integ] = compare_mega(scene, cam, px, py, mega_cfg(cfg0, integ),
                                   flavor, 0, f"{integ} {WIDTH}x{HEIGHT}")
        check(mres[integ]["chunks"].n_chunks == 2, "the 1080p mega sample is "
              "expected in two chunks")
        err14 = max(err14, mres[integ]["err"])
        stage_errs(stats, "mega_eye", mres[integ]["stages"])
        if integ != "VCM":
            del mres[integ]["eps"]
    vm_cfg, vin = mega_cfg(cfg0, "VCM"), mres["VCM"]["inputs"]
    mega_ms, mega_rows = time_mega(scene, cam, vm_cfg, "vcm", 0, vin)
    tbytes = sum(t.numel() * 4 for t in (scene.bvh8_table, scene.tri_f32,
                                          scene.light_f32, scene.textures,
                                          scene.mat_f32))
    gbytes = sum(32 * ch["grid"].rows.shape[0] + 16 * int(
        (ch["grid"].cell_se[:, 1] > ch["grid"].cell_se[:, 0]).sum())
        for ch in vin)
    # inputs read once: the tables, each chunk's light buffers and grid
    # (the buckets a photon lies in), the pixels; outputs the radiance,
    # rays and dropped counts
    stats["mega_eye"].update(
        bound=bound_ms(tbytes + vm_cfg.light_depth * n * VERTEX_BYTES
                       + gbytes + n * (8 + 12 + 4 + 4),
                       mega_rows * OPS_PER_ROW + n * OPS_PER_CAMERA_RAY),
        ms=mega_ms, plain_ms=mres["VCM"]["plain_ms"])
    say("K14", f"VCM {WIDTH}x{HEIGHT}, one sample's eye pass (2 chunks): "
        f"kernel {mega_ms:.3f} ms, plain {mres['VCM']['plain_ms']:.3f} ms; "
        f"{mega_rows} BVH8 rows; bound {stats['mega_eye']['bound'][0]:.4f} "
        f"ms ({stats['mega_eye']['bound'][1]}); bit-equal pixels "
        + ", ".join(f"{i} {mres[i]['same']:.6f}" for i in mres))
    eye_stage_stats(stats, "mega_eye", mres["VCM"]["stages"],
                    mres["VCM"]["eps"], vm_cfg.eye_depth, vm_cfg.light_depth,
                    n, tbytes, vm_cfg.light_depth * n * VERTEX_BYTES, gbytes)
    del mres["VCM"]["eps"]

    ch0 = vin[0]
    q, hit = first_hits(scene, cam, ch0["pxc"], ch0["pyc"], 0)
    cap, nq = vm_cfg.max_per_cell, q.shape[0]
    old = os.environ.get("TPT_GRID_ONE_BRICK")
    try:
        for mode in ("1", "0"):
            os.environ["TPT_GRID_ONE_BRICK"] = mode
            found = compare_slots(ch0["grid"], q, hit, ch0["mr"], cap,
                                  f"{WIDTH}x{HEIGHT} chunk 0 cap {cap} "
                                  + ("one-brick" if mode == "1"
                                     else "standard"))
            check(found > 0, "K9: no slot in range on the 1080p grid")
    finally:
        if old is None:
            os.environ.pop("TPT_GRID_ONE_BRICK")
        else:
            os.environ["TPT_GRID_ONE_BRICK"] = old
    sw = hashgrid.merge_switches(cap)
    m_slots = 64 if sw["one_brick"] else 8 * cap
    slot_args = (ch0["grid"], q, ch0["mr"], cap)
    stats["neighbor_slots"].update(
        bound=bound_ms(nq * (12 + 1 + 8 * 8) + 32 * ch0["grid"].rows.shape[0]
                       + m_slots * nq * (32 + 1 + 4) + nq * 4,
                       nq * (OPS_PER_QUERY + m_slots * OPS_PER_SLOT)),
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.neighbor_slots(
            *slot_args, mode="slots", active=hit, **sw), 5),
        plain_ms=cuda_ms(lambda: hashgrid.neighbor_slots(
            *slot_args, active=hit), 2))
    say("K9", f"neighbor_slots ({m_slots} slots x {nq} queries): kernel "
        f"{stats['neighbor_slots']['ms']:.3f} ms, plain "
        f"{stats['neighbor_slots']['plain_ms']:.3f} ms")
    del mres, vin, ch0, q, hit, slot_args

    cmega = mega_cfg(load_config(os.path.join(
        ROOT, "configs", "vcm_caustics.rendertron")), "VCM")
    ccam = Camera.pinhole((0.0, 0.0, 1.0), 512, 512, 0.0, 0.0, 0.0, 60.0)
    cx, cy = (t.reshape(-1).contiguous() for t in reversed(torch.meshgrid(
        torch.arange(512, dtype=torch.int32, device=dev),
        torch.arange(512, dtype=torch.int32, device=dev), indexing="ij")))
    for s in (0, 1):
        cres = compare_mega(sph, ccam, cx, cy, cmega, "vcm", s,
                            f"caustics 512x512 sample {s}")
        check(cres["chunks"].c_pix * cres["chunks"].n_chunks > 512 * 512,
              "the 512x512 mega sample is expected to carry pad paths")
        err14 = max(err14, cres["err"])
        stage_errs(stats, "mega_eye", cres["stages"])
        del cres
    stats["mega_eye"]["max_abs_err"] = err14
    say("K14", "the mega eye pass held to its plain version in "
        f"{time.perf_counter() - t0:.1f} s")

    # --- 22. the naive integrator (uni_mega.cu's naive schedule) against
    # its plain version at 1080p on the bunny scene, depth 8
    kn = naive.render_kernel(scene, cam, rng.base_key(), 0, px, py,
                             max_depth=DEPTH)
    pn = naive.render_plain(scene, cam, rng.base_key(), 0, px, py,
                            max_depth=DEPTH)
    errn = compare_render(kn, pn, f"{WIDTH}x{HEIGHT} bunny, 1 spp, naive")
    _, _, rows_n = kernels.render_unidirectional(
        scene, px, py, cam.kernel_params(), rng.base_key(), 0, 1,
        max_depth=DEPTH, use_mis=False, sample_environment=False,
        schedule="naive", air_priority=scene.air_priority, with_rows=True)
    tbytes5 = sum(t.numel() * 4 for t in (scene.bvh8_table, scene.tri_f32,
                                           scene.light_f32, scene.textures,
                                           scene.medium_f32))
    stats["naive"].update(
        bound=bound_ms(tbytes5 + n * (8 + 12 + 4),
                       int(rows_n.sum()) * OPS_PER_ROW
                       + n * OPS_PER_CAMERA_RAY),
        max_abs_err=errn,
        ms=cuda_ms(lambda: naive.render_kernel(
            scene, cam, rng.base_key(), 0, px, py, max_depth=DEPTH), 5),
        plain_ms=cuda_ms(lambda: naive.render_plain(
            scene, cam, rng.base_key(), 0, px, py, max_depth=DEPTH), 1,
            warmup=0))
    say("naive", f"{WIDTH}x{HEIGHT} sample: kernel "
        f"{stats['naive']['ms']:.3f} ms ({kn[1] / stats['naive']['ms'] / 1e3:.3f}"
        f" Mrays/s), plain {stats['naive']['plain_ms']:.3f} ms; "
        f"{int(rows_n.sum())} BVH8 rows; bound "
        f"{stats['naive']['bound'][0]:.4f} ms ({stats['naive']['bound'][1]})")
    del kn, pn, rows_n

    # --- 25. K5 with k samples a launch (models/batch.py, B1): one launch
    # of k samples bit-equal to k launches of one sample summed in sample
    # order, and to the launch of k on one block per SM, on the bunny scene
    # at 512x512 (k = 8) for the three schedules and at 1080p (k = 4) for
    # the mega schedule; CUDA events of the batch against the k singles
    kbase = rng.base_key()
    for sched, kw_, kh_, kk in (("mega", 512, 512, 8), ("classic", 512, 512, 8),
                                ("naive", 512, 512, 8),
                                ("mega", WIDTH, HEIGHT, 4)):
        kcam = Camera.pinhole((0.0, 0.0, 1.0), kw_, kh_, 0.0, 0.0, 0.0,
                              60.0)
        ky, kx = torch.meshgrid(
            torch.arange(kh_, dtype=torch.int32, device=dev),
            torch.arange(kw_, dtype=torch.int32, device=dev), indexing="ij")
        kx, ky = kx.reshape(-1).contiguous(), ky.reshape(-1).contiguous()
        k5kw = dict(max_depth=DEPTH, use_mis=sched != "naive",
                    sample_environment=False, schedule=sched)
        kernels.reset_launches()
        bli, brays = unidirectional.render_batch_kernel(
            scene, kcam, kbase, 0, kx, ky, kk, **k5kw)
        torch.cuda.synchronize()
        check(kernels.launches["naive" if sched == "naive"
                               else "render_unidirectional"] == 1
              and sum(kernels.launches.values()) == 1,
              f"K5 k-mode {sched}: launches {kernels.launches}")
        gli, grays = kernels.render_unidirectional(
            scene, kx, ky, kcam.kernel_params(), kbase, 0, kk, grid=sms,
            air_priority=scene.air_priority, **k5kw)
        check(torch.equal(gli.view(torch.int32), bli.view(torch.int32))
              and int(grays.sum()) == int(brays),
              f"K5 k-mode {sched} {kw_}x{kh_}: {sms} blocks differ from "
              "the resident grid")
        acc, tot = torch.zeros_like(bli), 0
        for s_ in range(kk):
            l1, r1 = unidirectional.render_kernel(scene, kcam, kbase, s_, kx,
                                                  ky, **k5kw)
            acc = acc + l1
            tot += int(r1)
        check(torch.equal(bli, acc) and int(brays) == tot,
              f"K5 k-mode {sched} {kw_}x{kh_}: not bit-equal to {kk} single "
              f"launches (rays {int(brays)} vs {tot}, max abs "
              f"{(bli - acc).abs().max().item():.3g})")
        ms_b = cuda_ms(lambda: unidirectional.render_batch_kernel(
            scene, kcam, kbase, 0, kx, ky, kk, **k5kw), 3)
        ms_s = cuda_ms(lambda: [unidirectional.render_kernel(
            scene, kcam, kbase, s_, kx, ky, **k5kw) for s_ in range(kk)], 3)
        say("K5 k-mode", f"{sched} {kw_}x{kh_}, k = {kk}: li_sum and {tot} "
            f"rays bit-equal to {kk} single launches summed and to {sms} "
            f"blocks; one launch {ms_b:.3f} ms, {kk} singles {ms_s:.3f} ms "
            f"({card})")
        del bli, acc, gli

    # --- 26. the keyed draws: K6's keyed mode bit-equal to uniform_keyed's
    # plain version on 2,073,600 ids with per-lane key pairs, then K12's
    # table mode (the keyed light walk of light_mega, its host-folded
    # table) against the walk whose prologue folds the same table on the
    # card, on chunk 0 of the 1080p mega partition (1,036,800 light paths),
    # in the VCM flavour (eta_vcm) and the BDPT flavour
    gen = np.random.default_rng(23)
    kw0 = torch.as_tensor(gen.integers(0, 2 ** 32, n, dtype=np.uint64)
                          .astype(np.uint32).view(np.int32), device=dev)
    kw1 = torch.as_tensor(gen.integers(0, 2 ** 32, n, dtype=np.uint64)
                          .astype(np.uint32).view(np.int32), device=dev)
    uk = rng.uniform_keyed(kw0, kw1, ids)
    up = rng.uniform_keyed_plain(kw0, kw1, ids)
    check(torch.equal(uk.view(torch.int32), up.view(torch.int32)),
          "K6 keyed: the kernel's draws are not bit-equal to the plain "
          "version")
    stats["uniform_keyed"].update(
        bound=bound_ms(n * 16, n * OPS_PER_DRAW), max_abs_err=0.0,
        ms=graph_ms(lambda: rng.uniform_keyed(kw0, kw1, ids)),
        call_ms=cuda_ms(lambda: rng.uniform_keyed(kw0, kw1, ids), 50),
        plain_ms=cuda_ms(lambda: rng.uniform_keyed_plain(kw0, kw1, ids), 10))
    say("K6 keyed", f"{n} ids with per-lane key pairs bit-equal; kernel "
        f"{stats['uniform_keyed']['ms']:.4f} ms (graph replay; a call from "
        f"the host {stats['uniform_keyed']['call_ms']:.4f} ms), plain "
        f"{stats['uniform_keyed']['plain_ms']:.4f} ms, bound "
        f"{stats['uniform_keyed']['bound'][0]:.5f} ms "
        f"({stats['uniform_keyed']['bound'][1]}) ({card})")
    del kw0, kw1, uk, up
    vc0 = vcm.VCMConfig.from_config(load_config(os.path.join(
        ROOT, "configs", "cornell.rendertron")))
    ch0 = vcm_mega.mega_chunks(n)
    pxc0, pyc0, cnt0 = vcm_mega.chunk_pixels_of(px, py, 0, ch0.c_pix)
    key_l0, _ = vcm.sample_keys(rng.base_key(), 0)
    _, eta0, _ = vcm_mega.chunk_scalars(scene, vc0, 0, cnt0)
    tb_ms = {}
    for flavor, depth_, eta_ in (("vcm", vc0.light_depth + 1, eta0),
                                 ("bdpt", vc0.light_depth, None)):
        ktab, ketab = light_mega.key_tables(key_l0, depth_)
        table = light_mega.device_table(ktab, ketab, dev)

        def lwalk(tab, with_rows=False):
            r_ = torch.zeros(ch0.c_pix, dtype=torch.int32, device=dev)
            w_ = kernels.bdpt_walk(scene, pxc0, pyc0,
                                   paths.walk_keys(key_l0, "light"),
                                   mode="light", max_depth=depth_, rays=r_,
                                   eta_vcm=eta_, key_table=tab,
                                   with_rows=with_rows)
            return w_, r_
        (tw, tr), (fw, fr) = lwalk(table, True), lwalk(None)
        diverged = ((tw["bufs"].valid != fw["bufs"].valid).any(0)
                    | ((tw["bufs"].pt != fw["bufs"].pt).any(-1)).any(0))
        check(int(diverged.sum()) == 0, f"K12 table mode {flavor}: "
              f"{int(diverged.sum())} lanes diverged from the card's table")
        for name_, a_, b_ in zip(paths.PathBuffers._fields, tw["bufs"],
                                 fw["bufs"]):
            check(torch.equal(a_, b_), f"K12 table mode {flavor}: {name_} "
                  "differs from the walk on the card's table")
        for k_ in fw["v0"]:
            check(torch.equal(tw["v0"][k_], fw["v0"][k_]),
                  f"K12 table mode {flavor}: endpoint {k_} differs")
        check(torch.equal(tr, fr), f"K12 table mode {flavor}: rays differ")
        tb_ms[flavor] = (cuda_ms(lambda: lwalk(table), 3),
                         cuda_ms(lambda: lwalk(None), 3))
        say("K12 table", f"{flavor} flavour, chunk 0 ({ch0.c_pix} light "
            f"paths, depth {depth_}): 0 lanes diverged, buffers, endpoint "
            f"and {int(tr.sum())} rays bit-equal to the walk on the card's "
            f"table; table mode {tb_ms[flavor][0]:.3f} ms, the card's table "
            f"{tb_ms[flavor][1]:.3f} ms ({card})")
        # path regeneration in the table mode: the resident grid against
        # one block per SM, bit-equal
        tgrid = walk_grids(scene, pxc0, pyc0, paths.walk_keys(key_l0,
                                                              "light"),
                           f"table mode {flavor}, chunk 0", sms,
                           mode="light", max_depth=depth_, eta_vcm=eta_,
                           key_table=table)
        if flavor == "vcm":
            stats["bdpt_walk_table"].update(lane_stats(tgrid))
            trows = int(tw["rows"].sum())
            tverts = int(tw["bufs"].valid.sum())
            stats["bdpt_walk_table"].update(
                bound=bound_ms(tbytes + ch0.c_pix * 8 + table.numel() * 4
                               + (depth_ - 1) * ch0.c_pix * VERTEX_BYTES
                               + ch0.c_pix * (52 + 4),
                               trows * OPS_PER_ROW
                               + tverts * OPS_PER_WALK_VERTEX
                               + ch0.c_pix * 5 * OPS_PER_DRAW),
                ms=tb_ms[flavor][0])
        # the table mode against its plain version (light_mega.walk_plain:
        # the classic walk with every draw from the same tables)
        pwalk = []
        pw_ms = cuda_ms(lambda: pwalk.append(light_mega.walk_plain(
            scene, key_l0, pxc0, pyc0, depth_, TRANSPORT_IMPORTANCE, eta_,
            ktab, ketab)), 1, warmup=0)
        pb_, pv0_, pr_ = pwalk[0]
        errt = compare_walk((tw["bufs"], tw["v0"], None), (pb_, pv0_, None),
                            f"table mode {flavor}, chunk 0")
        check(abs(int(tr.sum()) - pr_) <= 1e-3 * pr_, f"K12 table mode "
              f"{flavor}: rays {int(tr.sum())} vs plain {pr_}")
        stats["bdpt_walk_table"]["max_abs_err"] = max(
            stats["bdpt_walk_table"].get("max_abs_err", 0.0), errt)
        if flavor == "vcm":
            stats["bdpt_walk_table"]["plain_ms"] = pw_ms
            say("K12 table", f"plain keyed walk {pw_ms:.3f} ms; bound "
                f"{stats['bdpt_walk_table']['bound'][0]:.4f} ms "
                f"({stats['bdpt_walk_table']['bound'][1]})")
        del tw, fw, pwalk, pb_, pv0_

    # --- 34. the attribution of the eye passes (tools/eye_attribution.py):
    # one 1080p sample's classic VCM and SPPM passes and K14's VCM and BDPT
    # flavours timed with each strategy switch off in turn (timed only:
    # each toggle changes the estimator); the threaded row is 34b
    from tools import eye_attribution
    t0 = time.perf_counter()
    eye_attribution.attribution(scene, None, cam, px, py, cfg0,
                                log=lambda m: print(m, flush=True))
    say("attribution", f"done in {time.perf_counter() - t0:.1f} s ({card})")

    del scene, sph, gscene

    # --- 9. the main path through the Renderer: mega (the config's
    # default), then classic
    cfg0 = load_config(os.path.join(ROOT, "configs", "cornell.rendertron"))
    check(cfg0.engine == "mega", "configs/cornell.rendertron is expected to "
          f"select the default mega engine, got {cfg0.engine!r}")
    bunny = [MeshConfig("builtin:cornell_bunny", 1.0, (0.0, 0.0, 0.0), 2)]

    def main_cfg(**over):
        return dataclasses.replace(cfg0, width=WIDTH, height=HEIGHT,
                                   sample_count=SPP, output_dir=OUT_DIR,
                                   meshes=bunny, **over)
    for engine in ("mega", "classic"):
        r, launches = render_path(
            main_cfg(engine=engine, max_depth=DEPTH, name=f"smoke_{engine}"),
            engine, card, {"render_unidirectional": SPP})
        if engine == "mega":
            main_launches = launches
            k1_traversals = r.metrics.rays_traced
        del r

    # --- 15. the BDPT main path through the Renderer: the same config with
    # Integrator BIDIRECTIONAL and Engine classic at its own depths
    r, bdpt_launches = render_path(
        main_cfg(integrator="BIDIRECTIONAL", engine="classic",
                 name="smoke_bdpt"), "bdpt", card,
        {"bdpt_walk": 2 * SPP, "bdpt_splat_bin": SPP,
         "bdpt_splat_trace": SPP, "bdpt_pairs": SPP,
         "bdpt_gather": SPP, "render_unidirectional": 0})
    bcfg = bdpt.BDPTConfig.from_config(r.cfg)

    # one sample's five launches, each between two CUDA events
    key_l, key_e, key_c = bdpt.sample_keys(r.key, SPP)
    rays_t = torch.zeros(r.px.shape[0], dtype=torch.int32, device=dev)
    fb_t = torch.zeros((r.px.shape[0], 3), device=dev)
    stage_ms = {}
    for rep in range(2):   # the first pass warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        lw = kernels.bdpt_walk(r.scene, r.px, r.py,
                               paths.walk_keys(key_l, "light"), mode="light",
                               max_depth=bcfg.light_depth, rays=rays_t)
        ev[1].record()
        kernels.bdpt_splat(r.scene, r.camera, lw["bufs"], lw["v0"], fb_t,
                           rays_t, bcfg)
        ev[2].record()
        ew = kernels.bdpt_walk(r.scene, r.px, r.py,
                               paths.walk_keys(key_e, "eye"), mode="eye",
                               max_depth=bcfg.eye_depth, rays=rays_t,
                               camera=r.camera)
        ev[3].record()
        terms = kernels.bdpt_pairs(r.scene, r.camera, key_c, ew, lw, rays_t,
                                   bcfg, px=r.px, py=r.py)
        ev[4].record()
        kernels.bdpt_gather(r.scene, r.camera, ew, terms, fb_t, bcfg)
        ev[5].record()
        torch.cuda.synchronize()
        stage_ms = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
                    enumerate(("light walk", "splat", "eye walk",
                               "connection pairs", "gather"))}
        del lw, ew, terms
    say("bdpt", "one 1080p sample, CUDA events per launch: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.3f} ms ({card})")
    for k in ("packing_roundtrip",) + BDPT_KERNELS:
        main_launches[k] = bdpt_launches[k]
    main_launches["bdpt_splat"] = bdpt_launches[STAGE_OF["bdpt_splat"]]
    del r

    # --- 18. the photon main paths through the Renderer: Integrator VCM,
    # then SPPM, with Engine classic on the same config (the bunny scene,
    # 1080p, 4 spp, its BDPT depths), then configs/vcm_caustics.rendertron
    # as shipped with Engine classic at 4 spp: 5 launches and a sort per
    # VCM sample, SPPM without the splat
    caustics = load_config(os.path.join(ROOT, "configs",
                                        "vcm_caustics.rendertron"))
    for tag, cfg in (
            ("vcm", main_cfg(integrator="VCM", engine="classic",
                             name="smoke_vcm")),
            ("sppm", main_cfg(integrator="SPPM", engine="classic",
                              name="smoke_sppm")),
            ("caustics", dataclasses.replace(
                caustics, engine="classic", sample_count=SPP,
                name="smoke_caustics", output_dir=OUT_DIR))):
        splat = tag != "sppm"
        r, launches = render_path(
            cfg, tag, card,
            {"bdpt_walk": SPP,
             "vcm_splat_bin": SPP if splat else 0,
             "vcm_splat_trace": SPP if splat else 0,
             "photon_pack": SPP, "photon_sort": SPP, "photon_table": SPP,
             "vcm_eye_walk": SPP, "vcm_eye_connect": SPP if splat else 0,
             "vcm_eye_gather": SPP, "mega_eye_walk": 0,
             "bdpt_splat_trace": 0, "bdpt_pairs": 0,
             "render_unidirectional": 0})
        if tag == "vcm":
            for k in PHOTON_KERNELS:
                main_launches[k] = launches[k]
            for k in ("vcm_splat", "vcm_eye"):
                main_launches[k] = launches[STAGE_OF[k]]
            vr = r
        del r

    # --- 23. the default-engine main paths through the Renderer: the same
    # config with Integrator VCM, SPPM and BIDIRECTIONAL and no Engine line
    # (1080p bunny, 4 spp, two chunks a sample), configs/vcm_caustics.
    # rendertron as shipped (one chunk with pads), then NAIVE_UNIDIRECTIONAL
    # at depth 8 (one launch a sample; its image is sparse: only paths that
    # reach the light by BSDF sampling are lit)
    none = {k: 0 for k in ("bdpt_pairs", "render_unidirectional",
                           "naive", "vcm_splat_bin", "vcm_splat_trace",
                           "bdpt_splat_bin", "bdpt_splat_trace", "photon_pack",
                           "photon_sort", "photon_table", "vcm_eye_walk",
                           "vcm_eye_connect",
                           "vcm_eye_gather", "mega_eye_connect")}
    for tag, cfg, integ, chunks in (
            ("vcm mega", main_cfg(integrator="VCM", name="smoke_vcm_mega"),
             "VCM", 2),
            ("sppm mega", main_cfg(integrator="SPPM", name="smoke_sppm_mega"),
             "SPPM", 2),
            ("bdpt mega", main_cfg(integrator="BIDIRECTIONAL",
                                   name="smoke_bdpt_mega"),
             "BIDIRECTIONAL", 2),
            ("caustics mega", dataclasses.replace(
                caustics, sample_count=SPP, name="smoke_caustics_mega",
                output_dir=OUT_DIR), "VCM", 1)):
        check(cfg.engine == "mega", f"{tag}: expected the default engine")
        want = dict(none, **{k: chunks * SPP for k in MEGA_KERNELS[integ]})
        r, launches = render_path(cfg, tag, card, want)
        if tag == "vcm mega":
            # rgb9e5 and neighbor_slots are test entries: their device code
            # runs inside K14's gather (and K5's mega schedule), so they
            # launch 0
            for k in ("mega_eye_walk", "mega_eye_connect",
                      "mega_eye_gather", "rgb9e5", "neighbor_slots"):
                main_launches[k] = launches[k]
            main_launches["mega_eye"] = launches[STAGE_OF["mega_eye"]]
            vmr = r
        elif tag == "bdpt mega":
            bmr = r
        del r
    r, launches = render_path(
        main_cfg(integrator="NAIVE_UNIDIRECTIONAL", max_depth=DEPTH,
                 name="smoke_naive"), "naive", card,
        dict(none, naive=SPP, mega_eye_walk=0, bdpt_walk=0),
        min_lit=0.05)
    main_launches["naive"] = launches["naive"]
    del r

    # --- 24. one 1080p VCM-mega and one BDPT-mega sample's launches per
    # chunk, each between two CUDA events
    vc = vcm.VCMConfig.from_config(vmr.cfg)
    ch = vcm_mega.mega_chunks(vmr.px.shape[0])
    key_l, key_e = vcm.sample_keys(vmr.key, SPP)
    lkeys, ekeys = paths.walk_keys(key_l, "light"), vcm_mega.eye_keys(key_e)
    salt = hashgrid.photon_salt(SPP)
    sw = hashgrid.merge_switches(vc.max_per_cell)
    names = ("light walk", "vcm_splat", "photon_pack", "photon_sort",
             "photon_table", "mega_eye walk", "mega_eye connect",
             "mega_eye gather")
    stage_ms = {}
    for rep in range(2):   # the first pass warms up
        stage_ms = {k: 0.0 for k in names}
        out_t = torch.zeros((vmr.px.shape[0], 3), device=dev)
        fb_t = torch.zeros_like(out_t)
        for ci in range(ch.n_chunks):
            pxc, pyc, cnt = vcm_mega.chunk_pixels_of(vmr.px, vmr.py, ci,
                                                     ch.c_pix)
            mr, eta, norm = vcm_mega.chunk_scalars(vmr.scene, vc, SPP, cnt)
            rays_t = torch.zeros(ch.c_pix, dtype=torch.int32, device=dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
            ev[0].record()
            lw = kernels.bdpt_walk(vmr.scene, pxc, pyc, lkeys, mode="light",
                                   max_depth=vc.light_depth + 1, rays=rays_t,
                                   eta_vcm=eta)
            lb = vcm_mega.mask_pads(lw["bufs"], cnt)
            ev[1].record()
            kernels.vcm_splat(vmr.scene, vmr.camera, lb, fb_t, rays_t, vc,
                              eta)
            ev[2].record()
            tsize = hashgrid.photon_table_size(vc.light_depth * ch.c_pix)
            rows, h, cse = kernels.photon_pack(
                lb, vmr.scene.scene_min, 2.0 * mr, tsize)
            ev[3].record()
            order, hs = kernels.photon_sort(
                h, hashgrid.key_bits(tsize, hashgrid.REWEIGHT), salt)
            ev[4].record()
            srows = kernels.photon_table(rows, hs, order, cse)
            ev[5].record()
            ep = kernels.mega_eye_pass(
                vmr.scene, vmr.camera, ekeys, lb, hashgrid.PhotonGrid(
                    srows, cse, vmr.scene.scene_min, 2.0 * mr, tsize),
                out_t, rays_t, vc, px=pxc, py=pyc, cnt=cnt,
                gbase=ci * ch.c_pix, flavor="vcm", merge_radius=mr,
                eta_vcm=eta, merge_norm=norm, **sw)
            for i, stage in enumerate(EYE_STAGES):
                getattr(kernels, f"eye_{stage}")(ep)
                ev[6 + i].record()
            torch.cuda.synchronize()
            for i, k in enumerate(names):
                stage_ms[k] += ev[i].elapsed_time(ev[i + 1])
            del lw, lb, rows, h, cse, order, hs, srows, ep
    say("vcm mega", f"one 1080p sample ({ch.n_chunks} chunks), CUDA events "
        "per launch summed over the chunks: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.3f} ms ({card})")
    del vmr
    bc = bdpt.BDPTConfig.from_config(bmr.cfg)
    key_l, key_e = vcm.sample_keys(bmr.key, SPP)
    lkeys, ekeys = paths.walk_keys(key_l, "light"), vcm_mega.eye_keys(key_e)
    names = ("light walk", "bdpt_splat", "mega_eye walk", "mega_eye connect",
             "mega_eye gather")
    for rep in range(2):   # the first pass warms up
        stage_ms = {k: 0.0 for k in names}
        out_t = torch.zeros((bmr.px.shape[0], 3), device=dev)
        fb_t = torch.zeros_like(out_t)
        for ci in range(ch.n_chunks):
            pxc, pyc, cnt = vcm_mega.chunk_pixels_of(bmr.px, bmr.py, ci,
                                                     ch.c_pix)
            rays_t = torch.zeros(ch.c_pix, dtype=torch.int32, device=dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            lw = kernels.bdpt_walk(bmr.scene, pxc, pyc, lkeys, mode="light",
                                   max_depth=bc.light_depth, rays=rays_t)
            lb = vcm_mega.mask_pads(lw["bufs"], cnt)
            ev[1].record()
            kernels.bdpt_splat(bmr.scene, bmr.camera, lb, lw["v0"], fb_t,
                               rays_t, bc, n_live=cnt)
            ev[2].record()
            ep = kernels.mega_eye_pass(
                bmr.scene, bmr.camera, ekeys, lb, None, out_t, rays_t,
                bdpt_mega.as_machine_cfg(bc), px=pxc, py=pyc, cnt=cnt,
                gbase=ci * ch.c_pix, flavor="bdpt")
            for i, stage in enumerate(EYE_STAGES):
                getattr(kernels, f"eye_{stage}")(ep)
                ev[3 + i].record()
            torch.cuda.synchronize()
            for i, k in enumerate(names):
                stage_ms[k] += ev[i].elapsed_time(ev[i + 1])
            del lw, lb, ep
    say("bdpt mega", f"one 1080p sample ({ch.n_chunks} chunks), CUDA events "
        "per launch summed over the chunks: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.3f} ms ({card})")
    del bmr

    # --- 19. one VCM sample's launches, each between two CUDA events
    vc = vcm.VCMConfig.from_config(vr.cfg)
    n = vr.px.shape[0]
    key_l, key_e = vcm.sample_keys(vr.key, SPP)
    mr, eta, norm = vcm.sample_scalars(vr.scene, vc, SPP, n)
    salt = hashgrid.photon_salt(SPP)
    stage_ms = {}
    for rep in range(2):   # the first pass warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
        rays_t = torch.zeros(n, dtype=torch.int32, device=dev)
        fb_t = torch.zeros((n, 3), device=dev)
        ev[0].record()
        lw = kernels.bdpt_walk(vr.scene, vr.px, vr.py,
                               paths.walk_keys(key_l, "light"), mode="light",
                               max_depth=vc.light_depth + 1, rays=rays_t,
                               eta_vcm=eta)
        ev[1].record()
        kernels.vcm_splat(vr.scene, vr.camera, lw["bufs"], fb_t, rays_t, vc,
                          eta)
        ev[2].record()
        tsize = hashgrid.photon_table_size(vc.light_depth * n)
        rows, h, cse = kernels.photon_pack(
            lw["bufs"], vr.scene.scene_min, 2.0 * mr, tsize)
        ev[3].record()
        order, hs = kernels.photon_sort(
            h, hashgrid.key_bits(tsize, hashgrid.REWEIGHT), salt)
        ev[4].record()
        srows = kernels.photon_table(rows, hs, order, cse)
        ev[5].record()
        ep = kernels.vcm_eye_pass(
            vr.scene, vr.camera, paths.walk_keys(key_e, "eye"), lw["bufs"],
            hashgrid.PhotonGrid(srows, cse, vr.scene.scene_min, 2.0 * mr,
                                tsize),
            fb_t, rays_t, vc, px=vr.px, py=vr.py, merge_radius=mr,
            eta_vcm=eta, merge_norm=norm,
            **hashgrid.merge_switches(vc.max_per_cell))
        for i, stage in enumerate(EYE_STAGES):
            getattr(kernels, f"eye_{stage}")(ep)
            ev[6 + i].record()
        torch.cuda.synchronize()
        stage_ms = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
                    enumerate(("light walk", "vcm_splat", "photon_pack",
                               "photon_sort", "photon_table", "vcm_eye walk",
                               "vcm_eye connect", "vcm_eye gather"))}
        del lw, rows, h, cse, order, hs, srows, ep
    say("vcm", "one 1080p sample, CUDA events per launch: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.3f} ms ({card})")
    del vr

    # --- 27. the batched main path: configs/vcm_caustics.rendertron as
    # shipped (512x512, VCM with the mega engine, 256 samples, 8 per
    # dispatch by the auto rule) through cli.main with the checks on
    from cudapathtracer_tpu_torch import cli
    from cudapathtracer_tpu_torch.driver import (Renderer,
                                                 resolve_samples_per_dispatch)
    from cudapathtracer_tpu_torch.utils import checks, debugviz
    from cudapathtracer_tpu_torch.utils.metrics import RenderMetrics
    caustics_path = os.path.join(ROOT, "configs", "vcm_caustics.rendertron")
    spd_c = resolve_samples_per_dispatch(caustics, "cuda")
    check(spd_c == 8, f"caustics: auto samples per dispatch {spd_c}, "
          "expected 8")
    cli_dir = os.path.join(OUT_DIR, "cli")
    os.makedirs(cli_dir, exist_ok=True)
    # the checks run at the progressive saves, every Save Interval Seconds
    # (5 s by default), and the shipped render can take less than that:
    # the shipped config with a 1 s cadence, so that the checks run
    cli_cfg = os.path.join(cli_dir, "vcm_caustics.rendertron")
    with open(caustics_path) as f, open(cli_cfg, "w") as g:
        g.write("Save Interval Seconds: 1\n" + f.read())
    cwd = os.getcwd()
    buf = io.StringIO()
    # the switch under its JAX name, read when utils/checks.py loads
    os.environ["CUDAPATHTRACER_TPU_CHECKS"] = "1"
    importlib.reload(checks)
    kernels.reset_launches()
    os.chdir(cli_dir)   # the CLI writes renders/ under the working dir
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main([cli_cfg, "--device", "cuda"])
    finally:
        os.chdir(cwd)
        del os.environ["CUDAPATHTRACER_TPU_CHECKS"]
        importlib.reload(checks)
        # keep the BMPs only: the CSVs would crowd out the other outputs
        for root, _, files in os.walk(cli_dir):
            for f in files:
                if f.endswith(".csv"):
                    os.remove(os.path.join(root, f))
    cli_out = buf.getvalue()
    for line in cli_out.splitlines():
        say("caustics cli", line.strip())
    check(rc == 0, f"caustics cli: exit code {rc}")
    cl = dict(kernels.launches)
    phase_s = float(re.search(r"render: ([0-9.]+)s", cli_out).group(1))
    rays_c = int(re.search(r"rays traced: ([0-9,]+)", cli_out).group(1)
                 .replace(",", ""))
    check(cl["mega_eye_walk"] == caustics.sample_count and cl["bdpt_walk"]
          == caustics.sample_count, f"caustics cli: launches {cl}, "
          f"expected {caustics.sample_count} of K14 and K12 (one chunk)")
    check("render executed with no numerical errors" in cli_out,
          "caustics cli: the checks summary reports errors or no stage")
    say("caustics cli", f"{caustics.sample_count} samples at {spd_c} per "
        f"dispatch: {rays_c} rays in a {phase_s:.3f} s render phase = "
        f"{rays_c / phase_s / 1e6:.3f} Mrays/s ({card}); K14 launches "
        f"{cl['mega_eye_walk']} (256 samples x 1 chunk)")

    # the same config at 16 samples, 1 per dispatch against the auto 8:
    # rays and dropped photons equal, pixels within the VCM splat's atomic
    # spread and float association (|a - b| <= 1e-5 + 1e-5 |b|)
    res16 = {}
    for spd in (1, 0):
        r = Renderer(dataclasses.replace(
            caustics, sample_count=16, samples_per_dispatch=spd,
            output_dir=OUT_DIR, name=f"smoke_caustics16_spd{spd}"),
            device="cuda")
        r.render(progressive=False, verbose=False)
        res16[spd] = (r.accum.clone(), r.metrics.rays_traced,
                      r.metrics.merge_dropped, r.metrics.render_seconds)
        del r
    (a1, ra1, d1, t1), (a8, ra8, d8, t8) = res16[1], res16[0]
    diff = (a1 - a8).abs()
    over = int((diff > 1e-5 + 1e-5 * a8.abs()).sum())
    wrapped = (d8 + 2 ** 31) % 2 ** 32 - 2 ** 31
    say("caustics 16", f"spd 1: {ra1} rays, {d1} dropped, {t1:.3f} s "
        f"({ra1 / t1 / 1e6:.3f} Mrays/s); spd 8: {ra8} rays, {d8} dropped, "
        f"{t8:.3f} s ({ra8 / t8 / 1e6:.3f} Mrays/s) ({card}); max |diff| "
        f"{diff.max().item():.3g}, bit-equal share "
        f"{(diff == 0).float().mean().item():.6f}, {over} channels over the "
        f"bound; dropped total {'above' if d8 >= 2 ** 31 else 'below'} 2^31 "
        f"(an int32 sum would read {wrapped})")
    check(ra1 == ra8 and d1 == d8, "caustics 16: rays or dropped photons "
          "differ between 1 and 8 samples per dispatch")
    check(over == 0, f"caustics 16: {over} channels differ beyond the bound")
    del res16, a1, a8, diff

    # VCM-mega at 1080p (the bunny scene), 2 samples, 1 against 2 per
    # dispatch: one batch through make_batched whose int64 dropped total on
    # the card is above 2^31, equal to the unbatched total
    res2 = {}
    for spd in (1, 2):
        r = Renderer(dataclasses.replace(
            main_cfg(integrator="VCM", samples_per_dispatch=spd,
                     name=f"smoke_vcm_1080_spd{spd}"), sample_count=2),
            device="cuda")
        kernels.reset_launches()
        r.render(progressive=False, verbose=False)
        res2[spd] = (r.accum.clone(), r.metrics.rays_traced,
                     r.metrics.merge_dropped, r.metrics.render_seconds)
        check(kernels.launches["mega_eye_walk"] == 4,
              f"vcm 1080 spd {spd}: "
              f"launches {kernels.launches}, expected 2 samples x 2 chunks "
              "of K14")
        del r
    (a1, ra1, d1, t1), (a2, ra2, d2, t2) = res2[1], res2[2]
    diff = (a1 - a2).abs()
    over = int((diff > 1e-5 + 1e-5 * a2.abs()).sum())
    say("vcm 1080 batch", f"2 samples, spd 1: {ra1} rays, {d1} dropped, "
        f"{t1:.3f} s; spd 2: {ra2} rays, {d2} dropped, {t2:.3f} s ({card}); "
        f"max |diff| {diff.max().item():.3g}, {over} channels over the "
        f"bound; an int32 sum would read {(d2 + 2 ** 31) % 2 ** 32 - 2 ** 31}")
    check(ra1 == ra2 and d1 == d2, "vcm 1080: rays or dropped photons "
          "differ between 1 and 2 samples per dispatch")
    check(d2 >= 2 ** 31, f"vcm 1080: the batched dropped total {d2} is not "
          "above 2^31")
    check(over == 0, f"vcm 1080: {over} channels differ beyond the bound")
    del res2, a1, a2, diff

    # UNIDIRECTIONAL (mega) and NAIVE at 256x256 on cornell_blocks, 256
    # samples, 1 per dispatch against the auto 8: one K5 launch a sample
    # against one K5 launch of 8 samples a batch
    blocks = [MeshConfig("builtin:cornell_blocks", 1.0, (0.0, 0.0, 0.0), 2)]
    for integ, single, lit in (("UNIDIRECTIONAL", "render_unidirectional",
                                0.9), ("NAIVE_UNIDIRECTIONAL", "naive",
                                       0.05)):
        accs = {}
        for spd in (1, 0):
            tag = f"{integ[:5].lower()} 256 spd{spd or 'auto'}"
            want = {single: 256 if spd == 1 else 32}
            r, launches = render_path(dataclasses.replace(
                cfg0, integrator=integ, width=256, height=256,
                sample_count=256, max_depth=DEPTH, meshes=blocks,
                samples_per_dispatch=spd, output_dir=OUT_DIR,
                name=f"smoke_{integ[:5].lower()}_256_spd{spd}"), tag, card,
                want, min_lit=lit)
            accs[spd] = (r.accum.clone(), r.metrics.rays_traced)
            if integ == "UNIDIRECTIONAL" and spd == 0:
                b1_batch(r, stats, card)
            del r
        close = torch.isclose(accs[1][0], accs[0][0], rtol=1e-4, atol=1e-5)
        say(integ, f"256x256, 256 samples: rays {accs[1][1]} (spd 1) and "
            f"{accs[0][1]} (spd 8); accumulations within rtol 1e-4 on "
            f"{close.float().mean().item():.6f} of the channels")
        check(accs[1][1] == accs[0][1] and bool(close.all()),
              f"{integ} 256: spd 1 and 8 disagree")
        del accs

    # no host sync inside a batch: one batch of 2 samples of every
    # integrator and engine under torch.cuda's sync debug mode "error"
    for integ, engine, keyed in (
            ("UNIDIRECTIONAL", "mega", False),
            ("UNIDIRECTIONAL", "classic", False),
            ("NAIVE_UNIDIRECTIONAL", "mega", False),
            ("BIDIRECTIONAL", "classic", False), ("VCM", "classic", False),
            ("SPPM", "classic", False), ("BIDIRECTIONAL", "mega", False),
            ("VCM", "mega", False), ("SPPM", "mega", False),
            ("BIDIRECTIONAL", "mega", True), ("VCM", "mega", True)):
        r = Renderer(dataclasses.replace(
            cfg0, integrator=integ, engine=engine, width=64, height=64,
            max_depth=DEPTH, meshes=blocks, output_dir=OUT_DIR),
            device="cuda")
        if keyed:
            os.environ["TPT_MEGA_LIGHT"] = "1"
        try:
            r.render_batch(0, 2)   # warm-up
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = r.render_batch(2, 2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        except RuntimeError as e:
            raise SmokeFailure(f"{integ} {engine}: a host sync inside a "
                               f"batch: {e}") from e
        finally:
            os.environ.pop("TPT_MEGA_LIGHT", None)
        check(all(c.dtype == torch.int64 and c.dim() == 0
                  and c.device.type == "cuda" for c in out[1:]),
              f"{integ} {engine}: counts not int64 on the card")
        del r, out
    say("batch", "no host sync inside a batch of 2 samples, and int64 counts "
        "on the card, for every integrator and engine (and "
        "TPT_MEGA_LIGHT=1 for BDPT-mega and VCM-mega)")

    # --- 28. TPT_MEGA_LIGHT=1: BDPT-mega and VCM-mega at 1080p, 1 sample,
    # against the toggle-off render of the same Renderer. The keyed walk's
    # buffers are bit-equal to the classic walk's and the eye pass is
    # deterministic, so the images differ only through the splat's
    # atomicAdd order (BDPT's vertex 0 is the endpoint the same table-mode
    # launch writes): rays equal, pixels within 1e-6 + 1e-5 |x|. A second
    # toggle-off render prints the spread that atomicAdd's order alone gives
    keyed_r = {}
    for integ in ("BIDIRECTIONAL", "VCM"):
        r = Renderer(dataclasses.replace(
            main_cfg(integrator=integ, name=f"smoke_{integ.lower()}_keyed"),
            sample_count=1), device="cuda")
        os.environ.pop("TPT_MEGA_LIGHT", None)
        offs = []
        for _ in range(2):
            r.accum.zero_()
            r.sample_count, r.metrics = 0, RenderMetrics()
            r.render(progressive=False, verbose=False)
            offs.append(r.accum.clone())
        off, off_rays = offs[1], r.metrics.rays_traced
        off_drop, off_s = r.metrics.merge_dropped, r.metrics.render_seconds
        d_off = (offs[0] - off).abs()
        say(f"keyed {integ}", "two toggle-off renders (atomicAdd's order "
            f"alone): max |diff| {d_off.max().item():.3g}, bit-equal share "
            f"{(d_off == 0).float().mean().item():.6f}")
        del offs, d_off
        r.accum.zero_()
        r.sample_count, r.metrics = 0, RenderMetrics()
        os.environ["TPT_MEGA_LIGHT"] = "1"
        kernels.reset_launches()
        light_mega.calls["light_walk_mega"] = 0
        try:
            r.render(progressive=False, verbose=False)
        finally:
            os.environ.pop("TPT_MEGA_LIGHT", None)
        lk = dict(kernels.launches)
        rays_k, phase_k = r.metrics.rays_traced, r.metrics.render_seconds
        diff = (r.accum - off).abs()
        within = bool((diff <= 1e-6 + 1e-5 * off.abs()).all())
        say(f"keyed {integ}", f"1080p, 1 sample: {rays_k} rays in "
            f"{phase_k:.3f} s = {rays_k / phase_k / 1e6:.3f} Mrays/s "
            f"({card}); K12 table-mode launches {lk['bdpt_walk_table']}, "
            f"folded {lk['bdpt_walk']}; against the toggle-off render "
            f"({off_rays / off_s / 1e6:.3f} Mrays/s): rays "
            f"{off_rays}, max |diff| {diff.max().item():.3g}, bit-equal "
            f"share {(diff == 0).float().mean().item():.6f}")
        check(light_mega.calls["light_walk_mega"] == 2
              and lk["bdpt_walk_table"] == 2 and lk["bdpt_walk"] == 0,
              f"keyed {integ}: not routed through light_mega ({lk})")
        check(rays_k == off_rays and within
              and r.metrics.merge_dropped == off_drop, f"keyed {integ}: "
              "differs from the toggle-off render beyond the splat's spread")
        if integ == "VCM":
            # one 1080p VCM-mega sample drops more merge candidates than an
            # int32 holds: the int64 totals on the card stay exact
            d_ = r.metrics.merge_dropped
            say(f"keyed {integ}", f"merge-cap dropped photons {d_} with the "
                f"keyed walk and {off_drop} without (an int32 sum would "
                f"read {(d_ + 2 ** 31) % 2 ** 32 - 2 ** 31})")
            check(d_ >= 2 ** 31, "keyed VCM: expected a dropped total above "
                  "2^31 at 1080p")
        check(bool(torch.isfinite(r.accum).all()), f"keyed {integ}: "
              "non-finite pixels")
        if integ == "VCM":
            main_launches["bdpt_walk_table"] = lk["bdpt_walk_table"]
        keyed_r[integ] = r
        del off, diff
    del keyed_r["VCM"]

    # --- 29. BDPT_DRAWPATH on the 1080p BIDIRECTIONAL render: the overlay
    # from K12's eye walk equals the overlay drawn from the plain walk's
    # paths, and the image differs from the overlay-free one only under it
    r = keyed_r.pop("BIDIRECTIONAL")
    r.cfg = dataclasses.replace(r.cfg, bdpt_draw_path=True)
    kernels.reset_launches()
    fb_on = r.framebuffer()
    check(kernels.launches["bdpt_walk"] == 1, "drawpath: the overlay's eye "
          f"walk is not one K12 launch ({kernels.launches})")
    key0, depth0 = rng.sample_key(r.key, 0), max(r.cfg.bdpt_eye_depth, 2)
    sel = debugviz.overlay_eye_paths(r.scene, r.camera, key0, r.px, r.py,
                                     depth0)[0]
    idx = torch.as_tensor(sel, device=dev)
    pb, pv0, _, _ = paths.generate_eye_path(r.scene, r.camera, key0,
                                            r.px[idx], r.py[idx], depth0)
    ov_plain = debugviz.path_overlay(r.camera, sel, pb.pt.cpu().numpy(),
                                     pb.valid.cpu().numpy(),
                                     pv0["pt"].cpu().numpy())
    check(np.array_equal(r._overlay, ov_plain), "drawpath: the overlay "
          "from K12's eye walk differs from the plain walk's")
    r.cfg = dataclasses.replace(r.cfg, bdpt_draw_path=False)
    fb_off = r.framebuffer()
    changed = (fb_on != fb_off).any(-1)
    under = (r._overlay != 0).any(-1)
    say("drawpath", f"1080p BIDIRECTIONAL: {len(sel)} eye paths drawn, "
        f"{int(under.sum())} overlay pixels, {int(changed.sum())} image "
        "pixels changed, none outside the overlay; K12's overlay equals the "
        "plain walk's")
    check(changed.any() and not changed[~under].any(), "drawpath: the "
          "image changed outside the overlay, or not at all")
    del r, fb_on, fb_off, keyed_r

    # --- 30-33. the threaded binary engine (K15)
    tl = threaded_phases(card, stats, cam, px, py, ids, cfg0)
    # --- 35. tile x spp sharding and K8's rows mode
    main_launches["photon_bucket"] = sharded_phases(card, stats, px, py,
                                                    cfg0)
    # K15's entries launch 0 times on the threaded path, as K1's do on the
    # mega path: their device code runs inside K5's threaded instantiation,
    # whose launches the line gives beside them
    inside = {}
    for k in ("closest_hit_bin", "shadow_factor_bin"):
        main_launches[k] = tl[k]
        inside[k] = {"render_unidirectional": tl["threaded_engine"]}
    # K1's entries launch 0 times on the mega path: its device code traces
    # every ray of K5's launches there
    for k in ("closest_hit8", "shadow_factor8"):
        inside[k] = {"render_unidirectional":
                     main_launches["render_unidirectional"]}
        stats[k]["traversals_on_main_path"] = k1_traversals

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound"][0],
         "bound_by": stats[name]["bound"][1],
         "library_ms": stats[name].get("library_ms"),
         **{key: stats[name][key] for key in stats[name]
            if key.startswith("library_ms_")
            or key in ("ptxas", "traversals_on_main_path", "ms_aperture_0",
                       "bound_ms_aperture_0", "ms_thin_lens",
                       "sass_per_cipher", "call_ms")},
         **({"launches_of_the_kernel_it_runs_in": inside[name]}
            if name in inside else {}),
         **{key: stats[name][key] for key in ("lane_use", "event_balance")
            if key in stats[name]}}
        for name, src, rep in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
