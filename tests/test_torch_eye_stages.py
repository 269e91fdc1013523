"""The VCM eye passes' three stages on the CPU: the plain twins of
kernels/csrc/eye_walk.cu, eye_connect.cu and eye_gather.cu (models/vcm.py
and models/vcm_mega.py: eye_walk_plain, eye_connect_plain,
eye_gather_plain), whose composition is each pass's eye_pass_plain.

  * The record and pair layouts: EyeRecords' fields in eye.cuh's order
    (the struct, the launch's pointer slots, the flag bits); the walk's
    records [D, N] depth-major (a permuted pixel list permutes the lanes,
    bit for bit), each path's flags a run of live records closed by one
    END, escapes last, SPPM ending at its first non-delta hit; the
    connections [D, L, N, 3], pair (t, j, i) at (t L + j) N + i, zero
    where the eye record ran no strategy.
  * The connections' queue (eye_connect_queue_plain, the twin of
    eye_connect.cu's queue kernel) in each flavour: each gated pair once
    (its eye record ran its strategies, its light vertex valid and not
    delta), in (t, j, i) order; the connections computed slot by slot
    from the queue equal eye_connect_plain bit for bit; invalid light
    buffers give an empty queue and zero rows.
  * The ordered gather: hand-built terms (1e8, 1, -1e8, ...) whose
    float32 sum depends on the order equal a sequential float32 sum in the
    flavour's JAX order (classic: the sky, s=0, NEE, the connections;
    mega the same before RGB9E5), and differ from another order.
  * The staged plain pass against the JAX package's sample on the golden
    setup (cornell_with_blocks, 12x12, eye depth 3, light depth 2,
    sample 1) under two switch sets no other test covers: the connections
    off with the environment on (no connection stage; the sky slot), and
    the merge and NEE off (no fold in the gather). Tolerances of
    tests/test_torch_vcm.py: rays within 0.1%, image mean within 1e-3,
    >= 98% of the elements within rtol 1e-3.

On the card (marker cuda): the walk kernel's persistent lanes on one
block and on its resident grid give bit-equal records, terms, rays and
rows, and the plain walk's rays and records.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import vcm as jvcm
from cudapathtracer_tpu.scene import builtin as jbuiltin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import paths, vcm, vcm_mega
from cudapathtracer_tpu_torch.models.bdpt import _vertex
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import packing, rng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = H = 16
CFG = vcm.VCMConfig(eye_depth=4, light_depth=3)
SPPM = dict(light_trace=False, nee=False, naive=False, connection=False,
            do_mis=False, do_sppm=True)
EYE_CUH = os.path.join(os.path.dirname(kernels.__file__), "csrc", "eye.cuh")


@pytest.fixture(scope="module")
def setup():
    sc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    cam = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    key_l, key_e = vcm.sample_keys(rng.base_key(), 1)
    _, eta, _ = vcm.sample_scalars(sc, CFG, 1, px.shape[0])
    lbufs, _, _ = paths.generate_light_path(sc, key_l, px, py,
                                            CFG.light_depth + 1, eta_vcm=eta)
    rec, _ = vcm.eye_walk_plain(sc, cam, key_e, CFG, px, py, eta)
    return dict(sc=sc, cam=cam, px=px, py=py, key_e=key_e, eta=eta,
                lbufs=lbufs, rec=rec)


# --- the layouts --------------------------------------------------------------

def test_record_layout_is_eye_cuh():
    """EyeRecords' fields are eye.cuh's EyeRecs members and launch slots
    26-38 in order (the wrapper passes the tuple's tensors in field
    order), and the flag bits are its kRec* constants."""
    src = open(EYE_CUH).read()
    body = re.search(r"struct EyeRecs \{(.*?)\};", src, re.S).group(1)
    members = re.findall(r"(?:float|int32_t)\* (\w+);", body)
    assert tuple(members) == vcm.EyeRecords._fields
    slots = dict((int(k), f) for f, k in re.findall(
        r"r\.(\w+) = dev_ptr<\w+>\(ptrs, (\d+)\);", src))
    assert tuple(slots[k] for k in range(26, 39)) == vcm.EyeRecords._fields
    bits = {k: int(v) for k, v in re.findall(
        r"constexpr int32_t kRec(\w+) = (\d+);", src)}
    assert bits == dict(Valid=vcm.REC_VALID, NonDelta=vcm.REC_NON_DELTA,
                        Escaped=vcm.REC_ESCAPED, End=vcm.REC_END)


def _check_flags(flags):
    """Each path: live records (flags != 0) at depths 0..k-1, END on the
    k-th exactly and on no other, an escape only last."""
    d, n = flags.shape
    live = flags != 0
    k = live.int().sum(0)
    assert bool((live == (torch.arange(d)[:, None] < k[None])).all())
    end = (flags & vcm.REC_END) != 0
    assert bool((end.int().sum(0) == (k > 0).int()).all())
    last = torch.clamp(k - 1, min=0)
    assert bool(end[last, torch.arange(n)][k > 0].all())
    esc = (flags & vcm.REC_ESCAPED) != 0
    assert bool((~esc | end).all())
    return live, esc


def test_walk_records_layout(setup):
    rec = setup["rec"]
    d, n = CFG.eye_depth, W * H
    for f, t in zip(rec._fields, rec):
        tail = (3,) if f in ("pos", "n", "to_prev", "thr", "albedo",
                             "implicit", "nee") else ()
        assert tuple(t.shape) == (d, n) + tail, f
        assert t.dtype == (torch.int32 if f in ("mat_id", "flags")
                           else torch.float32), f
    live, esc = _check_flags(rec.flags)
    assert int(live[0].sum()) == n                  # every path starts
    hit = live & ~esc
    conn = (rec.flags & vcm.REC_CONN) == vcm.REC_CONN
    assert bool(conn.any()) and bool(esc.any())
    assert bool((conn <= hit).all())
    # a hit holds its vertex; dead and escaped records hold zeros
    assert bool(torch.isfinite(rec.pos[hit]).all())
    assert bool((rec.n[hit].norm(dim=-1) - 1.0).abs().max() < 1e-4)
    for f in ("pos", "thr", "nee", "d_vcm"):
        assert bool((getattr(rec, f)[~hit] == 0).all()), f
    # the strategies' terms only where they ran; the sky slot is empty
    # without sample_environment
    assert bool((rec.nee[~conn] == 0).all())
    assert bool((rec.implicit[esc] == 0).all())
    assert bool((rec.nee[conn] != 0).any())


def test_walk_is_depth_major_per_lane(setup):
    """The classic walk draws by pixel id: a reversed pixel list gives the
    records of the reversed lanes, bit for bit."""
    px, py = setup["px"].flip(0), setup["py"].flip(0)
    rec, _ = vcm.eye_walk_plain(setup["sc"], setup["cam"], setup["key_e"],
                                CFG, px, py, setup["eta"])
    for f, a, b in zip(rec._fields, rec, setup["rec"]):
        assert torch.equal(a.view(torch.int32),
                           b.flip(1).view(torch.int32)), f


def test_sppm_walk_ends_at_first_non_delta(setup):
    cfg = dataclasses.replace(CFG, **SPPM)
    rec, _ = vcm.eye_walk_plain(setup["sc"], setup["cam"], setup["key_e"],
                                cfg, setup["px"], setup["py"], setup["eta"])
    live, esc = _check_flags(rec.flags)
    k = live.int().sum(0)
    last = rec.flags[torch.clamp(k - 1, min=0), torch.arange(k.shape[0])]
    nondelta = (last & vcm.REC_NON_DELTA) != 0
    # the walk ends at a non-delta hit, an escape or an invalid sample
    assert bool((nondelta | ((last & vcm.REC_ESCAPED) != 0)
                 | ((last & vcm.REC_VALID) == 0) | (k == cfg.eye_depth))
                .all())
    before = live & ((torch.arange(cfg.eye_depth)[:, None]
                      < (k - 1)[None]))
    assert bool(((rec.flags[before] & vcm.REC_NON_DELTA) == 0).all())
    assert bool((rec.nee == 0).all()) and bool((rec.implicit == 0).all())


def test_pair_layout(setup):
    sc, rec, lb = setup["sc"], setup["rec"], setup["lbufs"]
    conn, rays = vcm.eye_connect_plain(sc, rec, lb, CFG, setup["eta"])
    d, n, lrows = CFG.eye_depth, W * H, CFG.light_depth
    assert tuple(conn.shape) == (d, lrows, n, 3) and conn.is_contiguous()
    assert rays > 0
    live = (rec.flags & vcm.REC_CONN) == vcm.REC_CONN
    assert bool((conn[~live[:, None, :].expand(-1, lrows, -1)] == 0).all())
    flat = conn.reshape(-1, 3)
    ones = torch.ones(n)
    for t, j in ((0, 0), (1, 2), (2, 1)):
        want, _ = vcm._connect_vcm(sc, rec.eye(sc, t), _vertex(lb, j),
                                   live[t], ones, CFG, setup["eta"])
        assert torch.equal(conn[t, j], want)
        i = torch.arange(n)
        assert torch.equal(flat[(t * lrows + j) * n + i], want)
    assert bool((conn != 0).any())


# --- the connections' queue ---------------------------------------------------

FLAVORS = ("classic", "vcm", "bdpt")
MEGA_N = 200   # the mega flavours' paths: lanes 0..199 of the 256 light lanes


def _flavor_inputs(setup, flavor):
    """(records, light buffers, paths, eta_vcm) of a flavour's pass on the
    golden setup, with delta vertices marked on both sides (the scene has
    no delta surface): every fourth lane's light vertices and every fifth
    path's depth-1 record. The classic pass runs over every lane; the mega
    ones over the first MEGA_N paths against the full light buffers, as a
    chunk's pass."""
    rec, lb = setup["rec"], setup["lbufs"]
    lanes = torch.arange(lb.flags.shape[1])
    lb = lb._replace(flags=torch.where((lanes % 4 == 1)[None],
                                       lb.flags | -2 ** 31, lb.flags))
    flags = rec.flags.clone()
    flags[1, lanes % 5 == 2] &= ~vcm.REC_NON_DELTA
    rec = rec._replace(flags=flags)
    if flavor == "classic":
        return rec, lb, W * H, setup["eta"]
    rec = vcm.EyeRecords(*(f[:, :MEGA_N] for f in rec))
    return rec, lb, MEGA_N, setup["eta"] if flavor == "vcm" else 0.0


def _connect_plain(setup, flavor, rec, lb, eta):
    if flavor == "classic":
        return vcm.eye_connect_plain(setup["sc"], rec, lb, CFG, eta)
    return vcm_mega.eye_connect_plain(setup["sc"], rec, lb, CFG,
                                      flavor=flavor, eta_vcm=eta)


def _connect_from_queue(setup, flavor, rec, lb, n, eta, queue):
    """The connections computed slot by slot from a queue, as the trace
    kernel runs it: each queued pair's eye record and light vertex gathered
    into one flat batch of lanes, the flavour's connection of each lane,
    scattered into a zero conn [D, L, n, 3] at its slot -> (conn, rays)."""
    sc = setup["sc"]
    depth, lrows = rec.flags.shape[0], lb.pt.shape[0]
    tj, i = queue // n, queue % n
    t, j = tj // lrows, tj % lrows
    eye = vcm.EyeRecords(*(f[t, i][None] for f in rec)).eye(sc, 0)
    lv = _vertex(paths.PathBuffers(*(f[j, i][None] for f in lb)), 0)
    q = queue.shape[0]
    every, ones = torch.ones(q, dtype=torch.bool), torch.ones(q)
    if flavor == "classic":
        out, rays = vcm._connect_vcm(sc, eye, lv, every, ones, CFG, eta)
    else:
        eye["n"] = vcm_mega._toward_prev(eye["n"], eye["to_prev"])
        out, rays = vcm_mega._connect_row(sc, eye, lv, every, ones, CFG,
                                          flavor, eta)
    conn = torch.zeros((depth, lrows, n, 3))
    conn.view(-1, 3)[queue] = out
    return conn, rays


def _queue_twin(flavor):
    return (vcm if flavor == "classic" else vcm_mega).eye_connect_queue_plain


@pytest.mark.parametrize("flavor", FLAVORS)
def test_connect_queue_holds_the_gated_pairs(setup, flavor):
    """The queue's twin holds each pair once, in (t, j, i) order: exactly
    those whose eye record ran its strategies and whose light vertex is
    valid and not delta."""
    rec, lb, n, _ = _flavor_inputs(setup, flavor)
    queue = _queue_twin(flavor)(rec, lb)
    assert queue.dtype == torch.int64 and queue.dim() == 1
    assert bool((queue[1:] > queue[:-1]).all())     # once each, in order
    depth, lrows = rec.flags.shape[0], lb.pt.shape[0]
    want = set()
    for t in range(depth):
        live = rec.conn(t)
        for j in range(lrows):
            lv = _vertex(lb, j)
            ok = live & lv["valid"][:n] & ~lv["is_delta"][:n]
            want |= {(t * lrows + j) * n + i for i in
                     torch.nonzero(ok)[:, 0].tolist()}
    assert set(queue.tolist()) == want
    # some live records' pairs pass, some fail the light vertex's test
    live = (rec.flags & vcm.REC_CONN) == vcm.REC_CONN
    assert 0 < len(want) < int(live.sum()) * lrows


@pytest.mark.parametrize("flavor", FLAVORS)
def test_connect_from_queue_matches_plain(setup, flavor):
    """The connections computed slot by slot from the queue equal the
    connection stage's twin bit for bit, conn and rays alike."""
    rec, lb, n, eta = _flavor_inputs(setup, flavor)
    queue = _queue_twin(flavor)(rec, lb)
    got, rays = _connect_from_queue(setup, flavor, rec, lb, n, eta, queue)
    want, want_rays = _connect_plain(setup, flavor, rec, lb, eta)
    assert rays == want_rays > 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((want != 0).any())


@pytest.mark.parametrize("flavor", FLAVORS)
def test_connect_queue_empty_without_light_vertices(setup, flavor):
    """Light buffers with every vertex invalid: an empty queue, no ray,
    and a zero row on every live record's pairs."""
    rec, lb, n, eta = _flavor_inputs(setup, flavor)
    dark = lb._replace(valid=torch.zeros_like(lb.valid))
    queue = _queue_twin(flavor)(rec, dark)
    assert queue.numel() == 0
    conn, rays = _connect_plain(setup, flavor, rec, dark, eta)
    assert rays == 0 and bool(rec.conn(0).any())
    assert not bool(conn.any())


# --- the ordered gather -------------------------------------------------------

BIG = 1e8   # float32 exactly


def _hand_built(depth: int, lrows: int):
    """One path: records whose float32 sum depends on the order. Depth 0:
    s=0 1e8, NEE 1, connections (-1e8, 0.5); depth 1: s=0 -1, NEE 4,
    connections (2, 0); depth 2 escaped: the sky 8 (when sampled)."""
    rec = vcm.EyeRecords.empty(depth, 1, "cpu", fill=torch.zeros)
    terms = [(BIG, 1.0, [-BIG, 0.5]), (-1.0, 4.0, [2.0, 0.0])]
    conn = torch.zeros((depth, lrows, 1, 3))
    for t, (s0, nee, cs) in enumerate(terms):
        rec.implicit[t] = float(s0)
        rec.nee[t] = nee
        conn[t, :, 0] = torch.tensor(cs)[:, None]
        rec.flags[t] = vcm.REC_CONN
    rec.flags[2] = vcm.REC_ESCAPED | vcm.REC_END
    rec.implicit[2] = 8.0
    order = []
    for s0, nee, cs in terms:
        order += [s0, nee, *cs]
    return rec, conn, order


def _seq(values):
    acc = np.float32(0.0)
    for v in values:
        acc = np.float32(acc + np.float32(v))
    return acc


@pytest.mark.parametrize("flavor", ["classic", "vcm", "bdpt"])
@pytest.mark.parametrize("env", [False, True])
def test_gather_adds_in_jax_order(setup, flavor, env):
    rec, conn, order = _hand_built(4, 2)
    cfg = dataclasses.replace(CFG, light_depth=2, do_merge=False,
                              sample_environment=env)
    if env:
        order = order + [8.0]
    want = _seq(order)
    # the order matters: the connections before NEE give another sum
    other = _seq(order[:1] + order[2:4] + order[1:2] + order[4:])
    assert want != other
    if flavor == "classic":
        li, dropped = vcm.eye_gather_plain(setup["sc"], rec, conn, None, cfg,
                                           0.0, 0.0, 0.0)
    else:
        li, dropped = vcm_mega.eye_gather_plain(setup["sc"], rec, conn, None,
                                                cfg, flavor=flavor)
        want = packing.round_rgb9e5(torch.full((1, 3), float(want)))[0, 0]
    assert dropped == 0
    assert torch.equal(li[0], torch.full((3,), float(want)))


# --- the staged plain pass against JAX ---------------------------------------

CASES = {"no_connection_environment": dict(connection=False,
                                           sample_environment=True),
         "no_merge_no_nee": dict(do_merge=False, nee=False)}


@pytest.mark.parametrize("case", list(CASES))
def test_staged_pass_matches_jax(case):
    side, s = 12, 1
    over = CASES[case]
    js, _ = jbuild_scene(jbuiltin.cornell_with_blocks(),
                         jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    jc = JCamera.pinhole((0.0, 0.0, 1.0), side, side, 0.0, 0.0, 0.0, 60.0)
    tc = Camera.pinhole((0.0, 0.0, 1.0), side, side, 0.0, 0.0, 0.0, 60.0)
    jpx, jpy = jnp.meshgrid(jnp.arange(side), jnp.arange(side))
    jpx, jpy = jpx.ravel(), jpy.ravel()
    jcfg = dataclasses.replace(jvcm.VCMConfig(eye_depth=3, light_depth=2),
                               **over)
    cfg = dataclasses.replace(vcm.VCMConfig(eye_depth=3, light_depth=2),
                              **over)
    want, jrays = (np.asarray(a) for a in jvcm.render_sample(
        js, jc, jrng.base_key(), s, jpx, jpy, cfg=jcfg))
    kernels.reset_launches()
    li, rays, dropped = vcm.render_sample(
        ts, tc, rng.base_key(), s, torch.as_tensor(np.array(jpx)),
        torch.as_tensor(np.array(jpy)), cfg=cfg)
    assert sum(kernels.launches.values()) == 0
    assert abs(rays - int(jrays)) <= 1e-3 * int(jrays)
    assert (dropped > 0) == cfg.do_merge
    got = li.numpy()
    assert np.isfinite(got).all() and (got >= 0).all()
    assert abs(got.mean() / want.mean() - 1.0) < 1e-3
    assert np.isclose(got, want, rtol=1e-3, atol=1e-5).mean() >= 0.98


# --- the walk kernel on the card ------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA for sm_90a)")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["bvh8", "threaded"])
def test_walk_grids_bit_equal_on_card(cuda, engine):
    """The classic VCM walk (eye_walk.cu: persistent lanes that take the
    next path when theirs ends) at the deployment's eye depth 16 on 96x64
    paths, on one block of 128 threads (each lane walks ~48 paths) and on
    its resident grid: every record field, flag word and term, the rays
    and the rows bit-equal (its draws are keyed by pixel and depth, never
    by lane; the records start as NaN and -1, so what either leaves
    unwritten compares too); each grid's lane counters count one bounce a
    record. Against eye_walk_plain on the card: the rays equal and the
    records within chip_smoke.compare_records' bounds."""
    import chip_smoke
    sc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        traversal=engine, device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 96, 64, 0.0, 0.0, 0.0, 60.0)
    py, px = torch.meshgrid(torch.arange(64, dtype=torch.int32, device=cuda),
                            torch.arange(96, dtype=torch.int32, device=cuda),
                            indexing="ij")
    px, py = px.reshape(-1).contiguous(), py.reshape(-1).contiguous()
    n = px.shape[0]
    cfg = vcm.VCMConfig(eye_depth=16, light_depth=10, connection=False,
                        do_merge=False)
    key_l, key_e = vcm.sample_keys(rng.base_key(), 1)
    mr, eta, norm = vcm.sample_scalars(sc, cfg, 1, n)
    lb = kernels.bdpt_walk(sc, px, py, paths.walk_keys(key_l, "light"),
                           mode="light", max_depth=cfg.light_depth + 1,
                           rays=torch.zeros_like(px), eta_vcm=eta)["bufs"]
    runs = {}
    for grid in (1, None):
        ep = kernels.vcm_eye_pass(
            sc, cam, paths.walk_keys(key_e, "eye"), lb, None, None,
            torch.zeros_like(px), cfg, px=px, py=py, merge_radius=mr,
            eta_vcm=eta, merge_norm=norm, one_brick=False, reweight=True,
            with_rows=True)
        for t in ep.rec:
            t.fill_(float("nan") if t.dtype == torch.float32 else -1)
        lanes = torch.zeros(3, dtype=torch.int64, device=cuda)
        kernels.eye_walk(ep, grid=grid, lanes=lanes)
        torch.cuda.synchronize()
        events, busiest, calls = lanes.tolist()
        assert events == int((ep.rec.flags != 0).sum())
        assert 0 < events <= min(32 * calls, 32 * busiest)
        runs[grid] = ep
    one, full = runs[1], runs[None]
    for f in vcm.EyeRecords._fields:
        a, b = getattr(one.rec, f), getattr(full.rec, f)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f
    assert torch.equal(one.rays, full.rays)
    assert torch.equal(one.rows, full.rows)
    assert bool((full.rec.flags >= 0).all())    # every flag word written
    prec, prays = vcm.eye_walk_plain(sc, cam, key_e, cfg, px, py, eta)
    assert int(full.rays.sum()) == prays
    assert bool(((full.rec.flags & vcm.REC_END) != 0).any(0).all())
    chip_smoke.compare_records(full.rec, prec, f"{engine} walk", "K13v")
