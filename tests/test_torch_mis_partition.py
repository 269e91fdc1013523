"""The MIS partition of unity (tests/test_mis_partition.py) on the PyTorch
port: for a FIXED transport path the strategy weights must sum to 1, and a
perturbed d_vc or d_vm chain must show.

The same scenes, cameras, keys, lanes and tolerances as the JAX tests:

  * BDPT on two planes (floor, downward light): camera -> floor -> light
    is covered by s=0, NEE and the light-trace splat; the eye-side
    d_vcm / d_vc come from the port's walk (models/paths.random_walk with
    models/mis.advance), the light side from mis.advance on the path's
    concrete pdfs.
  * VCM on three planes (floor, wall, light): camera -> floor -> wall ->
    light is covered by s=0, NEE, the connection P1 <-> P2, the splat at
    P1 and the merges at P1 and P2. The connection's weight is the port's
    models/vcm.conn_terms (the function the staged connection stage's
    plain twin calls); the other weights are assembled as models/vcm.py
    assembles them (implicit_vcm, the NEE weight of eye_walk_plain,
    vcm_light_splat's, merge_terms'), each at eta_vcm 0.3, 2 and 10.
  * Doubling the d_vm chain moves both merge weights by > 5%; scaling the
    d_vc chain by 1.05 breaks the BDPT partition by > 5e-3.
"""

import numpy as np
import pytest
import torch

from cudapathtracer_tpu_torch.models import mis, paths, vcm
from cudapathtracer_tpu_torch.models.bdpt import _gather_mat
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.scene.builtin import quad
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import (TRANSPORT_RADIANCE,
                                                      Material)
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.math import (PI, dot, length_sq,
                                                 normalize, to_local)
from cudapathtracer_tpu_torch.utils.obj import MeshData
from test_torch_common import _one_thread  # noqa: F401  (autouse)


def _grid(w, h):
    py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _two_plane_scene():
    mats = [Material.diffuse((0.7, 0.7, 0.7)),
            Material.diffuse((0.0, 0.0, 0.0))]
    m = MeshData()
    # floor at y=0 (normal +y), light at y=2 facing down (normal -y)
    quad(m, (-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2), 0)
    quad(m, (-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1), 1,
         emission=(5.0, 5.0, 5.0))
    scene, _ = build_scene(m, mats, device="cpu")
    assert scene.num_lights == 2  # the quad's two triangles
    return scene


def _light_pdf(scene, light_ind):
    num_lights = max(scene.num_lights, 1)
    area = scene.light_f32[torch.clamp(light_ind, min=0), 15]
    return (1.0 / num_lights) / area


def _partition_sums(scene, camera, key, px, py):
    """(sums, count): per-lane w_impl + w_nee + w_splat for the lanes whose
    eye walk realizes camera -> floor -> light, and how many there are."""
    n = px.shape[0]
    ebufs, ev0, _, _ = paths.generate_eye_path(scene, camera, key, px, py, 3)
    ones = torch.ones(n)
    # vertex 1 (buffer j=0): the floor hit; vertex 2 (j=1): the light hit
    sel = (ebufs.valid[0] & (ebufs.light_ind[0] < 0)
           & ebufs.valid[1] & (ebufs.light_ind[1] >= 0)
           & ~ebufs.backface[1])
    p, n0, q, n1 = ebufs.pt[0], ebufs.n[0], ebufs.pt[1], ebufs.n[1]
    cam_pt = ev0["pt"]
    mat0 = _gather_mat(scene, ebufs.mat_id[0])
    pdf_connect = _light_pdf(scene, ebufs.light_ind[1])
    plane_area = camera.plane_area()

    # (s=0, t=3) implicit hit, the previous vertex (floor) not delta
    cos_l = torch.abs(dot(n1, normalize(ebufs.wo[1])))
    w_eye_impl = (pdf_connect * ebufs.d_vcm[1]
                  + pdf_connect * (cos_l / PI) * ebufs.d_vc[1])
    w_impl = 1.0 / (1.0 + w_eye_impl)

    # (s=1, t=2) NEE from P to the SAME light point Q
    stl = q - p
    d2 = length_sq(stl)
    stl_u = stl / torch.sqrt(d2)[:, None]
    cos_light = dot(n1, -stl_u)
    pdf_emit_sa = cos_light / PI
    prev_to_curr_local = to_local(normalize(p - cam_pt), n0)
    stl_local = to_local(stl_u, n0)
    pdf_bsdf_sa = bsdf_ops.bsdf_pdf(mat0, -prev_to_curr_local, stl_local,
                                    ones)
    w_light_nee = (pdf_bsdf_sa * torch.abs(cos_light) / d2) / pdf_connect
    pdf_curr_rev_area = pdf_emit_sa * torch.abs(stl_local[..., 2]) / d2
    pdf_prev_rev_sa = bsdf_ops.bsdf_pdf(mat0, stl_local,
                                        -prev_to_curr_local, ones)
    w_eye_nee = pdf_curr_rev_area * (ebufs.d_vcm[0]
                                     + pdf_prev_rev_sa * ebufs.d_vc[0])
    w_nee = 1.0 / (1.0 + w_light_nee + w_eye_nee)

    # (s=2, t=1) the light-trace splat of the light path Q -> P, its d
    # chains at P from the port's recursion on the path's concrete pdfs
    cos_emit = dot(n1, -stl_u)
    cos_land = torch.abs(dot(n0, stl_u))
    pdf_fwd_area = (cos_emit / PI) * cos_land / d2
    g = cos_emit / d2
    first_d_vcm = 1.0 / torch.clamp(pdf_fwd_area, min=1e-20)
    first_d_vc = (1.0 / pdf_connect) * g / torch.clamp(pdf_fwd_area,
                                                       min=1e-20)
    d_vcm_p, d_vc_p, _, _ = mis.advance(
        mis.MisState.zeros(n), True, pdf_fwd_area, g, torch.zeros(n),
        torch.zeros(n, dtype=torch.bool), first_d_vcm, first_d_vc)
    to_cam = cam_pt - p
    d2c = length_sq(to_cam)
    tcu = to_cam / torch.sqrt(d2c)[:, None]
    fwd = tcu.new_tensor(camera.forward).expand_as(tcu)
    cos_cam = torch.abs(dot(fwd, -tcu))
    cos_p_cam = torch.abs(dot(n0, tcu))
    pdf_trace_cam = cos_p_cam / (d2c * plane_area * cos_cam ** 3)
    pdf_rev_sa = bsdf_ops.bsdf_pdf(mat0, to_local(tcu, n0),
                                   to_local(stl_u, n0), ones)
    w_light_splat = pdf_trace_cam * (d_vcm_p + pdf_rev_sa * d_vc_p)
    w_splat = 1.0 / (1.0 + w_light_splat)

    sums = torch.where(sel, w_impl + w_nee + w_splat, 1.0).numpy()
    return sums, int(sel.sum())


def _setup():
    scene = _two_plane_scene()
    camera = Camera.pinhole((0.0, 1.0, 3.0), 16, 16, -15.0, 0.0, 0.0, 70.0)
    return (scene, camera, *_grid(16, 16))


def test_mis_weights_partition_unity():
    scene, camera, px, py = _setup()
    total = 0
    for seed in range(6):
        key = rng.sample_key(rng.base_key(), seed)
        sums, cnt = _partition_sums(scene, camera, key, px, py)
        total += cnt
        np.testing.assert_allclose(sums, 1.0, rtol=2e-3,
                                   err_msg=f"seed {seed}")
    assert total > 50, f"only {total} camera->floor->light paths realized"


# --- VCM: the connection and merge weights (eta_vcm and the d_vm chain) ----

def _three_plane_scene():
    mats = [Material.diffuse((0.7, 0.7, 0.7)),
            Material.diffuse((0.0, 0.0, 0.0))]
    m = MeshData()
    # floor y=0 (+y), back wall z=-2 (+z), light y=2.2 facing down
    quad(m, (-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2), 0)
    quad(m, (-2, 0, -2), (2, 0, -2), (2, 2.5, -2), (-2, 2.5, -2), 0)
    quad(m, (-1, 2.2, -0.5), (1, 2.2, -0.5), (1, 2.2, 1), (-1, 2.2, 1), 1,
         emission=(5.0, 5.0, 5.0))
    scene, _ = build_scene(m, mats, device="cpu")
    assert scene.num_lights == 2
    return scene


def _vcm_partition_sums(scene, camera, key, px, py, eta: float,
                        nee_squared=True):
    n = px.shape[0]
    pid = rng.pixel_ids(px, py)
    ones, zero = torch.ones(n), torch.zeros(n)
    no_delta = torch.zeros(n, dtype=torch.bool)
    estart, ev0 = paths.start_eye_walk(scene, camera, key, px, py, pid)
    ebufs, _, _ = paths.random_walk(scene, key, estart, 4,
                                    TRANSPORT_RADIANCE, eta_vcm=eta,
                                    first_vm_seed=zero, ids=pid)
    cam_pt = ev0["pt"]
    # lanes realizing floor -> wall -> light
    sel = (ebufs.valid[0] & (ebufs.light_ind[0] < 0)
           & ebufs.valid[1] & (ebufs.light_ind[1] < 0)
           & ebufs.valid[2] & (ebufs.light_ind[2] >= 0)
           & ~ebufs.backface[2])
    p1, n1 = ebufs.pt[0], ebufs.n[0]
    p2, n2 = ebufs.pt[1], ebufs.n[1]
    q, nq = ebufs.pt[2], ebufs.n[2]
    mat1 = _gather_mat(scene, ebufs.mat_id[0])
    mat2 = _gather_mat(scene, ebufs.mat_id[1])
    pdf_connect = _light_pdf(scene, ebufs.light_ind[2])
    plane_area = camera.plane_area()

    def cosv(nrm, frm, to):
        return torch.abs(dot(nrm, normalize(to - frm)))

    # light-side d chains of THIS path by the port's recursion: depth 1 at
    # P2 (Q -> P2), depth 2 at P1 (P2 -> P1)
    d2_qp2 = length_sq(p2 - q)
    cos_emit = cosv(nq, q, p2)
    pfa1 = (cos_emit / PI) * cosv(n2, p2, q) / d2_qp2
    g1 = cos_emit / d2_qp2
    fvc = (1.0 / pdf_connect) * g1 / torch.clamp(pfa1, min=1e-20)
    l1_vcm, l1_vc, l1_vm, st1 = mis.advance(
        mis.MisState.zeros(n), True, pfa1, g1, cosv(n2, p2, q) / PI,
        no_delta, 1.0 / torch.clamp(pfa1, min=1e-20), fvc,
        fvc / max(eta, 1e-30), eta)
    d2_p21 = length_sq(p1 - p2)
    cos_out2 = cosv(n2, p2, p1)
    pfa2 = (cos_out2 / PI) * cosv(n1, p1, p2) / d2_p21
    g2 = cos_out2 / d2_p21
    l2_vcm, l2_vc, l2_vm, _ = mis.advance(
        st1, False, pfa2, g2, cosv(n1, p1, p2) / PI, no_delta, zero, zero,
        zero, eta)

    # (s=0) implicit hit at Q (the wall before it not delta)
    cos_l = cosv(nq, q, p2)
    w_impl = 1.0 / (1.0 + pdf_connect * ebufs.d_vcm[2]
                    + pdf_connect * (cos_l / PI) * ebufs.d_vc[2])

    # (s=1) NEE at P2 toward the SAME light point Q
    stl = q - p2
    d2n = length_sq(stl)
    stl_u = stl / torch.sqrt(d2n)[:, None]
    cos_light = dot(nq, -stl_u)
    stl_local = to_local(stl_u, n2)
    prev_to_curr_loc = to_local(normalize(p2 - p1), n2)
    pdf_bsdf_sa = bsdf_ops.bsdf_pdf(mat2, -prev_to_curr_loc, stl_local, ones)
    ratio = (pdf_bsdf_sa * torch.abs(cos_light) / d2n) / pdf_connect
    w_light = ratio * ratio if nee_squared else ratio
    pdf_curr_rev_area = (cos_light / PI) * torch.abs(stl_local[..., 2]) / d2n
    pdf_prev_rev_sa = bsdf_ops.bsdf_pdf(mat2, stl_local, -prev_to_curr_loc,
                                        ones)
    w_eye = pdf_curr_rev_area * (eta + ebufs.d_vcm[1]
                                 + pdf_prev_rev_sa * ebufs.d_vc[1])
    w_nee = 1.0 / (1.0 + w_light + w_eye)

    # (s=2) the connection eye P1 <-> light P2: models/vcm.conn_terms
    eye = dict(pos=p1, n=n1, mat=mat1, albedo=torch.full((n, 3), 0.7),
               trans=zero, thr=torch.ones((n, 3)), d_vcm=ebufs.d_vcm[0],
               d_vc=ebufs.d_vc[0], to_prev=normalize(cam_pt - p1))
    lv = dict(pt=p2, n=n2, wo=normalize(q - p2), mat_id=ebufs.mat_id[1],
              uv=torch.zeros((n, 2)), beta=torch.ones((n, 3)), d_vcm=l1_vcm,
              d_vc=l1_vc, valid=sel, is_delta=no_delta)
    do, e2l_u, _, cos_lc, cos_ec, d2c = vcm.conn_geometry(eye, lv, sel)
    _, w_conn = vcm.conn_terms(scene, eye, lv, ones, e2l_u, cos_lc, cos_ec,
                               d2c, eta)
    to_prev_loc_e = to_local(eye["to_prev"], n1)

    # (t=1) the light-trace splat at P1 (vcm_light_splat)
    to_cam = cam_pt - p1
    d2cam = length_sq(to_cam)
    tcu = to_cam / torch.sqrt(d2cam)[:, None]
    fwd = tcu.new_tensor(camera.forward).expand_as(tcu)
    cos_cam = torch.abs(dot(fwd, -tcu))
    pdf_curr_rev_area = dot(n1, tcu) / (d2cam * plane_area * cos_cam ** 3)
    pdf_rev_sa = bsdf_ops.bsdf_pdf(mat1, to_local(tcu, n1),
                                   to_local(e2l_u, n1), ones)
    w_splat = 1.0 / (1.0 + pdf_curr_rev_area
                     * (eta + l2_vcm + pdf_rev_sa * l2_vc))

    # the merges, both pdfs at the EYE vertex's material and frame
    # (merge_terms): at P1 with the photon of light depth 2, at P2 with
    # the photon of light depth 1
    def merge_weight(mat, nrm, eye_prev_loc, wi_loc, d_vcm, d_vm, p_vcm,
                     p_vm):
        pdf_eye_rev = bsdf_ops.bsdf_pdf(mat, wi_loc, eye_prev_loc, ones)
        pdf_light_rev = bsdf_ops.bsdf_pdf(mat, eye_prev_loc, wi_loc, ones)
        e = max(eta, 1e-30)
        return 1.0 / (1.0 + d_vcm / e + pdf_eye_rev * d_vm + p_vcm / e
                      + pdf_light_rev * p_vm)
    w_merge1 = merge_weight(mat1, n1, to_prev_loc_e, to_local(e2l_u, n1),
                            ebufs.d_vcm[0], ebufs.d_vm[0], l2_vcm, l2_vm)
    w_merge2 = merge_weight(mat2, n2, to_local(normalize(p1 - p2), n2),
                            to_local(normalize(q - p2), n2), ebufs.d_vcm[1],
                            ebufs.d_vm[1], l1_vcm, l1_vm)

    parts = dict(impl=w_impl, nee=w_nee, conn=w_conn, splat=w_splat,
                 merge1=w_merge1, merge2=w_merge2)
    total = sum(parts.values())
    sums = torch.where(sel, total, 1.0).numpy()
    parts = {k: torch.where(sel, v, 1.0).numpy() for k, v in parts.items()}
    return sums, int(sel.sum()), parts


def _vcm_setup():
    scene = _three_plane_scene()
    camera = Camera.pinhole((0.0, 1.1, 3.0), 32, 32, -10.0, 0.0, 0.0, 75.0)
    return (scene, camera, *_grid(32, 32))


@pytest.mark.parametrize("eta", [0.3, 2.0, 10.0])
def test_vcm_partition_unity_with_merge(eta):
    scene, camera, px, py = _vcm_setup()
    eta = float(np.float32(eta))
    total = 0
    for seed in range(2):
        key = rng.sample_key(rng.base_key(), seed)
        # with the squared NEE ratio the sum sits in [1.0, 1.012] (the
        # quirk biases high only); with the linear ratio it is exact. A
        # missing or broken eta or d_vm term shows as a low deviation.
        sums, cnt, _ = _vcm_partition_sums(scene, camera, key, px, py, eta)
        total += cnt
        assert sums.min() > 1.0 - 2e-3, \
            f"seed {seed}: partition deficit (min {sums.min()})"
        assert sums.max() < 1.0 + 2.5e-2, \
            f"seed {seed}: partition excess (max {sums.max()})"
        lin, _, _ = _vcm_partition_sums(scene, camera, key, px, py, eta,
                                        nee_squared=False)
        np.testing.assert_allclose(lin, 1.0, rtol=2e-3,
                                   err_msg=f"seed {seed} (linear NEE)")
    assert total > 12, f"only {total} camera->floor->wall->light paths"


def test_vcm_partition_detects_dvm_perturbation(monkeypatch):
    """Doubling the d_vm chain must move the merge weights: they are
    exercised by the harness (the sum alone is insensitive when the merge
    share is small, so the check is on the merge components)."""
    scene, camera, px, py = _vcm_setup()
    key = rng.sample_key(rng.base_key(), 0)
    _, cnt, good = _vcm_partition_sums(scene, camera, key, px, py, 2.0)
    assert cnt > 0
    real_advance = mis.advance

    def bad_advance(*args, **kw):
        d_vcm, d_vc, d_vm, st = real_advance(*args, **kw)
        return d_vcm, d_vc, d_vm * 2.0, st._replace(d_vm=st.d_vm * 2.0)

    monkeypatch.setattr(mis, "advance", bad_advance)
    _, _, bad = _vcm_partition_sums(scene, camera, key, px, py, 2.0)
    for k in ("merge1", "merge2"):
        rel = np.abs(bad[k] - good[k]) / np.maximum(good[k], 1e-12)
        assert rel.max() > 0.05, \
            f"{k}: d_vm x2 moved the weight by only {rel.max():.2%}"


def test_mis_partition_detects_dvc_perturbation(monkeypatch):
    """Scaling the d_vc chain by 5% must break the partition: the test
    exercises the recursion, not an identity."""
    scene, camera, px, py = _setup()
    key = rng.sample_key(rng.base_key(), 0)
    real_advance = mis.advance

    def bad_advance(*args, **kw):
        d_vcm, d_vc, d_vm, st = real_advance(*args, **kw)
        return d_vcm, d_vc * 1.05, d_vm, st._replace(d_vc=st.d_vc * 1.05)

    # paths.py resolves mis.advance at call time through the module object
    monkeypatch.setattr(mis, "advance", bad_advance)
    sums, cnt = _partition_sums(scene, camera, key, px, py)
    assert cnt > 0
    dev = np.abs(sums - 1.0).max()
    assert dev > 5e-3, f"perturbed recursion went undetected (max dev {dev})"
