"""BSDF lobes, texture lookups and the per-material dispatch (plain PyTorch).

Counterpart of cudapathtracer_tpu/ops/bsdf.py, transcribed operation for
operation: every lobe is evaluated for every lane and the material type
selects, as in the JAX package. Conventions: local shading frame with
z = the flipped geometric normal; `wi` points away from the surface;
`wo.z < 0` means transmission. The reference quirks docs/PARITY.md §2.4
lists are kept: Rs-only conductor Fresnel, Schlick dielectric Fresnel
with a forced mirror on TIR or F >= 0.99999, the EPS-clamped cosine pdf,
the adjoint eta^2 in radiance mode only, and the leaf's 3-event sample.
"""

from __future__ import annotations

import torch

from reference.tpt.scene.materials import (MAT_DELTAMIRROR,
                                                      MAT_DIFFUSE, MAT_LEAF,
                                                      MAT_METAL,
                                                      MAT_SMOOTHDIELECTRIC,
                                                      TRANSPORT_RADIANCE)
from reference.tpt.utils import rng
from reference.tpt.utils.math import (EPSILON, INV_PI, PI, dot,
                                                 normalize)

_FLIP_Z = (1.0, 1.0, -1.0)


def _pow5(x):
    """x**5 by the square-and-multiply order jnp's integer power uses."""
    x2 = x * x
    return x * (x2 * x2)


def fresnel_schlick(cos_theta, eta_i, eta_t):
    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * _pow5(1.0 - torch.abs(cos_theta))


def fresnel_conductor(cos_theta, eta, k):
    """s-polarized conductor Fresnel only (reference quirk).
    cos_theta [N], eta/k [N,3]."""
    c2 = (cos_theta * cos_theta)[..., None]
    s2 = 1.0 - c2
    eta2, k2 = eta * eta, k * k
    t0 = eta2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * cos_theta[..., None] * a
    return (t1 - t2) / (t1 + t2)


# --- Lambertian ------------------------------------------------------------

def cosine_f(albedo):
    return albedo * INV_PI


def cosine_pdf(wo):
    return torch.clamp(wo[..., 2], min=EPSILON) * INV_PI


def cosine_sample(u1, u2):
    """Cosine-hemisphere warp; [N,3] with z > 0."""
    u1 = torch.clamp(u1, max=1.0 - EPSILON)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(1.0 - u1)], dim=-1)


# --- GGX microfacet --------------------------------------------------------

def d_ggx(h_z, alpha):
    a2 = alpha * alpha
    denom = h_z * h_z * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def g1_ggx(v_z, alpha):
    """Rational G1 approximation."""
    v_z = torch.clamp(torch.abs(v_z), min=1e-6)
    tan_t = torch.sqrt(torch.clamp(1.0 - v_z * v_z, min=0.0)) / v_z
    a = 1.0 / torch.clamp(alpha * tan_t, min=1e-8)
    approx = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return torch.where(a < 1.6, approx, 1.0)


def g_smith(wi_z, wo_z, alpha):
    return g1_ggx(wi_z, alpha) * g1_ggx(wo_z, alpha)


def ggx_sample_h(u1, u2, alpha):
    """Sample the GGX NDF half-vector."""
    phi = 2.0 * PI * u2
    cos_t = torch.sqrt(torch.clamp(
        (1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1), min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def _upper(h):
    return torch.where((h[..., 2] <= 0.0)[..., None], -h, h)


def metal_f(eta, k, roughness, wi, wo):
    """[N,3] GGX conductor BRDF."""
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    h = _upper(normalize(wi + wo))
    alpha = roughness * roughness
    d = d_ggx(h[..., 2], alpha)
    g = g_smith(wi[..., 2], wo[..., 2], alpha)
    f = fresnel_conductor(dot(wi, h), eta, k)
    denom = torch.clamp(4.0 * wi[..., 2] * wo[..., 2], min=EPSILON)
    val = (d * g / denom)[..., None] * f
    return torch.where(valid[..., None], val, 0.0)


def metal_pdf(roughness, wi, wo):
    """D * h.z / (4 dot(wo, h)), the denominator's magnitude clamped."""
    h = normalize(wi + wo)
    d = d_ggx(h[..., 2], roughness * roughness)
    denom = 4.0 * dot(wo, h)
    sign = torch.where(denom >= 0, 1.0, -1.0)
    return d * h[..., 2] / (sign * torch.clamp(torch.abs(denom), min=1e-8))


# --- mirror ----------------------------------------------------------------

def mirror_f(wo):
    return 1.0 / torch.clamp(wo[..., 2], min=EPSILON)


# --- smooth dielectric (delta lobe: sample only) ---------------------------

def dielectric_sample(u, wi, ior, backface, transport_mode):
    """Schlick reflect/refract choice, forced mirror on TIR, adjoint eta^2
    in radiance mode. Returns (wo [N,3], f [N], pdf [N])."""
    eta_i = torch.where(backface, ior, 1.0)
    eta_t = torch.where(backface, 1.0, ior)
    cos_i = torch.clamp(wi[..., 2], EPSILON, 1.0)
    eta = eta_i / eta_t
    cos_t2 = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    fres = fresnel_schlick(cos_i, eta_i, eta_t)

    wo_refl = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
    force_reflect = (cos_t2 < 0.0) | (fres >= 0.99999)
    wo_refr = torch.stack([-eta * wi[..., 0], -eta * wi[..., 1],
                           -torch.sqrt(torch.clamp(cos_t2, min=0.0))],
                          dim=-1)
    reflect = force_reflect | (u < fres)
    wo = torch.where(reflect[..., None], wo_refl, wo_refr)

    f_refl = (torch.where(force_reflect, 1.0, fres)
              / torch.clamp(wo_refl[..., 2], min=EPSILON))
    f_refr = (1.0 - fres) / torch.clamp(torch.abs(wo_refr[..., 2]),
                                        min=EPSILON)
    if transport_mode == TRANSPORT_RADIANCE:
        f_refr = f_refr * eta * eta
    f = torch.where(reflect, f_refl, f_refr)
    pdf = torch.where(force_reflect, 1.0,
                      torch.where(reflect, fres, 1.0 - fres))
    return wo, f, pdf


# --- layered leaf ----------------------------------------------------------

def leaf_f(albedo, ior, curr_ior, roughness, transmission, wi, wo):
    is_refl = wo[..., 2] * wi[..., 2] > 0.0
    fres = fresnel_schlick(wi[..., 2], curr_ior, ior)
    h = _upper(normalize(wi + wo))
    mf = fresnel_schlick(dot(wi, h), curr_ior, ior)
    alpha = roughness * roughness
    d = d_ggx(h[..., 2], alpha)
    g = g_smith(wi[..., 2], wo[..., 2], alpha)
    denom = torch.clamp(4.0 * wi[..., 2] * wo[..., 2], min=EPSILON)
    f_cuticle = (d * g * mf / denom)[..., None]
    f_refl = (((1.0 - mf) * (1.0 - transmission))[..., None]
              * cosine_f(albedo) + f_cuticle)
    f_trans = cosine_f(albedo) * (transmission * (1.0 - fres))[..., None]
    return torch.where(is_refl[..., None], f_refl, f_trans)


def leaf_pdf(ior, curr_ior, roughness, transmission, wi, wo):
    is_refl = wo[..., 2] * wi[..., 2] > 0.0
    fres = fresnel_schlick(torch.abs(wi[..., 2]), curr_ior, ior)
    fres = torch.minimum(fres, 1.0 - 0.1 * roughness)
    p_spec = fres
    p_diff_refl = (1.0 - fres) * (1.0 - transmission)
    p_diff_trans = (1.0 - fres) * transmission
    pdf_refl = (p_spec * metal_pdf(roughness, wi, wo)
                + p_diff_refl * cosine_pdf(wo))
    pdf_trans = cosine_pdf(-wo) * p_diff_trans
    return torch.where(is_refl, pdf_refl, pdf_trans)


def leaf_sample(u_sel, u_t, u1, u2, wi, ior, curr_ior, roughness, albedo,
                transmission):
    fres = fresnel_schlick(wi[..., 2], curr_ior, ior)
    h = ggx_sample_h(u1, u2, roughness * roughness)
    wo_spec = 2.0 * dot(wi, h)[..., None] * h - wi
    wo_cos = cosine_sample(u1, u2)
    wo_trans = wo_cos * wo_cos.new_tensor(_FLIP_Z)
    spec = u_sel < fres
    through = u_t < transmission
    wo = torch.where(spec[..., None], wo_spec,
                     torch.where(through[..., None], wo_trans, wo_cos))
    f = leaf_f(albedo, ior, curr_ior, roughness, transmission, wi, wo)
    pdf = leaf_pdf(ior, curr_ior, roughness, transmission, wi, wo)
    return wo, f, pdf


# --- textures --------------------------------------------------------------

def sample_texture(textures, start, width, height, uv):
    """Bilinear, wrap addressing, flat [A,3] atlas. start/width/height [N]
    int32, uv [N,2]."""
    w = torch.clamp(width, min=1)
    h = torch.clamp(height, min=1)
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    sx = (fx - x0f)[..., None]
    sy = (fy - y0f)[..., None]
    x0 = torch.remainder(x0f.to(torch.int32), w)
    y0 = torch.remainder(y0f.to(torch.int32), h)
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.remainder(y0 + 1, h)
    base = torch.clamp(start, min=0)
    c00 = textures[base + y0 * w + x0]
    c10 = textures[base + y0 * w + x1]
    c01 = textures[base + y1 * w + x0]
    c11 = textures[base + y1 * w + x1]
    bottom = c00 * (1.0 - sx) + c10 * sx
    top = c01 * (1.0 - sx) + c11 * sx
    return bottom * (1.0 - sy) + top * sy


def resolve_albedo(scene, mat, uv):
    """Base albedo, replaced by the texture where the material has one."""
    tex = sample_texture(scene.textures, mat.tex_start, mat.tex_width,
                         mat.tex_height, uv)
    return torch.where((mat.tex_start >= 0)[..., None], tex, mat.albedo)


def resolve_transmission(scene, mat, uv):
    """Transmission, replaced by the transmission map's red channel where
    the material has one; no fetch when the scene has no such map."""
    if not scene.has_trans_maps:
        return mat.transmission
    tex = sample_texture(scene.textures, mat.trans_tex_start,
                         mat.trans_tex_width, mat.trans_tex_height, uv)
    return torch.where(mat.trans_tex_start >= 0, tex[..., 0],
                       mat.transmission)


# --- dispatch --------------------------------------------------------------

def bsdf_f(mat, albedo, wi, wo, eta_i, transmission=None):
    """f for every lane; mat: per-hit MaterialTable rows [N]."""
    t = mat.type
    trans = mat.transmission if transmission is None else transmission
    f = torch.where((t == MAT_DIFFUSE)[..., None], cosine_f(albedo), 0.0)
    f = torch.where((t == MAT_METAL)[..., None],
                    metal_f(mat.eta, mat.k, mat.roughness, wi, wo), f)
    f = torch.where((t == MAT_LEAF)[..., None],
                    leaf_f(albedo, mat.ior, eta_i, mat.roughness, trans,
                           wi, wo), f)
    f = torch.where((t == MAT_DELTAMIRROR)[..., None],
                    mirror_f(wo)[..., None], f)
    return f   # smooth dielectric: a delta lobe, f = 0


def bsdf_pdf(mat, wi, wo, eta_i, transmission=None):
    t = mat.type
    trans = mat.transmission if transmission is None else transmission
    pdf = torch.where(t == MAT_DIFFUSE, cosine_pdf(wo), 0.0)
    pdf = torch.where(t == MAT_METAL, metal_pdf(mat.roughness, wi, wo), pdf)
    pdf = torch.where(t == MAT_LEAF,
                      leaf_pdf(mat.ior, eta_i, mat.roughness, trans, wi, wo),
                      pdf)
    return torch.where(t == MAT_DELTAMIRROR, 1.0, pdf)


def _metal_pdf_hd(hn, d, wo):
    """metal_pdf from its half vector hn = normalize(wi + wo) and D."""
    denom = 4.0 * dot(wo, hn)
    sign = torch.where(denom >= 0, 1.0, -1.0)
    return d * hn[..., 2] / (sign * torch.clamp(torch.abs(denom), min=1e-8))


def bsdf_eval(mat, albedo, wi, wo, eta_i, transmission=None):
    """f(wi, wo), pdf(wi, wo) and pdf(wo, wi) in one evaluation that shares
    the half vector normalize(wi + wo), its D and the lobe's Fresnel and G
    terms between them, as the kernels' fused evaluation does
    (kernels/csrc/bsdf.cuh bsdf_eval; the merge term, NEE and the
    connections): bsdf_f and bsdf_pdf both ways, bit for bit (D of the
    upper half vector equals D of the half vector: d_ggx squares h.z).
    -> (f [N,3], pdf [N], pdf_rev [N])."""
    t = mat.type
    trans = mat.transmission if transmission is None else transmission
    r = mat.roughness
    wiz, woz = wi[..., 2], wo[..., 2]
    hn = normalize(wi + wo)
    d = d_ggx(hn[..., 2], r * r)
    h = _upper(hn)
    alpha = r * r
    g = g_smith(wiz, woz, alpha)
    denom = torch.clamp(4.0 * wiz * woz, min=EPSILON)
    # metal
    valid = (wiz > 0.0) & (woz > 0.0)
    f_metal = torch.where(
        valid[..., None],
        (d * g / denom)[..., None] * fresnel_conductor(dot(wi, h), mat.eta,
                                                       mat.k), 0.0)
    # leaf
    is_refl = woz * wiz > 0.0
    fres = fresnel_schlick(wiz, eta_i, mat.ior)
    mf = fresnel_schlick(dot(wi, h), eta_i, mat.ior)
    f_cuticle = (d * g * mf / denom)[..., None]
    f_refl = (((1.0 - mf) * (1.0 - trans))[..., None] * cosine_f(albedo)
              + f_cuticle)
    f_trans = cosine_f(albedo) * (trans * (1.0 - fres))[..., None]
    f_leaf = torch.where(is_refl[..., None], f_refl, f_trans)

    def leaf_pdf_hd(a, b):
        fr = fresnel_schlick(torch.abs(a[..., 2]), eta_i, mat.ior)
        fr = torch.minimum(fr, 1.0 - 0.1 * r)
        p_diff_refl = (1.0 - fr) * (1.0 - trans)
        p_diff_trans = (1.0 - fr) * trans
        pdf_refl = fr * _metal_pdf_hd(hn, d, b) + p_diff_refl * cosine_pdf(b)
        return torch.where(is_refl, pdf_refl, cosine_pdf(-b) * p_diff_trans)

    f = torch.where((t == MAT_DIFFUSE)[..., None], cosine_f(albedo), 0.0)
    f = torch.where((t == MAT_METAL)[..., None], f_metal, f)
    f = torch.where((t == MAT_LEAF)[..., None], f_leaf, f)
    f = torch.where((t == MAT_DELTAMIRROR)[..., None],
                    mirror_f(wo)[..., None], f)
    pdfs = []
    for a, b in ((wi, wo), (wo, wi)):
        pdf = torch.where(t == MAT_DIFFUSE, cosine_pdf(b), 0.0)
        pdf = torch.where(t == MAT_METAL, _metal_pdf_hd(hn, d, b), pdf)
        pdf = torch.where(t == MAT_LEAF, leaf_pdf_hd(a, b), pdf)
        pdfs.append(torch.where(t == MAT_DELTAMIRROR, 1.0, pdf))
    return f, pdfs[0], pdfs[1]


def bsdf_sample(key, draw_base, mat, albedo, wi, backface, eta_i,
                transport_mode=TRANSPORT_RADIANCE, transmission=None,
                ids=None, draws=None):
    """Sample wo for every lane -> (wo [N,3], f [N,3], pdf [N]); consumes
    draws draw_base .. draw_base+3 keyed by `ids`, or the four uniforms
    `draws` [N] the caller drew (the keyed walk, models/light_mega.py)."""
    n = wi.shape[0]
    if draws is None:
        draws = tuple(rng.uniform_any(key, draw_base + j, n, ids)
                      for j in range(4))
    u_sel, u_t, u1, u2 = draws
    t = mat.type
    trans = mat.transmission if transmission is None else transmission

    wo_d = cosine_sample(u1, u2)
    f_d = cosine_f(albedo)
    pdf_d = cosine_pdf(wo_d)

    h = ggx_sample_h(u1, u2, mat.roughness * mat.roughness)
    wo_m = 2.0 * dot(wi, h)[..., None] * h - wi
    wo_m = torch.where((wo_m[..., 2] <= 0.0)[..., None],
                       wo_m * wo_m.new_tensor(_FLIP_Z), wo_m)
    f_m = metal_f(mat.eta, mat.k, mat.roughness, wi, wo_m)
    pdf_m = metal_pdf(mat.roughness, wi, wo_m)

    wo_g, f_g, pdf_g = dielectric_sample(u_sel, wi, mat.ior, backface,
                                         transport_mode)
    wo_l, f_l, pdf_l = leaf_sample(u_sel, u_t, u1, u2, wi, mat.ior, eta_i,
                                   mat.roughness, albedo, trans)
    wo_mi = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
    f_mi = mirror_f(wo_mi)

    wo, f, pdf = wo_d, f_d, pdf_d
    for tt, wo_c, f_c, pdf_c in (
            (MAT_METAL, wo_m, f_m, pdf_m),
            (MAT_SMOOTHDIELECTRIC, wo_g, f_g[..., None].expand(n, 3), pdf_g),
            (MAT_LEAF, wo_l, f_l, pdf_l),
            (MAT_DELTAMIRROR, wo_mi, f_mi[..., None].expand(n, 3),
             torch.ones_like(pdf_d))):
        m = t == tt
        wo = torch.where(m[..., None], wo_c, wo)
        f = torch.where(m[..., None], f_c, f)
        pdf = torch.where(m, pdf_c, pdf)
    return wo, f, pdf
