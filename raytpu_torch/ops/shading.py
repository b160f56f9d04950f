"""Material-table shading and light queries on tensors.

Counterpart of ``raytpu/ops/shading.py``.  The reference's virtual
``Material::Shade`` (reference: source/Material.h:27) becomes a per-ray
gather of material parameters plus all four families evaluated and selected
by kind.  BRDF formulas follow reference: source/BRDFs.h, quirks included:
the clamped reflect inside Phong (:35), GGX with alpha = roughness^2
(:62-68) and the k = (alpha+1)^2/8 geometry term (:81).  The terms are
public one by one (``lambert`` to ``cook_torrance``); ``shade`` evaluates
the same formulas inline, in the order its images were held to raytpu's
and to the goldens with.
"""

from __future__ import annotations

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import LightKind, Lights, Materials

PI = 3.14159265358979323846


def _pow5(x):
    """x**5 as ``x * (x*x)**2``: the multiplication order of JAX's integer power."""
    x2 = x * x
    return x * (x2 * x2)


def lambert(kd, cd):
    """``cd * kd / pi``; ``kd`` per ray (...,) or per channel (...,3)
    (reference: source/BRDFs.h:14-22)."""
    if kd.ndim == cd.ndim - 1:
        kd = kd[..., None]
    return cd * kd / PI


def phong(ks, exp, l, v, n):
    """White specular lobe with the reference's clamped reflect
    (reference: source/BRDFs.h:33-40).  ``cosa**exp`` is guarded so that its
    gradient at cosa = 0 stays finite for exp < 1; the value is powf's:
    pow(0, 0) = 1, pow(0, e > 0) = 0."""
    cosa = torch.clamp(math3d.dot(math3d.reflect(l, n), v), min=0.0)
    pos = cosa > 0.0
    one = torch.ones_like(cosa)
    powv = torch.where(pos, torch.pow(torch.where(pos, cosa, one), exp),
                       torch.where(exp == 0.0, one, torch.zeros_like(one)))
    return (ks * powv)[..., None] * torch.ones(3, dtype=cosa.dtype, device=cosa.device)


def fresnel_schlick(h, v, f0):
    """Schlick's Fresnel (reference: source/BRDFs.h:49-53)."""
    return f0 + (1.0 - f0) * _pow5(1.0 - torch.clamp(math3d.dot(h, v), min=0.0))[..., None]


def ggx_distribution(n, h, roughness):
    """Trowbridge-Reitz GGX with UE4's alpha = roughness^2
    (reference: source/BRDFs.h:62-68)."""
    a = roughness * roughness
    sqr_a = a * a
    ndh = torch.clamp(math3d.dot(n, h), min=0.0)
    denom = ndh * ndh * (sqr_a - 1.0) + 1.0
    return sqr_a / (PI * denom * denom)


def schlick_ggx_geometry(n, x, roughness):
    """k = (alpha+1)^2/8 with alpha = roughness^2: the reference's deviation
    from UE4's (roughness+1)^2/8 (reference: source/BRDFs.h:78-86)."""
    a = roughness * roughness
    k = (a + 1.0) * (a + 1.0) / 8.0
    cd = torch.clamp(math3d.dot(n, x), min=0.0)
    return cd / (cd * (1.0 - k) + k)


def smith_geometry(n, v, l, roughness):
    """(reference: source/BRDFs.h:96-99)."""
    return schlick_ggx_geometry(n, v, roughness) * schlick_ggx_geometry(n, l, roughness)


def cook_torrance(albedo, metalness, roughness, n, l, v):
    """Microfacet specular plus Lambert diffuse for non-metals
    (reference: source/Material.h:107-123)."""
    h = math3d.normalize_safe(v + l)
    is_dielectric = (metalness == 0.0)[..., None]
    f0 = torch.where(is_dielectric, torch.full_like(albedo, 0.04), albedo)
    F = fresnel_schlick(h, v, f0)
    D = ggx_distribution(n, h, roughness)
    G = smith_geometry(n, v, l, roughness)
    denom = (4.0 * torch.clamp(math3d.dot(v, n), min=1e-4)
             * torch.clamp(math3d.dot(l, n), min=1e-4))
    specular = F * (D * G / denom)[..., None]
    kd = torch.where(is_dielectric, 1.0 - F, torch.zeros_like(F))
    return lambert(kd, albedo) + specular


def shade(materials: Materials, mat_idx, n, l, v):
    """BRDF color (R,3) for per-ray material ids ``mat_idx`` (R,) and unit
    normal, light and view directions (R,3).

    Every family is evaluated and the ray's kind selects.  Parameters are
    sanitized on the rows where a family is NOT selected, so that the
    unselected formulas stay finite (Cook-Torrance at roughness 0, Phong at
    a zero exponent)."""
    kind = math3d.gather_rows(materials.kind, mat_idx)
    col = math3d.gather_rows(materials.color, mat_idx)  # (R,3)
    p0, p1, p2 = math3d.gather_rows(materials.params, mat_idx).unbind(-1)
    one = torch.ones_like(p0)
    is_ct = kind == 3
    rough = torch.where(is_ct, p1, one)
    metal = torch.where(is_ct, p0, one)
    exp = torch.where(kind == 2, p2, one)

    # Lambert: cd * kd / pi (reference: source/BRDFs.h:14-22)
    c_lambert = col * (p0 / PI)[:, None]

    # Phong: white lobe with the clamped reflect (reference: source/BRDFs.h:33-40)
    refl = l - n * (2.0 * torch.clamp(math3d.dot(n, l), min=0.0))[:, None]
    cosa = torch.clamp(math3d.dot(refl, v), min=0.0)
    pos = cosa > 0.0
    powv = torch.where(pos, torch.pow(torch.where(pos, cosa, one), exp),
                       torch.where(exp == 0.0, one, torch.zeros_like(one)))
    c_lp = c_lambert + (p1 * powv)[:, None]

    # Cook-Torrance (reference: source/Material.h:107-123, BRDFs.h:49-99)
    h = v + l
    h = h / torch.sqrt(torch.clamp(math3d.dot(h, h), min=1e-20))[:, None]
    is_diel = (metal == 0.0)[:, None]
    f0 = torch.where(is_diel, torch.full_like(col, 0.04), col)
    F = f0 + (1.0 - f0) * _pow5(1.0 - torch.clamp(math3d.dot(h, v), min=0.0))[:, None]
    a = rough * rough
    sqr_a = a * a
    ndh = torch.clamp(math3d.dot(n, h), min=0.0)
    denom_d = ndh * ndh * (sqr_a - 1.0) + 1.0
    D = sqr_a / (PI * denom_d * denom_d)
    k = (a + 1.0) * (a + 1.0) / 8.0
    cd_v = torch.clamp(math3d.dot(n, v), min=0.0)
    cd_l = torch.clamp(math3d.dot(n, l), min=0.0)
    G = (cd_v / (cd_v * (1.0 - k) + k)) * (cd_l / (cd_l * (1.0 - k) + k))
    denom = 4.0 * torch.clamp(math3d.dot(v, n), min=1e-4) * torch.clamp(math3d.dot(l, n), min=1e-4)
    spec_s = (D * G / denom)[:, None]
    c_ct = torch.where(is_diel, 1.0 - F, torch.zeros_like(F)) * col * (1.0 / PI) + F * spec_s

    k3 = kind[:, None]
    out = torch.where(k3 == 0, col, c_ct)
    out = torch.where(k3 == 1, c_lambert, out)
    return torch.where(k3 == 2, c_lp, out)


def direction_to_light(lights: Lights, li: int, point):
    """Unit direction (R,3) and distance (R,) from ``point`` to light ``li``.
    Point lights: toward the light's origin, true distance
    (reference: source/Utils.h:341-353).  Directional lights: ``-direction``
    at FLT_MAX (the reference's directional branch is dead code,
    reference: source/Utils.h:348)."""
    d = lights.position[li] - point
    mag_pt = torch.sqrt(math3d.dot(d, d))
    is_point = lights.kind[li] == LightKind.POINT
    l = torch.where(is_point, d / mag_pt[:, None], -lights.direction[li])
    mag = torch.where(is_point, mag_pt, torch.finfo(point.dtype).max)
    return l, mag


def radiance(lights: Lights, li: int, target):
    """Point: ``color * intensity / dist^2``; directional: ``color * intensity``
    (reference: source/Utils.h:355-369)."""
    d = lights.position[li] - target
    s_pt = lights.intensity[li] / math3d.dot(d, d)  # (R,)
    is_point = lights.kind[li] == LightKind.POINT
    return torch.where(is_point, lights.color[li] * s_pt[:, None],
                       lights.color[li] * lights.intensity[li])
