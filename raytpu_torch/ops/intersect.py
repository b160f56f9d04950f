"""Batched ray-primitive intersection on tensors.

Counterpart of ``raytpu/ops/intersect.py`` (reference: source/Utils.h,
namespace GeometryUtils).  Each hit test is a masked formula over
(rays x primitives).  A miss is ``t = +inf``; the closest hit is the first
minimum over the spheres -> planes -> triangles concatenation, which keeps
the reference's iteration-order tie-break (reference: source/Scene.cpp:29-66).

Rays are ``ro`` (R,3) origins, or one (1,3) origin for all, and ``rd``
(R,3) unit directions; t-matrices are (R, N).  Each formula is written per component, in raytpu's op order,
with dot and cross products fused as ``raytpu_torch.core.math3d`` says.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import Scene

FLT_EPSILON = 1.1920929e-07
INF = float("inf")
OCC_MAX = 1.0 - 1e-6  #: soft occlusions stay below 1: torch.prod's backward divides by 1 - occ


def _cols(v):
    """(R,3) rays -> three (R,1) columns."""
    return v[:, 0:1], v[:, 1:2], v[:, 2:3]


def _rows(p):
    """(N,3) primitive table -> three (1,N) rows."""
    return p[None, :, 0], p[None, :, 1], p[None, :, 2]


def _dot(a, b):
    return math3d.dot3(*a, *b)


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def _cross(a, b):
    return math3d.cross3(*a, *b)


def _tmax_col(tmax):
    """Scalar or (R,) tmax -> something that broadcasts against (R, N)."""
    return tmax[:, None] if isinstance(tmax, torch.Tensor) and tmax.ndim == 1 else tmax


def sphere_t(center, radius, ro, rd, tmin, tmax):
    """(R, S) geometric sphere test, near root only: rays that start inside a
    sphere miss it, as in the reference (reference: source/Utils.h:52-71).
    Valid on [tmin, tmax]."""
    L = _sub(_rows(center), _cols(ro))
    d = _cols(rd)
    proj = _dot(d, L)
    perp2 = math3d.fma(-proj, proj, _dot(L, L))
    r2 = (radius * radius)[None, :]
    inside = r2 >= perp2
    t = proj - torch.sqrt(torch.where(inside, r2 - perp2, torch.ones_like(perp2)))
    valid = inside & (t >= tmin) & (t <= _tmax_col(tmax))
    return torch.where(valid, t, INF)


def plane_t(origin, normal, ro, rd, tmin, tmax):
    """(R, P) ``t = dot(po-ro, n)/dot(rd, n)``, valid on [tmin, tmax)
    (reference: source/Utils.h:82-98).  Exactly parallel rays miss."""
    n = _rows(normal)
    denom = _dot(_cols(rd), n)
    num = _dot(_sub(_rows(origin), _cols(ro)), n)
    denom_nz = denom != 0.0
    t = num / torch.where(denom_nz, denom, torch.ones_like(denom))
    valid = denom_nz & (t >= tmin) & (t < _tmax_col(tmax))
    return torch.where(valid, t, INF)


def triangle_t(v0, v1, v2, normal, cull, ro, rd, tmin, tmax, shadow_pass: bool):
    """(R, T) Möller–Trumbore with per-triangle cull modes, valid on
    [tmin, tmax).  Shadow rays swap front and back culling
    (reference: source/Utils.h:109-184)."""
    d = _cols(rd)
    p0 = _rows(v0)
    cull_dot = _dot(_rows(normal), d)
    not_parallel = torch.abs(cull_dot) >= FLT_EPSILON
    cull = cull[None, :]
    if shadow_pass:
        # FrontFaceCulling <-> BackFaceCulling; NoCulling unchanged
        cull = torch.where(cull == 2, 2, 1 - cull)
    culled = ((cull == 0) & (cull_dot < 0)) | ((cull == 1) & (cull_dot > 0))
    e1 = _sub(_rows(v1), p0)
    e2 = _sub(_rows(v2), p0)
    h = _cross(d, e2)
    a = _dot(e1, h)
    det_ok = torch.abs(a) >= FLT_EPSILON
    inv_a = 1.0 / torch.where(det_ok, a, torch.ones_like(a))
    s = _sub(_cols(ro), p0)
    u = inv_a * _dot(s, h)
    q = _cross(s, e1)
    v = inv_a * _dot(d, q)
    t = inv_a * _dot(e2, q)
    bary_ok = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    valid = not_parallel & ~culled & det_ok & bary_ok & (t >= tmin) & (t < _tmax_col(tmax))
    return torch.where(valid, t, INF)


def scene_t_matrix(scene: Scene, ro, rd, tmin, tmax, shadow_pass: bool):
    """All primitive t values as one (R, S+P+T) matrix (inf = miss)."""
    cols = []
    if scene.spheres.count:
        cols.append(sphere_t(scene.spheres.center, scene.spheres.radius, ro, rd, tmin, tmax))
    if scene.planes.count:
        cols.append(plane_t(scene.planes.origin, scene.planes.normal, ro, rd, tmin, tmax))
    tr = scene.triangles
    if tr.count:
        cols.append(triangle_t(tr.v0, tr.v1, tr.v2, tr.normal, tr.cull, ro, rd,
                               tmin, tmax, shadow_pass))
    if not cols:
        return torch.full((rd.shape[0], 1), INF, dtype=rd.dtype, device=rd.device)
    return torch.cat(cols, dim=1)


@dataclass(frozen=True)
class HitRecords:
    """Batched HitRecord (reference: source/DataTypes.h:567-575)."""

    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) f32, +inf on miss
    point: torch.Tensor  # (R,3)
    normal: torch.Tensor  # (R,3) unit
    material: torch.Tensor  # (R,) i32


def closest_hit(scene: Scene, ro, rd, tmin) -> HitRecords:
    """First-argmin closest hit plus the winner's payload
    (replaces Scene::GetClosestHit, reference: source/Scene.cpp:29-66)."""
    tmat = scene_t_matrix(scene, ro, rd, tmin, INF, shadow_pass=False)
    t = torch.amin(tmat, dim=1)
    idx = torch.argmin(tmat, dim=1)  # first minimum wins ties
    return assemble_hit_records(scene, ro, rd, t, idx)


def assemble_hit_records(scene: Scene, ro, rd, t, idx) -> HitRecords:
    """HitRecords from each ray's winning (t, global primitive index), the
    index running over spheres -> planes -> triangles.  The payload is a
    gather; sphere normals are normalized after the selection
    (reference: source/Scene.cpp:40)."""
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    point = math3d.fma(rd, t_safe[:, None], ro)
    S = scene.spheres.count
    vecs = torch.cat([scene.spheres.center, scene.planes.normal, scene.triangles.normal])
    mats = torch.cat([scene.spheres.material, scene.planes.material, scene.triangles.material])
    if vecs.shape[0] == 0:
        return HitRecords(hit=hit, t=torch.where(hit, t, INF), point=point,
                          normal=torch.zeros_like(point),
                          material=torch.zeros_like(idx, dtype=torch.int32))
    # sphere rows hold the CENTER; plane and triangle rows the normal
    v = torch.where(hit[:, None], vecs[idx], torch.zeros_like(point))
    material = torch.where(hit, mats[idx], torch.zeros_like(mats[idx]))
    in_s = ((idx < S) & hit)[:, None]
    # double-where keeps the unselected normalize argument away from zero
    d = torch.where(in_s, point - v, torch.ones_like(v))
    n_len = torch.sqrt(torch.clamp(math3d.dot(d, d), min=1e-20))
    normal = torch.where(in_s, d / n_len[:, None], v)
    return HitRecords(hit=hit, t=torch.where(hit, t, INF), point=point,
                      normal=normal, material=material)


def any_hit(scene: Scene, ro, rd, tmin, tmax):
    """Boolean occlusion for shadow rays, with inverted triangle culling
    (replaces Scene::DoesHit, reference: source/Scene.cpp:68-96).
    ``tmax`` is per-ray (R,): the distance to the light."""
    tmat = scene_t_matrix(scene, ro, rd, tmin, tmax, shadow_pass=True)
    return torch.isfinite(tmat).any(dim=1)


def _soft_occ(margin, gate, beta):
    """``min(sigmoid(beta * margin), OCC_MAX)`` on the gated entries, else 0.
    ``torch.sigmoid``'s backward stays finite where ``exp(-beta * margin)``
    overflows on an ungated entry; ``1 / (1 + exp)``'s would be NaN there,
    and ``where`` would carry the NaN into the gradient."""
    occ = torch.clamp(torch.sigmoid(beta * margin), max=OCC_MAX)
    return torch.where(gate, occ, 0.0)


def soft_transmittance(scene: Scene, ro, rd, tmin, tmax, beta):
    """(R,) differentiable visibility in [0, 1] of shadow rays ``ro``, ``rd``
    (R,3) over [tmin, tmax], ``tmax`` (R,): the product over primitives of
    ``1 - occ``, each occlusion a sigmoid of a signed penetration margin
    (raytpu/ops/intersect.py:288).  It tends to ``1 - any_hit`` as
    ``beta -> inf`` and gives shadow edges gradients that the binary
    visibility zeroes.

    Spheres gate on ``t <= tmax``, triangles on ``t < tmax``; triangle
    culling is inverted, as for every shadow ray.  Occlusions are clamped
    below 1 (``OCC_MAX``), so no factor is 0 and the product's backward
    stays finite."""
    d = _cols(rd)
    hi = _tmax_col(tmax)
    trans = torch.ones_like(rd[:, 0])
    if scene.spheres.count:
        L = _sub(_rows(scene.spheres.center), _cols(ro))
        proj = _dot(d, L)
        perp2 = math3d.fma(-proj, proj, _dot(L, L))
        r2 = (scene.spheres.radius * scene.spheres.radius)[None, :]
        margin = (r2 - perp2) / r2  # > 0 where the ray's core passes inside
        inside = margin > 0.0
        t = proj - torch.sqrt(torch.where(inside, r2 - perp2, torch.ones_like(perp2)))
        gate = inside & (t >= tmin) & (t <= hi)
        trans = trans * torch.prod(1.0 - _soft_occ(margin, gate, beta), dim=1)
    if scene.planes.count:
        # a plane's shadow edge comes from the segment's ends crossing it: the
        # margin is how far (in t) the crossing lies inside the segment
        n = _rows(scene.planes.normal)
        denom = _dot(d, n)
        num = _dot(_sub(_rows(scene.planes.origin), _cols(ro)), n)
        denom_nz = torch.abs(denom) > FLT_EPSILON
        t = num / torch.where(denom_nz, denom, torch.ones_like(denom))
        margin = torch.minimum(t - tmin, hi - t)
        gate = denom_nz & (margin > 0.0)
        trans = trans * torch.prod(1.0 - _soft_occ(margin, gate, beta), dim=1)
    tr = scene.triangles
    if tr.count:
        p0 = _rows(tr.v0)
        cull_dot = _dot(_rows(tr.normal), d)
        not_parallel = torch.abs(cull_dot) >= FLT_EPSILON
        cull = tr.cull[None, :]
        cull = torch.where(cull == 2, 2, 1 - cull)  # the shadow pass inverts
        culled = ((cull == 0) & (cull_dot < 0)) | ((cull == 1) & (cull_dot > 0))
        e1 = _sub(_rows(tr.v1), p0)
        e2 = _sub(_rows(tr.v2), p0)
        h = _cross(d, e2)
        a = _dot(e1, h)
        det_ok = torch.abs(a) >= FLT_EPSILON
        inv_a = 1.0 / torch.where(det_ok, a, torch.ones_like(a))
        s = _sub(_cols(ro), p0)
        u = inv_a * _dot(s, h)
        q = _cross(s, e1)
        v = inv_a * _dot(d, q)
        t = inv_a * _dot(e2, q)
        # signed distance to the triangle's boundary in barycentric terms
        margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        gate = not_parallel & ~culled & det_ok & (t >= tmin) & (t < hi)
        trans = trans * torch.prod(1.0 - _soft_occ(margin, gate, beta), dim=1)
    return trans
