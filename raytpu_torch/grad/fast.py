"""The closest hit with a detached winner search.

Counterpart of ``raytpu/grad/fast.py``.  Which primitive a ray sees is
piecewise constant in the scene's parameters: away from visibility
boundaries (a set of measure zero) moving a sphere or a light does not
change it, so its gradient is zero almost everywhere.  ``detached_closest_hit``
runs the winner search without autograd (no residuals, no backward), then
re-derives t, the hit point and the normal of the one winner of each ray
with gradients: O(R) differentiated work instead of O(R x primitives).  The
values are the eager closest hit's on the same winner; only the zero-a.e.
boundary terms are dropped.

The winner's parameters are index gathers (``math3d.gather_rows``), whose
backward is an ``index_add_`` (raytpu's one-hot matmuls are a TPU device
the port drops).
Replaces the gradient path through ``Scene::GetClosestHit`` (reference:
source/Scene.cpp:29-66), which has no gradients.
"""

from __future__ import annotations

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.math3d import gather_rows
from raytpu_torch.core.types import Scene
from raytpu_torch.ops import intersect
from raytpu_torch.ops.intersect import FLT_EPSILON, INF, HitRecords


def _winner(scene: Scene, ro, rd, tmin, min_t_fn):
    """(t, global index) of each ray's closest hit, without autograd."""
    with torch.no_grad():
        if min_t_fn is not None:
            return min_t_fn(scene, ro, rd, tmin)
        tmat = intersect.scene_t_matrix(scene, ro, rd, tmin, INF, shadow_pass=False)
        t, idx = tmat.min(dim=1)  # the first minimum wins ties
        return t, idx


def detached_closest_hit(scene: Scene, ro, rd, tmin, min_t_fn=None) -> HitRecords:
    """``intersect.closest_hit`` with a detached winner search: differentiable
    in the scene's geometry through the winner's re-derived t and normal,
    and in ``ro`` and ``rd`` (R,3).

    ``min_t_fn(scene, ro, rd, tmin) -> (t, global index)`` replaces the
    eager t-matrix argmin, e.g. K3 (``render/packed.py:scene_min_t_mega2``);
    it runs under ``torch.no_grad()``, so it needs no backward."""
    t_det, idx = _winner(scene, ro, rd, tmin, min_t_fn)
    idx = idx.long()
    hit = torch.isfinite(t_det)
    S, P, T = scene.spheres.count, scene.planes.count, scene.triangles.count
    R = rd.shape[0]
    zero = torch.zeros((R,), dtype=rd.dtype, device=rd.device)
    t = torch.full((R,), INF, dtype=rd.dtype, device=rd.device)
    normal = torch.zeros_like(rd)
    material = torch.zeros((R,), dtype=torch.int32, device=rd.device)
    o, d = ro.unbind(1), rd.unbind(1)
    in_s = center = None

    if S:
        in_s = (idx < S) & hit
        si = torch.clamp(idx, 0, S - 1)
        center, r = gather_rows(scene.spheres.center, si), gather_rows(scene.spheres.radius, si)
        L = (center[:, 0] - o[0], center[:, 1] - o[1], center[:, 2] - o[2])
        proj = math3d.dot3(*d, *L)
        perp2 = math3d.fma(-proj, proj, math3d.dot3(*L, *L))
        # double-where: the unselected rays' sqrt argument is held away from
        # 0, so its unbounded derivative never reaches the backward
        arg = torch.where(in_s, r * r - perp2, 1.0)
        t = torch.where(in_s, proj - torch.sqrt(torch.clamp(arg, min=1e-20)), t)
        material = torch.where(in_s, gather_rows(scene.spheres.material, si), material)

    if P:
        in_p = (idx >= S) & (idx < S + P) & hit
        pi = torch.clamp(idx - S, 0, P - 1)
        n_p, o_p = gather_rows(scene.planes.normal, pi), gather_rows(scene.planes.origin, pi)
        denom = math3d.dot3(*d, *n_p.unbind(1))
        denom = torch.where(in_p & (denom != 0.0), denom, 1.0)
        num = math3d.dot3(o_p[:, 0] - o[0], o_p[:, 1] - o[1], o_p[:, 2] - o[2], *n_p.unbind(1))
        t = torch.where(in_p, num / denom, t)
        normal = torch.where(in_p[:, None], n_p, normal)
        material = torch.where(in_p, gather_rows(scene.planes.material, pi), material)

    if T:
        in_t = (idx >= S + P) & hit
        ti = torch.clamp(idx - S - P, 0, T - 1)
        tr = scene.triangles
        v0 = gather_rows(tr.v0, ti).unbind(1)
        e1 = tuple(a - b for a, b in zip(gather_rows(tr.v1, ti).unbind(1), v0))
        e2 = tuple(a - b for a, b in zip(gather_rows(tr.v2, ti).unbind(1), v0))
        h = math3d.cross3(*d, *e2)
        a = math3d.dot3(*e1, *h)
        a = torch.where(in_t & (torch.abs(a) >= FLT_EPSILON), a, 1.0)
        s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
        q = math3d.cross3(*s, *e1)
        t = torch.where(in_t, (1.0 / a) * math3d.dot3(*e2, *q), t)
        normal = torch.where(in_t[:, None], gather_rows(tr.normal, ti), normal)
        material = torch.where(in_t, gather_rows(tr.material, ti), material)

    t_safe = torch.where(hit, t, zero)
    point = math3d.fma(rd, t_safe[:, None], ro)
    if S:
        # the sphere normal is normalized after the selection (reference:
        # source/Scene.cpp:40); double-where keeps the unselected argument
        # away from 0
        dvec = torch.where(in_s[:, None], point - center, 1.0)
        normal = torch.where(in_s[:, None], math3d.normalize_safe(dvec), normal)
    return HitRecords(hit=hit, t=torch.where(hit, t, INF), point=point, normal=normal,
                      material=material)
