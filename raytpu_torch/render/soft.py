"""The soft-shadow transmittance and its VJP: K5, K6 and K7 with their
worklists and plain versions.

Counterpart of the soft half of ``raytpu/render/pallas_soft.py``
(``soft_trans_lights_pallas``, ``soft_dray_pallas``, ``soft_dprim_pallas``
and their streamed forms).  The kernels are ``csrc/soft.cu``:

  * K5 (``soft_trans_lights_cuda``): every light's transmittance (L, R) of
    the shadow rays, the product of ``1 - occ`` over the spheres, the planes
    and the triangles of each (tile, light) worklist, each ray skipping the
    groups whose soft normal record (``soft_boxes``) its segment misses, all
    of whose factors are exactly 1.0f;
  * K6 (``soft_dray``): K5's VJP on the ray side, ``g_p`` (R, 3) summed
    over lights, ``g_dirs`` (L, R, 3) and ``g_mags`` (L, R), each ray
    skipping the groups whose gradient record (``grad_boxes``) its segment
    misses, whose partials are all exactly 0.0f; a thread per (ray, light)
    writes its light's ``g_p`` to a scratch that a second kernel sums over
    the lights in order;
  * K7 (``soft_dprim``): K5's VJP on the triangles, ``[g_s, g_e1, g_e2]``
    (T, 9) summed over rays and lights, with s = p - v0, e1 = v1 - v0 and
    e2 = v2 - v0, each ray skipping the groups whose gradient record
    (``grad_boxes``) its segment misses, all of whose partials are exactly
    0.0f.  It sums with atomics, so its last bits vary from run to run.

The worklists are K4's shadow culls over group boxes widened by the
sigmoid's support (``soft_worklists``); the forward builds them once and
the backward reuses them.  Each wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.  A
plain version tests every primitive, so it differs from its kernel only by
the clipped sigmoid tail, under ~2e-9 per primitive, and by the order of
its sums.  Its arithmetic is the kernel's, op for op (``plain``'s
docstring says how it rounds); it writes out the kernel's analytic
partials, not autograd's.
"""

from __future__ import annotations

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import Scene
from raytpu_torch.ops import accel
from raytpu_torch.ops.intersect import OCC_MAX
from raytpu_torch.render import build, packed, plain
from raytpu_torch.render.packed import SP_COLS, TILE, TRI_COLS

FLT_EPSILON = plain.FLT_EPSILON

#: Launches of K5, K6 and K7, counted where the wrappers launch them.  K6
#: is two kernels, its walk and its sum over the lights, each counted.
SOFT_TRANS_LAUNCHES = 0
SOFT_DRAY_LAUNCHES = 0
SOFT_DRAY_SUM_LAUNCHES = 0
SOFT_DPRIM_LAUNCHES = 0

_dot3, _fma, _cross3 = math3d.dot3, math3d.fma, math3d.cross3


def soft_worklists(scene: Scene, p, dirs, mags, tmin, beta, group_bounds=None):
    """K5-K7's worklists ``(wl (nt, L, ng) int32, cnt (nt, L) int32)``:
    K4's shadow culls over group boxes widened by the soft slack.
    ``group_bounds``: the groups' ``accel.chunk_bounds`` where the caller
    has them."""
    return packed.shadow_worklists(scene, p, dirs, mags, tmin, soft_beta=beta,
                                   group_bounds=group_bounds)


def soft_boxes(scene: Scene, p, dirs, mags, tmin, beta):
    """K5's per-step inputs from one set of group bounds: the soft normal
    records (``accel.normal_boxes`` with ``beta``: a segment that misses one
    meets no triangle whose factor differs from 1.0f) and the worklists
    ``(boxes, wl, cnt)``."""
    glo, ghi, boxes = accel.normal_boxes(scene.triangles, soft_beta=beta)
    return (boxes, *soft_worklists(scene, p, dirs, mags, tmin, beta, group_bounds=(glo, ghi)))


def grad_boxes(scene: Scene, beta):
    """K6's and K7's gradient records: ``accel.normal_boxes`` padded for the soft
    VJP's support (``accel.GRAD_SUPPORT``: a segment that misses one meets
    no triangle with a partial other than 0.0f)."""
    return accel.normal_boxes(scene.triangles, soft_beta=beta, support=accel.GRAD_SUPPORT)[2]


def soft_trans_lights_kernel(scene: Scene, p, dirs, mags, tmin, beta):
    """(L, R) transmittance of the shadow rays ``p`` (R,3), ``dirs``
    (L,R,3), ``mags`` (L,R) through K5, with what K6 and K7 need:
    ``(trans, (blobs, wl, cnt))``."""
    p, dirs, mags = p.contiguous(), dirs.contiguous(), mags.contiguous()
    blobs = packed.soft_packs(scene)
    boxes, wl, cnt = soft_boxes(scene, p, dirs, mags, tmin, beta)
    return (soft_trans_lights_cuda(p, dirs, mags, *blobs, boxes, wl, cnt, tmin, beta),
            (blobs, wl, cnt))


def _check(what, p, dirs, mags, sph, pln, tri, wl, cnt, extra=None):
    L, R, S, P, T = dirs.shape[0], p.shape[0], sph.shape[0], pln.shape[0], tri.shape[0]
    nt = -(-R // TILE)
    spec = {"p": (p, torch.float32, (R, 3)), "dirs": (dirs, torch.float32, (L, R, 3)),
            "mags": (mags, torch.float32, (L, R)),
            "spheres": (sph, torch.float32, (S, SP_COLS)),
            "planes": (pln, torch.float32, (P, SP_COLS)),
            "triangles": (tri, torch.float32, (T, TRI_COLS)),
            "wl": (wl, torch.int32, (nt, L, wl.shape[-1])), "cnt": (cnt, torch.int32, (nt, L))}
    for name, x in (extra or {}).items():
        spec[name] = (x, torch.float32, (L, R))
    build.check_tensors(what, p.device, spec)
    return L, R, S, P, T


def soft_trans_lights_cuda(p, dirs, mags, sph, pln, tri, boxes, wl, cnt, tmin, beta):
    """K5 over shadow rays and the records of ``packed.soft_packs``, walking
    each (tile, light) worklist ``wl`` (nt, L, n) int32 up to ``cnt``
    (nt, L) and testing each ray's segment against the soft normal records
    ``boxes`` (ceil(T/8), 32) of ``soft_boxes`` before a group's triangles
    -> (L, R) float32.  CPU tensors take ``soft_trans_plain``, which needs
    no boxes."""
    global SOFT_TRANS_LAUNCHES
    if p.device.type == "cpu":
        return soft_trans_plain(p, dirs, mags, sph, pln, tri, tmin, beta)
    L, R, S, P, T = _check("K5", p, dirs, mags, sph, pln, tri, wl, cnt)
    build.check_tensors("K5", p.device, {
        "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS))})
    build.check_aligned("K5", "boxes", boxes, 16)
    trans = torch.empty((L, R), dtype=torch.float32, device=p.device)
    lib = build.load()
    with torch.cuda.device(p.device):
        err = lib.raytpu_soft_trans(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(), S,
            pln.data_ptr(), P, tri.data_ptr(), T, boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(),
            wl.shape[-1], float(tmin), float(beta), trans.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: {build.cuda_error_name(lib, err)}")
    SOFT_TRANS_LAUNCHES += 1
    return trans


def soft_dray(p, dirs, mags, g, trans, sph, pln, tri, wl, cnt, tmin, beta, boxes=None):
    """K6: the ray side of K5's VJP for the upstream cotangent ``g`` and
    K5's output ``trans`` (both (L, R)) -> ``(g_p (R,3), g_dirs (L,R,3),
    g_mags (L,R))``, walking K5's worklists ``wl``, ``cnt`` with the
    gradient records ``boxes`` (ceil(T/8), 32) of ``grad_boxes``, which
    CUDA tensors need; deterministic (no atomics).  CPU tensors take
    ``soft_dray_plain``, which needs no boxes."""
    global SOFT_DRAY_LAUNCHES, SOFT_DRAY_SUM_LAUNCHES
    if p.device.type == "cpu":
        return soft_dray_plain(p, dirs, mags, g, trans, sph, pln, tri, tmin, beta)
    if boxes is None:
        raise ValueError("K6 walks the gradient records: pass boxes (soft.grad_boxes)")
    L, R, S, P, T = _check("K6", p, dirs, mags, sph, pln, tri, wl, cnt,
                           {"g": g, "trans": trans})
    build.check_tensors("K6", p.device, {
        "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS))})
    build.check_aligned("K6", "boxes", boxes, 16)
    dev = p.device
    g_p = torch.empty((R, 3), dtype=torch.float32, device=dev)
    g_dirs = torch.empty((L, R, 3), dtype=torch.float32, device=dev)
    g_mags = torch.empty((L, R), dtype=torch.float32, device=dev)
    scratch = torch.empty((L, R, 3), dtype=torch.float32, device=dev)  # each light's g_p
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.raytpu_soft_dray(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(), S,
            pln.data_ptr(), P, tri.data_ptr(), T, boxes.data_ptr(), wl.data_ptr(),
            cnt.data_ptr(), wl.shape[-1], float(tmin), float(beta), g.data_ptr(),
            trans.data_ptr(), g_p.data_ptr(), g_dirs.data_ptr(), g_mags.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: {build.cuda_error_name(lib, err)}")
    SOFT_DRAY_LAUNCHES += 1  # the walk
    SOFT_DRAY_SUM_LAUNCHES += 1  # the light sum, launched by the same call
    return g_p, g_dirs, g_mags


def soft_dprim(p, dirs, mags, g, trans, tri, wl, cnt, tmin, beta, boxes=None):
    """K7: the triangle side of K5's VJP -> (T, 9) ``[g_s, g_e1, g_e2]``
    summed over rays and lights, in an order that varies from run to run
    (atomics), walking K5's worklists ``wl``, ``cnt`` with the gradient
    records ``boxes`` (ceil(T/8), 32) of ``grad_boxes``, which CUDA
    tensors need.  CPU tensors take ``soft_dprim_plain``, which needs no
    boxes."""
    global SOFT_DPRIM_LAUNCHES
    if p.device.type == "cpu":
        return soft_dprim_plain(p, dirs, mags, g, trans, tri, tmin, beta)
    empty = torch.zeros((0, SP_COLS), dtype=torch.float32, device=p.device)
    L, R, _, _, T = _check("K7", p, dirs, mags, empty, empty, tri, wl, cnt,
                           {"g": g, "trans": trans})
    if boxes is None:
        raise ValueError("K7 walks the gradient records: pass boxes (soft.grad_boxes)")
    build.check_tensors("K7", p.device, {
        "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS))})
    build.check_aligned("K7", "boxes", boxes, 16)
    out = torch.zeros((T, 9), dtype=torch.float32, device=p.device)
    lib = build.load()
    with torch.cuda.device(p.device):
        err = lib.raytpu_soft_dprim(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, tri.data_ptr(), T,
            boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(tmin),
            float(beta), g.data_ptr(), trans.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7 launch failed: {build.cuda_error_name(lib, err)}")
    SOFT_DPRIM_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Plain versions: soft.cu's device functions on broadcast tensors, (R,1) ray
# columns against (1,N) record rows, over every primitive.
# ---------------------------------------------------------------------------


def _soft_occ(margin, gate, beta):
    """soft.cu:soft_occ -> (occ, d occ / d margin)."""
    sig = 1.0 / (1.0 + torch.exp(-beta * margin))
    occ = torch.where(gate, torch.clamp(sig, max=OCC_MAX), 0.0)
    docc = torch.where(gate & (sig < OCC_MAX), beta * sig * (1.0 - sig), 0.0)
    return occ, docc


def _sphere_soft(s, o, d, tmin, mag, beta):
    """soft.cu:sphere_soft -> (occ, docc, L, proj)."""
    L = (s[0] - o[0], s[1] - o[1], s[2] - o[2])
    proj = _dot3(*d, *L)
    perp2 = _fma(-proj, proj, _dot3(*L, *L))
    margin = (s[3] - perp2) / s[3]
    inside = margin > 0.0
    t = proj - torch.sqrt(torch.where(inside, s[3] - perp2, 1.0))
    occ, docc = _soft_occ(margin, inside & (t >= tmin) & (t <= mag), beta)
    return occ, docc, L, proj


def _plane_soft(pl, o, d, tmin, mag, beta):
    """soft.cu:plane_soft -> (occ, docc, t, den, near)."""
    denom = _dot3(*d, pl[0], pl[1], pl[2])
    nz = torch.abs(denom) > FLT_EPSILON
    den = torch.where(nz, denom, 1.0)
    t = (pl[3] - _dot3(*o, pl[0], pl[1], pl[2])) / den
    m0, m1 = t - tmin, mag - t
    margin = torch.minimum(m0, m1)
    occ, docc = _soft_occ(margin, nz & (margin > 0.0), beta)
    return occ, docc, t, den, m0 <= m1


def _tri_soft(k, o, d, tmin, mag, beta):
    """soft.cu:tri_soft -> (occ, docc, u, v, w, inv_a, h, s, q)."""
    cull = k[12]
    cull_dot = _dot3(k[9], k[10], k[11], *d)
    not_par = torch.abs(cull_dot) >= FLT_EPSILON
    cull_eff = torch.where(cull == 2.0, 2.0, 1.0 - cull)  # the shadow pass inverts
    culled = ((cull_eff == 0.0) & (cull_dot < 0.0)) | ((cull_eff == 1.0) & (cull_dot > 0.0))
    h = _cross3(*d, k[6], k[7], k[8])
    a = _dot3(k[3], k[4], k[5], *h)
    det_ok = torch.abs(a) >= FLT_EPSILON
    inv_a = 1.0 / torch.where(det_ok, a, 1.0)
    s = (o[0] - k[0], o[1] - k[1], o[2] - k[2])
    u = inv_a * _dot3(*s, *h)
    q = _cross3(*s, k[3], k[4], k[5])
    v = inv_a * _dot3(*d, *q)
    t = inv_a * _dot3(k[6], k[7], k[8], *q)
    w = 1.0 - u - v
    margin = torch.minimum(torch.minimum(u, v), w)
    gate = not_par & ~culled & det_ok & (t >= tmin) & (t < mag)
    occ, docc = _soft_occ(margin, gate, beta)
    return occ, docc, u, v, w, inv_a, h, s, q


def _tri_grad(u, v, w, inv_a, g_m):
    """soft.cu:tri_grad -> (g_Nu, g_Nv, g_a)."""
    su = (u <= v) & (u <= w)
    sv = ~su & (v <= w)
    sw = ~su & ~sv
    g_u = g_m * (su.to(g_m.dtype) - sw.to(g_m.dtype))
    g_v = g_m * (sv.to(g_m.dtype) - sw.to(g_m.dtype))
    return g_u * inv_a, g_v * inv_a, -(g_u * u + g_v * v) * inv_a


def _ray_cols(p, dirs, mags, li):
    """(o, d, mag) of light ``li``'s shadow rays as (R,1) columns."""
    return (tuple(p[:, c:c + 1] for c in range(3)),
            tuple(dirs[li, :, c:c + 1] for c in range(3)), mags[li][:, None])


def _rows(table, n):
    return tuple(table[None, :, c] for c in range(n))


def soft_trans_plain(p, dirs, mags, sph, pln, tri, tmin, beta):
    """What K5 computes, over every primitive."""
    L, R, T = dirs.shape[0], p.shape[0], tri.shape[0]
    out = []
    for li in range(L):
        o, d, mag = _ray_cols(p, dirs, mags, li)
        tr = torch.ones((R,), dtype=torch.float32, device=p.device)
        if sph.shape[0]:
            tr = tr * torch.prod(1.0 - _sphere_soft(_rows(sph, 4), o, d, tmin, mag, beta)[0], dim=1)
        if pln.shape[0]:
            tr = tr * torch.prod(1.0 - _plane_soft(_rows(pln, 4), o, d, tmin, mag, beta)[0], dim=1)
        for a, b in plain._tri_chunks(T, R, p.device):
            occ = _tri_soft(_rows(tri[a:b], 13), o, d, tmin, mag, beta)[0]
            tr = tr * torch.prod(1.0 - occ, dim=1)
        out.append(tr)
    return torch.stack(out) if out else torch.zeros((0, R), dtype=torch.float32, device=p.device)


def soft_dray_plain(p, dirs, mags, g, trans, sph, pln, tri, tmin, beta):
    """What K6 computes, over every primitive: the partials of soft.cu's
    soft_dray_kernel summed over primitives, then over lights for g_p."""
    L, R, T = dirs.shape[0], p.shape[0], tri.shape[0]
    g_p = torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    g_dirs, g_mags = [], []
    for li in range(L):
        o, d, mag = _ray_cols(p, dirs, mags, li)
        gob = (-g[li] * trans[li])[:, None]
        gp = [torch.zeros((R,), dtype=torch.float32, device=p.device) for _ in range(3)]
        gl = [torch.zeros_like(gp[0]) for _ in range(3)]
        gm = torch.zeros_like(gp[0])
        if sph.shape[0]:
            s = _rows(sph, 4)
            occ, docc, Lv, proj = _sphere_soft(s, o, d, tmin, mag, beta)
            g_m = gob / (1.0 - occ) * docc
            c2 = 2.0 * (-g_m / s[3])
            for c in range(3):
                gp[c] = gp[c] + (-c2 * (Lv[c] - proj * d[c])).sum(dim=1)
                gl[c] = gl[c] + (-c2 * proj * Lv[c]).sum(dim=1)
        if pln.shape[0]:
            pl = _rows(pln, 4)
            occ, docc, t, den, near = _plane_soft(pl, o, d, tmin, mag, beta)
            g_m = gob / (1.0 - occ) * docc
            g_t = torch.where(near, g_m, -g_m)
            g_num = g_t / den
            g_den = -g_t * t / den
            for c in range(3):
                gp[c] = gp[c] + (-g_num * pl[c]).sum(dim=1)
                gl[c] = gl[c] + (g_den * pl[c]).sum(dim=1)
            gm = gm + torch.where(near, 0.0, g_m).sum(dim=1)
        for a, b in plain._tri_chunks(T, R, p.device):
            k = _rows(tri[a:b], 13)
            occ, docc, u, v, w, inv_a, h, s, q = _tri_soft(k, o, d, tmin, mag, beta)
            g_m = gob / (1.0 - occ) * docc
            g_nu, g_nv, g_a = _tri_grad(u, v, w, inv_a, g_m)
            e1d = _cross3(k[3], k[4], k[5], *d)
            e2s = _cross3(k[6], k[7], k[8], *s)
            e21 = _cross3(k[6], k[7], k[8], k[3], k[4], k[5])
            for c in range(3):
                gp[c] = gp[c] + (g_nu * h[c] + g_nv * e1d[c]).sum(dim=1)
                gl[c] = gl[c] + (g_nu * e2s[c] + g_nv * q[c] + g_a * e21[c]).sum(dim=1)
        g_p = g_p + torch.stack(gp, dim=1)
        g_dirs.append(torch.stack(gl, dim=1))
        g_mags.append(gm)
    if not g_dirs:
        return g_p, torch.zeros_like(dirs), torch.zeros_like(mags)
    return g_p, torch.stack(g_dirs), torch.stack(g_mags)


def soft_dprim_plain(p, dirs, mags, g, trans, tri, tmin, beta):
    """What K7 computes, over every primitive: (T, 9) ``[g_s, g_e1, g_e2]``
    summed over rays and lights."""
    L, R, T = dirs.shape[0], p.shape[0], tri.shape[0]
    out = torch.zeros((T, 9), dtype=torch.float32, device=p.device)
    for li in range(L):
        o, d, mag = _ray_cols(p, dirs, mags, li)
        gob = (-g[li] * trans[li])[:, None]
        for a, b in plain._tri_chunks(T, R, p.device):
            k = _rows(tri[a:b], 13)
            occ, docc, u, v, w, inv_a, h, s, q = _tri_soft(k, o, d, tmin, mag, beta)
            g_m = gob / (1.0 - occ) * docc
            g_nu, g_nv, g_a = _tri_grad(u, v, w, inv_a, g_m)
            e1d = _cross3(k[3], k[4], k[5], *d)
            ds = _cross3(*d, *s)
            parts = ([g_nu * h[c] + g_nv * e1d[c] for c in range(3)]
                     + [g_nv * ds[c] + g_a * h[c] for c in range(3)]
                     + [-g_nu * ds[c] + g_a * e1d[c] for c in range(3)])
            out[a:b] += torch.stack([x.sum(dim=0) for x in parts], dim=1)
    return out
