"""What the CUDA kernels compute, in plain tensor ops: the shared pieces of
every kernel's plain version.

The kernels (``csrc/*.cu``) and these functions share one arithmetic, op
for op: dot and cross products and the points ``o + t*d`` are fused where
the kernels call ``fmaf`` (``raytpu_torch.core.math3d`` says why), and
every divisor is a tensor, so that CUDA divides rather than multiplying by
a rounded reciprocal.  The plain versions test every primitive (no cull):
the kernels' culls are conservative, so the result is the same.

Closest hits fold spheres, then planes, then triangles with a strict
``<``, so a tie goes to the first primitive in that order.  Triangles are
taken in chunks of columns of a (rays x triangles) t-matrix, whose first
minimum is the first triangle of the chunk at that t: the same winner as a
loop over triangles one at a time.

The scene buffer of the whole-frame kernels (K1 ``mega.cu``, K2a and K2b
``mega2.cu``) is one contiguous float32 tensor on the scene's device:

  [cam 16 | spheres S x 11 | planes P x 11 | triangles T x 20 | lights L x 8]

  cam:      origin(3) right(3) up(3) forward(3) fov_scale aspect 0 0
  sphere:   center(3) radius^2                    | material(7)
  plane:    normal(3) dot(origin, normal)         | material(7)
  triangle: v0(3) e1(3) e2(3) normal(3) cull      | material(7)
  light:    position-or-direction(3) color(3) intensity kind
  material: kind r g b p0 p1 p2

Directional lights keep their direction in the position slot.
"""

from __future__ import annotations

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import LightingMode, RenderConfig, Scene

CAM_COLS, SPH_COLS, PLN_COLS, TRI_COLS, LIGHT_COLS = 16, 11, 11, 20, 8
FLT_EPSILON = 1.1920929e-07
FLT_MAX = torch.finfo(torch.float32).max  # 3.4028235e38
INF = float("inf")
#: (rays x triangles) elements of one triangle chunk's t-matrix, by device:
#: on the CPU a chunk's temporaries stay in cache, on a card a chunk is large
#: enough that launches do not dominate
CHUNK_ELEMS = {"cpu": 1 << 18, "cuda": 1 << 24}


def pack_lights(lights):
    """(L, 8): [pos|dir, color, intensity, kind]."""
    lpos = torch.where((lights.kind == 0)[:, None], lights.position, lights.direction)
    return torch.cat([lpos, lights.color, lights.intensity[:, None],
                      lights.kind.to(torch.float32)[:, None]], dim=1)


def material_table(mats):
    """(M, 7): [kind, rgb, p0 p1 p2] per material."""
    return torch.cat([mats.kind.to(torch.float32)[:, None], mats.color, mats.params], dim=1)


def mega_pack(scene: Scene, config: RenderConfig):
    """The whole-frame kernels' scene buffer (1-D float32, contiguous, on the
    scene's device) and the counts (S, P, T, L)."""
    mat_table = material_table(scene.materials)
    dev = scene.device
    right, up, fwd = scene.camera.onb()
    cam = torch.cat([
        scene.camera.origin, right, up, fwd, scene.camera.fov_scale[None],
        math3d.scalar(config.aspect_ratio, dev)[None], torch.zeros(2, device=dev),
    ])
    sph, pln, tr = scene.spheres, scene.planes, scene.triangles
    sph_blob = torch.cat([sph.center, (sph.radius * sph.radius)[:, None],
                          mat_table[sph.material.long()]], dim=1)
    pl_d = math3d.dot(pln.origin, pln.normal)
    pl_blob = torch.cat([pln.normal, pl_d[:, None], mat_table[pln.material.long()]], dim=1)
    tri_blob = torch.cat([tr.v0, tr.v1 - tr.v0, tr.v2 - tr.v0, tr.normal,
                          tr.cull.to(torch.float32)[:, None], mat_table[tr.material.long()]], dim=1)
    buf = torch.cat([cam, sph_blob.reshape(-1), pl_blob.reshape(-1), tri_blob.reshape(-1),
                     pack_lights(scene.lights).reshape(-1)])
    return buf.contiguous(), (sph.count, pln.count, tr.count, scene.lights.count)


def mega_unpack(buf, counts):
    """(cam (16,), spheres (S,11), planes (P,11), triangles (T,20), lights (L,8))."""
    S, P, T, L = counts
    cam = buf[:CAM_COLS]
    o = CAM_COLS
    sph = buf[o:o + SPH_COLS * S].reshape(S, SPH_COLS)
    o += SPH_COLS * S
    pln = buf[o:o + PLN_COLS * P].reshape(P, PLN_COLS)
    o += PLN_COLS * P
    tri = buf[o:o + TRI_COLS * T].reshape(T, TRI_COLS)
    o += TRI_COLS * T
    return cam, sph, pln, tri, buf[o:o + LIGHT_COLS * L].reshape(L, LIGHT_COLS)


_dot3, _fma = math3d.dot3, math3d.fma


def _sqn(x, y, z):
    return _dot3(x, y, z, x, y, z)


# Per-primitive tests.  ``s``/``p``/``k`` are sequences of the record's
# columns, ``o``/``d`` of the ray's components; all broadcast, so (R,1) ray
# columns against (1,N) record rows give (R,N) t-matrices.

def sphere_t(s, o, d, lo, hi):
    """Geometric near-root test, valid on [lo, hi] (mega.cu:sphere_t)."""
    lx, ly, lz = s[0] - o[0], s[1] - o[1], s[2] - o[2]
    l2 = _sqn(lx, ly, lz)
    proj = _dot3(d[0], d[1], d[2], lx, ly, lz)
    perp2 = _fma(-proj, proj, l2)
    inside = s[3] >= perp2
    tc = proj - torch.sqrt(torch.where(inside, s[3] - perp2, 1.0))
    return torch.where(inside & (tc >= lo) & (tc <= hi), tc, INF)


def plane_t(p, o, d, lo, hi):
    """``(d - dot(o, n)) / dot(rd, n)``, valid on [lo, hi) (mega.cu:plane_t)."""
    denom = _dot3(d[0], d[1], d[2], p[0], p[1], p[2])
    num = p[3] - _dot3(o[0], o[1], o[2], p[0], p[1], p[2])
    nz = denom != 0.0
    tc = num / torch.where(nz, denom, 1.0)
    return torch.where(nz & (tc >= lo) & (tc < hi), tc, INF)


def tri_t(k, o, d, lo, hi, shadow: bool):
    """Möller–Trumbore with cull modes, valid on [lo, hi); a shadow ray
    swaps front- and back-face culling (mega.cu:tri_t)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz, cull = (k[i] for i in range(13))
    cull_dot = _dot3(nx, ny, nz, d[0], d[1], d[2])
    not_par = torch.abs(cull_dot) >= FLT_EPSILON
    cull_eff = torch.where(cull == 2.0, 2.0, (1.0 - cull) if shadow else cull)
    culled = ((cull_eff == 0.0) & (cull_dot < 0.0)) | ((cull_eff == 1.0) & (cull_dot > 0.0))
    hx, hy, hz = math3d.cross3(d[0], d[1], d[2], e2x, e2y, e2z)
    a = _dot3(e1x, e1y, e1z, hx, hy, hz)
    det_ok = torch.abs(a) >= FLT_EPSILON
    inv_a = 1.0 / torch.where(det_ok, a, 1.0)
    sx, sy, sz = o[0] - v0x, o[1] - v0y, o[2] - v0z
    u = inv_a * _dot3(sx, sy, sz, hx, hy, hz)
    qx, qy, qz = math3d.cross3(sx, sy, sz, e1x, e1y, e1z)
    v = inv_a * _dot3(d[0], d[1], d[2], qx, qy, qz)
    tc = inv_a * _dot3(e2x, e2y, e2z, qx, qy, qz)
    ok = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(not_par & ~culled & det_ok & ok & (tc >= lo) & (tc < hi), tc, INF)


def _col(x):
    return x[:, None] if isinstance(x, torch.Tensor) and x.ndim == 1 else x


def _rows(table, n):
    return tuple(table[None, :, c] for c in range(n))


def _tri_chunks(T, R, device):
    step = max(1, CHUNK_ELEMS.get(device.type, 1 << 18) // max(R, 1))
    return ((j, min(j + step, T)) for j in range(0, T, step))


def closest_plain(sph, pln, tri, ro, rd, tmin):
    """Winner search over every primitive: ``(t (R,), idx (R,) int64)``,
    ``t`` = inf and ``idx`` = 0 on a miss, ``idx`` running over spheres ->
    planes -> triangles.  Tables are the kernels' records (any width; the
    leading columns are the geometry); ``ro``/``rd`` are 3-tuples of (R,)
    tensors or scalars."""
    R = rd[0].shape[0]
    o, d = tuple(_col(x) for x in ro), tuple(_col(x) for x in rd)
    S, P, T = sph.shape[0], pln.shape[0], tri.shape[0]
    t = torch.full((R,), INF, dtype=torch.float32, device=rd[0].device)
    idx = torch.zeros((R,), dtype=torch.long, device=rd[0].device)

    def fold(tmat, base):
        nonlocal t, idx
        tc, k = tmat.min(dim=1)  # the first minimum of the block
        sel = tc < t
        t = torch.where(sel, tc, t)
        idx = torch.where(sel, k + base, idx)

    if S:
        fold(sphere_t(_rows(sph, 4), o, d, tmin, INF), 0)
    if P:
        fold(plane_t(_rows(pln, 4), o, d, tmin, INF), S)
    for a, b in _tri_chunks(T, R, rd[0].device):
        fold(tri_t(_rows(tri[a:b], 13), o, d, tmin, INF, shadow=False), S + P + a)
    return t, idx


def any_hit_plain(sph, pln, tri, ro, rd, tmin, tmax):
    """(R,) bool: some primitive lies on the shadow ray within [tmin, tmax)
    ([tmin, tmax] for spheres); triangle culling inverted.  ``tmax`` is (R,)."""
    R = rd[0].shape[0]
    o, d, hi = tuple(_col(x) for x in ro), tuple(_col(x) for x in rd), _col(tmax)
    S, P, T = sph.shape[0], pln.shape[0], tri.shape[0]
    occ = torch.zeros((R,), dtype=torch.bool, device=rd[0].device)
    if S:
        occ |= (sphere_t(_rows(sph, 4), o, d, tmin, hi) < INF).any(dim=1)
    if P:
        occ |= (plane_t(_rows(pln, 4), o, d, tmin, hi) < INF).any(dim=1)
    for a, b in _tri_chunks(T, R, rd[0].device):
        occ |= (tri_t(_rows(tri[a:b], 13), o, d, tmin, hi, shadow=True) < INF).any(dim=1)
    return occ


def camera_rays(cam, px, py, W: int, H: int):
    """K1's raygen for pixel indices ``px``, ``py``: ``(ro, rd)`` as
    3-tuples, ``ro`` the camera origin's scalars.  cx = ((2u-1)*aspect)*fov
    (reference: source/Renderer.cpp:104-114)."""
    ux = (px.to(torch.float32) + 0.5) / math3d.as_divisor(W, cam)
    uy = (py.to(torch.float32) + 0.5) / math3d.as_divisor(H, cam)
    cx = (2.0 * ux - 1.0) * cam[13] * cam[12]
    cy = (1.0 - 2.0 * uy) * cam[12]
    dx = cx * cam[3] + cy * cam[6] + cam[9]
    dy = cx * cam[4] + cy * cam[7] + cam[10]
    dz = cx * cam[5] + cy * cam[8] + cam[11]
    d_len = torch.sqrt(_sqn(dx, dy, dz))
    return (cam[0], cam[1], cam[2]), (dx / d_len, dy / d_len, dz / d_len)


def closest_records(sph, pln, tri, ro, rd, tmin):
    """The whole-frame kernels' closest hit with its payload: ``(t (R,),
    normal 3-tuple, material 7-tuple)``; a miss has t = inf and zeros.  A
    sphere's normal is normalized after the selection (reference:
    source/Scene.cpp:40); spheres and planes are (N, 11) and triangles
    (T, 20) records of the scene buffer."""
    t, idx = closest_plain(sph, pln, tri, ro, rd, tmin)
    S = sph.shape[0]
    pay = torch.cat([torch.cat([sph[:, 0:3], sph[:, 4:11]], dim=1),
                     torch.cat([pln[:, 0:3], pln[:, 4:11]], dim=1),
                     torch.cat([tri[:, 9:12], tri[:, 13:20]], dim=1)])
    hit = t < INF
    if pay.shape[0] == 0:
        zero = torch.zeros_like(t)
        return t, (zero,) * 3, (zero,) * 7
    g = torch.where(hit[:, None], pay[idx], 0.0)
    ts = torch.where(hit, t, 0.0)
    is_sph = hit & (idx < S)
    c = [_fma(ts, rd[i], ro[i]) - g[:, i] for i in range(3)]
    n_len = torch.sqrt(torch.clamp(_sqn(*c), min=1e-20))
    n = tuple(torch.where(is_sph, c[i] / n_len, g[:, i]) for i in range(3))
    return t, n, tuple(g[:, 3 + i] for i in range(7))


def _shade_one_light(mode, is_point, lp, lcol, lint, p, n, l, v, mat):
    """Per-light contribution (pallas_kernel.py:_shade_one_light): radiance at
    the UNOFFSET hit point, the material-kind select, the four lighting modes."""
    mk, mr, mg, mb, m0, m1, m2 = mat
    rdx, rdy, rdz = lp[0] - p[0], lp[1] - p[1], lp[2] - p[2]
    rad_scale = torch.where(is_point, lint / _sqn(rdx, rdy, rdz), lint)
    ndl = _dot3(*n, *l)
    oa = torch.clamp(ndl, min=0.0)
    if mode == LightingMode.OBSERVED_AREA:
        return oa, oa, oa
    if mode == LightingMode.RADIANCE:
        return rad_scale * lcol[0], rad_scale * lcol[1], rad_scale * lcol[2]
    pi = math3d.as_divisor(math3d.PI, oa)
    lam = (mr * m0 / pi, mg * m0 / pi, mb * m0 / pi)
    two_ndl = 2.0 * oa
    rf = (l[0] - two_ndl * n[0], l[1] - two_ndl * n[1], l[2] - two_ndl * n[2])
    cosa = torch.clamp(_dot3(*rf, *v), min=0.0)
    spec_p = m1 * torch.pow(cosa, m2)
    h = (v[0] + l[0], v[1] + l[1], v[2] + l[2])
    h_len = torch.clamp(torch.sqrt(_sqn(*h)), min=1e-20)
    h = (h[0] / h_len, h[1] / h_len, h[2] / h_len)
    diel = m0 == 0.0
    hdv = torch.clamp(_dot3(*h, *v), min=0.0)
    w = 1.0 - hdv
    w2 = w * w
    fres_w = w * (w2 * w2)  # JAX's integer power: x * (x^2)^2
    a_ = m1 * m1
    sqr_a = a_ * a_
    ndh = torch.clamp(_dot3(*n, *h), min=0.0)
    dden = ndh * ndh * (sqr_a - 1.0) + 1.0
    D = sqr_a / (pi * dden * dden)
    kk = (a_ + 1.0) * (a_ + 1.0) / 8.0
    ndv = torch.clamp(_dot3(*n, *v), min=0.0)
    G = (ndv / (ndv * (1.0 - kk) + kk)) * (oa / (oa * (1.0 - kk) + kk))
    spec_s = D * G / (4.0 * torch.clamp(ndv, min=1e-4) * torch.clamp(oa, min=1e-4))
    brdf = []
    for c, lam_c in zip((mr, mg, mb), lam):
        f0 = torch.where(diel, 0.04, c)
        F = f0 + (1.0 - f0) * fres_w
        ct = torch.where(diel, c * (1.0 - F) / pi, 0.0) + F * spec_s
        brdf.append(torch.where(mk == 0.0, c, torch.where(
            mk == 1.0, lam_c, torch.where(mk == 2.0, lam_c + spec_p, ct))))
    if mode == LightingMode.BRDF:
        return tuple(brdf)
    # COMBINED: ((oa * (color*scale)) * brdf), the jnp path's op order
    return tuple(oa * (lc * rad_scale) * b for lc, b in zip(lcol, brdf))


def shade_records(sph, pln, tri, lit, config: RenderConfig, ro, rd, t, n, mat):
    """The whole-frame kernels' tail from the closest hit: one shadow ray
    per light from the offset hit point, shading, 0.95 dim per occluded
    light, MaxToOne.  Returns the (R, 3) colors; a miss is black."""
    tmin = float(config.ray_min)
    hit = t < INF
    ts = torch.where(hit, t, 0.0)
    pt = tuple(_fma(ts, rd[i], ro[i]) for i in range(3))
    po = tuple(_fma(n[i], float(config.normal_offset), pt[i]) for i in range(3))
    view = (-rd[0], -rd[1], -rd[2])
    zero = torch.zeros_like(t)
    color = [zero, zero, zero]
    sf = torch.ones_like(t)
    for li in range(lit.shape[0]):
        row = lit[li]
        lp, lcol, lint = row[0:3], row[3:6], row[6]
        is_point = row[7] == 0.0
        ld = (lp[0] - po[0], lp[1] - po[1], lp[2] - po[2])
        mag_pt = torch.sqrt(_sqn(*ld))
        l = tuple(torch.where(is_point, ld[i] / mag_pt, -lp[i]) for i in range(3))
        mag = torch.where(is_point, mag_pt, FLT_MAX)
        if config.shadows:
            occ = any_hit_plain(sph, pln, tri, po, l, tmin, mag)
            lit_mask = ~(occ & hit)
            sf = sf * torch.where(lit_mask, 1.0, float(config.shadow_dim))
        else:
            lit_mask = torch.ones_like(hit)
        w = _shade_one_light(config.lighting_mode, is_point, lp, lcol, lint, pt, n, l, view, mat)
        color = [c + torch.where(lit_mask, wc, 0.0) for c, wc in zip(color, w)]
    return dim_and_tonemap(color, sf, hit)


def dim_and_tonemap(color, sf, hit):
    """The kernels' tail (common.cuh:dim_and_tonemap): the summed color (a
    3-sequence of (R,)) times the shadow factor ``sf`` where ``hit``, black
    elsewhere, then MaxToOne -> (R, 3)."""
    color = [torch.where(hit, c * sf, 0.0) for c in color]
    mx = torch.maximum(color[0], torch.maximum(color[1], color[2]))
    over = mx > 1.0
    # a division, not a multiply by the reciprocal
    color = [torch.where(over, c / mx, c) for c in color]
    return torch.stack(color, dim=-1)


# -- the chunked route's kernels (csrc/chunked.cu) -----------------------------

#: raytpu's index of a miss (pallas_kernel.py:BIG_I), K8's too
BIG_I = 2 ** 30


def chunked_min_t_plain(ro, rd, tmax, sph, pln, tri, tmin, shadow: bool):
    """What K8 computes, over every primitive, for rays ``ro``, ``rd`` (R,3)
    bounded by ``tmax`` (R,) or, when None, unbounded; tables as
    ``packed.soft_packs`` lays them out.

    Closest mode (``tmax`` None): ``(t, idx, normal, material)``: t = inf, idx = ``BIG_I``,
    normal and material 0 on a miss; a sphere's normal is the hit point
    minus the center, unnormalized (pallas_kernel.py:_sphere_t_matrix).
    Shadow mode (triangle culling inverted, t in [tmin, tmax)): ``(t, None,
    None, None)``, t the first occluder's in primitive order, as the kernel
    stops there, or inf."""
    R = rd.shape[0]
    o, d = tuple(_col(x) for x in ro.unbind(1)), tuple(_col(x) for x in rd.unbind(1))
    hi = INF if tmax is None else _col(tmax)
    if shadow:
        t = torch.full((R,), INF, dtype=torch.float32, device=rd.device)

        def first(tmat):  # the first finite column where no occluder was found yet
            nonlocal t
            found = tmat < INF
            k = found.to(torch.uint8).argmax(dim=1, keepdim=True)
            t = torch.where((t == INF) & found.any(dim=1), tmat.gather(1, k)[:, 0], t)

        if sph.shape[0]:
            first(sphere_t(_rows(sph, 4), o, d, tmin, hi))
        if pln.shape[0]:
            first(plane_t(_rows(pln, 4), o, d, tmin, hi))
        for a, b in _tri_chunks(tri.shape[0], R, rd.device):
            first(tri_t(_rows(tri[a:b], 13), o, d, tmin, hi, shadow=True))
        return t, None, None, None
    t, idx = closest_plain(sph, pln, tri, ro.unbind(1), rd.unbind(1), tmin)
    hit = t < INF
    pay = torch.cat([sph[:, [0, 1, 2, 4]], pln[:, [0, 1, 2, 4]], tri[:, [9, 10, 11, 13]]])
    if pay.shape[0] == 0:
        pay = torch.zeros((1, 4), dtype=torch.float32, device=rd.device)
    g = torch.where(hit[:, None], pay[idx], 0.0)
    is_sph = hit & (idx < sph.shape[0])
    ts = torch.where(hit, t, 0.0)
    normal = torch.stack([torch.where(is_sph, _fma(ts, rd[:, i], ro[:, i]) - g[:, i], g[:, i])
                          for i in range(3)], dim=1)
    return (t, torch.where(hit, idx, BIG_I).to(torch.int32), normal,
            g[:, 3].to(torch.int32))


def shadow_shade_plain(hit, normal, point, mat, rd, p_off, dirs, mags, lights, mats, sph, pln,
                       tri, config: RenderConfig):
    """What K10 computes, over every primitive: for the hit records ``hit``
    (R,) bool, ``normal``, ``point`` (R,3) and ``mat`` (R,) material ids of
    rays ``rd`` (R,3), every light's shadow query from ``p_off`` (R,3) along
    ``dirs`` (L,R,3) up to ``mags`` (L,R) when ``config.shadows``, the
    shading of the lit lights (``lights`` (L,8) as ``pack_lights``, ``mats``
    (M,7) as ``material_table``), the dim per occluded light and MaxToOne
    -> (R,3) colors, rounded as ``shade_records`` rounds K1's."""
    tmin = float(config.ray_min)
    m = tuple(mats[mat.long()].unbind(1))
    n, pt, po = normal.unbind(1), point.unbind(1), p_off.unbind(1)
    view = tuple(-x for x in rd.unbind(1))
    zero = torch.zeros_like(rd[:, 0])
    color, sf = [zero, zero, zero], torch.ones_like(zero)
    for li in range(lights.shape[0]):
        row = lights[li]
        l = dirs[li].unbind(1)
        lit_mask = torch.ones_like(hit)
        if config.shadows:
            lit_mask = ~(any_hit_plain(sph, pln, tri, po, l, tmin, mags[li]) & hit)
            sf = sf * torch.where(lit_mask, 1.0, float(config.shadow_dim))
        w = _shade_one_light(config.lighting_mode, row[7] == 0.0, row[0:3], row[3:6], row[6], pt,
                             n, l, view, m)
        color = [c + torch.where(lit_mask, wc, 0.0) for c, wc in zip(color, w)]
    return dim_and_tonemap(color, sf, hit)
