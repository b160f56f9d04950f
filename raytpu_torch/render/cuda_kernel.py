"""The whole-frame megakernel (K1) and the router in front of it.

Counterpart of the megakernel part of ``raytpu/render/pallas_kernel.py``:
``pack_lights``, ``_mega_pack``, ``render_image_mega_f32``, ``route_kind``
and ``render_image_f32`` / ``render_image``.  The kernel itself is
``csrc/mega.cu``; it replaces ``pallas_kernel.py:_mega_kernel``.

``render_image_mega_f32`` takes the plain version below only for a scene on
the CPU.  For a scene on CUDA it launches the kernel or raises.

The scene goes to the kernel as one contiguous float32 buffer, packed by
tensor ops on the scene's device (an animated frame never visits the host):

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
from raytpu_torch.render import build, renderer

MEGA_MAX_PRIMS = 72
MEGA_MAX_LIGHTS = 8
CAM_COLS, SPH_COLS, PLN_COLS, TRI_COLS, LIGHT_COLS = 16, 11, 11, 20, 8
FLT_EPSILON = 1.1920929e-07
FLT_MAX = torch.finfo(torch.float32).max  # 3.4028235e38
INF = float("inf")

#: Launches of the megakernel, counted where the wrapper launches it.
MEGA_LAUNCHES = 0

# raytpu's routing thresholds (raytpu/render/pallas_kernel.py), unchanged
_MEGA2_MAX_TRIS = 8 * 1200
_MEGA2_MAX_UNROLL = 16
_MEGA2_MAX_LIGHTS = 8
_MEGA3_MAX_TRIS = 1048576
_MEGA3_WL_SMEM_ENTRIES = 8192
_MAX_VMEM_TRIS = 32768


def pack_lights(lights):
    """(L, 8): [pos|dir, color, intensity, kind]."""
    lpos = torch.where((lights.kind == 0)[:, None], lights.position, lights.direction)
    return torch.cat([lpos, lights.color, lights.intensity[:, None],
                      lights.kind.to(torch.float32)[:, None]], dim=1)


def mega_pack(scene: Scene, config: RenderConfig):
    """The kernel's scene buffer (1-D float32, contiguous, on the scene's
    device) and the counts (S, P, T, L)."""
    mats = scene.materials
    mat_table = torch.cat([mats.kind.to(torch.float32)[:, None], mats.color, mats.params], dim=1)
    dev = scene.device
    right, up, fwd = scene.camera.onb()
    cam = torch.cat([
        scene.camera.origin, right, up, fwd, scene.camera.fov_scale[None],
        torch.tensor([config.aspect_ratio, 0.0, 0.0], dtype=torch.float32, device=dev),
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


def _check_mega(scene: Scene, config: RenderConfig):
    if scene.num_primitives > MEGA_MAX_PRIMS or scene.lights.count > MEGA_MAX_LIGHTS:
        raise ValueError(f"megakernel takes <= {MEGA_MAX_PRIMS} primitives and <= "
                         f"{MEGA_MAX_LIGHTS} lights, got {scene.num_primitives} and "
                         f"{scene.lights.count}")
    if config.width <= 0 or config.height <= 0:
        raise ValueError(f"image size must be positive, got {config.width}x{config.height}")
    if config.soft_shadows:
        raise ValueError("the megakernel renders hard shadows only")


def render_image_mega_f32(scene: Scene, config: RenderConfig):
    """Whole-frame megakernel render -> (H, W, 3) float32 on the scene's
    device.  The CPU takes the plain version; CUDA launches ``mega.cu``."""
    _check_mega(scene, config)
    if scene.device.type == "cpu":
        return render_image_mega_f32_plain(scene, config)
    if scene.device.type != "cuda":
        raise ValueError(f"megakernel runs on cuda or (plain) cpu, not {scene.device}")
    buf, counts = mega_pack(scene, config)
    out = torch.empty((config.height, config.width, 3), dtype=torch.float32, device=buf.device)
    return launch_mega(buf, counts, config, out)


def launch_mega(buf, counts, config: RenderConfig, out):
    """Launch ``mega.cu`` on the current stream: ``buf`` and ``counts`` from
    ``mega_pack``, ``out`` an (H, W, 3) float32 CUDA tensor it overwrites."""
    global MEGA_LAUNCHES
    S, P, T, L = counts
    W, H = config.width, config.height
    if buf.device.type != "cuda" or out.device != buf.device:
        raise ValueError(f"megakernel tensors must share one CUDA device, got {buf.device}, {out.device}")
    if buf.dtype != torch.float32 or not buf.is_contiguous() or buf.numel() != (
            CAM_COLS + SPH_COLS * S + PLN_COLS * P + TRI_COLS * T + LIGHT_COLS * L):
        raise ValueError("megakernel scene buffer is malformed")
    if out.dtype != torch.float32 or not out.is_contiguous() or tuple(out.shape) != (H, W, 3):
        raise ValueError(f"megakernel output must be contiguous float32 ({H}, {W}, 3)")
    if S + P + T > MEGA_MAX_PRIMS or L > MEGA_MAX_LIGHTS or W <= 0 or H <= 0:
        raise ValueError(f"megakernel cannot take S+P+T={S + P + T}, L={L}, {W}x{H}")
    lib = build.load()
    with torch.cuda.device(buf.device):
        err = lib.raytpu_mega_render(
            buf.data_ptr(), S, P, T, L, W, H, int(config.lighting_mode), int(bool(config.shadows)),
            float(config.ray_min), float(config.normal_offset), float(config.shadow_dim),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: {build.cuda_error_name(lib, err)}")
    MEGA_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# The plain version: what mega.cu computes, in its op order, vectorized over
# rays, reading the same packed buffer.  Loops over primitives run in Python
# with running torch.where selects (strict <: the first primitive wins ties).
# Dot and cross products and the points o + t*d are fused where mega.cu calls
# fmaf (math3d's module docstring says why); every divisor is a tensor, so
# that CUDA divides rather than multiplying by a rounded reciprocal.
# ---------------------------------------------------------------------------

_dot3, _fma = math3d.dot3, math3d.fma


def _sqn(x, y, z):
    return _dot3(x, y, z, x, y, z)


def _sphere_t(s, o, d, lo, hi):
    lx, ly, lz = s[0] - o[0], s[1] - o[1], s[2] - o[2]
    l2 = _sqn(lx, ly, lz)
    proj = _dot3(d[0], d[1], d[2], lx, ly, lz)
    perp2 = _fma(-proj, proj, l2)
    inside = s[3] >= perp2
    tc = proj - torch.sqrt(torch.where(inside, s[3] - perp2, 1.0))
    return torch.where(inside & (tc >= lo) & (tc <= hi), tc, INF)


def _plane_t(p, o, d, lo, hi):
    denom = _dot3(d[0], d[1], d[2], p[0], p[1], p[2])
    num = p[3] - _dot3(o[0], o[1], o[2], p[0], p[1], p[2])
    nz = denom != 0.0
    tc = num / torch.where(nz, denom, 1.0)
    return torch.where(nz & (tc >= lo) & (tc < hi), tc, INF)


def _tri_t(k, o, d, lo, hi, shadow: bool):
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


def render_image_mega_f32_plain(scene: Scene, config: RenderConfig):
    """What ``mega.cu`` computes, in plain tensor ops on the scene's device."""
    _check_mega(scene, config)
    buf, (S, P, T, L) = mega_pack(scene, config)
    W, H = config.width, config.height
    dev = buf.device
    tmin = float(config.ray_min)
    cam = buf[:CAM_COLS]
    sph = buf[CAM_COLS:CAM_COLS + SPH_COLS * S].reshape(S, SPH_COLS)
    o = CAM_COLS + SPH_COLS * S
    pln = buf[o:o + PLN_COLS * P].reshape(P, PLN_COLS)
    o += PLN_COLS * P
    tri = buf[o:o + TRI_COLS * T].reshape(T, TRI_COLS)
    o += TRI_COLS * T
    lit = buf[o:o + LIGHT_COLS * L].reshape(L, LIGHT_COLS)

    # raygen: cx = ((2*u - 1)*aspect)*fov, as generate_rays
    rid = torch.arange(W * H, device=dev)
    ux = ((rid % W).to(torch.float32) + 0.5) / math3d.as_divisor(W, buf)
    uy = ((rid // W).to(torch.float32) + 0.5) / math3d.as_divisor(H, buf)
    cx = (2.0 * ux - 1.0) * cam[13] * cam[12]
    cy = (1.0 - 2.0 * uy) * cam[12]
    dx = cx * cam[3] + cy * cam[6] + cam[9]
    dy = cx * cam[4] + cy * cam[7] + cam[10]
    dz = cx * cam[5] + cy * cam[8] + cam[11]
    d_len = torch.sqrt(_sqn(dx, dy, dz))
    rd = (dx / d_len, dy / d_len, dz / d_len)
    ro = (cam[0], cam[1], cam[2])

    # closest hit with running selects: t, unnormalized normal, is_sphere, material
    t = torch.full((W * H,), INF, device=dev)
    zero = torch.zeros_like(t)
    nrm = [zero, zero, zero]
    is_sph = torch.zeros_like(t, dtype=torch.bool)
    mat = [zero] * 7

    def upd(tc, ncand, sphere, m):
        nonlocal t, nrm, is_sph, mat
        sel = tc < t
        t = torch.where(sel, tc, t)
        nrm = [torch.where(sel, c, a) for c, a in zip(ncand, nrm)]
        is_sph = (is_sph | sel) if sphere else (is_sph & ~sel)
        mat = [torch.where(sel, c, a) for c, a in zip(m, mat)]

    for s in range(S):
        r = sph[s]
        tc = _sphere_t(r, ro, rd, tmin, INF)
        upd(tc, [_fma(tc, rd[i], ro[i]) - r[i] for i in range(3)], True, r[4:11].unbind())
    for p in range(P):
        r = pln[p]
        upd(_plane_t(r, ro, rd, tmin, INF), r[0:3].unbind(), False, r[4:11].unbind())
    for k in range(T):
        r = tri[k]
        upd(_tri_t(r, ro, rd, tmin, INF, shadow=False), r[9:12].unbind(), False,
            r[13:20].unbind())

    hit = t < INF
    ts = torch.where(hit, t, 0.0)
    pt = tuple(_fma(ts, rd[i], ro[i]) for i in range(3))
    # sphere normals normalized after the selection (reference: source/Scene.cpp:40)
    n_len = torch.sqrt(torch.clamp(_sqn(*nrm), min=1e-20))
    n = tuple(torch.where(is_sph, c / n_len, c) for c in nrm)
    po = tuple(_fma(n[i], float(config.normal_offset), pt[i]) for i in range(3))
    view = (-rd[0], -rd[1], -rd[2])

    color = [zero, zero, zero]
    sf = torch.ones_like(t)
    for li in range(L):
        row = lit[li]
        lp, lcol, lint = row[0:3], row[3:6], row[6]
        is_point = row[7] == 0.0
        ld = (lp[0] - po[0], lp[1] - po[1], lp[2] - po[2])
        mag_pt = torch.sqrt(_sqn(*ld))
        l = tuple(torch.where(is_point, ld[i] / mag_pt, -lp[i]) for i in range(3))
        mag = torch.where(is_point, mag_pt, FLT_MAX)
        if config.shadows:
            occ = torch.zeros_like(hit)
            for s in range(S):
                occ |= _sphere_t(sph[s], po, l, tmin, mag) < INF
            for p in range(P):
                occ |= _plane_t(pln[p], po, l, tmin, mag) < INF
            for k in range(T):
                occ |= _tri_t(tri[k], po, l, tmin, mag, shadow=True) < INF
            lit_mask = ~(occ & hit)
            sf = sf * torch.where(lit_mask, 1.0, float(config.shadow_dim))
        else:
            lit_mask = torch.ones_like(hit)
        w = _shade_one_light(config.lighting_mode, is_point, lp, lcol, lint, pt, n, l,
                             view, mat)
        color = [c + torch.where(lit_mask, wc, 0.0) for c, wc in zip(color, w)]

    color = [torch.where(hit, c * sf, 0.0) for c in color]
    mx = torch.maximum(color[0], torch.maximum(color[1], color[2]))
    over = mx > 1.0
    # a division, not a multiply by the reciprocal
    color = [torch.where(over, c / mx, c) for c in color]
    return torch.stack(color, dim=-1).reshape(H, W, 3)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

_NOT_PORTED = {
    "mega2": "K2, the mega2 closest-hit and shadow kernels (pallas_kernel.py:_make_mega2_*)",
    "packed": "K3 and K4, the winner search and all-lights any-hit (pallas_soft.py), "
              "with their streamed forms K3s and K4s",
    "chunked": "K8-K10, the chunked min-t, shadow and shadow+shade kernels (pallas_kernel.py)",
    "jnp": "K5, the soft-shadow transmittance kernel (pallas_soft.py:_make_soft_mega_kernel), "
           "and the differentiable path (raytpu/grad)",
}


def route_kind(scene: Scene, config: RenderConfig) -> str:
    """The route raytpu's ``route_kind`` takes for this scene, with its
    thresholds unchanged: "mega" | "mega2" | "packed" | "jnp" | "chunked"."""
    S, P, T, L = (scene.spheres.count, scene.planes.count, scene.triangles.count,
                  scene.lights.count)
    if config.soft_shadows:
        return "jnp"
    if scene.num_primitives <= MEGA_MAX_PRIMS and L <= MEGA_MAX_LIGHTS:
        return "mega"
    small_caps = S <= _MEGA2_MAX_UNROLL and P <= _MEGA2_MAX_UNROLL and L <= _MEGA2_MAX_LIGHTS
    if T <= _MEGA2_MAX_TRIS and small_caps:
        return "mega2"
    if (T <= _MEGA3_MAX_TRIS and small_caps
            and L * -(-T // 512) <= _MEGA3_WL_SMEM_ENTRIES):
        return "packed"
    if T > _MAX_VMEM_TRIS:
        return "jnp"
    return "chunked"


def render_image_f32(scene: Scene, config: RenderConfig):
    """(H, W, 3) float32 image through the route raytpu would take.  The
    megakernel route and raytpu's jnp route for hard shadows are ported; the
    others raise, naming the kernels they wait for."""
    kind = route_kind(scene, config)
    if kind == "mega":
        return render_image_mega_f32(scene, config)
    if kind == "jnp" and not config.soft_shadows:
        # past 32k triangles raytpu renders with plain jnp ops: the eager path
        return renderer.render_image_f32(scene, config)
    raise NotImplementedError(f"route {kind!r} needs {_NOT_PORTED[kind]}, not ported yet")


def render_image(scene: Scene, config: RenderConfig):
    """(H, W, 3) uint8 image through ``render_image_f32``."""
    return math3d.quantize_u8(render_image_f32(scene, config))

