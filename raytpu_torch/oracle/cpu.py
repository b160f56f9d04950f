"""Scalar numpy oracle renderer: the ground truth for every fast path.

Counterpart of ``raytpu/oracle/cpu.py``, a copy statement for statement, so
that both give the same bytes on the same scene arrays.  It transcribes the
reference's per-pixel pipeline (reference: source/Renderer.cpp:100-182) and
hit tests (reference: source/Utils.h): sequential closest hit with strict
``<`` in sphere, plane, mesh order, per-light shadow rays with inverted
triangle culling, the 0.95 shadow dim factor, four lighting modes, MaxToOne
and truncating u8 quantization.

Slow on purpose: per-pixel Python loops over numpy float32 scalars.  Use it
at 64x48 or less.  The scene is read through ``core.convert.scene_to_arrays``,
so the port's Scene on any device works, and so does any object with its
field names.
"""

from __future__ import annotations

import numpy as np

from raytpu_torch.core.convert import scene_to_arrays
from raytpu_torch.core.types import (
    CullMode,
    LightingMode,
    LightKind,
    MaterialKind,
    RenderConfig,
    Scene,
)

FLT_EPSILON = np.float32(1.1920929e-07)
FLT_MAX = np.float32(3.4028235e38)
PI = np.float32(3.14159265358979323846)

f32 = np.float32


def _n(x):
    return np.asarray(x, np.float32)


def _normalize(v):
    return v / np.sqrt(f32(np.dot(v, v)))


def render_oracle(scene: Scene, config: RenderConfig) -> np.ndarray:
    """Render to a (H, W, 3) uint8 buffer."""
    a = scene_to_arrays(scene)
    sp_c = _n(a["spheres.center"])
    sp_r = _n(a["spheres.radius"])
    sp_m = a["spheres.material"]
    pl_o = _n(a["planes.origin"])
    pl_n = _n(a["planes.normal"])
    pl_m = a["planes.material"]
    tr_v0, tr_v1, tr_v2 = _n(a["triangles.v0"]), _n(a["triangles.v1"]), _n(a["triangles.v2"])
    tr_n = _n(a["triangles.normal"])
    tr_cull = a["triangles.cull"]
    tr_m = a["triangles.material"]
    li_p, li_d = _n(a["lights.position"]), _n(a["lights.direction"])
    li_c, li_i = _n(a["lights.color"]), _n(a["lights.intensity"])
    li_k = a["lights.kind"]
    mat_kind = a["materials.kind"]
    mat_color = _n(a["materials.color"])
    mat_params = _n(a["materials.params"])

    cam_o = _n(a["camera.origin"])
    fwd = _n(a["camera.forward"])
    right = _normalize(np.cross(_n([0.0, 1.0, 0.0]), fwd))
    up = _normalize(np.cross(fwd, right))
    fov = f32(a["camera.fov_scale"])

    W, H = config.width, config.height
    aspect = f32(W / H)
    ray_min = f32(config.ray_min)
    offset_eps = f32(config.normal_offset)
    shadow_dim = f32(config.shadow_dim)
    mode = config.lighting_mode

    # -- scalar hit tests ---------------------------------------------------

    def hit_sphere(i, ro, rd, tmin, tmax):
        """Geometric method, near root only (reference: source/Utils.h:52-71)."""
        L = sp_c[i] - ro
        L2 = f32(np.dot(L, L))
        proj = f32(np.dot(rd, L))
        perp2 = f32(L2 - proj * proj)
        r2 = f32(sp_r[i] * sp_r[i])
        if r2 < perp2:
            return None
        t = f32(proj - np.sqrt(f32(r2 - perp2)))
        if t < tmin or t > tmax:
            return None
        return t

    def hit_plane(i, ro, rd, tmin, tmax):
        """(reference: source/Utils.h:82-98) — range is [tmin, tmax)."""
        denom = f32(np.dot(rd, pl_n[i]))
        with np.errstate(divide="ignore", invalid="ignore"):
            t = f32(np.dot(pl_o[i] - ro, pl_n[i]) / denom)
        if t >= tmin and t < tmax:
            return t
        return None

    def hit_triangle(i, ro, rd, tmin, tmax, shadow_pass):
        """Möller–Trumbore with cull modes; shadow rays invert culling
        (reference: source/Utils.h:109-184)."""
        n = tr_n[i]
        cull_dot = f32(np.dot(n, rd))
        if abs(cull_dot) < FLT_EPSILON:
            return None
        cull = int(tr_cull[i])
        if shadow_pass:
            if cull == CullMode.FRONT_FACE:
                cull = CullMode.BACK_FACE
            elif cull == CullMode.BACK_FACE:
                cull = CullMode.FRONT_FACE
        if cull == CullMode.FRONT_FACE and cull_dot < 0:
            return None
        if cull == CullMode.BACK_FACE and cull_dot > 0:
            return None
        e1 = tr_v1[i] - tr_v0[i]
        e2 = tr_v2[i] - tr_v0[i]
        h = np.cross(rd, e2).astype(f32)
        a = f32(np.dot(e1, h))
        if abs(a) < FLT_EPSILON:
            return None
        inv_a = f32(1.0 / a)
        s = ro - tr_v0[i]
        u = f32(inv_a * np.dot(s, h))
        if u < 0.0 or u > 1.0:
            return None
        q = np.cross(s, e1).astype(f32)
        v = f32(inv_a * np.dot(rd, q))
        if v < 0.0 or (u + v) > 1.0:
            return None
        t = f32(inv_a * np.dot(e2, q))
        if t < tmin or t >= tmax:
            return None
        return t

    def closest_hit(ro, rd):
        """Sequential strict-< closest hit in sphere→plane→triangle order
        (reference: source/Scene.cpp:29-66)."""
        best_t = FLT_MAX
        best = None  # (origin, normal, material)
        for i in range(sp_c.shape[0]):
            t = hit_sphere(i, ro, rd, ray_min, FLT_MAX)
            if t is not None and t < best_t:
                p = ro + t * rd
                best_t = t
                best = (p, _normalize(p - sp_c[i]), int(sp_m[i]))
        for i in range(pl_o.shape[0]):
            t = hit_plane(i, ro, rd, ray_min, FLT_MAX)
            if t is not None and t < best_t:
                best_t = t
                best = (ro + t * rd, pl_n[i], int(pl_m[i]))
        for i in range(tr_v0.shape[0]):
            t = hit_triangle(i, ro, rd, ray_min, FLT_MAX, shadow_pass=False)
            if t is not None and t < best_t:
                best_t = t
                best = (ro + t * rd, tr_n[i], int(tr_m[i]))
        return best

    def does_hit(ro, rd, tmax):
        """Any-hit for shadow rays (reference: source/Scene.cpp:68-96)."""
        for i in range(sp_c.shape[0]):
            if hit_sphere(i, ro, rd, ray_min, tmax) is not None:
                return True
        for i in range(pl_o.shape[0]):
            if hit_plane(i, ro, rd, ray_min, tmax) is not None:
                return True
        for i in range(tr_v0.shape[0]):
            if hit_triangle(i, ro, rd, ray_min, tmax, shadow_pass=True) is not None:
                return True
        return False

    # -- shading ------------------------------------------------------------

    def shade(mat_idx, normal, l, v):
        """Material table dispatch (reference: source/Material.h:34-129)."""
        kind = int(mat_kind[mat_idx])
        color = mat_color[mat_idx]
        p = mat_params[mat_idx]
        if kind == MaterialKind.SOLID:
            return color
        if kind == MaterialKind.LAMBERT:
            return color * p[0] / PI
        if kind == MaterialKind.LAMBERT_PHONG:
            kd, ks, exp = p[0], p[1], p[2]
            refl = l - f32(2.0) * max(f32(np.dot(normal, l)), f32(0.0)) * normal
            cosa = max(f32(np.dot(refl, v)), f32(0.0))
            spec = f32(ks * np.power(cosa, exp))
            return color * kd / PI + spec
        # Cook-Torrance (reference: source/Material.h:107-123, source/BRDFs.h:49-99)
        metal, rough = p[0], p[1]
        h = _normalize(v + l)
        f0 = np.array([0.04, 0.04, 0.04], f32) if metal == 0.0 else color
        fresnel = f0 + (1.0 - f0) * f32(np.power(1.0 - max(f32(np.dot(h, v)), f32(0.0)), 5))
        a = f32(rough * rough)
        sqr_a = f32(a * a)
        ndh = max(f32(np.dot(normal, h)), f32(0.0))
        denom_d = f32(ndh * ndh * (sqr_a - 1.0) + 1.0)
        D = f32(sqr_a / (PI * denom_d * denom_d))
        k = f32((a + 1.0) * (a + 1.0) / 8.0)

        def g1(x):
            cd = max(f32(np.dot(normal, x)), f32(0.0))
            return f32(cd / (cd * (1.0 - k) + k))

        G = f32(g1(v) * g1(l))
        spec = (
            fresnel
            * D
            * G
            / f32(4.0 * max(f32(np.dot(v, normal)), f32(1e-4)) * max(f32(np.dot(l, normal)), f32(1e-4)))
        )
        kd = (1.0 - fresnel) if metal == 0.0 else np.zeros(3, f32)
        diffuse = color * kd / PI
        return (diffuse + spec).astype(f32)

    def radiance(li, target):
        """Inverse-square point radiance (reference: source/Utils.h:355-369)."""
        if int(li_k[li]) == LightKind.POINT:
            d = li_p[li] - target
            return li_c[li] * f32(li_i[li] / np.dot(d, d))
        return li_c[li] * li_i[li]

    # -- per-pixel loop (reference: source/Renderer.cpp:100-182) ------------

    out = np.zeros((H, W, 3), np.uint8)
    for py in range(H):
        for px in range(W):
            cx = f32((2.0 * ((px + 0.5) / W) - 1.0) * aspect * fov)
            cy = f32((1.0 - (2.0 * (py + 0.5) / H)) * fov)
            rd = _normalize(cx * right + cy * up + fwd)
            hit = closest_hit(cam_o, rd)
            color = np.zeros(3, f32)
            if hit is not None:
                p, n, mi = hit
                p_off = p + n * offset_eps
                shadow_factor = f32(1.0)
                for li in range(li_p.shape[0]):
                    if int(li_k[li]) == LightKind.POINT:
                        ldir = li_p[li] - p_off
                        mag = f32(np.sqrt(np.dot(ldir, ldir)))
                        l = ldir / mag
                    else:
                        l = -li_d[li]
                        mag = FLT_MAX
                    if config.shadows and does_hit(p_off, l, mag):
                        shadow_factor = f32(shadow_factor * shadow_dim)
                        continue
                    if mode == LightingMode.COMBINED:
                        oa = max(f32(np.dot(n, l)), f32(0.0))
                        color = color + oa * radiance(li, p) * shade(mi, n, l, -rd)
                    elif mode == LightingMode.OBSERVED_AREA:
                        oa = max(f32(np.dot(n, l)), f32(0.0))
                        color = color + oa
                    elif mode == LightingMode.RADIANCE:
                        color = color + radiance(li, p)
                    elif mode == LightingMode.BRDF:
                        color = color + shade(mi, n, l, -rd)
                color = (color * shadow_factor).astype(f32)
            m = f32(color.max())
            if m > 1.0:
                color = color / m
            out[py, px] = (color * 255.0).astype(np.uint8)
    return out
