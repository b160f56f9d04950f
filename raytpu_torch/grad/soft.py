"""Every light's soft-shadow transmittance as one differentiable call.

Counterpart of ``raytpu/grad/soft.py``.  ``soft_trans_lights`` computes the
(L, R) transmittance of the shadow rays.  With ``kernels=True`` it is a
``torch.autograd.Function``: the forward is K5 (``render/soft.py``), the
backward K6 for the rays and K7 for the triangle vertices (both on the
gradient records, ``soft.grad_boxes``, built once a backward), and autograd of
the eager transmittance of a triangle-free scene for the spheres and planes
(``_scene_cotangent``).  The backward computes only what its inputs need
(``ctx.needs_input_grad``), as XLA's dead-code elimination prunes raytpu's:
a material or light-colour fit reaches neither K6 nor K7.  With
``kernels=False`` it is plain autograd through
``ops.intersect.soft_transmittance``, raytpu's jnp reference, whose
gradients the kernels reproduce.

Replaces the gradient path the reference does not have (its DoesHit is
boolean, reference: source/Scene.cpp:68-96); the hard-shadow limit is
``beta -> inf``.
"""

from __future__ import annotations

import dataclasses

import torch

from raytpu_torch.core.types import Scene, Triangles
from raytpu_torch.ops import intersect
from raytpu_torch.render import soft


def soft_trans_lights(kernels: bool, tmin: float, beta: float, scene: Scene, p, dirs, mags):
    """(L, R) soft transmittance of shadow rays from ``p`` (R,3) along
    ``dirs`` (L,R,3) over [tmin, ``mags`` (L,R)].  Differentiable in the
    scene's sphere and plane geometry and triangle vertices, and in ``p``,
    ``dirs`` and ``mags``.  ``kernels`` selects K5-K7 (on CPU tensors, their
    plain versions)."""
    if not kernels:
        return torch.stack([intersect.soft_transmittance(scene, p, dirs[li], tmin, mags[li], beta)
                            for li in range(dirs.shape[0])])
    sph, pln, tr = scene.spheres, scene.planes, scene.triangles
    return _SoftTrans.apply(scene, float(tmin), float(beta), p, dirs, mags, sph.center,
                            sph.radius, pln.origin, pln.normal, tr.v0, tr.v1, tr.v2)


class _SoftTrans(torch.autograd.Function):
    """K5 forward, K6 / K7 / eager sphere-plane backward.  The inputs after
    the scene are the tensors it differentiates: p, dirs, mags, sphere
    centers and radii, plane origins and normals, triangle v0, v1, v2 (the
    scene holds the same tensors).  Triangle normals and cull modes only
    gate, so they carry no gradient."""

    @staticmethod
    def forward(ctx, scene, tmin, beta, p, dirs, mags, *_leaves):
        trans, (blobs, wl, cnt) = soft.soft_trans_lights_kernel(scene, p, dirs, mags, tmin, beta)
        ctx.save_for_backward(p.contiguous(), dirs.contiguous(), mags.contiguous(), trans)
        ctx.scene, ctx.tmin, ctx.beta = scene, tmin, beta
        ctx.blobs, ctx.wl, ctx.cnt = blobs, wl, cnt
        return trans

    @staticmethod
    def backward(ctx, g):
        p, dirs, mags, trans = ctx.saved_tensors
        g = g.contiguous()
        need = ctx.needs_input_grad
        tmin, beta, (sph, pln, tri), wl, cnt = ctx.tmin, ctx.beta, ctx.blobs, ctx.wl, ctx.cnt
        rays, verts = any(need[3:6]), any(need[10:13]) and tri.shape[0] > 0
        # the gradient records, built once a backward for K6 and K7 (the
        # CPU's plain versions need none)
        boxes = (soft.grad_boxes(ctx.scene, beta)
                 if (rays or verts) and p.device.type != "cpu" else None)
        g_ray = (None, None, None)
        if rays:
            g_ray = soft.soft_dray(p, dirs, mags, g, trans, sph, pln, tri, wl, cnt, tmin, beta,
                                   boxes)
        g_sp = (None,) * 4
        if any(need[6:10]):
            g_sp = _scene_cotangent(ctx.scene, need[6:10], tmin, beta, p, dirs, mags, g, trans)
        g_v = (None,) * 3
        if verts:
            out = soft.soft_dprim(p, dirs, mags, g, trans, tri, wl, cnt, tmin, beta, boxes)
            g_s, g_e1, g_e2 = out[:, 0:3], out[:, 3:6], out[:, 6:9]
            # e1 = v1 - v0, e2 = v2 - v0, s = p - v0 (pallas_soft.py:1820-1822)
            g_v = (-g_s - g_e1 - g_e2, g_e1, g_e2)
        return (None, None, None, *g_ray, *g_sp, *g_v)


def _scene_cotangent(scene: Scene, need, tmin, beta, p, dirs, mags, g, trans):
    """Cotangents of (sphere center, sphere radius, plane origin, plane
    normal), each None unless ``need`` asks for it.  The transmittance
    factors as ``trans_sp * trans_tri``, so these are autograd of the eager
    transmittance of the triangle-free scene (O(R) per sphere or plane)
    with the cotangent scaled by the triangles' factor ``trans / trans_sp``
    (raytpu/grad/soft.py:62-103).  ``trans_sp`` is exactly 0 only past ~8
    near-opaque occluders; the product's own gradient is 0 there too."""
    sph, pln = scene.spheres, scene.planes
    leaves = [x.detach().requires_grad_(bool(n))
              for x, n in zip((sph.center, sph.radius, pln.origin, pln.normal), need)]
    dev = p.device
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    zi = torch.zeros((0,), dtype=torch.int32, device=dev)
    sp_only = dataclasses.replace(
        scene,
        spheres=dataclasses.replace(sph, center=leaves[0], radius=leaves[1]),
        planes=dataclasses.replace(pln, origin=leaves[2], normal=leaves[3]),
        triangles=Triangles(v0=z3, v1=z3, v2=z3, normal=z3, cull=zi, material=zi))
    with torch.enable_grad():
        trans_sp = soft_trans_lights(False, tmin, beta, sp_only, p, dirs, mags)
        if not trans_sp.requires_grad:  # no sphere or plane to differentiate
            return (None,) * 4
        ts = trans_sp.detach()
        g_eff = torch.where(ts > 0, g * trans / torch.where(ts > 0, ts, 1.0), 0.0)
        wanted = [x for x in leaves if x.requires_grad]
        grads = iter(torch.autograd.grad(trans_sp, wanted, g_eff, allow_unused=True))
    return tuple(next(grads) if x.requires_grad else None for x in leaves)
