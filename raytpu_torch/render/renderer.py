"""The eager forward renderer: raygen -> closest hit -> shadows + shading ->
tone map, as plain tensor ops.

Counterpart of ``raytpu/render/renderer.py`` (reference:
source/Renderer.cpp:34-182).  It runs on whatever device the scene is on, is
the reference the megakernel's plain version is held against, and is what
the tests compare with raytpu's jnp renderer.  Soft shadows
(``RenderConfig.soft_shadows``) are differentiable: ``raytpu_torch.grad``
renders them through the kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import LightingMode, RenderConfig, Scene
from raytpu_torch.ops import intersect, shading

#: Elements of the (rays x primitives) t-matrix kept in one eager chunk.
CHUNK_ELEMS = 1 << 25


def generate_rays(camera, config: RenderConfig):
    """Primary ray directions for the pixel grid (reference:
    source/Renderer.cpp:104-114):
      cx = ((2(px+.5)/W - 1) * aspect) * fov,  cy = (1 - 2(py+.5)/H) * fov
      dir = normalize(cx*right + cy*up + forward)
    Returns ``(origin (3,), directions (H*W, 3))`` in row-major pixel order."""
    W, H = config.width, config.height
    dev = camera.origin.device
    right, up, fwd = camera.onb()
    px = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / math3d.as_divisor(W, camera.origin)
    py = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / math3d.as_divisor(H, camera.origin)
    aspect = math3d.scalar(config.aspect_ratio, dev)
    cx = (2.0 * px - 1.0) * aspect * camera.fov_scale  # (W,)
    cy = (1.0 - 2.0 * py) * camera.fov_scale  # (H,)
    d = cx[None, :, None] * right + cy[:, None, None] * up + fwd  # (H,W,3)
    return camera.origin, math3d.normalize(d).reshape(-1, 3)


def shade_rays(scene: Scene, ro, rd, config: RenderConfig, closest_fn=None, any_fn=None,
               any_multi_fn=None, soft_multi_fn=None):
    """Closest hit, per-light shadows and shading, shadow dim and tone map
    for a batch of rays.  ``ro`` is (3,) or (N,3).  Returns (N,3) in [0,1].
    One shared origin stays (1,3), so the primary pass's origin-to-primitive
    terms are computed once per primitive rather than once per ray.

    ``closest_fn(scene, ro (N,3), rd, tmin) -> HitRecords`` replaces the
    eager closest hit (the differentiable path's detached winner search, the
    chunked route's K8); ``any_fn``, ``any_multi_fn`` and ``soft_multi_fn``
    go to ``shade_from_records``."""
    if closest_fn is None:
        rec = intersect.closest_hit(scene, ro.reshape(-1, 3), rd, config.ray_min)
    else:
        rec = closest_fn(scene, ro.reshape(-1, 3).expand_as(rd), rd, config.ray_min)
    return shade_from_records(scene, rec, rd, config, any_fn=any_fn, any_multi_fn=any_multi_fn,
                              soft_multi_fn=soft_multi_fn)


def shadow_query_inputs(scene: Scene, rec, config: RenderConfig):
    """(p_off (R,3), dirs (L,R,3), mags (L,R)) for the per-light occlusion
    queries; ``dirs`` and ``mags`` are None for a scene without lights."""
    p_off = math3d.fma(rec.normal, config.normal_offset, rec.point)
    lds = [shading.direction_to_light(scene.lights, li, p_off)
           for li in range(scene.lights.count)]
    if not lds:
        return p_off, None, None
    return p_off, torch.stack([l for l, _ in lds]), torch.stack([m for _, m in lds])


def shade_from_records(scene: Scene, rec, rd, config: RenderConfig, any_fn=None,
                       any_multi_fn=None, soft_multi_fn=None):
    """The shading tail of ``shade_rays`` given the closest hit's records:
    shadows, the shadow dim, MaxToOne.

    Hard shadows dim a pixel by ``shadow_dim`` per occluded light.
    ``any_multi_fn(scene, p_off (R,3), dirs (L,R,3), mags (L,R), tmin) ->
    (L,R) bool`` answers every light's occlusion in one call (the all-lights
    any-hit kernels K4 and K9); without it each light takes ``any_fn(scene,
    p_off, dir (R,3), tmin, mag (R,)) -> (R,) bool``, by default
    ``intersect.any_hit``.

    Soft shadows (``config.soft_shadows``) weight each light by its
    transmittance ``trans`` in [0, 1] and dim by ``dim + (1 - dim) *
    trans``.  ``soft_multi_fn(scene, p_off, dirs, mags) -> (L,R)`` gives
    every light's transmittance in one call, computed once per render, as
    raytpu hoists it out of its recompute (raytpu/render/renderer.py:228);
    without it each light takes ``intersect.soft_transmittance``."""
    n = rd.shape[0]
    p_off, dirs, mags = shadow_query_inputs(scene, rec, config)
    color = torch.zeros((n, 3), dtype=torch.float32, device=rd.device)
    shadow_factor = torch.ones((n,), dtype=torch.float32, device=rd.device)
    mode = config.lighting_mode
    soft = config.shadows and config.soft_shadows
    occ_multi = trans_multi = None
    if any_multi_fn is not None and config.shadows and not soft and dirs is not None:
        occ_multi = any_multi_fn(scene, p_off, dirs, mags, config.ray_min)
    if soft_multi_fn is not None and soft and dirs is not None:
        trans_multi = soft_multi_fn(scene, p_off, dirs, mags)
    # float32 arithmetic on the dim, as raytpu's jnp.float32(shadow_dim)
    dim = math3d.scalar(config.shadow_dim, rd.device)
    for li in range(scene.lights.count):
        l, mag = dirs[li], mags[li]
        if soft:
            trans = (trans_multi[li] if trans_multi is not None
                     else intersect.soft_transmittance(scene, p_off, l, config.ray_min, mag,
                                                       config.soft_beta))
            trans = torch.where(rec.hit, trans, 1.0)
            # the soft dim interpolates between dim and 1
            shadow_factor = shadow_factor * (dim + (1.0 - dim) * trans)
        elif config.shadows:
            occluded = (occ_multi[li] if occ_multi is not None
                        else (any_fn or intersect.any_hit)(scene, p_off, l, config.ray_min, mag))
            trans = torch.where(occluded & rec.hit, 0.0, 1.0)
            # each occluded light dims the whole pixel (reference: source/Renderer.cpp:139)
            shadow_factor = shadow_factor * torch.where(trans == 0.0, config.shadow_dim, 1.0)
        else:
            trans = torch.ones((n,), dtype=torch.float32, device=rd.device)
        if mode == LightingMode.COMBINED:
            oa = torch.clamp(math3d.dot(rec.normal, l), min=0.0)[:, None]
            rad = shading.radiance(scene.lights, li, rec.point)
            brdf = shading.shade(scene.materials, rec.material, rec.normal, l, -rd)
            contrib = oa * rad * brdf
        elif mode == LightingMode.OBSERVED_AREA:
            contrib = torch.clamp(math3d.dot(rec.normal, l), min=0.0)[:, None].expand(n, 3)
        elif mode == LightingMode.RADIANCE:
            contrib = shading.radiance(scene.lights, li, rec.point)
        else:  # BRDF
            contrib = shading.shade(scene.materials, rec.material, rec.normal, l, -rd)
        color = color + contrib * trans[:, None]
    color = torch.where(rec.hit[:, None], color * shadow_factor[:, None], 0.0)
    return math3d.max_to_one(color)


def render_pixels_f32(scene: Scene, ro, rd, config: RenderConfig, closest_fn=None,
                      soft_multi_fn=None):
    """``shade_rays`` over a flat ray batch, in chunks of
    ``config.ray_chunk`` rays, by default as many as keep the (rays x
    primitives) t-matrix within ``CHUNK_ELEMS`` elements."""
    n = rd.shape[0]
    chunk = config.ray_chunk or max(1024, CHUNK_ELEMS // max(scene.num_primitives, 1))
    return torch.cat([shade_rays(scene, ro, rd[i:i + chunk], config, closest_fn=closest_fn,
                                 soft_multi_fn=soft_multi_fn) for i in range(0, n, chunk)])


def render_image_f32(scene: Scene, config: RenderConfig):
    """(H, W, 3) float32 tone-mapped image in [0,1]."""
    ro, rd = generate_rays(scene.camera, config)
    return render_pixels_f32(scene, ro, rd, config).reshape(config.height, config.width, 3)


def render_image(scene: Scene, config: RenderConfig):
    """(H, W, 3) uint8 image, truncating like the reference's
    ``static_cast<uint8_t>(c*255)`` (reference: source/Renderer.cpp:178-181)."""
    return math3d.quantize_u8(render_image_f32(scene, config))


def render_image_ssaa(scene: Scene, config: RenderConfig, samples: int = 2, render_fn=None):
    """Supersampled render: a ``samples x samples`` grid per pixel, box
    filtered.  ``render_fn(scene, config) -> (H, W, 3) float32`` renders the
    supersampled grid: any route's ``render_image_f32`` (the kernel route's
    ``cuda_kernel.render_image_f32``, the sharded
    ``parallel.sharding.render_pixels_sharded``); by default this module's
    eager one.  Returns uint8."""
    hi = dataclasses.replace(config, width=config.width * samples,
                             height=config.height * samples)
    img = (render_fn or render_image_f32)(scene, hi)
    img = img.reshape(config.height, samples, config.width, samples, 3).mean(dim=(1, 3))
    return math3d.quantize_u8(img)
