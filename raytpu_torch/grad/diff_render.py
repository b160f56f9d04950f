"""Differentiable rendering and inverse rendering.

Counterpart of ``raytpu/grad/diff_render.py``.  The float32 soft-shadow
render is differentiable almost everywhere in the material, light and
geometry parameters: the intersection ops keep double-where guards, so the
gradients are finite, and soft shadows swap the binary visibility for a
sigmoid transmittance, so shadow edges carry gradients too.

``render_soft_f32`` is the fast differentiable path.  On a CUDA scene of
256 to 1M triangles (raytpu's thresholds) it runs on the kernels: K3's
winner search, detached, for the closest hit and K5's transmittance, with
K6 and K7 in the backward where the parameters need them.  Elsewhere it
renders with eager tensor ops and autograd.  ``make_train_step`` fits scene
parameters to a target image with a ``torch.optim`` optimizer.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.grad.fast import detached_closest_hit
from raytpu_torch.grad.soft import soft_trans_lights
from raytpu_torch.render import packed, renderer

#: the kernels take scenes of KERNEL_MIN_TRIS to KERNEL_MAX_TRIS triangles
#: with at most 16 spheres, 16 planes and 8 lights: raytpu's thresholds
#: (raytpu/grad/diff_render.py:33, pallas_soft.STREAM_MAX_TRIS), not yet
#: measured on the card
KERNEL_MIN_TRIS = 256
KERNEL_MAX_TRIS = 1 << 20
KERNEL_MAX_UNROLL = 16
KERNEL_MAX_LIGHTS = 8
WL_ENTRIES = 8192  # raytpu's worklist budget, L * ceil(T / 512)


def _kernel_min_t(scene: Scene, ro, rd, tmin):
    """K3's winner search for the detached closest hit: (t, global index)."""
    t, idx, _, _ = packed.scene_min_t_mega2(scene, ro, rd, tmin)
    return t, idx


def _payload_closest_hit(scene: Scene, ro, rd, tmin):
    """The closest hit entirely from K3's payload (normal, material), without
    autograd: the image is ``detached_closest_hit``'s, but no gradient
    reaches the visible surface's geometry through the hit point and normal.
    Occluder geometry still gets its gradients through the soft
    transmittance, and material and light gradients are unchanged.  Select
    it with ``render_soft_f32(..., payload_grad=False)``."""
    with torch.no_grad():
        t, _, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, tmin)
    return packed.hit_records_from_payload(ro, rd, t, normal, mat)


def kernels_fit(scene: Scene) -> bool:
    """Whether the kernels take this scene: on CUDA, within raytpu's
    triangle, sphere, plane, light and worklist thresholds."""
    S, P, T, L = (scene.spheres.count, scene.planes.count, scene.triangles.count,
                  scene.lights.count)
    return (scene.device.type == "cuda" and KERNEL_MIN_TRIS <= T <= KERNEL_MAX_TRIS
            and S <= KERNEL_MAX_UNROLL and P <= KERNEL_MAX_UNROLL and L <= KERNEL_MAX_LIGHTS
            and L * -(-T // 512) <= WL_ENTRIES)


def soft_backends(scene: Scene, cfg: RenderConfig, kernels: bool | None = None,
                  payload_grad: bool = True):
    """``(closest_fn, soft_multi_fn)`` for ``renderer.render_pixels_f32``.
    ``kernels=None`` takes the kernels where ``kernels_fit``; True takes
    them on any scene (on CPU tensors, their plain versions)."""
    if kernels is None:
        kernels = kernels_fit(scene)
    if not kernels:
        return detached_closest_hit, None
    soft_multi_fn = functools.partial(soft_trans_lights, True, float(cfg.ray_min),
                                      float(cfg.soft_beta))
    if payload_grad:
        return functools.partial(detached_closest_hit, min_t_fn=_kernel_min_t), soft_multi_fn
    return _payload_closest_hit, soft_multi_fn


def render_soft_f32(scene: Scene, config: RenderConfig, kernels: bool | None = None,
                    payload_grad: bool = True):
    """(H, W, 3) float32 soft-shadow render on the fast differentiable path.

    The closest hit is ``detached_closest_hit``, O(R) differentiated work.
    ``kernels`` (default: on where
    ``kernels_fit``): K3's winner search and K5's transmittance, K6 and K7
    in the backward; the gradients are the eager path's.  The kernels see
    every ray at once, in 32x32 pixel blocks when W and H are multiples of
    32, so that a tile's shadow rays form a tight cone.  The transmittance
    is computed once; raytpu's recompute of the shade tail
    (``jax.checkpoint``) is a memory device the port does not need at
    640x480.  ``payload_grad=False`` takes the closest hit from K3's payload
    (``_payload_closest_hit``)."""
    cfg = dataclasses.replace(config, soft_shadows=True)
    closest_fn, soft_multi_fn = soft_backends(scene, cfg, kernels, payload_grad)
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if soft_multi_fn is not None:  # the kernels hold no t-matrix: one launch each
        cfg = dataclasses.replace(cfg, ray_chunk=cfg.ray_chunk or rd.shape[0])
    tiled = soft_multi_fn is not None and cfg.height % 32 == 0 and cfg.width % 32 == 0
    if tiled:
        rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    colors = renderer.render_pixels_f32(scene, ro, rd, cfg, closest_fn=closest_fn,
                                        soft_multi_fn=soft_multi_fn)
    if tiled:
        colors = packed.mega2_unfold_rows(colors, cfg.height, cfg.width)
    return colors.reshape(cfg.height, cfg.width, 3)


def render_soft(scene: Scene, config: RenderConfig, **kw):
    """float32 render with soft (differentiable) shadows."""
    return render_soft_f32(scene, config, **kw)


def image_loss(scene: Scene, target, config: RenderConfig, **kw):
    """Mean squared error against a float32 target image."""
    return torch.mean((render_soft(scene, config, **kw) - target) ** 2)


def trainable(params: dict) -> dict:
    """Copies of ``params`` (e.g. ``material_params(scene)``) as leaves that
    require gradients, for an optimizer to update."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


def make_train_step(config: RenderConfig, optimizer: torch.optim.Optimizer, merge_fn, **kw):
    """An inverse-rendering step: ``step(params, scene, target) -> loss``.

    ``params`` is a dict of leaf tensors (``trainable``), ``optimizer`` a
    ``torch.optim`` optimizer over them, ``merge_fn(scene, params) ->
    scene`` substitutes them (``merge_material_params`` and the like).  A
    step zeroes the gradients, renders, backpropagates the image loss and
    steps the optimizer, which updates ``params`` in place and keeps its own
    state between steps.  For SGD without momentum the state is empty, so
    a step from parameters carried across out of raytpu is raytpu's step with
    ``optax.sgd``.  ``kw`` goes to ``render_soft_f32``."""

    def step(params: dict, scene: Scene, target):
        optimizer.zero_grad(set_to_none=True)
        loss = image_loss(merge_fn(scene, params), target, config, **kw)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# -- parameter selections for inverse rendering -------------------------------


def material_params(scene: Scene) -> dict:
    return {"color": scene.materials.color, "params": scene.materials.params}


def merge_material_params(scene: Scene, p: dict) -> Scene:
    mats = dataclasses.replace(scene.materials, color=p["color"], params=p["params"])
    return dataclasses.replace(scene, materials=mats)


def light_params(scene: Scene) -> dict:
    return {"position": scene.lights.position, "color": scene.lights.color,
            "intensity": scene.lights.intensity}


def merge_light_params(scene: Scene, p: dict) -> Scene:
    lights = dataclasses.replace(scene.lights, position=p["position"], color=p["color"],
                                 intensity=p["intensity"])
    return dataclasses.replace(scene, lights=lights)


def geometry_params(scene: Scene) -> dict:
    return {"sphere_center": scene.spheres.center, "sphere_radius": scene.spheres.radius,
            "mesh_positions": scene.meshes.positions,
            "mesh_translation": scene.meshes.translation}


def merge_geometry_params(scene: Scene, p: dict) -> Scene:
    spheres = dataclasses.replace(scene.spheres, center=p["sphere_center"],
                                  radius=p["sphere_radius"])
    meshes = dataclasses.replace(scene.meshes, translation=p["mesh_translation"])
    meshes = meshes.with_positions(p["mesh_positions"])  # also refreshes the face normals
    return dataclasses.replace(scene, spheres=spheres).with_meshes(meshes)
