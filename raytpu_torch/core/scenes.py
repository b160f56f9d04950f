"""The course scenes and the stress meshes, as builders
(reference: source/Scene.cpp:163-475).

Counterpart of ``raytpu/core/scenes.py``.  Each entry builds a Scene on a
device (``build(device)``) and has an ``animate(scene, t)`` function in place
of the reference's ``Scene::Update`` overrides.  The OBJ scenes read
raytpu's assets (``raytpu_torch.core.obj``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np

from raytpu_torch.core import obj
from raytpu_torch.core.types import CullMode, Scene, SceneBuilder

PI_DIV_2 = 1.57079632679489661923

# Named colors (reference: source/ColorRGB.h:137-148)
RED = (1.0, 0.0, 0.0)
BLUE = (0.0, 0.0, 1.0)
GREEN = (0.0, 1.0, 0.0)
YELLOW = (1.0, 1.0, 0.0)
MAGENTA = (1.0, 0.0, 1.0)
WHITE = (1.0, 1.0, 1.0)


class SceneSpec(NamedTuple):
    build: Callable[..., Scene]  # build(device="cuda")
    animate: Callable[[Scene, float], Scene]
    description: str


def _static(scene: Scene, t) -> Scene:
    return scene


def _cos_yaw(scene: Scene, t) -> Scene:
    """yaw = (cos(t)+1)/2 * 2π (reference: source/Scene.cpp:394)."""
    return scene.update(t)


def _linear_yaw(scene: Scene, t) -> Scene:
    """yaw = π/2 * t (reference: source/Scene.cpp:326)."""
    return scene.with_mesh_yaw(PI_DIV_2 * t)


def _add_room_planes(b: SceneBuilder, mat: int, half_extent=5.0, height=10.0, depth=10.0):
    """The W3/W4 room: back wall, floor, ceiling, right, left
    (reference: source/Scene.cpp:348-352)."""
    b.add_plane((0.0, 0.0, depth), (0.0, 0.0, -1.0), mat)
    b.add_plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), mat)
    b.add_plane((0.0, height, 0.0), (0.0, -1.0, 0.0), mat)
    b.add_plane((half_extent, 0.0, 0.0), (-1.0, 0.0, 0.0), mat)
    b.add_plane((-half_extent, 0.0, 0.0), (1.0, 0.0, 0.0), mat)


def _add_w4_lights(b: SceneBuilder):
    """(reference: source/Scene.cpp:387-389)."""
    b.add_point_light((0.0, 5.0, 5.0), 50.0, (1.0, 0.61, 0.45))
    b.add_point_light((-2.5, 5.0, -5.0), 70.0, (1.0, 0.8, 0.45))
    b.add_point_light((2.5, 2.5, -5.0), 50.0, (0.34, 0.47, 0.68))


def _add_ct_sphere_grid(b: SceneBuilder):
    """Six Cook-Torrance spheres, metal/plastic x rough/medium/smooth
    (reference: source/Scene.cpp:336-360)."""
    metal_rough = b.add_cook_torrance((0.972, 0.960, 0.915), 1.0, 1.0)
    metal_med = b.add_cook_torrance((0.972, 0.960, 0.915), 1.0, 0.6)
    metal_smooth = b.add_cook_torrance((0.972, 0.960, 0.915), 1.0, 0.1)
    plastic_rough = b.add_cook_torrance((0.75, 0.75, 0.75), 0.0, 1.0)
    plastic_med = b.add_cook_torrance((0.75, 0.75, 0.75), 0.0, 0.6)
    plastic_smooth = b.add_cook_torrance((0.75, 0.75, 0.75), 0.0, 0.1)
    b.add_sphere((-1.75, 1.0, 0.0), 0.75, metal_rough)
    b.add_sphere((0.0, 1.0, 0.0), 0.75, metal_med)
    b.add_sphere((1.75, 1.0, 0.0), 0.75, metal_smooth)
    b.add_sphere((-1.75, 3.0, 0.0), 0.75, plastic_rough)
    b.add_sphere((0.0, 3.0, 0.0), 0.75, plastic_med)
    b.add_sphere((1.75, 3.0, 0.0), 0.75, plastic_smooth)


def scene_w1(device="cuda") -> Scene:
    """Two spheres + five solid-color planes (reference: source/Scene.cpp:164-184).
    The reference never sets this scene's FOV; the intended 90° is used."""
    b = SceneBuilder()
    red = 0
    blue = b.add_solid_color(BLUE)
    yellow = b.add_solid_color(YELLOW)
    green = b.add_solid_color(GREEN)
    magenta = b.add_solid_color(MAGENTA)
    b.add_sphere((-25.0, 0.0, 100.0), 50.0, red)
    b.add_sphere((25.0, 0.0, 100.0), 50.0, blue)
    b.add_plane((-75.0, 0.0, 0.0), (1.0, 0.0, 0.0), green)
    b.add_plane((75.0, 0.0, 0.0), (-1.0, 0.0, 0.0), green)
    b.add_plane((0.0, -75.0, 0.0), (0.0, 1.0, 0.0), yellow)
    b.add_plane((0.0, 75.0, 0.0), (0.0, -1.0, 0.0), yellow)
    b.add_plane((0.0, 0.0, 125.0), (0.0, 0.0, -1.0), magenta)
    b.set_camera((0.0, 0.0, 0.0), fov_degrees=90.0)
    return b.build(device)


def scene_w2(device="cuda") -> Scene:
    """Sphere grid in a box, one point light (reference: source/Scene.cpp:188-218)."""
    b = SceneBuilder()
    red = 0
    blue = b.add_solid_color(BLUE)
    yellow = b.add_solid_color(YELLOW)
    green = b.add_solid_color(GREEN)
    magenta = b.add_solid_color(MAGENTA)
    b.add_plane((-5.0, 0.0, 0.0), (1.0, 0.0, 0.0), green)
    b.add_plane((5.0, 0.0, 0.0), (-1.0, 0.0, 0.0), green)
    b.add_plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), yellow)
    b.add_plane((0.0, 10.0, 0.0), (0.0, -1.0, 0.0), yellow)
    b.add_plane((0.0, 0.0, 10.0), (0.0, 0.0, -1.0), magenta)
    b.add_sphere((-1.75, 1.0, 0.0), 0.75, red)
    b.add_sphere((0.0, 1.0, 0.0), 0.75, blue)
    b.add_sphere((1.75, 1.0, 0.0), 0.75, red)
    b.add_sphere((-1.75, 3.0, 0.0), 0.75, blue)
    b.add_sphere((0.0, 3.0, 0.0), 0.75, red)
    b.add_sphere((1.75, 3.0, 0.0), 0.75, blue)
    b.add_point_light((0.0, 5.0, -5.0), 70.0, WHITE)
    b.set_camera((0.0, 3.0, -9.0), fov_degrees=45.0)
    return b.build(device)


def scene_w3_test(device="cuda") -> Scene:
    """Lambert + LambertPhong spheres, two lights (reference: source/Scene.cpp:223-243)."""
    b = SceneBuilder()
    lam_red = b.add_lambert(RED, 1.0)
    lp_blue = b.add_lambert_phong(BLUE, 1.0, 1.0, 60.0)
    lam_yellow = b.add_lambert(YELLOW, 1.0)
    b.add_plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), lam_yellow)
    b.add_sphere((-0.75, 1.0, 0.0), 1.0, lam_red)
    b.add_sphere((0.75, 1.0, 0.0), 1.0, lp_blue)
    b.add_point_light((0.0, 5.0, 5.0), 25.0, WHITE)
    b.add_point_light((0.0, 2.5, -5.0), 25.0, WHITE)
    b.set_camera((0.0, 1.0, -5.0), fov_degrees=45.0)
    return b.build(device)


def scene_w3(device="cuda") -> Scene:
    """Cook-Torrance sphere grid + three colored lights
    (reference: source/Scene.cpp:245-286)."""
    b = SceneBuilder()
    gray_blue = b.add_lambert((0.49, 0.57, 0.57), 1.0)
    _add_room_planes(b, gray_blue)
    _add_ct_sphere_grid(b)
    _add_w4_lights(b)
    b.set_camera((0.0, 3.0, -9.0), fov_degrees=45.0)
    return b.build(device)


def scene_w4_test(device="cuda") -> Scene:
    """simple_object.obj mesh, rotating (reference: source/Scene.cpp:289-328)."""
    b = SceneBuilder()
    gray_blue = b.add_lambert((0.49, 0.57, 0.57), 1.0)
    white = b.add_lambert(WHITE, 1.0)
    _add_room_planes(b, gray_blue)
    pos, nrm, idx = obj.parse_obj("simple_object.obj")
    m = b.add_triangle_mesh(CullMode.BACK_FACE, white)
    m.set_geometry(pos, idx, nrm)
    m.scale((0.7, 0.7, 0.7))
    m.translate((0.0, 1.0, 0.0))
    _add_w4_lights(b)
    b.set_camera((0.0, 1.0, -5.0), fov_degrees=45.0)
    return b.build(device)


def scene_w4_reference(device="cuda") -> Scene:
    """The default benchmark scene: CT sphere grid + 3 one-triangle meshes with
    the three cull modes + 3 point lights (reference: source/Scene.cpp:330-400)."""
    b = SceneBuilder()
    gray_blue = b.add_lambert((0.49, 0.57, 0.57), 1.0)
    white = b.add_lambert(WHITE, 1.0)
    _add_room_planes(b, gray_blue)
    _add_ct_sphere_grid(b)
    tri = ((-0.75, 1.5, 0.0), (0.75, 0.0, 0.0), (-0.75, 0.0, 0.0))
    for cull, tx in (
        (CullMode.BACK_FACE, -1.75),
        (CullMode.FRONT_FACE, 0.0),
        (CullMode.NONE, 1.75),
    ):
        m = b.add_triangle_mesh(cull, white)
        m.append_triangle(*tri)
        m.translate((tx, 4.5, 0.0))
    _add_w4_lights(b)
    b.set_camera((0.0, 3.0, -9.0), fov_degrees=45.0)
    return b.build(device)


def scene_w4_bunny(device="cuda") -> Scene:
    """lowpoly_bunny2.obj at 2x scale in the room (reference: source/Scene.cpp:402-437)."""
    b = SceneBuilder()
    gray_blue = b.add_lambert((0.49, 0.57, 0.57), 1.0)
    white = b.add_lambert(WHITE, 1.0)
    pos, nrm, idx = obj.parse_obj("lowpoly_bunny2.obj")
    m = b.add_triangle_mesh(CullMode.BACK_FACE, white)
    m.set_geometry(pos, idx, nrm)
    m.scale((2.0, 2.0, 2.0))
    _add_room_planes(b, gray_blue)
    _add_w4_lights(b)
    b.set_camera((0.0, 3.0, -9.0), fov_degrees=45.0)
    return b.build(device)


def _subdivide(pos, idx, levels: int):
    """Midpoint 1->4 triangle subdivision with no smoothing: the surface is
    the base mesh's, so renders match it up to shared-edge ties.  Stress
    geometry for the big-mesh kernels; the reference has no such scene."""
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    idx = np.asarray(idx, np.int64).reshape(-1, 3)
    for _ in range(levels):
        a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
        edges = np.stack([np.stack([a, b], 1), np.stack([b, c], 1), np.stack([c, a], 1)],
                         axis=1).reshape(-1, 2)  # (3F, 2)
        uniq, inv = np.unique(np.sort(edges, axis=1), axis=0, return_inverse=True)
        mid = 0.5 * (pos[uniq[:, 0]] + pos[uniq[:, 1]])
        mids = inv.reshape(-1, 3) + len(pos)  # (F, 3): [mab, mbc, mca]
        mab, mbc, mca = mids[:, 0], mids[:, 1], mids[:, 2]
        pos = np.concatenate([pos, mid.astype(np.float32)], axis=0)
        idx = np.concatenate([np.stack([a, mab, mca], 1), np.stack([mab, b, mbc], 1),
                              np.stack([mca, mbc, c], 1), np.stack([mab, mbc, mca], 1)], axis=0)
    return pos, idx.astype(np.int32)


def scene_bunny_subdiv(levels: int = 4, device="cuda") -> Scene:
    """The bunny room with the mesh midpoint-subdivided ``levels`` times,
    292 * 4^levels triangles (4 -> 74,752; 5 -> 299,008).  Same surface as
    ``bunny``, so images match it up to edge-tie flips."""
    b = SceneBuilder()
    gray_blue = b.add_lambert((0.49, 0.57, 0.57), 1.0)
    white = b.add_lambert(WHITE, 1.0)
    pos, _, idx = obj.parse_obj("lowpoly_bunny2.obj")
    pos, idx = _subdivide(pos, idx, levels)
    m = b.add_triangle_mesh(CullMode.BACK_FACE, white)
    m.set_geometry(pos, idx.reshape(-1), None)  # per-face normals recomputed
    m.scale((2.0, 2.0, 2.0))
    _add_room_planes(b, gray_blue)
    _add_w4_lights(b)
    b.set_camera((0.0, 3.0, -9.0), fov_degrees=45.0)
    return b.build(device)


def scene_w4_optional(device="cuda") -> Scene:
    """Assignment3D1.obj at 0.03x scale, Cook-Torrance orange
    (reference: source/Scene.cpp:439-467)."""
    b = SceneBuilder()
    gray_blue = b.add_lambert((0.49, 0.57, 0.57), 1.0)
    orange_ct = b.add_cook_torrance((0.72, 0.254, 0.055), 1.0, 0.7)
    pos, nrm, idx = obj.parse_obj("Assignment3D1.obj")
    m = b.add_triangle_mesh(CullMode.BACK_FACE, orange_ct)
    m.set_geometry(pos, idx, nrm)
    m.scale((0.03, 0.03, 0.03))
    _add_room_planes(b, gray_blue)
    _add_w4_lights(b)
    b.set_camera((0.0, 2.0, -9.0), fov_degrees=45.0)
    return b.build(device)


def scene_single_sphere(device="cuda") -> Scene:
    """One Lambert sphere + one point light."""
    b = SceneBuilder()
    lam = b.add_lambert((0.8, 0.2, 0.2), 1.0)
    b.add_sphere((0.0, 0.0, 3.0), 1.0, lam)
    b.add_point_light((2.0, 2.0, 0.0), 25.0, WHITE)
    b.set_camera((0.0, 0.0, -2.0), fov_degrees=45.0)
    return b.build(device)


def scene_phong(device="cuda") -> Scene:
    """Spheres + plane with Phong specular and hard shadows."""
    b = SceneBuilder()
    floor = b.add_lambert((0.5, 0.5, 0.5), 1.0)
    lp1 = b.add_lambert_phong((0.2, 0.2, 0.9), 0.6, 0.6, 20.0)
    lp2 = b.add_lambert_phong((0.9, 0.4, 0.1), 0.6, 0.8, 60.0)
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), floor)
    b.add_sphere((-1.2, 0.0, 4.0), 1.0, lp1)
    b.add_sphere((1.2, 0.0, 4.5), 1.0, lp2)
    b.add_sphere((0.0, 1.6, 5.5), 0.8, lp1)
    b.add_point_light((0.0, 5.0, 0.0), 60.0, WHITE)
    b.add_point_light((-3.0, 3.0, 2.0), 30.0, (1.0, 0.8, 0.6))
    b.set_camera((0.0, 1.0, -2.0), fov_degrees=55.0)
    return b.build(device)


REGISTRY: dict[str, SceneSpec] = {
    "sphere": SceneSpec(scene_single_sphere, _static, "1 Lambert sphere + 1 light"),
    "phong": SceneSpec(scene_phong, _static, "spheres + plane, Phong + hard shadows"),
    "w1": SceneSpec(scene_w1, _static, "2 spheres + 5 planes, solid colors"),
    "w2": SceneSpec(scene_w2, _static, "6 spheres + box + 1 point light"),
    "w3_test": SceneSpec(scene_w3_test, _static, "Lambert/LambertPhong spheres"),
    "w3": SceneSpec(scene_w3, _static, "Cook-Torrance sphere grid + 3 lights"),
    "w4_test": SceneSpec(scene_w4_test, _linear_yaw, "rotating simple_object.obj"),
    "reference": SceneSpec(scene_w4_reference, _cos_yaw, "default benchmark scene"),
    "bunny": SceneSpec(scene_w4_bunny, _cos_yaw, "lowpoly bunny x2"),
    "bunny50k": SceneSpec(functools.partial(scene_bunny_subdiv, 4), _cos_yaw,
                          "bunny subdivided 4x (74,752 triangles)"),
    "bunny300k": SceneSpec(functools.partial(scene_bunny_subdiv, 5), _cos_yaw,
                           "bunny subdivided 5x (299,008 triangles)"),
    "optional": SceneSpec(scene_w4_optional, _cos_yaw, "Assignment3D1 x0.03 CT orange"),
}


def get(name: str) -> SceneSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown scene '{name}'; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
