"""Scene schema: frozen dataclasses of tensors.

Counterpart of ``raytpu/core/types.py``, with the same fields and enum order.
A scene is flat float32 / int32 tensors on one device: spheres, planes and
triangles as structure-of-arrays, materials as a parameter table indexed by
id, meshes as a shared vertex pool plus per-mesh transforms so that one frame
of animation is a few batched tensor ops.  ``.to(device)`` moves a whole
scene.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from raytpu_torch.core import math3d


class CullMode(enum.IntEnum):
    """Triangle cull modes (reference: source/DataTypes.h:29-34)."""

    FRONT_FACE = 0
    BACK_FACE = 1
    NONE = 2


class LightKind(enum.IntEnum):
    POINT = 0
    DIRECTIONAL = 1


class MaterialKind(enum.IntEnum):
    """Material families (reference: source/Material.h:34,54,74,99)."""

    SOLID = 0
    LAMBERT = 1
    LAMBERT_PHONG = 2
    COOK_TORRANCE = 3


class LightingMode(enum.IntEnum):
    """Debug lighting modes (reference: source/Renderer.h:40-48)."""

    OBSERVED_AREA = 0
    RADIANCE = 1
    BRDF = 2
    COMBINED = 3


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _i32(x, device):
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


class _Tensors:
    """``.to(device)`` for a frozen dataclass whose fields are tensors or
    other such dataclasses."""

    def to(self, device):
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


@dataclass(frozen=True)
class Camera(_Tensors):
    """Pinhole camera.  ``fov_scale`` is ``tan(fov_angle/2)``, like the
    reference's ``Camera::fov`` (reference: source/Camera.h:55-59)."""

    origin: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    fov_scale: torch.Tensor  # ()

    @staticmethod
    def create(origin=(0.0, 0.0, 0.0), forward=math3d.UNIT_Z, fov_degrees=90.0,
               device="cuda") -> "Camera":
        fov_degrees = float(np.clip(fov_degrees, 10.0, 175.0))
        # the tangent is taken by numpy in float32, exactly as raytpu does
        fov_scale = np.float32(np.tan(np.float32(fov_degrees) * np.float32(math3d.TO_RADIANS) / 2.0))
        return Camera(_f32(origin, device), _f32(forward, device), _f32(fov_scale, device))

    def with_fov(self, fov_degrees: float) -> "Camera":
        """The field of view clamped to [10, 175] degrees, its tangent taken
        in float32 as ``create`` takes it; filled on the camera's device."""
        fov_degrees = float(np.clip(fov_degrees, 10.0, 175.0))
        fov_scale = np.float32(np.tan(np.float32(fov_degrees) * np.float32(math3d.TO_RADIANS) / 2.0))
        return dataclasses.replace(self, fov_scale=math3d.scalar(float(fov_scale),
                                                                 self.origin.device))

    def with_orientation(self, pitch, yaw) -> "Camera":
        """Forward from pitch and yaw: UnitZ through ``Rx(pitch) @ Ry(yaw)``,
        row-vector order (reference: source/Camera.h:61-66).  The angles are
        numbers or tensors; numbers are filled on the camera's device."""
        dev = self.origin.device
        rot = math3d.mat_rotation(pitch, yaw, 0.0, device=dev)
        unit_z = (torch.arange(3, device=dev) == 2).to(torch.float32)  # UNIT_Z
        return dataclasses.replace(self, forward=math3d.transform_vector(rot, unit_z))

    def onb(self):
        """Camera-to-world basis: ``right = normalize(UnitY x fwd)``,
        ``up = normalize(fwd x right)`` (reference: source/Camera.h:43-53)."""
        unit_y = (torch.arange(3, device=self.forward.device) == 1).to(torch.float32)  # UNIT_Y
        right = math3d.normalize(math3d.cross(unit_y, self.forward))
        up = math3d.normalize(math3d.cross(self.forward, right))
        return right, up, self.forward


@dataclass(frozen=True)
class Spheres(_Tensors):
    center: torch.Tensor  # (S,3)
    radius: torch.Tensor  # (S,)
    material: torch.Tensor  # (S,) i32

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclass(frozen=True)
class Planes(_Tensors):
    origin: torch.Tensor  # (P,3)
    normal: torch.Tensor  # (P,3)
    material: torch.Tensor  # (P,) i32

    @property
    def count(self) -> int:
        return self.origin.shape[0]


@dataclass(frozen=True)
class Triangles(_Tensors):
    """World-space triangle soup (all meshes flattened)."""

    v0: torch.Tensor  # (T,3)
    v1: torch.Tensor  # (T,3)
    v2: torch.Tensor  # (T,3)
    normal: torch.Tensor  # (T,3) unit face normals
    cull: torch.Tensor  # (T,) i32 CullMode
    material: torch.Tensor  # (T,) i32

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@dataclass(frozen=True)
class Meshes(_Tensors):
    """Object-space mesh pool plus per-mesh transforms; world-space triangles
    are recomputed each frame from the shared vertex pool
    (reference: source/DataTypes.h:210-236)."""

    positions: torch.Tensor  # (V,3) object-space vertex pool
    face_vertex: torch.Tensor  # (T,3) i32 indices into positions
    face_normal: torch.Tensor  # (T,3) object-space unit face normals
    face_mesh: torch.Tensor  # (T,) i32 mesh id per face
    vertex_mesh: torch.Tensor  # (V,) i32 mesh id per vertex
    cull: torch.Tensor  # (N,) i32 per-mesh cull mode
    material: torch.Tensor  # (N,) i32 per-mesh material id
    scale: torch.Tensor  # (N,3)
    rotation: torch.Tensor  # (N,3,3) row-vector rotation
    translation: torch.Tensor  # (N,3)

    @property
    def num_meshes(self) -> int:
        return self.cull.shape[0]

    @property
    def num_faces(self) -> int:
        return self.face_vertex.shape[0]

    def with_rotation_y(self, yaw) -> "Meshes":
        """Set every mesh's rotation to RotateY(yaw); ``yaw`` is a scalar or
        (N,) (reference: source/DataTypes.h:162-165)."""
        dev = self.rotation.device
        yaw = torch.as_tensor(yaw, dtype=torch.float32, device=dev).expand(self.num_meshes)
        c, s = torch.cos(yaw), torch.sin(yaw)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack(
            [torch.stack([c, z, -s], dim=-1),
             torch.stack([z, o, z], dim=-1),
             torch.stack([s, z, c], dim=-1)],
            dim=-2,
        )
        return dataclasses.replace(self, rotation=rot)

    def with_positions(self, positions) -> "Meshes":
        """Replace the vertex pool and recompute the object-space face
        normals, ``normalize(cross(v1-v0, v2-v0))`` (reference:
        source/DataTypes.h:191-208), as vertices being optimized need."""
        v = math3d.gather_rows(positions, self.face_vertex)
        n = math3d.normalize_safe(math3d.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
        return dataclasses.replace(self, positions=positions, face_normal=n)

    def world_triangles(self) -> Triangles:
        """Positions through ``S·R·T`` (scale, rotate, translate in row-vector
        order), face normals through the 3x3 part and re-normalized
        (reference: source/DataTypes.h:210-236)."""
        lin = self.scale[:, :, None] * self.rotation  # (N,3,3) == diag(s) @ R
        vm, fm = self.vertex_mesh, self.face_mesh
        wpos = (_row_times(self.positions, math3d.gather_rows(lin, vm))
                + math3d.gather_rows(self.translation, vm))
        n = _row_times(self.face_normal, math3d.gather_rows(lin, fm))
        # the sum of squares unfused, as raytpu's op-by-op jnp.sum(n*n) rounds it
        n_len = torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2])
        wnrm = n / n_len[:, None]
        v = math3d.gather_rows(wpos, self.face_vertex)  # (T,3,3)
        return Triangles(
            v0=v[:, 0], v1=v[:, 1], v2=v[:, 2], normal=wnrm,
            cull=math3d.gather_rows(self.cull, fm),
            material=math3d.gather_rows(self.material, fm),
        )

    @staticmethod
    def empty(device="cuda") -> "Meshes":
        def f(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        def i(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        return Meshes(positions=f(0, 3), face_vertex=i(0, 3), face_normal=f(0, 3),
                      face_mesh=i(0), vertex_mesh=i(0), cull=i(0), material=i(0),
                      scale=f(0, 3), rotation=f(0, 3, 3), translation=f(0, 3))


def _row_times(v, m):
    """Batched row vector times matrix, ``v[k] @ m[k]``, as
    ``fma(z, m2, fma(y, m1, x*m0))``: the rounding of raytpu's
    ``jnp.einsum`` on the CPU, so that an animated mesh's world triangles
    are bit-identical in both packages."""
    return math3d.fma(v[:, 2:3], m[:, 2], math3d.fma(v[:, 1:2], m[:, 1], v[:, 0:1] * m[:, 0]))


@dataclass(frozen=True)
class Lights(_Tensors):
    position: torch.Tensor  # (L,3)
    direction: torch.Tensor  # (L,3)
    color: torch.Tensor  # (L,3)
    intensity: torch.Tensor  # (L,)
    kind: torch.Tensor  # (L,) i32 LightKind

    @property
    def count(self) -> int:
        return self.position.shape[0]


@dataclass(frozen=True)
class Materials(_Tensors):
    """Material parameter table; shading selects on ``kind``
    (reference: source/Material.h:27).

    params by kind:
      SOLID:          unused
      LAMBERT:        [kd, -, -]
      LAMBERT_PHONG:  [kd, ks, phong_exponent]
      COOK_TORRANCE:  [metalness, roughness, -]
    ``color`` is the solid color / diffuse color / albedo.
    """

    kind: torch.Tensor  # (M,) i32
    color: torch.Tensor  # (M,3)
    params: torch.Tensor  # (M,3)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclass(frozen=True)
class Scene(_Tensors):
    """Geometry, lights, materials and camera.  ``triangles`` caches the
    world-space soup for the current mesh transforms; ``update(t)`` animates."""

    spheres: Spheres
    planes: Planes
    meshes: Meshes
    triangles: Triangles
    lights: Lights
    materials: Materials
    camera: Camera

    @property
    def device(self) -> torch.device:
        return self.camera.origin.device

    def with_meshes(self, meshes: Meshes) -> "Scene":
        return dataclasses.replace(self, meshes=meshes, triangles=meshes.world_triangles())

    def with_mesh_yaw(self, yaw) -> "Scene":
        return self.with_meshes(self.meshes.with_rotation_y(yaw))

    def with_camera(self, camera: Camera) -> "Scene":
        return dataclasses.replace(self, camera=camera)

    def update(self, total_time) -> "Scene":
        """Every mesh yaws by ``(cos(t)+1)/2 * 2π`` (reference:
        source/Scene.cpp:394).  ``total_time`` may be a tensor on the scene's
        device, so an animated frame needs nothing from the host."""
        if self.meshes.num_meshes == 0:
            return self
        t = torch.as_tensor(total_time, dtype=torch.float32, device=self.device)
        yaw = (torch.cos(t) + 1.0) / 2.0 * float(np.float32(math3d.PI_2))
        return self.with_mesh_yaw(yaw)

    @property
    def num_primitives(self) -> int:
        return self.spheres.count + self.planes.count + self.triangles.count


@dataclass(frozen=True)
class RenderConfig:
    """Static render settings (reference: source/Renderer.cpp:21-22,
    source/main.cpp:70-81)."""

    width: int = 640
    height: int = 480
    lighting_mode: LightingMode = LightingMode.COMBINED
    shadows: bool = True
    shadow_dim: float = 0.95  # per-occluded-light pixel dimming factor
    ray_min: float = 1e-4
    normal_offset: float = 1e-4
    soft_shadows: bool = False  # differentiable (sigmoid) visibility
    soft_beta: float = 300.0  # sharpness of the soft visibility sigmoid
    ray_chunk: Optional[int] = None  # rays per eager chunk (None = auto)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height


# ---------------------------------------------------------------------------
# Builder: the host-side mirror of the reference's Scene::Add* helpers
# (reference: source/Scene.cpp:99-159).
# ---------------------------------------------------------------------------

#: Largest mesh soup the builder keeps in insertion order, so that small
#: scenes keep the reference's tie-break; larger ones are reordered by SAH
#: leaf order (``raytpu_torch.ops.accel.reorder_scene_triangles``), as in raytpu.
MAX_UNORDERED_FACES = 256


@dataclass
class _MeshAccum:
    cull: int
    material: int
    positions: list = field(default_factory=list)
    indices: list = field(default_factory=list)  # flat, 3 per face
    normals: list = field(default_factory=list)  # per-face, optional
    scale: tuple = (1.0, 1.0, 1.0)
    yaw: float = 0.0
    translation: tuple = (0.0, 0.0, 0.0)


class MeshHandle:
    """Handle returned by ``SceneBuilder.add_triangle_mesh``; mirrors the
    TriangleMesh mutators (reference: source/DataTypes.h:157-189)."""

    def __init__(self, accum: _MeshAccum):
        self._a = accum

    def append_triangle(self, v0, v1, v2, normal=None):
        a = self._a
        base = len(a.positions)
        a.positions += [tuple(v0), tuple(v1), tuple(v2)]
        a.indices += [base, base + 1, base + 2]
        if normal is None:
            e1 = np.asarray(v1, np.float32) - np.asarray(v0, np.float32)
            e2 = np.asarray(v2, np.float32) - np.asarray(v0, np.float32)
            n = np.cross(e1, e2)
            n = n / np.linalg.norm(n)
            normal = tuple(n.tolist())
        a.normals.append(tuple(normal))
        return self

    def set_geometry(self, positions, indices, normals=None):
        a = self._a
        a.positions = [tuple(p) for p in positions]
        a.indices = [int(i) for i in indices]
        a.normals = [tuple(n) for n in normals] if normals is not None else []
        return self

    def scale(self, s):
        self._a.scale = tuple(float(x) for x in s)
        return self

    def rotate_y(self, yaw):
        self._a.yaw = float(yaw)
        return self

    def translate(self, t):
        self._a.translation = tuple(float(x) for x in t)
        return self


class SceneBuilder:
    """Host-side scene assembly producing a frozen Scene.  Starts with
    material 0 = solid red, like the reference (reference: source/Scene.cpp:9-16)."""

    def __init__(self, default_material: bool = True):
        self._mat_kind, self._mat_color, self._mat_params = [], [], []
        if default_material:
            self.add_solid_color((1.0, 0.0, 0.0))
        self._sph_c, self._sph_r, self._sph_m = [], [], []
        self._pl_o, self._pl_n, self._pl_m = [], [], []
        self._meshes: list[_MeshAccum] = []
        self._li_p, self._li_d, self._li_c, self._li_i, self._li_k = [], [], [], [], []
        self.camera = Camera.create(device="cpu")

    # -- materials ---------------------------------------------------------
    def _add_material(self, kind, color, params):
        self._mat_kind.append(int(kind))
        self._mat_color.append(tuple(color))
        self._mat_params.append(tuple(params))
        return len(self._mat_kind) - 1

    def add_solid_color(self, color):
        return self._add_material(MaterialKind.SOLID, color, (0.0, 0.0, 0.0))

    def add_lambert(self, diffuse_color, kd):
        return self._add_material(MaterialKind.LAMBERT, diffuse_color, (kd, 0.0, 0.0))

    def add_lambert_phong(self, diffuse_color, kd, ks, phong_exponent):
        return self._add_material(MaterialKind.LAMBERT_PHONG, diffuse_color, (kd, ks, phong_exponent))

    def add_cook_torrance(self, albedo, metalness, roughness):
        return self._add_material(MaterialKind.COOK_TORRANCE, albedo, (metalness, roughness, 0.0))

    # -- geometry ----------------------------------------------------------
    def add_sphere(self, origin, radius, material):
        self._sph_c.append(tuple(origin))
        self._sph_r.append(float(radius))
        self._sph_m.append(int(material))
        return self

    def add_plane(self, origin, normal, material):
        self._pl_o.append(tuple(origin))
        self._pl_n.append(tuple(normal))
        self._pl_m.append(int(material))
        return self

    def add_triangle_mesh(self, cull: CullMode, material: int) -> MeshHandle:
        a = _MeshAccum(cull=int(cull), material=int(material))
        self._meshes.append(a)
        return MeshHandle(a)

    # -- lights ------------------------------------------------------------
    def add_point_light(self, origin, intensity, color):
        self._li_p.append(tuple(origin))
        self._li_d.append((0.0, 0.0, 1.0))
        self._li_c.append(tuple(color))
        self._li_i.append(float(intensity))
        self._li_k.append(int(LightKind.POINT))
        return self

    def add_directional_light(self, direction, intensity, color):
        """Directional light with correct direction semantics (the
        reference's directional branch is dead code, reference: source/Utils.h:348)."""
        self._li_p.append((0.0, 0.0, 0.0))
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        self._li_d.append(tuple(d.tolist()))
        self._li_c.append(tuple(color))
        self._li_i.append(float(intensity))
        self._li_k.append(int(LightKind.DIRECTIONAL))
        return self

    # -- camera ------------------------------------------------------------
    def set_camera(self, origin, fov_degrees=90.0, forward=math3d.UNIT_Z):
        self.camera = Camera.create(origin, forward, fov_degrees, device="cpu")
        return self

    # -- build -------------------------------------------------------------
    def build(self, device="cuda") -> Scene:
        meshes = self._build_meshes(device)

        def vec3(rows):
            return _f32(np.asarray(rows, np.float32).reshape(-1, 3), device)

        scene = Scene(
            spheres=Spheres(center=vec3(self._sph_c), radius=_f32(self._sph_r, device),
                            material=_i32(self._sph_m, device)),
            planes=Planes(origin=vec3(self._pl_o), normal=vec3(self._pl_n),
                          material=_i32(self._pl_m, device)),
            meshes=meshes,
            triangles=meshes.world_triangles(),
            lights=Lights(position=vec3(self._li_p), direction=vec3(self._li_d),
                          color=vec3(self._li_c), intensity=_f32(self._li_i, device),
                          kind=_i32(self._li_k, device)),
            materials=Materials(kind=_i32(self._mat_kind, device), color=vec3(self._mat_color),
                                params=vec3(self._mat_params)),
            camera=self.camera.to(device),
        )
        if meshes.num_faces > MAX_UNORDERED_FACES:
            from raytpu_torch.ops import accel

            scene = accel.reorder_scene_triangles(scene)
        return scene

    def _build_meshes(self, device) -> Meshes:
        if not self._meshes:
            return Meshes.empty(device)
        positions, face_vertex, face_normal = [], [], []
        face_mesh, vertex_mesh = [], []
        cull, material, scale, yaw, translation = [], [], [], [], []
        v_base = 0
        for mid, a in enumerate(self._meshes):
            pos = np.asarray(a.positions, np.float32).reshape(-1, 3)
            idx = np.asarray(a.indices, np.int32).reshape(-1, 3)
            if a.normals:
                nrm = np.asarray(a.normals, np.float32).reshape(-1, 3)
            else:
                # per-face normals from cross(e1, e2), normalized
                # (reference: source/DataTypes.h:191-208)
                v = pos[idx]
                n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
                nrm = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
            positions.append(pos)
            face_vertex.append(idx + v_base)
            face_normal.append(nrm)
            face_mesh.append(np.full((idx.shape[0],), mid, np.int32))
            vertex_mesh.append(np.full((pos.shape[0],), mid, np.int32))
            cull.append(a.cull)
            material.append(a.material)
            scale.append(a.scale)
            yaw.append(a.yaw)
            translation.append(a.translation)
            v_base += pos.shape[0]
        yaw_arr = np.asarray(yaw, np.float32)
        c, s = np.cos(yaw_arr), np.sin(yaw_arr)
        rot = np.zeros((len(self._meshes), 3, 3), np.float32)
        rot[:, 0, 0] = c
        rot[:, 0, 2] = -s
        rot[:, 1, 1] = 1.0
        rot[:, 2, 0] = s
        rot[:, 2, 2] = c
        return Meshes(
            positions=_f32(np.concatenate(positions, axis=0), device),
            face_vertex=_i32(np.concatenate(face_vertex, axis=0), device),
            face_normal=_f32(np.concatenate(face_normal, axis=0), device),
            face_mesh=_i32(np.concatenate(face_mesh, axis=0), device),
            vertex_mesh=_i32(np.concatenate(vertex_mesh, axis=0), device),
            cull=_i32(cull, device),
            material=_i32(material, device),
            scale=_f32(np.asarray(scale, np.float32).reshape(-1, 3), device),
            rotation=_f32(rot, device),
            translation=_f32(np.asarray(translation, np.float32).reshape(-1, 3), device),
        )
