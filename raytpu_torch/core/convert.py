"""Carry a scene across from flat arrays, leaf for leaf.

``scene_from_arrays`` takes one numpy array per leaf of a Scene, keyed
``"<group>.<field>"`` (``"spheres.center"``, ``"meshes.rotation"``,
``"camera.fov_scale"``, ...), and builds this package's Scene on a device.
Filled with ``np.asarray`` of each leaf of a raytpu scene, it lets both
packages render identical scene data.  ``scene_to_arrays`` is its inverse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytpu_torch.core.types import (
    Camera,
    Lights,
    Materials,
    Meshes,
    Planes,
    Scene,
    Spheres,
    Triangles,
)

#: Scene's groups in field order, each with its dataclass.
GROUPS = {"spheres": Spheres, "planes": Planes, "meshes": Meshes, "triangles": Triangles,
          "lights": Lights, "materials": Materials, "camera": Camera}


def leaf_names() -> list[str]:
    """Every key ``scene_from_arrays`` needs, in Scene field order."""
    return [f"{g}.{f.name}" for g, cls in GROUPS.items() for f in dataclasses.fields(cls)]


def scene_from_arrays(arrays: dict[str, np.ndarray], device="cuda") -> Scene:
    """Scene from one array per leaf.  Integer leaves become int32 tensors and
    floating leaves float32, as in raytpu's schema."""
    missing = sorted(set(leaf_names()) - set(arrays))
    if missing:
        raise KeyError(f"scene_from_arrays: missing leaves {missing}")
    groups = {}
    for g, cls in GROUPS.items():
        kw = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(arrays[f"{g}.{f.name}"])
            dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
            kw[f.name] = torch.as_tensor(np.array(a, dtype, copy=True), device=device)
        groups[g] = cls(**kw)
    return Scene(**groups)


def scene_to_arrays(scene) -> dict[str, np.ndarray]:
    """One numpy array per leaf, keyed as ``scene_from_arrays`` expects.  Takes
    any scene object with Scene's field names, so a raytpu scene too."""
    out = {}
    for key in leaf_names():
        g, f = key.split(".")
        x = getattr(getattr(scene, g), f)
        out[key] = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


def with_point_lights(scene, positions, intensity: float = 15.0):
    """``scene`` with white point lights of ``intensity`` appended at
    ``positions``, rebuilt on its device."""
    n = len(positions)
    arrays = scene_to_arrays(scene)
    rows = {"lights.position": positions, "lights.direction": [(0.0, 0.0, 1.0)] * n,
            "lights.color": [(1.0, 1.0, 1.0)] * n, "lights.intensity": [intensity] * n,
            "lights.kind": [0] * n}
    for key, new in rows.items():
        arrays[key] = np.concatenate([arrays[key], np.asarray(new, arrays[key].dtype)])
    return scene_from_arrays(arrays, scene.device)
