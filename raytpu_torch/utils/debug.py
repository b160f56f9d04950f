"""Numerical checks: NaN trapping and finiteness audits of scenes, parameters
and gradients.

Counterpart of ``raytpu/utils/debug.py``.  ``nan_check`` stands where raytpu
turns on ``jax_debug_nans``; ``assert_finite_tree`` and ``validate_scene``
walk dicts, lists, tuples and the dataclasses of ``core/types`` and name a
leaf by its path as raytpu does (``.spheres.center``, ``['color']``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.overrides import TorchFunctionMode


class _NanMode(TorchFunctionMode):
    """Checks the floating outputs of every torch function called under it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(x, torch.Tensor) and x.is_floating_point() and bool(torch.isnan(x).any()):
                name = getattr(func, "__name__", None) or repr(func)
                raise FloatingPointError(f"NaN in the output of {name}")
        return out


@contextlib.contextmanager
def nan_check():
    """Raise ``FloatingPointError`` at the first torch op whose floating
    output holds a NaN, naming the op.

    Forward: a ``TorchFunctionMode`` checks each op's output (one host sync
    an op: a debugging tool, not for timing).  Backward:
    ``torch.autograd.detect_anomaly(check_nan=True)``, whose error is raised
    again as ``FloatingPointError``.  Kernels launched through ctypes (the
    CUDA kernels of ``render/``) are not seen: their NaNs surface at the
    next torch op that reads their output."""
    try:
        with torch.autograd.detect_anomaly(check_nan=True), _NanMode():
            yield
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(str(e)) from e


def _leaves(tree, path: str = ""):
    """(path, leaf) of every leaf, depth first in field, key and index order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _nonfinite(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and not bool(torch.isfinite(leaf).all()))


def assert_finite_tree(tree, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming the first floating leaf that holds
    a NaN or an infinity."""
    for path, leaf in _leaves(tree):
        if _nonfinite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def validate_scene(scene) -> list[str]:
    """Static audit of a scene: non-finite leaves, material ids out of the
    table, non-unit face normals.  Returns the problems, as raytpu words them."""
    problems = [f"non-finite: {path}" for path, leaf in _leaves(scene) if _nonfinite(leaf)]
    m = scene.materials.count
    for what, ids in (("spheres", scene.spheres.material), ("planes", scene.planes.material),
                      ("triangles", scene.triangles.material)):
        if ids.numel() and (int(ids.max()) >= m or int(ids.min()) < 0):
            problems.append(f"{what}: material index out of range [0, {m})")
    if scene.triangles.count:
        norms = torch.linalg.vector_norm(scene.triangles.normal, dim=-1)
        if not bool((torch.abs(norms - 1.0) < 1e-3).all()):
            problems.append("triangles: non-unit face normals")
    return problems
