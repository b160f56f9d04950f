"""The fly camera: a pure (state, input, dt) -> state controller.

Counterpart of ``raytpu/core/camera.py`` (reference: source/Camera.h:68-106),
with the same control scheme and constants:

  * WASD / arrows: move along forward / right; Shift = 4x speed (linear
    speed 4 m/s, reference: source/Camera.h:72,79)
  * mouse LMB drag: move forward / back by dy, yaw by dx
  * mouse RMB drag: pitch by -dy, yaw by dx (rotation speed 15, :73)
  * LMB + RMB drag: elevate along world Y by dy and yaw by dx (yaw fires
    whenever either button is held, reference: source/Camera.h:101-102)
  * forward from pitch and yaw: UnitZ through ``Rx(pitch) @ Ry(yaw)``
    (reference: source/Camera.h:61-66)

The state lives on the host, in Python and numpy floats, as raytpu's does.
``FlyCamera.camera(device)`` builds the ``Camera`` for a frame without a
copy that waits on the card: the origin and field of view go through pinned
memory with a non-blocking copy, the angles are filled on the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import Camera

LINEAR_SPEED = 4.0
ROTATION_SPEED = 15.0
SHIFT_MULTIPLIER = 4.0


@dataclass(frozen=True)
class CameraInput:
    """One frame of input state, whatever the window library."""

    forward: bool = False  # W / Up
    backward: bool = False  # S / Down
    right: bool = False  # D / Right
    left: bool = False  # A / Left
    shift: bool = False
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0
    lmb: bool = False
    rmb: bool = False


@dataclass(frozen=True)
class FlyCamera:
    """Camera pose as Euler state; ``camera(device)`` builds the ``Camera``."""

    origin: tuple = (0.0, 0.0, 0.0)
    pitch: float = 0.0
    yaw: float = 0.0
    fov_degrees: float = 90.0

    def camera(self, device="cuda") -> Camera:
        dev = torch.device(device)
        fov = float(np.clip(self.fov_degrees, 10.0, 175.0))
        fov_scale = np.float32(np.tan(np.float32(fov) * np.float32(math3d.TO_RADIANS) / 2.0))
        # origin, forward (UnitZ, turned below), tan(fov/2), rounded to float32
        host = torch.tensor([*self.origin, *math3d.UNIT_Z, float(fov_scale)], dtype=torch.float32)
        if dev.type == "cuda":  # a pageable copy would wait for the queued frames
            host = host.pin_memory()
        vals = host.to(dev, non_blocking=True)
        cam = Camera(origin=vals[:3], forward=vals[3:6], fov_scale=vals[6])
        return cam.with_orientation(np.float32(self.pitch), np.float32(self.yaw))

    def _basis(self):
        """(forward, right) on the host: forward is Rx(pitch) @ Ry(yaw)'s
        last row in float32, ``[cos p sin y, sin p, cos p cos y]``."""
        p, y = np.float32(self.pitch), np.float32(self.yaw)
        cp = np.cos(p)
        fwd = np.array([cp * np.sin(y), np.sin(p), cp * np.cos(y)], np.float32)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        return fwd, right / np.linalg.norm(right)

    def update(self, inp: CameraInput, dt: float) -> "FlyCamera":
        fwd, right = self._basis()
        shift = SHIFT_MULTIPLIER if inp.shift else 1.0
        speed = dt * LINEAR_SPEED * shift
        origin = np.asarray(self.origin, np.float64)
        if inp.forward:
            origin = origin + fwd * speed
        if inp.backward:
            origin = origin - fwd * speed
        if inp.right:
            origin = origin + right * speed
        if inp.left:
            origin = origin - right * speed

        pitch, yaw = self.pitch, self.yaw
        if inp.mouse_dx or inp.mouse_dy:
            rot_mod = dt * ROTATION_SPEED * shift
            if inp.lmb and inp.rmb:
                origin = origin + np.array([0.0, 1.0, 0.0]) * speed * inp.mouse_dy
            elif inp.lmb:
                origin = origin + fwd * speed * inp.mouse_dy
            elif inp.rmb:
                pitch -= inp.mouse_dy * math3d.TO_RADIANS * rot_mod
            # yaw whenever LMB or RMB is held, both-button drags included
            # (reference: source/Camera.h:101-102)
            if inp.lmb or inp.rmb:
                yaw += inp.mouse_dx * math3d.TO_RADIANS * rot_mod
        return dataclasses.replace(self, origin=tuple(float(x) for x in origin),
                                   pitch=float(pitch), yaw=float(yaw))
