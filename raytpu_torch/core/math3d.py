"""Vector / matrix / color math in the reference's conventions, on tensors.

Counterpart of ``raytpu/core/math3d.py``.  Matrices are **row-vector**: a 4x4
matrix stores its basis axes as rows plus a translation row, and a point is
transformed as ``p @ M[:3, :3] + M[3, :3]`` (reference: source/Matrix.cpp).
Everything is float32, as parity with the reference requires.

Rounding.  XLA compiles raytpu's jnp code on the CPU with multiply-adds
contracted into fused multiply-adds, and the committed goldens were rendered
that way.  Ray-primitive decisions near a tie (a shadow ray grazing the
sphere it leaves) turn on that last bit.  With every product rounded on its
own, 0.29% of the 640x480 reference frame differed from its golden by more
than one step, against a budget of 0.2%; fused as below, 0.06% (both from
chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W).  So
the port fuses where the geometry does its cancelling sums: 3-vector dot
products and squared lengths (``dot3``), cross products (``cross3``), and
points ``o + t*d`` (``fma``).  The CUDA kernel uses ``fmaf`` at the same
places and rounds every other operation on its own, as these tensor ops do.
"""

from __future__ import annotations

import struct

import torch

PI = 3.14159265358979323846
PI_2 = 6.283185307179586476925
PI_DIV_2 = 1.57079632679489661923
TO_RADIANS = PI / 180.0
TO_DEGREES = 180.0 / PI

UNIT_X = (1.0, 0.0, 0.0)
UNIT_Y = (0.0, 1.0, 0.0)
UNIT_Z = (0.0, 0.0, 1.0)


def fma(a, b, c):
    """``a*b + c`` rounded once to float32, as CUDA's ``fmaf``; each operand
    a float32 tensor or a Python float.  The product of two float32 values
    is exact in float64; the sum is rounded to float64 and then to float32,
    which differs from one rounding only when the float64 sum lands exactly
    halfway between two float32 values (a few in 2^29).  ``addcmul`` forms
    the float64 sum in one pass, promoting the float32 operands as it reads
    them once one operand is float64: the smaller of ``a`` and ``b`` is cast."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and isinstance(c, torch.Tensor):
        if a.numel() <= b.numel():
            return torch.addcmul(c, a.double(), b).float()
        return torch.addcmul(c, a, b.double()).float()
    return (_f64(a) * _f64(b) + _f64(c)).float()


def _f64(x):
    """An operand of ``fma`` in float64: a Python number is rounded to float32
    first, as ``fmaf``'s operands are (1e-4 is not a float32)."""
    if isinstance(x, torch.Tensor):
        return x.double()
    return struct.unpack("f", struct.pack("f", x))[0]


def dot3(ax, ay, az, bx, by, bz):
    """``ax*bx + ay*by + az*bz`` as ``fma(az, bz, fma(ay, by, ax*bx))``."""
    return fma(az, bz, fma(ay, by, ax * bx))


def cross3(ax, ay, az, bx, by, bz):
    """``a x b``, each component ``fma(p, q, -(r*s))``."""
    return (fma(ay, bz, -(az * by)),
            fma(az, bx, -(ax * bz)),
            fma(ax, by, -(ay * bx)))


def dot(a, b):
    """Batched 3-vector dot product over the last axis (``dot3``)."""
    return dot3(a[..., 0], a[..., 1], a[..., 2], b[..., 0], b[..., 1], b[..., 2])


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def sqr_magnitude(v):
    return dot(v, v)


def magnitude(v):
    return torch.sqrt(sqr_magnitude(v))


def normalize(v):
    """Divide by the Euclidean norm, with no epsilon guard (``Vector3::Normalize``)."""
    return v / magnitude(v)[..., None]


def normalize_safe(v, eps=1e-20):
    """Normalize with the norm clamped away from zero, so that the gradient
    of a zero vector is finite (the differentiable path's normalize)."""
    return v / torch.clamp(magnitude(v), min=eps)[..., None]


def reflect(l, n):
    """The reference's Phong reflect, with its nonstandard clamp inside
    (reference: source/BRDFs.h:35): ``l - 2*max(dot(n,l),0)*n``."""
    return l - 2.0 * torch.clamp(dot(n, l), min=0.0)[..., None] * n


def project(v, onto):
    """``v`` projected onto ``onto`` (reference: Vector3::Project)."""
    return onto * (dot(v, onto) / dot(onto, onto))[..., None]


def reject(v, onto):
    """The part of ``v`` perpendicular to ``onto`` (reference: Vector3::Reject)."""
    return v - project(v, onto)


def lerp(a, b, factor):
    """Linear interpolation (reference: source/ColorRGB.h Lerp, MathHelpers Lerpf)."""
    return a + (b - a) * factor


def gather_rows(table, idx):
    """``table[idx]`` for an integer index tensor of any shape, through
    ``index_select``: its backward is an ``index_add_``, where advanced
    indexing's serialises repeated indices (every vertex of a mesh gathers
    the mesh's one transform; every ray that misses a class gathers its
    row 0)."""
    flat = torch.index_select(table, 0, idx.reshape(-1).long())
    return flat.reshape(*idx.shape, *table.shape[1:])


def transform_vector(m, v):
    """``v @ M[:3, :3]``: rotate and scale only (reference: source/Matrix.cpp:35-42)."""
    return v @ m[:3, :3]


def transform_point(m, p):
    """``p @ M[:3, :3] + M[3, :3]`` (reference: source/Matrix.cpp:49-56)."""
    return p @ m[:3, :3] + m[3, :3]


def mat_identity(device="cuda"):
    return torch.eye(4, dtype=torch.float32, device=device)


def _angle(a, device):
    """An angle as a 0-dim float32 tensor on ``device``: a tensor is moved,
    a number filled there (``scalar``), so that no copy waits on the card."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return scalar(float(a), device)


def mat_rotation_x(pitch, device="cuda"):
    """Row-vector X rotation: rows = {1,0,0}, {0,cos,-sin}, {0,sin,cos}."""
    a = _angle(pitch, device)
    c, s = torch.cos(a), torch.sin(a)
    m = mat_identity(device)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def mat_rotation_y(yaw, device="cuda"):
    """Row-vector Y rotation (reference: source/Matrix.cpp:124-134):
    rows = {cos,0,-sin}, {0,1,0}, {sin,0,cos}."""
    a = _angle(yaw, device)
    c, s = torch.cos(a), torch.sin(a)
    m = mat_identity(device)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def mat_rotation_z(roll, device="cuda"):
    """Row-vector Z rotation: rows = {cos,sin,0}, {-sin,cos,0}, {0,0,1}."""
    a = _angle(roll, device)
    c, s = torch.cos(a), torch.sin(a)
    m = mat_identity(device)
    m[0, 0], m[0, 1] = c, s
    m[1, 0], m[1, 1] = -s, c
    return m


def mat_rotation(pitch, yaw, roll, device="cuda"):
    """``Rx @ Ry @ Rz`` (reference: source/Matrix.cpp:150-155)."""
    return (mat_rotation_x(pitch, device) @ mat_rotation_y(yaw, device)
            @ mat_rotation_z(roll, device))


def _vec3(v, device):
    """A 3-vector as a float32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(v, dtype=torch.float32, device=device)


def mat_translation(t, device="cuda"):
    """Identity with ``t`` in the translation row."""
    m = mat_identity(device)
    m[3, :3] = _vec3(t, device)
    return m


def mat_scale(s, device="cuda"):
    """Diagonal scale by the three components of ``s``."""
    return torch.diag(torch.cat([_vec3(s, device), torch.ones(1, dtype=torch.float32, device=device)]))


def srt(scale_m, rot_m, trans_m):
    """A mesh's transform ``S @ R @ T``: with row vectors, scale first, then
    rotation, then translation (reference: source/DataTypes.h:213)."""
    return scale_m @ rot_m @ trans_m


def max_to_one(rgb):
    """Per-pixel tone map: divide by the max channel when it exceeds 1
    (reference: source/ColorRGB.h:12-17).

    Double-where on the denominator: on black pixels (m=0) the unselected
    division's partial is infinite, and a zero cotangent times infinity would
    put NaN into every gradient that sums over pixels."""
    m = torch.amax(rgb, dim=-1, keepdim=True)
    over = m > 1.0
    return torch.where(over, rgb / torch.where(over, m, torch.ones_like(m)), rgb)


def as_divisor(x, like):
    """A Python number as a 0-dim float32 tensor on ``like``'s device.  On
    CUDA, PyTorch divides by a Python number as a multiply by its rounded
    reciprocal, which is not IEEE division; by a tensor, it divides."""
    return scalar(x, like.device)


def scalar(x, device):
    """A Python number as a 0-dim float32 tensor on ``device``, filled there:
    ``torch.tensor(x, device=...)`` copies from pageable host memory, which
    waits for every kernel queued on the card before it."""
    return torch.full((), x, dtype=torch.float32, device=device)


def quantize_u8(rgb):
    """``static_cast<uint8_t>(c*255)``: truncation, not rounding
    (reference: source/Renderer.cpp:178-181)."""
    return (rgb * 255.0).to(torch.uint8)
