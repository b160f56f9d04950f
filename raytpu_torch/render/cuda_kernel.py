"""The whole-frame megakernel (K1) and the router in front of every route.

Counterpart of the megakernel part of ``raytpu/render/pallas_kernel.py``
(``_mega_pack``, ``render_image_mega_f32``), of ``route_kind`` and of
``render_image_f32`` / ``render_image``.  The kernel itself is
``csrc/mega.cu``; it replaces ``pallas_kernel.py:_mega_kernel``.  The other
routes live in ``mega2.py`` (K2a, K2b), ``packed.py`` (K3, K4) and
``chunked.py`` (K8, K10).

``render_image_mega_f32`` takes the plain version below only for a scene on
the CPU.  For a scene on CUDA it launches the kernel or raises.  The scene
goes to the kernel as the buffer ``plain.mega_pack`` packs (its layout is in
``plain``'s docstring), on the scene's device: an animated frame never
visits the host.
"""

from __future__ import annotations

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.ops import accel
from raytpu_torch.render import build, chunked, mega2, packed, plain, renderer
from raytpu_torch.render.plain import (  # noqa: F401  (mega_pack: K1's buffer, public here)
    CAM_COLS,
    LIGHT_COLS,
    PLN_COLS,
    SPH_COLS,
    TRI_COLS,
    mega_pack,
)

MEGA_MAX_PRIMS = 72
MEGA_MAX_LIGHTS = 8

#: Launches of the megakernel, counted where the wrapper launches it.
MEGA_LAUNCHES = 0

# raytpu's routing thresholds (raytpu/render/pallas_kernel.py), unchanged
_MEGA2_MAX_TRIS = 8 * 1200
_MEGA2_MAX_UNROLL = 16
_MEGA2_MAX_LIGHTS = 8
_MEGA3_MAX_TRIS = 1048576
_MEGA3_WL_SMEM_ENTRIES = 8192


def _check_mega(scene: Scene, config: RenderConfig):
    if scene.num_primitives > MEGA_MAX_PRIMS or scene.lights.count > MEGA_MAX_LIGHTS:
        raise ValueError(f"megakernel takes <= {MEGA_MAX_PRIMS} primitives and <= "
                         f"{MEGA_MAX_LIGHTS} lights, got {scene.num_primitives} and "
                         f"{scene.lights.count}")
    if config.width <= 0 or config.height <= 0:
        raise ValueError(f"image size must be positive, got {config.width}x{config.height}")
    if config.soft_shadows:
        raise ValueError("the megakernel renders hard shadows only")


def render_image_mega_f32(scene: Scene, config: RenderConfig, tile0: int | None = None,
                          tiles: int | None = None):
    """Whole-frame megakernel render -> (H, W, 3) float32 on the scene's
    device.  The CPU takes the plain version; CUDA launches ``mega.cu``.

    With ``tile0``/``tiles`` set it renders only the 1024-ray tiles
    [tile0, tile0 + tiles) of the row-major frame and returns their
    (tiles * 1024, 3) colors, black past the frame: the per-rank body of
    the px-sharded render."""
    _check_mega(scene, config)
    if scene.device.type == "cpu":
        return render_image_mega_f32_plain(scene, config, tile0, tiles)
    if scene.device.type != "cuda":
        raise ValueError(f"megakernel runs on cuda or (plain) cpu, not {scene.device}")
    buf, counts = mega_pack(scene, config)
    out = torch.empty(mega2.frame_shape(config, tiles), dtype=torch.float32, device=buf.device)
    return launch_mega(buf, counts, config, out, tile0 or 0)


def launch_mega(buf, counts, config: RenderConfig, out, tile0: int = 0):
    """Launch ``mega.cu`` on the current stream: ``buf`` and ``counts`` from
    ``mega_pack``, ``out`` a float32 CUDA tensor it overwrites, the
    (H, W, 3) frame or, from ray ``1024 * tile0``, (n, 3) rays of it."""
    global MEGA_LAUNCHES
    S, P, T, L = counts
    W, H = config.width, config.height
    if buf.device.type != "cuda" or out.device != buf.device:
        raise ValueError(f"megakernel tensors must share one CUDA device, got {buf.device}, {out.device}")
    if buf.dtype != torch.float32 or not buf.is_contiguous() or buf.numel() != (
            CAM_COLS + SPH_COLS * S + PLN_COLS * P + TRI_COLS * T + LIGHT_COLS * L):
        raise ValueError("megakernel scene buffer is malformed")
    whole = tuple(out.shape) == (H, W, 3) and tile0 == 0
    if (out.dtype != torch.float32 or not out.is_contiguous()
            or not (whole or (out.ndim == 2 and out.shape[1] == 3)) or tile0 < 0):
        raise ValueError(f"megakernel output must be contiguous float32 ({H}, {W}, 3) or (n, 3)")
    if S + P + T > MEGA_MAX_PRIMS or L > MEGA_MAX_LIGHTS or W <= 0 or H <= 0:
        raise ValueError(f"megakernel cannot take S+P+T={S + P + T}, L={L}, {W}x{H}")
    lib = build.load()
    with torch.cuda.device(buf.device):
        err = lib.raytpu_mega_render(
            buf.data_ptr(), S, P, T, L, W, H, int(config.lighting_mode), int(bool(config.shadows)),
            float(config.ray_min), float(config.normal_offset), float(config.shadow_dim),
            tile0, out.numel() // 3, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: {build.cuda_error_name(lib, err)}")
    MEGA_LAUNCHES += 1
    return out


def mega_rays(W: int, H: int, tile0: int, n_out: int):
    """(row, px, py, valid), each (n_out,): what thread ``slot`` of
    ``mega.cu``'s grid (``blockIdx.x * 128 + threadIdx.x``) renders and
    where it writes it (``mega.cu:slot_ray``).  The whole frame with W and
    H multiples of 32 runs in 32x32 pixel tiles, warp w on the 8x4 block
    ``accel.warp_slots()[w % 32]`` of tile w // 32, each pixel written at
    its row-major row; else slot j is ray ``1024 * tile0 + j`` of the
    row-major frame at row j, not valid past the frame."""
    slot = torch.arange(n_out)
    if tile0 == 0 and n_out == W * H and W % 32 == 0 and H % 32 == 0:
        warp = slot // 32
        j = accel.warp_slots()[warp % 32, slot % 32]
        tile = warp // 32
        px = (tile % (W // 32)) * 32 + j % 32
        py = (tile // (W // 32)) * 32 + j // 32
        return py * W + px, px, py, torch.ones_like(slot, dtype=torch.bool)
    rid = tile0 * mega2.TILE + slot
    valid = rid < W * H
    rid = torch.where(valid, rid, 0)
    return slot, rid % W, rid // W, valid


def render_image_mega_f32_plain(scene: Scene, config: RenderConfig, tile0: int | None = None,
                                tiles: int | None = None):
    """What ``mega.cu`` computes, in plain tensor ops on the scene's device
    (``plain``'s docstring says how they round): the frame, or the tiles
    [tile0, tile0 + tiles) as ``render_image_mega_f32`` returns them."""
    _check_mega(scene, config)
    buf, counts = mega_pack(scene, config)
    W, H = config.width, config.height
    cam, sph, pln, tri, lit = plain.mega_unpack(buf, counts)
    if tiles is None:
        rid = torch.arange(W * H, device=buf.device)
    else:
        rid = torch.arange(tile0 * mega2.TILE, (tile0 + tiles) * mega2.TILE, device=buf.device)
    valid = rid < W * H
    rid = torch.where(valid, rid, 0)
    ro, rd = plain.camera_rays(cam, rid % W, rid // W, W, H)
    t, n, mat = plain.closest_records(sph, pln, tri, ro, rd, float(config.ray_min))
    colors = plain.shade_records(sph, pln, tri, lit, config, ro, rd, t, n, mat)
    if tiles is None:
        return colors.reshape(H, W, 3)
    return torch.where(valid[:, None], colors, 0.0)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def route_kind(scene: Scene, config: RenderConfig) -> str:
    """The route raytpu's ``route_kind`` takes for this scene, with its
    thresholds unchanged: "mega" | "mega2" | "packed" | "jnp" | "chunked"."""
    S, P, T, L = (scene.spheres.count, scene.planes.count, scene.triangles.count,
                  scene.lights.count)
    if config.soft_shadows:
        return "jnp"
    if scene.num_primitives <= MEGA_MAX_PRIMS and L <= MEGA_MAX_LIGHTS:
        return "mega"
    small_caps = S <= _MEGA2_MAX_UNROLL and P <= _MEGA2_MAX_UNROLL and L <= _MEGA2_MAX_LIGHTS
    if T <= _MEGA2_MAX_TRIS and small_caps:
        return "mega2"
    if (T <= _MEGA3_MAX_TRIS and small_caps
            and L * -(-T // 512) <= _MEGA3_WL_SMEM_ENTRIES):
        return "packed"
    if T > chunked.MAX_TRIS:
        return "jnp"
    return "chunked"


def render_image_f32(scene: Scene, config: RenderConfig):
    """(H, W, 3) float32 image through the route raytpu would take: K1 for
    small scenes, K2a + K2b up to 9,600 triangles, K3 + K4 and the eager
    shade tail up to 1M, K8 + K10 past their sphere, plane and light caps up
    to 32,768 triangles, and raytpu's jnp route (the eager path) for soft
    shadows and for hard shadows past that (pallas_kernel.py:2291; the
    differentiable renderer with its kernels is ``raytpu_torch.grad``)."""
    kind = route_kind(scene, config)
    if kind == "mega":
        return render_image_mega_f32(scene, config)
    if kind == "mega2":
        return mega2.render_image_mega2_f32(scene, config)
    if kind == "packed":
        return packed.render_image_packed_f32(scene, config)
    if kind == "jnp":
        # soft shadows, and hard shadows past the packed band over 32k
        # triangles: raytpu's plain jnp ops, here the eager path
        return renderer.render_image_f32(scene, config)
    return chunked.render_image_chunked_f32(scene, config)


def render_image(scene: Scene, config: RenderConfig):
    """(H, W, 3) uint8 image through ``render_image_f32``."""
    return math3d.quantize_u8(render_image_f32(scene, config))

