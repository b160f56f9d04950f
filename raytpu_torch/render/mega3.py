"""The streamed whole-frame route: K11a and K11b for scenes of up to
1,048,576 triangles.

Counterpart of ``raytpu/render/pallas_kernel.py:render_image_mega3_f32``
(``pack_triangles_sg`` and the two kernels it launches).  As in raytpu it
is off the default route (``cuda_kernel.route_kind`` never returns
"mega3"): the px-sharded render reaches it by name
(``parallel.sharding._render_fused_px``), and a caller may call it
directly.  The kernels are ``csrc/mega3.cu``:

  * K11a (``mega3_closest``): what K2a computes, the camera rays' culled
    closest hit and each tile's box of offset hit points;
  * the glue builds each light's shadow worklists from those boxes, as for
    K2b (``mega2.shadow_worklists``);
  * K11b (``mega3_shade``): what K2b computes, the shadow any-hit per light,
    shading, shadow dim and tone map.

They read the same worklists as K2 (each tile's passing 8-triangle groups
in ascending order, ``mega2.primary_worklists``) and take the triangles
from ``pack_groups``'s blob ray by ray, only from the groups whose padded
box, widened for the ray, the ray's segment crosses: K11a's up to its
current closest hit (``accel.normal_boxes``), K11b's each shadow
segment (their first columns, ``accel.shadow_boxes``).  The buffer, the tile boxes and the
image are K2's bit for bit.  The group bounds and records are computed
once a frame, for both culls and both kernels.
raytpu's worklist modes (fine, coarse, coarse2), ring depths and SMEM
entry budget fit Mosaic's scalar memory and are not ported; its
1,048,576-triangle ceiling is kept.

The plain versions are K2's (``mega2.mega2_closest_plain``,
``mega2.mega2_shade_plain``): the kernels compute the same function.  Each
wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.ops import accel
from raytpu_torch.render import build, mega2, packed, plain

GROUP = 8  #: triangles in a group: one worklist entry, 640 bytes of the blob
MAX_TRIS = 1048576  #: raytpu's MEGA3_MAX_TRIS
MAX_LIGHTS = 32  #: K11b keeps each light's shadow answer in one bit of a word

#: Launches of K11a and of K11b, counted where the wrappers launch them.
MEGA3_CLOSEST_LAUNCHES = 0
MEGA3_SHADE_LAUNCHES = 0


def _check(scene_or_counts, config: RenderConfig):
    T, L = ((scene_or_counts.triangles.count, scene_or_counts.lights.count)
            if isinstance(scene_or_counts, Scene) else scene_or_counts[2:])
    if T > MAX_TRIS:
        raise ValueError(f"mega3 takes <= {MAX_TRIS} triangles, got {T}")
    if L > MAX_LIGHTS:
        raise ValueError(f"mega3 takes <= {MAX_LIGHTS} lights, got {L}")
    if config.width <= 0 or config.height <= 0:
        raise ValueError(f"image size must be positive, got {config.width}x{config.height}")
    if config.soft_shadows:
        raise ValueError("mega3 renders hard shadows only")


def pack_groups(buf, counts):
    """The kernels' triangle blob, (ceil(T / 8), 160) float32: group g holds
    triangles 8g..8g+7 of the scene buffer's (T, 20) records, padded with
    all-zero triangles, which every test misses (pallas_kernel.py:
    pack_triangles_sg, without its 256-lane rows).  A scene without
    triangles gets one all-zero group, which no worklist lists."""
    tri = plain.mega_unpack(buf, counts)[3]
    ng = max(-(-tri.shape[0] // GROUP), 1)
    blob = torch.zeros((ng * GROUP, plain.TRI_COLS), dtype=torch.float32, device=buf.device)
    blob[:tri.shape[0]] = tri
    return blob.reshape(ng, GROUP * plain.TRI_COLS)


def render_image_mega3_f32(scene: Scene, config: RenderConfig, tile0: int | None = None,
                           tiles: int | None = None):
    """Whole-frame mega3 render -> (H, W, 3) float32 on the scene's device:
    K11a, the shadow worklists, K11b.  With ``tile0``/``tiles`` set, the
    1024-ray tiles [tile0, tile0 + tiles) -> (tiles * 1024, 3) in feed
    order, black past the frame (pallas_kernel.py:2089-2097)."""
    _check(scene, config)
    tile0 = tile0 or 0
    buf, counts = plain.mega_pack(scene, config)
    blob = pack_groups(buf, counts)
    glo, ghi, boxes = accel.normal_boxes(scene.triangles)  # once: both culls, both kernels
    wl, cnt = mega2.primary_worklists(scene, config, tile0, tiles, (glo, ghi))
    acc, bounds = mega3_closest(buf, counts, blob, boxes, wl, cnt, config, tile0, tiles)
    if counts[3] == 0:  # no lights: black (W1)
        return mega2.black(config, tiles, buf.device)
    wl_s, cnt_s = mega2.shadow_worklists(scene, config, bounds, (glo, ghi))
    return mega3_shade(buf, counts, blob, packed.shadow_records(boxes), wl_s, cnt_s, acc, config,
                       tile0, tiles)


def _launch_args(buf, counts, blob, wl, cnt, config: RenderConfig, tiles, what, extra):
    """Check the tensors a K11 launch takes; ``(nt, S, P, T, L)``."""
    _check(counts, config)
    S, P, T, L = counts
    nt = mega2.num_tiles(config) if tiles is None else tiles
    ng = max(-(-T // GROUP), 1)
    wl_shape = (nt, wl.shape[-1]) if wl.ndim == 2 else (nt, L, wl.shape[-1])
    build.check_tensors(what, buf.device, {
        "scene buffer": (buf, torch.float32, mega2._buf_shape(counts)),
        "blob": (blob, torch.float32, (ng, GROUP * plain.TRI_COLS)),
        "wl": (wl, torch.int32, wl_shape), "cnt": (cnt, torch.int32, wl_shape[:-1]), **extra})
    build.check_aligned(what, "the blob", blob, 16)
    return nt, S, P, T, L


def mega3_closest(buf, counts, blob, boxes, wl, cnt, config: RenderConfig, tile0: int = 0,
                  tiles: int | None = None):
    """K11a -> ``(acc (11, nt*1024) float32, bounds (nt, 6) float32)`` over
    the frame's tiles, or the ``tiles`` from ``tile0``.  ``blob`` is
    ``pack_groups``'s, ``boxes`` (ceil(T/8), 32) float32 the normal
    records (``accel.normal_boxes``) each ray tests up to its
    current closest hit before a group's triangles, ``wl`` (nt, n) int32
    and ``cnt`` (nt,) int32 the tiles' group worklists.  A CPU buffer
    takes K2a's plain version, which needs no boxes."""
    global MEGA3_CLOSEST_LAUNCHES
    if buf.device.type == "cpu":
        _check(counts, config)
        return mega2.mega2_closest_plain(buf, counts, config, tile0, tiles)
    nt, S, P, T, _ = _launch_args(
        buf, counts, blob, wl, cnt, config, tiles, "K11a",
        {"boxes": (boxes, torch.float32, (-(-counts[2] // GROUP), accel.NORMAL_COLS))})
    build.check_aligned("K11a", "boxes", boxes, 16)
    dev = buf.device
    acc = torch.empty((mega2.ACC_ROWS, nt * mega2.TILE), dtype=torch.float32, device=dev)
    bounds = torch.empty((nt, 6), dtype=torch.float32, device=dev)
    lib = build.load()
    part, done = mega2.closest_scratch(lib, nt, dev)
    with torch.cuda.device(dev):
        err = lib.raytpu_mega3_closest(
            buf.data_ptr(), S, P, T, blob.data_ptr(), boxes.data_ptr(), wl.data_ptr(),
            cnt.data_ptr(), wl.shape[1], config.width, config.height,
            int(mega2.is_tiled(config)), tile0, nt, float(config.ray_min),
            float(config.normal_offset), acc.data_ptr(), part.data_ptr(), done.data_ptr(),
            bounds.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K11a launch failed: {build.cuda_error_name(lib, err)}")
    MEGA3_CLOSEST_LAUNCHES += 1
    return acc, bounds


def mega3_shade(buf, counts, blob, boxes, wl, cnt, acc, config: RenderConfig, tile0: int = 0,
                tiles: int | None = None):
    """K11b -> (H, W, 3) float32, or with ``tiles`` set the range's
    (tiles * 1024, 3) in feed order.  ``boxes`` (ceil(T/8), 8) float32 are
    the group box records (``accel.shadow_boxes``) each shadow ray tests
    before a group's triangles, ``wl`` (nt, L, n) int32 and ``cnt`` (nt, L)
    int32 the shadow worklists, ``acc`` K11a's.  A CPU buffer takes K2b's
    plain version, which needs no boxes."""
    global MEGA3_SHADE_LAUNCHES
    if buf.device.type == "cpu":
        _check(counts, config)
        return mega2.mega2_shade_plain(buf, counts, acc, config, tile0, tiles)
    nt, S, P, T, L = _launch_args(
        buf, counts, blob, wl, cnt, config, tiles, "K11b",
        {"acc": (acc, torch.float32, (mega2.ACC_ROWS, (tiles or mega2.num_tiles(config))
                                      * mega2.TILE)),
         "boxes": (boxes, torch.float32, (-(-counts[2] // GROUP), accel.BOX_COLS))})
    build.check_aligned("K11b", "boxes", boxes, 16)
    out = torch.empty(mega2.frame_shape(config, tiles), dtype=torch.float32, device=buf.device)
    lib = build.load()
    with torch.cuda.device(buf.device):
        err = lib.raytpu_mega3_shade(
            buf.data_ptr(), S, P, T, L, blob.data_ptr(), boxes.data_ptr(), wl.data_ptr(),
            cnt.data_ptr(), wl.shape[2], config.width, config.height, int(mega2.is_tiled(config)),
            tile0, nt,
            int(tiles is not None), int(config.lighting_mode), int(bool(config.shadows)),
            float(config.ray_min), float(config.normal_offset), float(config.shadow_dim),
            acc.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K11b launch failed: {build.cuda_error_name(lib, err)}")
    MEGA3_SHADE_LAUNCHES += 1
    return out
