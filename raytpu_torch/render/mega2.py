"""The mega2 route: K2a and K2b for scenes of up to 9,600 triangles.

Counterpart of ``raytpu/render/pallas_kernel.py:render_image_mega2_f32``.
The kernels are ``csrc/mega2.cu``:

  * K2a (``mega2_closest``): the culled closest hit of the camera rays,
    generated in the kernel, tile by tile; it leaves each ray's t, normal
    and material in an (11, nt*1024) buffer and each tile's box of offset
    hit points in (nt, 6); each ray walks its tile's worklist with
    ``csrc/closest.cuh``'s closest pass, K11a's body, testing a group's
    normal record up to its current closest hit before the group's
    triangles;
  * the glue here builds each light's shadow worklists from those boxes
    (``accel.light_shadow_cull_from_aabb``), O(tiles) work;
  * K2b (``mega2_shade``): the culled shadow any-hit per light, shading,
    shadow dim and tone map, into the (H, W, 3) image; its shadow queries
    walk the groups of their worklist rows with ``csrc/shadow.cuh``'s box
    tests.  Both kernels test the normal records of ``accel.normal_boxes``,
    computed once a frame with the group bounds that both worklist
    builders take.

A tile is 1024 rays: a 32x32 pixel block when W and H are multiples of 32,
else 1024 consecutive row-major pixels (``accel.tile_pixels``).  Given
``tile0``/``tiles``, the route renders only the frame's tiles [tile0,
tile0 + tiles) and returns their rays' colors in feed order, black past the
frame: the per-rank body of the px-sharded render.  The kernels read the
scene buffer that ``plain.mega_pack`` packs for K1.  Each wrapper takes its
plain version only for tensors on the CPU; for CUDA tensors it launches its
kernel or raises.
"""

from __future__ import annotations

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import LightKind, RenderConfig, Scene
from raytpu_torch.ops import accel
from raytpu_torch.render import build, plain

TILE = 1024
ACC_ROWS = 11  #: t, normal(3), material(7)
MAX_LIGHTS = 32  #: K2b keeps each light's shadow answer in one bit of a word

#: Launches of K2a and of K2b, counted where the wrappers launch them.
MEGA2_CLOSEST_LAUNCHES = 0
MEGA2_SHADE_LAUNCHES = 0


def is_tiled(config: RenderConfig) -> bool:
    return config.width % 32 == 0 and config.height % 32 == 0


def num_tiles(config: RenderConfig) -> int:
    return -(-(config.width * config.height) // TILE)


def _check(config: RenderConfig):
    if config.width <= 0 or config.height <= 0:
        raise ValueError(f"image size must be positive, got {config.width}x{config.height}")
    if config.soft_shadows:
        raise ValueError("mega2 renders hard shadows only")


def frame_shape(config: RenderConfig, tiles: int | None):
    """(H, W, 3) for the frame, (tiles * 1024, 3) for a tile range."""
    return (config.height, config.width, 3) if tiles is None else (tiles * TILE, 3)


def black(config: RenderConfig, tiles: int | None, device):
    """The frame of a scene without lights (W1), or a tile range's: zeros."""
    return torch.zeros(frame_shape(config, tiles), dtype=torch.float32, device=device)


def render_image_mega2_f32(scene: Scene, config: RenderConfig, tile0: int | None = None,
                           tiles: int | None = None):
    """Whole-frame mega2 render -> (H, W, 3) float32 on the scene's device:
    K2a, the shadow worklists, K2b.  With ``tile0``/``tiles`` set, the
    tiles [tile0, tile0 + tiles) -> (tiles * 1024, 3) in feed order."""
    _check(config)
    tile0 = tile0 or 0
    buf, counts = plain.mega_pack(scene, config)
    glo, ghi, boxes = accel.normal_boxes(scene.triangles)  # once: both culls, both kernels
    wl, cnt = primary_worklists(scene, config, tile0, tiles, (glo, ghi))
    acc, bounds = mega2_closest(buf, counts, boxes, wl, cnt, config, tile0, tiles)
    if counts[3] == 0:  # no lights: black (W1)
        return black(config, tiles, buf.device)
    wl_s, cnt_s = shadow_worklists(scene, config, bounds, (glo, ghi))
    return mega2_shade(buf, counts, boxes, wl_s, cnt_s, acc, config, tile0, tiles)


def take_tiles(wl, cnt, tile0: int, tiles: int | None):
    """Rows [tile0, tile0 + tiles) of the frame's worklists ``wl`` (nt, n)
    and ``cnt`` (nt,); rows past the frame are empty (raytpu: "padded tiles
    past the frame cull everything").  ``tiles`` None: the frame's."""
    if tiles is None:
        return wl, cnt
    pad = max(0, tile0 + tiles - wl.shape[0])
    wl = torch.cat([wl, wl.new_zeros((pad, wl.shape[1]))])[tile0:tile0 + tiles]
    cnt = torch.cat([cnt, cnt.new_zeros((pad,))])[tile0:tile0 + tiles]
    return wl.contiguous(), cnt.contiguous()


def primary_worklists(scene: Scene, config: RenderConfig, tile0: int = 0,
                      tiles: int | None = None, group_bounds=None):
    """K2a's (and K11a's) worklists ``(wl (nt, ng) int32, cnt (nt,) int32)``:
    each tile's groups that its camera rays may hit, in ascending order; a
    tile range's rows with ``tiles`` set.  ``group_bounds`` is
    ``accel.chunk_bounds(scene.triangles, accel.GROUP)`` (the first two of
    ``accel.normal_boxes``) where the caller has it."""
    if not accel.culls_groups(scene.triangles):
        return take_tiles(*accel.full_worklist(num_tiles(config), scene.triangles), tile0, tiles)
    glo, ghi = group_bounds or accel.chunk_bounds(scene.triangles, accel.GROUP)
    rb = accel.camera_tile_bounds(scene.camera, config.width, config.height, is_tiled(config),
                                  tile=TILE)
    return take_tiles(*accel.chunk_worklist(accel.cull_matrix(rb, glo, ghi,
                                                              float(config.ray_min))),
                      tile0, tiles)


def shadow_worklists(scene: Scene, config: RenderConfig, bounds, group_bounds=None):
    """K2b's (and K11b's) worklists ``(wl (nt, L, n) int32, cnt (nt, L)
    int32)`` from K2a's per-tile boxes of shadow origins ``bounds`` (nt, 6):
    each light's groups that a shadow ray of the tile may hit; an empty box
    (a tile whose rays all miss, or past the frame) culls every group.
    Without shadows they are empty.  ``group_bounds`` as for
    ``primary_worklists``."""
    nt, L, dev = bounds.shape[0], scene.lights.count, scene.device
    if not config.shadows:
        return (torch.zeros((nt, L, 0), dtype=torch.int32, device=dev),
                torch.zeros((nt, L), dtype=torch.int32, device=dev))
    if not accel.culls_groups(scene.triangles):
        wl, cnt = accel.full_worklist(nt * L, scene.triangles)
        return wl.reshape(nt, L, -1), cnt.reshape(nt, L)
    glo, ghi = group_bounds or accel.chunk_bounds(scene.triangles, accel.GROUP)
    lights = scene.lights
    per_light = [accel.chunk_worklist(accel.light_shadow_cull_from_aabb(
        bounds[:, 0:3], bounds[:, 3:6], lights.position[li], lights.direction[li],
        lights.kind[li] == LightKind.POINT, glo, ghi, float(config.ray_min))) for li in range(L)]
    return (torch.stack([w for w, _ in per_light], dim=1).contiguous(),
            torch.stack([c for _, c in per_light], dim=1).contiguous())


def _buf_shape(counts):
    S, P, T, L = counts
    return (plain.CAM_COLS + plain.SPH_COLS * S + plain.PLN_COLS * P + plain.TRI_COLS * T
            + plain.LIGHT_COLS * L,)


def closest_scratch(lib, nt: int, device):
    """The closest pass's scratch for ``nt`` tiles (K2a and K11a,
    ``csrc/closest.cuh``): the blocks' partial boxes ``part`` (nt * the
    library's blocks a tile, 6) float32 and the tiles' block counts
    ``done`` (nt,) int32, zero before each launch."""
    blocks = lib.raytpu_closest_blocks_per_tile()
    return (torch.empty((nt * blocks, 6), dtype=torch.float32, device=device),
            torch.zeros((nt,), dtype=torch.int32, device=device))


def mega2_closest(buf, counts, boxes, wl, cnt, config: RenderConfig, tile0: int = 0,
                  tiles: int | None = None):
    """K2a -> ``(acc (11, nt*1024) float32, bounds (nt, 6) float32)`` over
    the frame's tiles, or the ``tiles`` from ``tile0``.  ``boxes``
    (ceil(T/8), 32) float32 are the normal records (``accel.normal_boxes``)
    each ray tests up to its current closest hit before a group's
    triangles, which CUDA tensors need; ``wl`` (nt, n) int32 lists each
    tile's groups, ``cnt`` (nt,) int32 how many of them to walk.  A CPU
    buffer takes ``mega2_closest_plain``, which needs no boxes."""
    global MEGA2_CLOSEST_LAUNCHES
    if buf.device.type == "cpu":
        return mega2_closest_plain(buf, counts, config, tile0, tiles)
    if boxes is None:
        raise ValueError("K2a walks the normal records: pass boxes (accel.normal_boxes)")
    _check(config)
    nt = num_tiles(config) if tiles is None else tiles
    S, P, T, _ = counts
    build.check_tensors("K2a", buf.device, {
        "scene buffer": (buf, torch.float32, _buf_shape(counts)),
        "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS)),
        "wl": (wl, torch.int32, (nt, wl.shape[-1])), "cnt": (cnt, torch.int32, (nt,))})
    build.check_aligned("K2a", "boxes", boxes, 16)
    dev = buf.device
    acc = torch.empty((ACC_ROWS, nt * TILE), dtype=torch.float32, device=dev)
    bounds = torch.empty((nt, 6), dtype=torch.float32, device=dev)
    lib = build.load()
    part, done = closest_scratch(lib, nt, dev)
    with torch.cuda.device(dev):
        err = lib.raytpu_mega2_closest(
            buf.data_ptr(), S, P, T, boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(), wl.shape[1],
            config.width, config.height, int(is_tiled(config)), tile0, nt,
            float(config.ray_min), float(config.normal_offset), acc.data_ptr(), part.data_ptr(),
            done.data_ptr(), bounds.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2a launch failed: {build.cuda_error_name(lib, err)}")
    MEGA2_CLOSEST_LAUNCHES += 1
    return acc, bounds


def mega2_shade(buf, counts, boxes, wl, cnt, acc, config: RenderConfig, tile0: int = 0,
                tiles: int | None = None):
    """K2b -> (H, W, 3) float32, or with ``tiles`` set the range's
    (tiles * 1024, 3) in feed order.  ``boxes`` (ceil(T/8), 32) float32 are
    the normal records (``accel.normal_boxes``) each shadow ray tests before
    a group's triangles, ``wl`` (nt, L, n) int32 and ``cnt`` (nt, L) int32
    the shadow worklists, ``acc`` K2a's.  A CPU buffer takes
    ``mega2_shade_plain``, which needs no boxes."""
    global MEGA2_SHADE_LAUNCHES
    if buf.device.type == "cpu":
        return mega2_shade_plain(buf, counts, acc, config, tile0, tiles)
    _check(config)
    S, P, T, L = counts
    if L > MAX_LIGHTS:
        raise ValueError(f"K2b takes <= {MAX_LIGHTS} lights, got {L}")
    nt = num_tiles(config) if tiles is None else tiles
    build.check_tensors("K2b", buf.device, {
        "scene buffer": (buf, torch.float32, _buf_shape(counts)),
        "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS)),
        "wl": (wl, torch.int32, (nt, L, wl.shape[-1])), "cnt": (cnt, torch.int32, (nt, L)),
        "acc": (acc, torch.float32, (ACC_ROWS, nt * TILE))})
    build.check_aligned("K2b", "boxes", boxes, 16)
    out = torch.empty(frame_shape(config, tiles), dtype=torch.float32, device=buf.device)
    lib = build.load()
    with torch.cuda.device(buf.device):
        err = lib.raytpu_mega2_shade(
            buf.data_ptr(), S, P, T, L, boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(),
            wl.shape[2], config.width, config.height, int(is_tiled(config)), tile0, nt,
            int(tiles is not None), int(config.lighting_mode), int(bool(config.shadows)),
            float(config.ray_min), float(config.normal_offset), float(config.shadow_dim),
            acc.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2b launch failed: {build.cuda_error_name(lib, err)}")
    MEGA2_SHADE_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Plain versions: what mega2.cu computes, tile for tile, with no cull
# ---------------------------------------------------------------------------

def _tile_rays(cam, config: RenderConfig, tile0: int = 0, tiles: int | None = None):
    """Camera rays of the frame's slots in tile order (``accel.tile_pixels``),
    or of the tiles [tile0, tile0 + tiles), slots past the frame not valid."""
    px, py, valid = accel.tile_pixels(config.width, config.height, is_tiled(config), cam.device,
                                      tile=TILE)
    if tiles is not None:
        n0, n1 = tile0 * TILE, (tile0 + tiles) * TILE
        pad = max(0, n1 - px.shape[0])
        px, py, valid = (torch.cat([x, x.new_zeros((pad,))])[n0:n1] for x in (px, py, valid))
    ro, rd = plain.camera_rays(cam, px, py, config.width, config.height)
    return ro, rd, px, py, valid


def mega2_closest_plain(buf, counts, config: RenderConfig, tile0: int = 0,
                        tiles: int | None = None):
    """What K2a computes: ``(acc, bounds)`` as ``mega2_closest`` returns them."""
    cam, sph, pln, tri, _ = plain.mega_unpack(buf, counts)
    ro, rd, _, _, valid = _tile_rays(cam, config, tile0, tiles)
    t, n, mat = plain.closest_records(sph, pln, tri, ro, rd, float(config.ray_min))
    hit = valid & (t < plain.INF)
    t = torch.where(hit, t, plain.INF)
    acc = torch.stack([t] + [torch.where(hit, x, 0.0) for x in n + mat])
    ts = torch.where(hit, t, 0.0)
    po = torch.stack([math3d.fma(n[i], float(config.normal_offset), math3d.fma(ts, rd[i], ro[i]))
                      for i in range(3)], dim=1).reshape(-1, TILE, 3)
    hit = hit.reshape(-1, TILE, 1)
    lo = torch.where(hit, po, plain.INF).amin(dim=1)
    hi = torch.where(hit, po, -plain.INF).amax(dim=1)
    return acc, torch.cat([lo, hi], dim=1)


def mega2_shade_plain(buf, counts, acc, config: RenderConfig, tile0: int = 0,
                      tiles: int | None = None):
    """What K2b computes from K2a's ``acc``: the (H, W, 3) image, or a tile
    range's rays as ``mega2_shade`` returns them."""
    cam, sph, pln, tri, lit = plain.mega_unpack(buf, counts)
    ro, rd, px, py, valid = _tile_rays(cam, config, tile0, tiles)
    colors = plain.shade_records(sph, pln, tri, lit, config, ro, rd, acc[0],
                                 tuple(acc[1:4]), tuple(acc[4:11]))
    if tiles is not None:
        return torch.where(valid[:, None], colors, 0.0)
    W, H = config.width, config.height
    out = torch.zeros((H * W, 3), dtype=torch.float32, device=buf.device)
    out[(py * W + px)[valid]] = colors[valid]
    return out.reshape(H, W, 3)


def render_image_mega2_f32_plain(scene: Scene, config: RenderConfig):
    """The whole mega2 frame in plain tensor ops: K2a's plain version, then
    K2b's, with no cull."""
    _check(config)
    buf, counts = plain.mega_pack(scene, config)
    acc, _ = mega2_closest_plain(buf, counts, config)
    return mega2_shade_plain(buf, counts, acc, config)
