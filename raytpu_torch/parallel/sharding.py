"""Pixel x primitive sharding over ``torch.distributed``.

Counterpart of ``raytpu/parallel/sharding.py``.  The ranks of a group form
a (px, prim) mesh (``make_mesh``), each rank one process on one device:

  * ``px``: data parallelism over the rays; each px rank shades a
    contiguous block of them (the reference's CPU-thread pixel fan-out,
    source/Renderer.cpp:42-92);
  * ``prim``: the triangles are split over the prim ranks; each intersects
    its shard with the whole ray block, and the per-shard closest hits are
    merged by an all-gather and a lexicographic (t, priority) minimum, which
    keeps the reference's sphere < plane < triangle, low-index-first
    tie-break.  Shadow occlusion reduces with an all-reduce MAX.

On a px-only mesh a scene that the single-device router sends to K1 or K2
renders through the whole-frame kernels, each rank its own tile range
(``_render_fused_px``): no merge, one all-gather of the image.  Every rank
ends with the whole image.

Collectives go through ``all_gather`` and ``all_reduce`` below, on the
tensors' own device: gloo takes CUDA tensors for all-reduce, broadcast
and all-gather (checked on an H100, PERF.md) and stages them through the
host itself, which is what lets two ranks share one card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from raytpu_torch.core import math3d
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.grad import diff_render
from raytpu_torch.ops import accel, intersect
from raytpu_torch.render import chunked, cuda_kernel, mega2, mega3, packed, renderer

#: elements of one eager (rays x primitives) t-matrix chunk past the kernels'
#: limits (raytpu's 2^24, without its 1024-ray floor, which broke the bound
#: for huge shards)
EAGER_CHUNK_ELEMS = 1 << 24


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (px, prim) grid of ranks: rank = px_index *
    prim + prim_index, raytpu's device grid reshaped (px, prim).
    ``px_group`` joins the ranks of this rank's prim index (the ray blocks
    of one triangle shard), ``prim_group`` those of its px index (the
    triangle shards of one ray block); None where the axis has one rank, so
    its collectives are the identity."""

    px: int
    prim: int
    rank: int = 0
    px_group: object = None
    prim_group: object = None

    @property
    def shape(self) -> dict:
        return {"px": self.px, "prim": self.prim}

    @property
    def px_index(self) -> int:
        return self.rank // self.prim

    @property
    def prim_index(self) -> int:
        return self.rank % self.prim


def make_mesh(px: int | None = None, prim: int = 1, ranks: int | None = None) -> Mesh | None:
    """The (px, prim) mesh of the first ``ranks`` ranks of the process group
    (default all; one process without a group: 1x1), or None on a rank
    outside it.  ``px`` defaults to the ranks over ``prim``.  Every rank of
    the group calls it with the same arguments: it creates every axis
    group."""
    n = ranks or (dist.get_world_size() if dist.is_initialized() else 1)
    if prim < 1 or n % prim:
        raise ValueError(f"prim={prim} must divide the ranks {n}")
    px = n // prim if px is None else px
    if px * prim != n:
        raise ValueError(f"px*prim must equal the ranks ({px}x{prim} != {n})")
    rank = dist.get_rank() if dist.is_initialized() else 0
    px_group = prim_group = None
    if prim > 1:
        for i in range(px):
            g = dist.new_group([i * prim + j for j in range(prim)])
            if i == rank // prim:
                prim_group = g
    if px > 1:
        for j in range(prim):
            g = dist.new_group([i * prim + j for i in range(px)])
            if j == rank % prim:
                px_group = g
    return Mesh(px, prim, rank, px_group, prim_group) if rank < n else None


def all_gather(x, group, n: int):
    """(n, *x.shape): every rank's ``x`` over ``group`` of ``n`` ranks, in
    rank order."""
    if group is None:
        return x[None]
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """``op`` of every rank's ``x`` over ``group``, in a new tensor."""
    if group is None:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def _pad_rows(x, multiple: int, value=0.0):
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), value)])


def _pad_triangles(tris, multiple: int):
    """Pad with degenerate triangles: all-zero vertices fail the determinant
    test and zero normals the parallel test, so they always miss."""
    return dataclasses.replace(tris, **{f.name: _pad_rows(getattr(tris, f.name), multiple)
                                        for f in dataclasses.fields(tris)})


def _rows(tris, a: int, b: int):
    return dataclasses.replace(tris, **{f.name: getattr(tris, f.name)[a:b]
                                        for f in dataclasses.fields(tris)})


# ---------------------------------------------------------------------------
# Sharded closest hit: per-shard records and the lexicographic merge
# ---------------------------------------------------------------------------

def _mega2_fits(scene: Scene) -> bool:
    """A shard within K3's and K4's limits (raytpu's thresholds)?"""
    S, P, T, L = (scene.spheres.count, scene.planes.count, scene.triangles.count,
                  scene.lights.count)
    return (T <= diff_render.KERNEL_MAX_TRIS and S <= diff_render.KERNEL_MAX_UNROLL
            and P <= diff_render.KERNEL_MAX_UNROLL and L <= diff_render.KERNEL_MAX_LIGHTS
            and L * -(-T // 512) <= diff_render.WL_ENTRIES)


def _local_closest_hit(scene: Scene, ro, rd, tmin, tri_prio_offset: int, records=None):
    """Closest hit over every sphere and plane and this shard's triangles,
    and each ray's global priority (sphere < plane < triangle, low index
    first) for the merge: K3 with its payload on a shard within its
    limits, with the shard's own group records (``records``, from
    ``accel.normal_boxes`` of the shard, where the caller has them),
    past them the eager t-matrix in ray chunks."""
    S, P = scene.spheres.count, scene.planes.count
    ro_b = ro.expand_as(rd).contiguous()
    if _mega2_fits(scene):
        t, idx, normal, mat = packed.scene_min_t_mega2(scene, ro_b, rd, tmin, records)
        rec = packed.hit_records_from_payload(ro_b, rd, t, normal, mat)
        idx = idx.long()
    else:
        R, C = rd.shape[0], max(scene.num_primitives, 1)
        chunk = max(1, min(R, EAGER_CHUNK_ELEMS // C))
        t, idx = [], []
        for a in range(0, R, chunk):
            tmat = intersect.scene_t_matrix(scene, ro_b[a:a + chunk], rd[a:a + chunk], tmin,
                                            float("inf"), shadow_pass=False)
            t.append(tmat.amin(dim=1))
            idx.append(tmat.argmin(dim=1))  # the first minimum wins ties
        t, idx = torch.cat(t), torch.cat(idx)
        rec = intersect.assemble_hit_records(scene, ro_b, rd, t, idx)
    # triangles follow every sphere and plane globally: shift this shard's ids
    prio = torch.where(idx < S + P, idx, idx + tri_prio_offset)
    return rec, prio


def _merge_records(rec, prio, mesh: Mesh):
    """All-gather every shard's winners over ``prim`` and keep, per ray, the
    minimum t and, among equal t, the minimum priority."""
    if mesh.prim_group is None:
        return rec
    R = rec.t.shape[0]
    f = all_gather(torch.cat([rec.t[:, None], rec.point, rec.normal], dim=1), mesh.prim_group,
                   mesh.prim)  # (D, R, 7)
    i = all_gather(torch.stack([prio, rec.material.long()], dim=1), mesh.prim_group,
                   mesh.prim)  # (D, R, 2)
    t = f[:, :, 0]
    t_min = t.amin(dim=0)
    big = torch.iinfo(torch.int64).max
    d = torch.where(t == t_min[None], i[:, :, 0], big).argmin(dim=0)  # (R,)
    rows = torch.arange(R, device=d.device)
    fw, iw = f[d, rows], i[d, rows]
    return intersect.HitRecords(hit=torch.isfinite(t_min), t=t_min, point=fw[:, 1:4],
                                normal=fw[:, 4:7], material=iw[:, 1].to(torch.int32))


def _any_over_prim(occ, mesh: Mesh):
    return all_reduce(occ.to(torch.int32), mesh.prim_group, dist.ReduceOp.MAX) > 0


# ---------------------------------------------------------------------------
# The sharded render
# ---------------------------------------------------------------------------

def _shade_rays_sharded(scene: Scene, ro, rd, config: RenderConfig, tri_prio_offset: int,
                        mesh: Mesh):
    """``renderer.shade_rays`` on this rank's triangle shard, its closest
    hits merged and its shadow answers OR-ed over ``prim``.  The hooks are
    the kernels (their plain versions on the CPU): K3 for the closest hit,
    every light's occlusion at once by K4 within its limits and by K9 past
    them (which raises past 24 lights, as raytpu's does), one light at a
    time by K8's shadow mode.  K3's and K4's group records come from the
    shard's own triangles (``accel.normal_boxes`` of ``scene``), computed
    once for both, so record g is the shard's group g, the one its
    worklists and triangle records index."""
    records = accel.normal_boxes(scene.triangles) if _mega2_fits(scene) else None

    def closest_fn(s, ro_b, rd_b, tmin):
        rec, prio = _local_closest_hit(s, ro_b, rd_b, tmin, tri_prio_offset, records)
        return _merge_records(rec, prio, mesh)

    def any_fn(s, p, l, tmin, mag):
        return _any_over_prim(chunked.any_hit_chunked(s, p, l.contiguous(), tmin, mag), mesh)

    def any_multi_fn(s, p, dirs, mags, tmin):
        if _mega2_fits(s):
            occ = packed.any_hit_lights_mega2(s, p, dirs, mags, tmin, records)
        else:
            occ = chunked.any_hit_lights_chunked(s, p, dirs, mags, tmin)
        return _any_over_prim(occ, mesh)

    return renderer.shade_rays(scene, ro, rd, config, closest_fn=closest_fn, any_fn=any_fn,
                               any_multi_fn=any_multi_fn)


def _fused_kind(scene: Scene, config: RenderConfig):
    """The whole-frame kernels that serve this scene on a px-only mesh, or
    None: the single-device router's choice (``cuda_kernel.route_kind``),
    so the two cannot diverge.  "mega3" stays off it, as in raytpu
    (sharding.py:214-221): it is reached by name."""
    kind = cuda_kernel.route_kind(scene, config)
    return kind if kind in ("mega", "mega2") else None


_FUSED = {"mega": cuda_kernel.render_image_mega_f32, "mega2": mega2.render_image_mega2_f32,
          "mega3": mega3.render_image_mega3_f32}


def _render_fused_px(scene: Scene, config: RenderConfig, mesh: Mesh, kind: str):
    """px-sharded render through the whole-frame kernels (K1, K2 or K11):
    each px rank renders its contiguous range of 1024-ray tiles (raygen in
    the kernel, from the range's first tile), and the ranges are
    all-gathered.  Tiles are computed alone either way, so the image is the
    whole-frame kernels' bit for bit; the last rank's tiles past the frame
    are dropped."""
    H, W = config.height, config.width
    R = H * W
    tpc = -(-mega2.num_tiles(config) // mesh.px)  # tiles per rank
    colors = _FUSED[kind](scene, config, tile0=mesh.px_index * tpc, tiles=tpc)
    flat = all_gather(colors, mesh.px_group, mesh.px).reshape(-1, 3)[:R]
    if kind in ("mega2", "mega3") and mega2.is_tiled(config):
        flat = packed.mega2_unfold_rows(flat, H, W)  # 32x32 blocks -> row-major
    return flat.reshape(H, W, 3)


def render_pixels_sharded(scene: Scene, config: RenderConfig, mesh: Mesh):
    """The sharded forward pass (raytpu's ``render_pixels_shard_map``): rays
    split over ``px``, triangles over ``prim``; the (H, W, 3) float32 image
    on every rank.  Soft shadows multiply transmittances over every
    triangle, which a prim shard does not hold: they need prim = 1."""
    if config.soft_shadows and mesh.prim > 1:
        raise ValueError("soft shadows over triangle shards are not reduced: use prim = 1")
    if mesh.prim == 1:
        kind = _fused_kind(scene, config)
        if kind is not None:
            return _render_fused_px(scene, config, mesh, kind)

    H, W = config.height, config.width
    ro, rd = renderer.generate_rays(scene.camera, config)
    R = rd.shape[0]
    # rays in 32x32 pixel blocks, so that each 1024-ray cull tile is a
    # tight cone (a permutation, undone below)
    tiled = H % 32 == 0 and W % 32 == 0
    if tiled:
        rd = packed.mega2_fold(rd, H, W)
    rd = _pad_rows(rd, mesh.px, value=1.0)
    block = rd.shape[0] // mesh.px
    rd_l = rd[mesh.px_index * block:(mesh.px_index + 1) * block]

    tris = _pad_triangles(scene.triangles, mesh.prim)
    shard = tris.count // mesh.prim
    scene_l = dataclasses.replace(
        scene, triangles=_rows(tris, mesh.prim_index * shard, (mesh.prim_index + 1) * shard))
    colors = _shade_rays_sharded(scene_l, ro, rd_l, config, mesh.prim_index * shard, mesh)
    colors = all_gather(colors, mesh.px_group, mesh.px).reshape(-1, 3)[:R]
    if tiled:
        colors = packed.mega2_unfold_rows(colors, H, W)
    return colors.reshape(H, W, 3)


def render_image_sharded(scene: Scene, config: RenderConfig, mesh: Mesh):
    """The sharded render as (H, W, 3) uint8."""
    return math3d.quantize_u8(render_pixels_sharded(scene, config, mesh))
