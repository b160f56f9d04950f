"""The port's big-mesh scene data against raytpu's: the OBJ parser, the
native SAH order, the OBJ scenes and stress meshes after the
reorder, the cull glue of raytpu_torch.ops.accel, and the router.

Tolerances:
  * parsed arrays, native orders, every leaf of every built or animated
    scene, group boxes, cull matrices and worklists: exact (np.array_equal);
    both packages run the same native library code and the same float32
    operations in the same order;
  * tile bounds computed by arithmetic on rays or on the camera: 1e-6
    relative, since XLA may contract a multiply-add that torch rounds
    twice.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core import obj as jobj
from raytpu.core import scenes as jscenes
from raytpu.core import types as jtypes
from raytpu.native import runtime as jruntime
from raytpu.ops import accel as jaccel
from raytpu.render import pallas_kernel as jpk
from raytpu_torch.core import convert, obj, scenes
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.native import runtime
from raytpu_torch.ops import accel
from raytpu_torch.render import cuda_kernel, renderer

torch.set_num_threads(2)

OBJS = ["simple_object.obj", "lowpoly_bunny2.obj", "Assignment3D1.obj"]

# name -> (port builder, raytpu builder, animate for t=1.25)
BUILT = {
    "w4_test": ("w4_test", "w4_test"),
    "bunny": ("bunny", "bunny"),
    "optional": ("optional", "optional"),
    "bunny_subdiv3": (functools.partial(scenes.scene_bunny_subdiv, 3),
                      functools.partial(jscenes.scene_bunny_subdiv, 3)),
    "bunny50k": ("bunny50k", "bunny50k"),
}
_SCENES = {}


def _scene_pair(name):
    """(port scene on the CPU, raytpu scene), each built once per module."""
    if name not in _SCENES:
        mine, ref = BUILT[name]
        mine = scenes.get(mine).build if isinstance(mine, str) else mine
        ref = jscenes.get(ref).build if isinstance(ref, str) else ref
        _SCENES[name] = (mine(device="cpu"), ref())
    return _SCENES[name]


def _animate(name):
    """The port's and raytpu's animate functions of a built scene."""
    key = "bunny" if name == "bunny_subdiv3" else name
    return scenes.get(key).animate, jscenes.get(key).animate


def _jax_scene(arrays):
    """A raytpu Scene from one array per leaf (convert's keys)."""
    groups = {g: getattr(jtypes, cls.__name__)(**{
        f.name: jnp.asarray(arrays[f"{g}.{f.name}"]) for f in dataclasses.fields(cls)})
        for g, cls in convert.GROUPS.items()}
    return jtypes.Scene(**groups)


@pytest.mark.parametrize("name", OBJS)
def test_parse_obj_matches_raytpu(name):
    """raytpu parses with its native library when that is built, as the
    port always does.  The port reads its own copy of each asset, equal to
    raytpu's byte for byte."""
    for a, b in zip(obj.parse_obj(name), jobj.parse_obj(name)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert obj.resolve_asset(name) == str(obj.ASSET_DIR / name)
    assert (Path(obj.resolve_asset(name)).read_bytes()
            == Path(jobj.resolve_asset(name)).read_bytes())
    with pytest.raises(FileNotFoundError):
        obj.resolve_asset("no_such_mesh.obj")


def test_native_orders_match_raytpu():
    """The copied builder gives raytpu's SAH tree and leaf order, bit for
    bit, on a real soup and on one with ties."""
    pos, _, idx = jobj.parse_obj("Assignment3D1.obj")
    soups = [pos[idx.reshape(-1, 3)]]
    grid = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0), np.arange(2.0)), -1).reshape(-1, 3)
    soups.append(np.stack([grid, grid + [1, 0, 0], grid + [0, 1, 0]], axis=1).astype(np.float32))
    for soup in soups:
        for a, b in zip(runtime.build_bvh(soup, 8, 8), jruntime.build_bvh(soup, 8, 8)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(accel.spatial_permutation(soup),
                                      jaccel.spatial_permutation(soup))


def test_no_silent_fallback_without_the_native_library(monkeypatch, tmp_path):
    """raytpu falls back to Morton order when its library will not build;
    the port raises instead of changing the scene's triangle order."""
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "GXX_FLAGS", runtime.GXX_FLAGS + ["-no-such-flag"])
    soup = np.zeros((3, 3, 3), np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        accel.spatial_permutation(soup)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        obj.parse_obj("simple_object.obj")


@pytest.mark.parametrize("t", [None, 1.25])
@pytest.mark.parametrize("name", list(BUILT))
def test_scene_arrays_match_raytpu(name, t):
    """Every leaf after the build (with the SAH reorder past 256 faces) and
    after an animation step equals raytpu's exactly, triangle order
    included."""
    mine, ref = _scene_pair(name)
    if t is not None:
        anim_mine, anim_ref = _animate(name)
        mine, ref = anim_mine(mine, t), anim_ref(ref, t)
    a, b = convert.scene_to_arrays(mine), convert.scene_to_arrays(ref)
    for key in convert.leaf_names():
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_route_kind_matches_raytpu_on_every_scene():
    """The router takes raytpu's route for every registry scene.  bunny300k
    (299,008 triangles) is stood in for by bunny50k's soup repeated four
    times: the router reads only the counts."""
    assert sorted(scenes.REGISTRY) == sorted(jscenes.REGISTRY)
    cfgs = [RenderConfig(), RenderConfig(shadows=False), RenderConfig(soft_shadows=True)]
    kinds = {}
    for name in scenes.REGISTRY:
        if name == "bunny300k":
            continue
        scene = _scene_pair(name)[0] if name in BUILT else scenes.get(name).build("cpu")
        kinds[name] = scene
    big = kinds["bunny50k"]
    kinds["bunny300k"] = dataclasses.replace(big, triangles=type(big.triangles)(
        **{f.name: getattr(big.triangles, f.name).repeat_interleave(4, dim=0)
           for f in dataclasses.fields(big.triangles)}))
    assert kinds["bunny300k"].triangles.count == 299_008
    for name, scene in kinds.items():
        ref = _jax_scene(convert.scene_to_arrays(scene))
        for cfg in cfgs:
            jcfg = jtypes.RenderConfig(soft_shadows=cfg.soft_shadows, shadows=cfg.shadows)
            assert cuda_kernel.route_kind(scene, cfg) == jpk.route_kind(ref, jcfg), (name, cfg)
    want = {"bunny": "mega2", "optional": "mega2", "bunny50k": "packed", "bunny300k": "packed",
            "reference": "mega", "w4_test": "mega"}
    assert {n: cuda_kernel.route_kind(kinds[n], RenderConfig()) for n in want} == want


# ---------------------------------------------------------------------------
# Cull glue
# ---------------------------------------------------------------------------

W, H = 64, 32  # tiled: two 32x32 tiles


def _glue_inputs():
    """bunny's triangles and camera, its tiled camera rays, and the shadow
    rays of their hits, as numpy arrays shared by both packages."""
    scene = _scene_pair("bunny")[0]
    cfg = RenderConfig(width=W, height=H)
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    from raytpu_torch.render import packed

    rd = packed.mega2_fold(rd, H, W)
    ro_b = ro.expand_as(rd).contiguous()
    from raytpu_torch.ops import intersect

    rec = intersect.closest_hit(scene, ro_b, rd, cfg.ray_min)
    p_off, dirs, mags = renderer.shadow_query_inputs(scene, rec, cfg)
    hit = rec.hit.numpy()
    po = p_off.numpy()
    lo = np.where(hit[:, None], po, np.inf).reshape(2, 1024, 3).min(axis=1)
    hi = np.where(hit[:, None], po, -np.inf).reshape(2, 1024, 3).max(axis=1)
    lo = np.concatenate([lo, np.full((1, 3), np.inf, np.float32)])  # an all-miss tile
    hi = np.concatenate([hi, np.full((1, 3), -np.inf, np.float32)])
    return {"arrays": convert.scene_to_arrays(scene), "ro": ro_b.numpy(), "rd": rd.numpy(),
            "p": po, "dirs": dirs.numpy(), "mags": mags.numpy(), "lo": lo, "hi": hi, "hit": hit}


def _glue(acc, scene, inp, rtb_tile):
    """Every glue function on the same inputs; ``acc`` is either module."""
    out = {}
    tr = scene.triangles
    glo, ghi = acc.chunk_bounds(tr, 8)
    out["chunk_bounds8"] = (glo, ghi)
    out["chunk_bounds128"] = acc.chunk_bounds(tr, 128)
    for name, args in (("cam_tiled", (W, H, True)), ("cam_rows", (50, 37, False))):
        out[name] = acc.camera_tile_bounds(scene.camera, *args, tile=1024)
    out["cull_cam"] = acc.cull_matrix(out["cam_tiled"], glo, ghi, 1e-4)
    rb = acc.ray_tile_bounds(inp["ro"], inp["rd"], float("inf"), tile=rtb_tile)
    out["rtb"] = rb
    out["cull_rays"] = acc.cull_matrix(rb, glo, ghi, 1e-4)
    lights = scene.lights
    for li in range(lights.position.shape[0]):
        args = (lights.position[li], lights.direction[li], lights.kind[li] == 0)
        out[f"shadow{li}"] = acc.shadow_cull_matrix(inp["p"], inp["dirs"][li], inp["mags"][li],
                                                    args[0], args[2], glo, ghi, 1e-4, tile=rtb_tile)
        out[f"aabb{li}"] = acc.light_shadow_cull_from_aabb(inp["lo"], inp["hi"], *args, glo, ghi, 1e-4)
    out["aabb_dir"] = acc.light_shadow_cull_from_aabb(
        inp["lo"], inp["hi"], lights.position[0], inp["unit"], False, glo, ghi, 1e-4)
    return out


def test_accel_glue_matches_raytpu():
    inp = _glue_inputs()
    inp["unit"] = np.asarray([0.3, -0.9, 0.316227766], np.float32)
    inp["unit"] /= np.linalg.norm(inp["unit"])

    arrays = {k: v for k, v in inp.items() if k not in ("arrays", "hit")}
    ref = jax.jit(lambda scene, x: _glue(jaccel, scene, x, 1024))(_jax_scene(inp["arrays"]), arrays)
    scene = convert.scene_from_arrays(inp["arrays"], "cpu")
    mine = _glue(accel, scene, {k: torch.as_tensor(v) for k, v in arrays.items()}, 1024)
    for key, b in ref.items():
        a = mine[key]
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        for x, y in zip(a, b):
            x, y = x.numpy(), np.asarray(y)
            assert x.shape == y.shape, key
            if key.startswith(("chunk_bounds", "cull", "shadow", "aabb")):
                np.testing.assert_array_equal(x, y, err_msg=key)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=key)
        if key.startswith(("cull", "shadow", "aabb")):
            wl, cnt = accel.chunk_worklist(mine[key])
            jwl, jcnt = jax.jit(jpk.chunk_worklist)(np.asarray(ref[key]))
            np.testing.assert_array_equal(wl.numpy(), np.asarray(jwl), err_msg=key)
            np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt)[:, 0], err_msg=key)
    assert not mine["aabb0"][2].any()  # the all-miss tile culls every group


def test_worklists_keep_every_hit_group():
    """The culls are conservative: every group holding a triangle that a
    ray of the tile hits (camera rays) or that occludes it (the shadow rays
    of hits for the box cull, every shadow ray for the per-ray cull) is on
    the tile's worklist, in ascending order.  So a kernel walking the
    worklists finds what a search of every triangle finds, and the first
    triangle on a tie."""
    from raytpu_torch.ops import intersect

    inp = _glue_inputs()
    scene = _scene_pair("bunny")[0]
    glo, ghi = accel.chunk_bounds(scene.triangles, 8)
    S, P = scene.spheres.count, scene.planes.count
    ro, rd = torch.as_tensor(inp["ro"]), torch.as_tensor(inp["rd"])
    hits = torch.isfinite(intersect.scene_t_matrix(scene, ro, rd, 1e-4, float("inf"),
                                                   shadow_pass=False)[:, S + P:])
    assert hits.any()
    cases = [(hits, accel.cull_matrix(accel.camera_tile_bounds(scene.camera, W, H, True),
                                      glo, ghi, 1e-4))]
    p, dirs, mags = (torch.as_tensor(inp[k]) for k in ("p", "dirs", "mags"))
    hit = torch.as_tensor(inp["hit"])
    lo, hi = torch.as_tensor(inp["lo"][:2]), torch.as_tensor(inp["hi"][:2])
    lights = scene.lights
    for li in range(lights.count):
        occ = torch.isfinite(intersect.scene_t_matrix(scene, p, dirs[li], 1e-4, mags[li],
                                                      shadow_pass=True)[:, S + P:])
        pos, is_pt = lights.position[li], lights.kind[li] == 0
        cases.append((occ & hit[:, None], accel.light_shadow_cull_from_aabb(
            lo, hi, pos, lights.direction[li], is_pt, glo, ghi, 1e-4)))
        cases.append((occ, accel.shadow_cull_matrix(p, dirs[li], mags[li], pos, is_pt, glo, ghi,
                                                    1e-4, tile=1024)))
    for tri_hits, cull in cases:
        groups = torch.zeros((tri_hits.shape[0], glo.shape[0]), dtype=torch.bool)
        r, k = tri_hits.nonzero(as_tuple=True)
        groups[r, k // 8] = True
        need = groups.reshape(2, 1024, -1).any(dim=1)
        assert not (need & (cull == 0)).any()
        wl, cnt = accel.chunk_worklist(cull)
        for i in range(2):
            row = wl[i, :cnt[i]]
            assert torch.equal(row, torch.sort(row).values)
            assert set(need[i].nonzero().flatten().tolist()) <= set(row.tolist())


def test_tile_pixels_cover_the_frame_once():
    for w, h, tiled in ((64, 32, True), (50, 37, False)):
        px, py, valid = accel.tile_pixels(w, h, tiled, "cpu")
        rid = (py * w + px)[valid]
        assert torch.equal(torch.sort(rid).values, torch.arange(w * h))
    folded = torch.arange(64 * 32)[:, None].float()
    from raytpu_torch.render import packed

    px, py, _ = accel.tile_pixels(64, 32, True, "cpu")
    assert torch.equal(packed.mega2_fold(folded, 32, 64)[:, 0].long(), py * 64 + px)
    assert torch.equal(packed.mega2_unfold_rows(packed.mega2_fold(folded, 32, 64), 32, 64), folded)

