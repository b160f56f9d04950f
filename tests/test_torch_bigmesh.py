"""The big-mesh routes of raytpu_torch against raytpu: the mega2 route (K2a
and K2b, here their plain versions) on bunny and optional, the packed route
(K3 and K4, here their plain versions, around the eager shade tail) on the
subdivided bunny, K3's and K4's plain versions against raytpu's
intersection, and the first-primitive tie-break.

On the CPU every kernel wrapper takes its plain version, so these tests hold
the plain versions and the glue around them against raytpu; the tests
marked ``cuda`` hold the kernels against the plain versions on a card.

Tolerances:
  * images against raytpu's jitted jnp renderer: the megakernel budget of
    tests/test_pallas.py, <= 1% of pixels off by more than one u8 step with
    mean absolute difference <= 0.5 (XLA fuses and contracts raytpu's
    arithmetic in its own way, so a near-tie can go the other way);
  * the packed route against the port's eager path: equal float32 images,
    since both shade with the same tail from the same winners;
  * K3 against raytpu's closest hit: the same winner on every ray, t and
    the normal within 1e-6 relative (absolute for the normal);
  * K4 against raytpu's any-hit: the same answer for every (light, ray);
  * kernels against plain versions on the card: the megakernel budget for
    images, K3's winners on >= 99.99% of rays with t within 1e-6 relative,
    K4 on >= 99.9% of (light, ray) pairs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core import math3d as jmath3d
from raytpu.core import types as jtypes
from raytpu.ops import intersect as jintersect
from raytpu.render import renderer as jrenderer
from raytpu_torch.core import convert, math3d, scenes
from raytpu_torch.core.types import CullMode, LightingMode, RenderConfig, SceneBuilder
from raytpu_torch.ops import accel
from raytpu_torch.render import cuda_kernel, mega2, packed, plain, renderer

torch.set_num_threads(2)

SIZES = [(32, 24), (64, 32)]  # 64x32 is two 32x32 tiles: the tiled feed
CONFIGS = [(LightingMode.COMBINED, True), (LightingMode.OBSERVED_AREA, True),
           (LightingMode.COMBINED, False)]
BUILDERS = {"bunny": scenes.get("bunny").build, "optional": scenes.get("optional").build,
            "bunny_subdiv3": functools.partial(scenes.scene_bunny_subdiv, 3)}
_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        _CACHE[name] = BUILDERS[name](device="cpu")
    return _CACHE[name]


def _jax_scene(scene):
    """raytpu's Scene holding the port scene's arrays, leaf for leaf (the
    builders agree exactly: tests/test_torch_mesh.py)."""
    arrays = convert.scene_to_arrays(scene)
    return jtypes.Scene(**{g: getattr(jtypes, cls.__name__)(**{
        f.name: jnp.asarray(arrays[f"{g}.{f.name}"]) for f in dataclasses.fields(cls)})
        for g, cls in convert.GROUPS.items()})


def _jnp_images(name):
    """raytpu's jnp renderer on scene ``name`` at every size, in the configs
    ROUTE_CASES takes on it, from one compile: rays of both sizes go as one
    batch, the closest hit and every light's any-hit run once, and
    shade_from_records shades them in each config (shade_rays is
    closest_hit then shade_from_records)."""
    key = ("jnp", name)
    if key not in _CACHE:
        L = _scene(name).lights.count
        confs = [c for c in CONFIGS if any(n == name and cc == c for n, _, _, cc in ROUTE_CASES)]

        def cfg(w, h, mode=LightingMode.COMBINED, shadows=True):
            return jtypes.RenderConfig(width=w, height=h, shadows=shadows,
                                       lighting_mode=jtypes.LightingMode(int(mode)))

        @jax.jit
        def run(s):
            rays = [jrenderer.generate_rays(s.camera, cfg(w, h)) for w, h in SIZES]
            rd = jnp.concatenate([d for _, d in rays])
            c0 = cfg(*SIZES[0])
            rec = jintersect.closest_hit(s, jnp.broadcast_to(rays[0][0], rd.shape), rd, c0.ray_min)
            p_off, dirs, mags = jrenderer.shadow_query_inputs(s, rec, c0)
            occ = jnp.stack([jintersect.any_hit(s, p_off, dirs[li], c0.ray_min, mags[li])
                             for li in range(L)])
            return [jmath3d.quantize_u8(jrenderer.shade_from_records(
                s, rec, rd, cfg(*SIZES[0], mode, shadows), any_multi_fn=lambda *_: occ))
                for mode, shadows in confs]

        flat = [np.asarray(x) for x in run(_jax_scene(_scene(name)))]
        starts = np.cumsum([0] + [w * h for w, h in SIZES])
        _CACHE[key] = {(w, h, conf): img[s:s + w * h].reshape(h, w, 3)
                       for conf, img in zip(confs, flat)
                       for (w, h), s in zip(SIZES, starts)}
    return _CACHE[key]


def _close(a, b, budget=0.01, mean_max=0.5):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    flipped = (d > 1).any(axis=-1).mean()
    assert flipped <= budget, f"{flipped:.4%} pixels differ by more than 1 (max {d.max()})"
    assert d.mean() <= mean_max, f"mean abs diff {d.mean():.4f}"


# (scene, route, size, config): every size and config on bunny, fewer on the
# larger meshes, whose plain versions test every triangle on the CPU
ROUTE_CASES = (
    [("bunny", "mega2", s, c) for s in SIZES for c in CONFIGS]
    + [("optional", "mega2", SIZES[0], c) for c in CONFIGS]
    + [("optional", "mega2", SIZES[1], CONFIGS[0])]
    + [("bunny", "packed", SIZES[1], CONFIGS[0]), ("bunny", "packed", SIZES[0], CONFIGS[1])]
    + [("bunny_subdiv3", "packed", SIZES[0], CONFIGS[0]),
       ("bunny_subdiv3", "packed", SIZES[1], CONFIGS[2])]
)


@pytest.mark.parametrize("name,route,size,conf", ROUTE_CASES, ids=[
    f"{n}-{r}-{s[0]}x{s[1]}-{c[0].name.lower()}-shadows{int(c[1])}" for n, r, s, c in ROUTE_CASES])
def test_plain_routes_match_raytpu_jnp(name, route, size, conf):
    """The route render_image takes (the packed route is also driven on
    bunny, below its band) against raytpu's jnp renderer.  On the CPU no
    kernel launches."""
    scene = _scene(name)
    cfg = RenderConfig(width=size[0], height=size[1], lighting_mode=conf[0], shadows=conf[1])
    counts = (mega2.MEGA2_CLOSEST_LAUNCHES, mega2.MEGA2_SHADE_LAUNCHES,
              packed.PACKED_CLOSEST_LAUNCHES, packed.PACKED_ANYHIT_LAUNCHES)
    if route == "packed" and name == "bunny":
        img = math3d.quantize_u8(packed.render_image_packed_f32(scene, cfg))
    else:
        assert cuda_kernel.route_kind(scene, cfg) == route
        img = cuda_kernel.render_image(scene, cfg)
    _close(img.numpy(), _jnp_images(name)[(size[0], size[1], conf)])
    assert counts == (mega2.MEGA2_CLOSEST_LAUNCHES, mega2.MEGA2_SHADE_LAUNCHES,
                      packed.PACKED_CLOSEST_LAUNCHES, packed.PACKED_ANYHIT_LAUNCHES)


def test_packed_route_equals_the_eager_path():
    """The packed route shades with the eager tail from K3's winners, which
    are the eager argmin's: the images are equal, tiled feed included."""
    scene = _scene("bunny")
    for w, h in SIZES:
        cfg = RenderConfig(width=w, height=h)
        np.testing.assert_array_equal(packed.render_image_packed_f32(scene, cfg).numpy(),
                                      renderer.render_image_f32(scene, cfg).numpy())


def _random_rays(n, seed):
    """``n`` rays from points in the bunny room, in random directions."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform([-4.5, 0.2, -4.0], [4.5, 6.0, 9.0], (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3))
    return ro, (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)


def test_k3_k4_plain_match_raytpu_intersection():
    """K3's plain version against raytpu's closest hit (the winner from its
    t-matrix's first argmin), K4's against raytpu's any-hit, on the same
    rays through the subdivided bunny's 18,688 triangles."""
    scene = _scene("bunny_subdiv3")
    ro, rd = _random_rays(128, 0)
    L = scene.lights.count
    mags = np.linalg.norm(scene.lights.position.numpy()[:, None] - ro[None], axis=-1)
    dirs = ((scene.lights.position.numpy()[:, None] - ro[None]) / mags[..., None]).astype(np.float32)

    @jax.jit
    def ref(s, ro, rd, dirs, mags):
        tmat = jintersect.scene_t_matrix(s, ro, rd, 1e-4, jnp.inf, shadow_pass=False)
        rec = jintersect.closest_hit(s, ro, rd, 1e-4)
        occ = jnp.stack([jintersect.any_hit(s, ro, dirs[li], 1e-4, mags[li]) for li in range(L)])
        return jnp.argmin(tmat, axis=1), rec.t, rec.normal, rec.material, occ

    idx_r, t_r, n_r, m_r, occ_r = (np.asarray(x) for x in ref(
        _jax_scene(scene), ro, rd, dirs, mags.astype(np.float32)))
    blobs = packed.soft_packs(scene)
    t, idx, normal, mat = (x.numpy() for x in packed.winner_search_plain(
        torch.as_tensor(ro), torch.as_tensor(rd), *blobs, 1e-4))
    hit = np.isfinite(t_r)
    assert hit.mean() > 0.9
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_array_equal(idx[hit], idx_r[hit])
    np.testing.assert_allclose(t[hit], t_r[hit], rtol=1e-6, atol=0)
    np.testing.assert_allclose(normal, n_r, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mat, m_r)
    occ = packed.any_hit_lights_plain(torch.as_tensor(ro), torch.as_tensor(dirs),
                                      torch.as_tensor(mags.astype(np.float32)), *blobs, 1e-4)
    assert 0.05 < occ_r.mean() < 0.95
    np.testing.assert_array_equal(occ.numpy(), occ_r)


def _tie_scene(device):
    """20 triangles of one mesh facing the camera (insertion order kept: the
    builder reorders only past 256 faces); triangles 3 and 17, in different
    8-triangle groups, coincide."""
    b = SceneBuilder()
    lam = b.add_lambert((0.8, 0.8, 0.8), 1.0)
    b.add_plane((0.0, 0.0, 10.0), (0.0, 0.0, -1.0), lam)
    m = b.add_triangle_mesh(CullMode.NONE, lam)
    for i in range(20):
        k = 3 if i == 17 else i
        x, y = (k % 5) * 0.9 - 2.0, (k // 5) * 0.9 - 2.0
        m.append_triangle((x, y, 4.0), (x + 0.8, y, 4.0), (x, y + 0.8, 4.0))
    b.add_point_light((0.0, 0.0, 0.0), 10.0, (1.0, 1.0, 1.0))
    b.set_camera((0.0, 0.0, 0.0), fov_degrees=70.0)
    return b.build(device)


def _tie_rays(scene):
    """64x32 camera rays, folded into 32x32 tiles, and the index of the ray
    through the middle of triangle 3."""
    ro, rd = renderer.generate_rays(scene.camera, RenderConfig(width=64, height=32))
    rd = packed.mega2_fold(rd, 32, 64)
    c = torch.tensor([-2.0 + 3 * 0.9 + 0.27, -2.0 + 0.27, 4.0])
    target = int(torch.argmax(rd.cpu() @ (c / c.norm())))
    return ro.expand_as(rd).contiguous(), rd, target


def test_coincident_triangles_go_to_the_first(monkeypatch):
    """A tie goes to the first primitive: with 8 triangles to a chunk of the
    plain t-matrix, as in 8-triangle kernel groups, the coincident triangles
    3 and 17 fall in different chunks, and 3 wins."""
    scene = _tie_scene("cpu")
    ro, rd, target = _tie_rays(scene)
    monkeypatch.setitem(plain.CHUNK_ELEMS, "cpu", 8 * rd.shape[0])
    t, idx, _, _ = packed.scene_min_t_mega2(scene, ro, rd, 1e-4)
    first = scene.spheres.count + scene.planes.count + 3
    assert torch.isfinite(t[target]) and int(idx[target]) == first
    # the whole-frame kernels' plain closest hit picks the same winner
    buf, counts = plain.mega_pack(scene, RenderConfig())
    _, sph, pln, tri, _ = plain.mega_unpack(buf, counts)
    t2, idx2 = plain.closest_plain(sph, pln, tri, ro.unbind(1), rd.unbind(1), 1e-4)
    assert torch.equal(t2, t) and torch.equal(idx2.to(torch.int32), idx)


def test_route_wrappers_refuse_what_the_kernels_do_not_take():
    """A wrapper takes its plain version only for CPU tensors; tensors on
    any other device than CUDA, or of the wrong shape, raise before a
    launch, and the routes render hard shadows only."""
    from raytpu_torch.render import build

    scene = _scene("bunny")
    cfg = RenderConfig(width=32, height=24)
    buf, counts = plain.mega_pack(scene, cfg)
    wl, cnt = mega2.primary_worklists(scene, cfg)
    before = (mega2.MEGA2_CLOSEST_LAUNCHES, mega2.MEGA2_SHADE_LAUNCHES,
              packed.PACKED_CLOSEST_LAUNCHES)
    records = accel.normal_boxes(scene.triangles)[2]
    with pytest.raises(ValueError, match="K2a runs on CUDA"):
        mega2.mega2_closest(buf.to("meta"), counts, records.to("meta"), wl.to("meta"),
                            cnt.to("meta"), cfg)
    acc = torch.zeros((mega2.ACC_ROWS, mega2.num_tiles(cfg) * mega2.TILE))
    wl_s, cnt_s = wl[:, None].expand(-1, counts[3], -1), cnt[:, None].expand(-1, counts[3])
    with pytest.raises(ValueError, match="K2b runs on CUDA"):
        mega2.mega2_shade(buf.to("meta"), counts, records.to("meta"), wl_s.to("meta"),
                          cnt_s.to("meta"), acc.to("meta"), cfg)
    ro, rd = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError, match="K3 runs on CUDA"):
        packed.winner_search(ro.to("meta"), rd.to("meta"),
                             *(b.to("meta") for b in packed.soft_packs(scene)),
                             accel.normal_boxes(scene.triangles)[2].to("meta"),
                             wl.to("meta"), cnt.to("meta"), 1e-4)
    with pytest.raises(ValueError, match="rd must be a contiguous"):
        build.check_tensors("K3", torch.device("cuda"), {"rd": (rd, torch.float32, (4, 3))})
    for route in (mega2.render_image_mega2_f32, packed.render_image_packed_f32):
        with pytest.raises(ValueError, match="hard shadows"):
            route(scene, RenderConfig(width=8, height=8, soft_shadows=True))
    assert (mega2.MEGA2_CLOSEST_LAUNCHES, mega2.MEGA2_SHADE_LAUNCHES,
            packed.PACKED_CLOSEST_LAUNCHES) == before


def test_k2a_refuses_to_run_without_the_normal_records():
    """K2a walks the normal records (``accel.normal_boxes``): a wrapper call
    on tensors off the CPU without them raises before a launch, on any
    device; with them, tensors off CUDA still raise."""
    scene = _scene("bunny")
    cfg = RenderConfig(width=32, height=24)
    buf, counts = plain.mega_pack(scene, cfg)
    wl, cnt = mega2.primary_worklists(scene, cfg)
    before = mega2.MEGA2_CLOSEST_LAUNCHES
    with pytest.raises(ValueError, match="K2a walks the normal records"):
        mega2.mega2_closest(buf.to("meta"), counts, None, wl.to("meta"), cnt.to("meta"), cfg)
    assert mega2.MEGA2_CLOSEST_LAUNCHES == before
    # the CPU's plain version needs none
    acc, bounds = mega2.mega2_closest(buf, counts, None, wl, cnt, cfg)
    assert acc.shape == (mega2.ACC_ROWS, mega2.num_tiles(cfg) * mega2.TILE)
    assert bounds.shape == (mega2.num_tiles(cfg), 6)


@pytest.mark.cuda
def test_k2a_equals_k11a_on_the_card():
    """K2a is K11a's closest pass over the scene buffer's triangles: its
    buffer and tile boxes equal K11a's on the same worklists and records
    bit for bit, and its own launch's over records that pass every group,
    on bunny and optional at 64x32 and 50x37 (ragged) and on a tile range
    with a padded tile past the frame, the range's counters zeroed by the
    wrapper.  Run on a machine with a card with
    ``pytest -m cuda tests/test_torch_bigmesh.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from raytpu_torch.render import mega3

    for name in ("bunny", "optional"):
        scene = scenes.get(name).build("cuda")
        glo, ghi, records = accel.normal_boxes(scene.triangles)
        opened = accel.open_normal_boxes(records.shape[0], "cuda")
        for w, h in ((64, 32), (50, 37)):
            cfg = RenderConfig(width=w, height=h)
            buf, counts = plain.mega_pack(scene, cfg)
            blob = mega3.pack_groups(buf, counts)
            nt = mega2.num_tiles(cfg)
            for tile0, tiles in ((0, None), (1, nt)):  # the range ends past the frame
                wl, cnt = mega2.primary_worklists(scene, cfg, tile0, tiles, (glo, ghi))
                before = mega2.MEGA2_CLOSEST_LAUNCHES
                got = mega2.mega2_closest(buf, counts, records, wl, cnt, cfg, tile0, tiles)
                assert mega2.MEGA2_CLOSEST_LAUNCHES == before + 1
                for want in (mega3.mega3_closest(buf, counts, blob, records, wl, cnt, cfg, tile0,
                                                 tiles),
                             mega2.mega2_closest(buf, counts, opened, wl, cnt, cfg, tile0, tiles)):
                    for a, b in zip(got, want):
                        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_big_mesh_kernels_match_plain_versions_on_the_card():
    """K2a + K2b, K3 and K4 against their plain versions on a card (K2b bit
    for bit, and equal to its own launch over records that pass every
    group), and the tie-break through the kernels; run on a machine with a
    card with
    ``pytest -m cuda tests/test_torch_bigmesh.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    bunny = scenes.get("bunny").build("cuda")
    for cfg in (RenderConfig(width=64, height=32), RenderConfig(width=50, height=37)):
        before = (mega2.MEGA2_CLOSEST_LAUNCHES, mega2.MEGA2_SHADE_LAUNCHES)
        img = cuda_kernel.render_image(bunny, cfg)
        assert (mega2.MEGA2_CLOSEST_LAUNCHES, mega2.MEGA2_SHADE_LAUNCHES) == (before[0] + 1,
                                                                            before[1] + 1)
        ref = math3d.quantize_u8(mega2.render_image_mega2_f32_plain(bunny, cfg))
        _close(img.cpu().numpy(), ref.cpu().numpy())
        # K2b on the walk: its plain version's image on K2a's buffer, and its
        # own launch's over records that pass every group, bit for bit
        buf, counts = plain.mega_pack(bunny, cfg)
        glo, ghi, records = accel.normal_boxes(bunny.triangles)
        wl, cnt = mega2.primary_worklists(bunny, cfg, group_bounds=(glo, ghi))
        acc, bounds = mega2.mega2_closest(buf, counts, records, wl, cnt, cfg)
        wl_s, cnt_s = mega2.shadow_worklists(bunny, cfg, bounds, (glo, ghi))
        shaded = mega2.mega2_shade(buf, counts, records, wl_s, cnt_s, acc, cfg)
        opened = accel.open_normal_boxes(records.shape[0], "cuda")
        for want in (mega2.mega2_shade_plain(buf, counts, acc, cfg),
                     mega2.mega2_shade(buf, counts, opened, wl_s, cnt_s, acc, cfg)):
            assert torch.equal(shaded.view(torch.int32), want.view(torch.int32))
    scene = scenes.scene_bunny_subdiv(3, device="cuda")
    cfg = RenderConfig(width=64, height=32)
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rd = packed.mega2_fold(rd, 32, 64)
    ro = ro.expand_as(rd).contiguous()
    t, idx, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, cfg.ray_min)
    blobs = packed.soft_packs(scene)
    tp, idxp, normalp, matp = packed.winner_search_plain(ro, rd, *blobs, cfg.ray_min)
    same = idx == idxp
    assert same.float().mean() >= 0.9999
    both = same & torch.isfinite(tp)
    assert ((t - tp).abs() <= 1e-6 * tp.abs())[both].all()
    rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
    p_off, dirs, mags = renderer.shadow_query_inputs(scene, rec, cfg)
    occ = packed.any_hit_lights_mega2(scene, p_off, dirs, mags, cfg.ray_min)
    occp = packed.any_hit_lights_plain(p_off, dirs, mags, *blobs, cfg.ray_min)
    assert (occ == occp).float().mean() >= 0.999
    tie = _tie_scene("cuda")
    ro, rd, target = _tie_rays(tie)
    _, idx, _, _ = packed.scene_min_t_mega2(tie, ro, rd, 1e-4)
    assert int(idx[target]) == tie.spheres.count + tie.planes.count + 3
