"""The chunked route of raytpu_torch against raytpu: K8 (both modes), K9 and
K10, here their plain versions, the route that runs K8 and K10, the
``shade_rays`` that runs K8 and K9, the router's boundaries and the
per-stage profiler, on bunny_l12 (the 292-triangle bunny plus nine lights:
12 lights, so culled chunks) and reference_s106 (reference plus 100
spheres: 106 spheres, 3 triangles, so every chunk).

On the CPU every kernel wrapper takes its plain version; the test marked
``cuda`` holds the kernels against the plain versions on a card.  raytpu's
references run its Pallas kernels in interpret mode, as its own tests do
on the CPU (tests/test_pallas.py), jitted and compiled at XLA's backend
optimisation level 0, which compiles several times faster; they run in
worker processes (``_raytpu_jobs``, tests/torch_jobs.py: niced, one
thread each), started as the module starts, while the port's side runs
here.

Tolerances (raytpu's own, tests/test_pallas.py):
  * K8's closest mode against ``closest_hit_pallas`` and the jnp
    ``closest_hit``: ``hit`` and ``material`` equal, t within 1e-5
    relative, normal and point within 1e-5;
  * K8's shadow mode against ``any_hit_pallas`` and K9 against
    ``any_hit_lights_pallas``: >= 99.9% of rays and of (light, ray) pairs
    equal;
  * images (the chunked route against raytpu's chunked route and its jnp
    renderer, ``shade_rays`` against raytpu's): the megakernel budget, <= 1%
    of pixels off by more than one u8 step, mean absolute difference <= 0.5
    (XLA reduces raytpu's dot products in its own order, so a near-tie may
    go the other way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jobs

from raytpu.core import math3d as jmath3d
from raytpu.core import types as jtypes
from raytpu.ops import intersect as jintersect
from raytpu.render import pallas_kernel as pk
from raytpu.render import renderer as jrenderer
from raytpu.utils import stage_profile as jstage_profile
from raytpu_torch.core import convert, math3d, scenes
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.ops import accel
from raytpu_torch.render import chunked, cuda_kernel, packed, plain, renderer
from raytpu_torch.utils import stage_profile

torch.set_num_threads(2)

W, H = 32, 24
FIXTURES = ("bunny_l12", "reference_s106")
FAST_COMPILE = {"xla_backend_optimization_level": 0}
JOB_WORKERS = 5
_CACHE = {}


def _appended(arrays, rows):
    """``arrays`` with ``rows[leaf]`` appended to each ``"group.field"`` leaf."""
    out = dict(arrays)
    for key, new in rows.items():
        out[key] = np.concatenate([arrays[key], np.asarray(new, arrays[key].dtype)])
    return out


def _point_lights(arrays, positions, intensity):
    n = len(positions)
    return _appended(arrays, {"lights.position": positions,
                              "lights.direction": [(0.0, 0.0, 1.0)] * n,
                              "lights.color": [(1.0, 1.0, 1.0)] * n,
                              "lights.intensity": [intensity] * n, "lights.kind": [0] * n})


def _nine_lights(arrays):
    """Nine white point lights of intensity 15 at y = 8, x in {-3, 0, 3}
    (outer), z in {0, 3, 6} (inner)."""
    return _point_lights(arrays, [(x, 8.0, z) for x in (-3.0, 0.0, 3.0) for z in (0.0, 3.0, 6.0)],
                         15.0)


def _spheres(arrays, centers, radius=0.2, material=2):
    n = len(centers)
    return _appended(arrays, {"spheres.center": centers, "spheres.radius": [radius] * n,
                              "spheres.material": [material] * n})


def _sphere_grid(arrays):
    """100 Lambert spheres of radius 0.2 in reference's white material (id
    2) at x = -4.05 + 0.9 i, y = 0.5, z = 1.5 + 0.8 j."""
    return _spheres(arrays, [(-4.05 + 0.9 * i, 0.5, 1.5 + 0.8 * j)
                             for i in range(10) for j in range(10)])


def _base(name):
    if ("base", name) not in _CACHE:
        _CACHE[("base", name)] = convert.scene_to_arrays(scenes.get(name).build("cpu"))
    return _CACHE[("base", name)]


def _arrays(name):
    """The scene arrays of a fixture or a boundary case."""
    if name == "bunny_l12":
        return _nine_lights(_base("bunny"))
    if name == "reference_s106":
        return _sphere_grid(_base("reference"))
    if name == "bunny_l12_sun":  # and a directional light
        d = np.float32([0.3, -1.0, 0.2])
        return _appended(_arrays("bunny_l12"), {
            "lights.position": [(0.0, 0.0, 0.0)], "lights.direction": [d / np.linalg.norm(d)],
            "lights.color": [(1.0, 0.95, 0.9)], "lights.intensity": [2.5], "lights.kind": [1]})
    kind, n = name.rsplit("_", 1)  # "spheres_17", "lights_9": bunny plus n in all
    if kind == "spheres":
        return _spheres(_base("bunny"), [(-4.0 + 0.45 * i, 0.5, 1.0) for i in range(int(n))])
    more = int(n) - 3
    return _point_lights(_base("bunny"), [(-3.0 + 1.5 * (k % 5), 8.0, float(k // 5))
                                          for k in range(more)], 5.0)


def _scene(name):
    if ("scene", name) not in _CACHE:
        _CACHE[("scene", name)] = convert.scene_from_arrays(_arrays(name), "cpu")
    return _CACHE[("scene", name)]


def _jax_scene(arrays):
    """raytpu's Scene from a port scene's arrays, leaf for leaf."""
    return jtypes.Scene(**{g: getattr(jtypes, cls.__name__)(**{
        f.name: jnp.asarray(arrays[f"{g}.{f.name}"]) for f in dataclasses.fields(cls)})
        for g, cls in convert.GROUPS.items()})


def _jcfg():
    return jtypes.RenderConfig(width=W, height=H)


def _queries(name):
    """The port's rays and shadow queries of scene ``name`` at W x H: camera
    rays ``(ro (R,3), rd)``, K8's (plain) hit records, and every light's
    shadow query ``(p, dirs, mags)`` from them."""
    if ("queries", name) not in _CACHE:
        scene, cfg = _scene(name), RenderConfig(width=W, height=H)
        ro, rd = renderer.generate_rays(scene.camera, cfg)
        ro = ro.expand_as(rd).contiguous()
        rec = chunked.closest_hit_chunked(scene, ro, rd, cfg.ray_min)
        p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
        _CACHE[("queries", name)] = (ro, rd, rec, p, dirs, mags)
    return _CACHE[("queries", name)]


# -- raytpu's references, computed in worker processes -------------------------


def _compiled(fn, *args, fast=True):
    """``jax.jit(fn)(*args)``, compiled at optimisation level 0 when
    ``fast``."""
    options = FAST_COMPILE if fast else None
    return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)


def _raytpu_job(kind, arrays, ro, rd, p, dirs, mags):
    """One of raytpu's references for scene ``arrays``, its camera rays
    ``ro``, ``rd`` and the port's shadow queries ``p``, ``dirs``, ``mags``
    (numpy), by ``kind``:

      * "records": the closest hit of the rays (``closest_hit_pallas`` and the
        jnp ``closest_hit``), compiled at the default optimisation level,
        which contracts the sphere test's dot products into fused
        multiply-adds as the port does (at level 0, rays that graze the small
        spheres of reference_s106 move their t by up to 1.8e-5 relative, at
        the default level by 5.6e-6);
      * "shadows": ``any_hit_pallas`` on every light's shadow queries,
        flattened into one batch, and ``any_hit_lights_pallas`` on them;
      * "shade_rays": ``renderer.shade_rays`` with raytpu's kernels as its
        hooks (``pallas_kernel.shade_rays``), uint8;
      * "route", "jnp": the W x H image through raytpu's chunked route (K8
        then K10) and through its jnp renderer, uint8.
    """
    js, cfg, L = _jax_scene(arrays), _jcfg(), dirs.shape[0]
    if kind == "records":
        def run(js, ro, rd):
            return {f"{k}.{f}": getattr(r, f) for k, r in (
                ("pallas", pk.closest_hit_pallas(js, ro, rd, 1e-4)),
                ("jnp", jintersect.closest_hit(js, ro, rd, 1e-4)))
                for f in ("hit", "t", "point", "normal", "material")}

        out = _compiled(run, js, ro, rd, fast=False)
    elif kind == "shadows":
        def run(js, p, dirs, mags):
            return {"any_hit": pk.any_hit_pallas(js, jnp.tile(p, (L, 1)), dirs.reshape(-1, 3),
                                                 1e-4, mags.reshape(-1)),
                    "lights": pk.any_hit_lights_pallas(js, p, dirs, mags, 1e-4)}

        out = _compiled(run, js, p, dirs, mags)
    elif kind == "shade_rays":
        out = {kind: _compiled(lambda js, ro, rd: jmath3d.quantize_u8(jrenderer.shade_rays(
            js, ro, rd, cfg, closest_fn=pk.closest_hit_pallas, any_fn=pk.any_hit_pallas,
            any_multi_fn=pk.any_hit_lights_pallas)), js, ro, rd)}
    elif kind == "route":
        assert pk.route_kind(js, cfg) == "chunked"
        out = {kind: _compiled(lambda js: pk.render_image(js, cfg), js)}
    else:
        out = {kind: _compiled(lambda js: jrenderer.render_image(js, cfg), js)}
    return {k: np.asarray(v) for k, v in out.items()}


#: the references, the longest to compile first
JOBS = ("route", "shade_rays", "jnp", "shadows", "records")


@pytest.fixture(scope="module", autouse=True)
def _raytpu_jobs(request):
    """Submit every raytpu reference to worker processes as the module
    starts, unless only the card's test was selected; stop the workers when
    it ends."""
    mine = [i for i in request.session.items if i.module is request.module]
    if all(i.get_closest_marker("cuda") for i in mine):
        yield
        return
    ex = torch_jobs.pool(JOB_WORKERS)
    jobs = _CACHE["jobs"] = {}
    try:
        for kind in JOBS:
            for name in FIXTURES:
                ro, rd, _, p, dirs, mags = _queries(name)
                jobs[kind, name] = ex.submit(_raytpu_job, kind, _arrays(name), ro.numpy(),
                                             rd.numpy(), p.numpy(), dirs.numpy(), mags.numpy())
        yield
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _raytpu(kind, name):
    return _CACHE["jobs"][kind, name].result()


def _close(a, b, budget=0.01, mean_max=0.5):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    flipped = (d > 1).any(axis=-1).mean()
    assert flipped <= budget, f"{flipped:.4%} pixels differ by more than 1 (max {d.max()})"
    assert d.mean() <= mean_max, f"mean abs diff {d.mean():.4f}"


# -- the port against raytpu ---------------------------------------------------


@pytest.mark.parametrize("name,route", [
    ("bunny_l12", "chunked"), ("reference_s106", "chunked"),
    ("spheres_16", "mega2"), ("spheres_17", "chunked"),
    ("lights_8", "mega2"), ("lights_9", "chunked"),
    ("lights_24", "chunked"), ("lights_25", "chunked")])
def test_route_kind_matches_raytpu(name, route):
    """The router sends each fixture, and scenes on either side of the
    sphere and light caps, where raytpu's does."""
    arrays, cfg = _arrays(name), RenderConfig(width=W, height=H)
    assert cuda_kernel.route_kind(convert.scene_from_arrays(arrays, "cpu"), cfg) == route
    assert pk.route_kind(_jax_scene(arrays), _jcfg()) == route


@pytest.mark.parametrize("name", FIXTURES)
def test_k8_closest_mode_matches_raytpu(name):
    """K8's closest hit (plain) against raytpu's ``closest_hit_pallas``
    (interpret mode) and its jnp ``closest_hit``.  The point and normal are
    held to 1e-5 plus what the ray's t difference moves them by: |dt| along
    the ray for the point, |dt| / radius for a sphere's normal (a ray that
    grazes a sphere of radius 0.2 at t = 14.3 differs by 8e-5 in t, within
    the 1e-5 relative, and so by 1.9e-4 in the normal)."""
    scene = _scene(name)
    ro, rd, rec, *_ = _queries(name)
    _, idx, _, _ = chunked.scene_min_t(scene, ro, rd, 1e-4)
    S = scene.spheres.count
    is_sph = idx < S
    radius = torch.where(is_sph, scene.spheres.radius[torch.where(is_sph, idx, 0).long()]
                         if S else 1.0, float("inf")).numpy()
    ref = _raytpu("records", name)
    assert 0.2 < float(rec.hit.float().mean()) <= 1.0
    for side in ("pallas", "jnp"):
        hit = ref[f"{side}.hit"]
        np.testing.assert_array_equal(rec.hit.numpy(), hit)
        np.testing.assert_array_equal(rec.material.numpy(), ref[f"{side}.material"])
        np.testing.assert_allclose(rec.t.numpy()[hit], ref[f"{side}.t"][hit], rtol=1e-5, atol=0)
        dt = np.where(hit, np.abs(rec.t.numpy() - ref[f"{side}.t"]), 0.0)[:, None]
        for key, tol in (("point", 1e-5 + dt), ("normal", 1e-5 + dt / radius[:, None])):
            err = np.abs(getattr(rec, key).numpy() - ref[f"{side}.{key}"])
            assert (err <= tol).all(), f"{side} {key}: {int((err > tol).sum())} beyond, max {err.max()}"


@pytest.mark.parametrize("name", FIXTURES)
def test_k8_shadow_mode_matches_raytpu(name):
    """K8's shadow mode (plain) on every light's shadow queries against
    raytpu's ``any_hit_pallas`` on the same queries."""
    scene = _scene(name)
    _, _, _, p, dirs, mags = _queries(name)
    L = dirs.shape[0]
    got = chunked.any_hit_chunked(scene, p.repeat(L, 1), dirs.reshape(-1, 3), 1e-4,
                                  mags.reshape(-1))
    want = _raytpu("shadows", name)["any_hit"]
    assert 0.02 < want.mean() < 0.98
    assert (got.numpy() == want).mean() >= 0.999


@pytest.mark.parametrize("name", FIXTURES)
def test_k9_matches_raytpu(name):
    """K9 (plain) against raytpu's ``any_hit_lights_pallas`` on the same
    shadow queries, and against K8's shadow mode."""
    scene = _scene(name)
    _, _, _, p, dirs, mags = _queries(name)
    got = chunked.any_hit_lights_chunked(scene, p, dirs, mags, 1e-4).numpy()
    ref = _raytpu("shadows", name)
    assert got.shape == ref["lights"].shape == (scene.lights.count, W * H)
    assert (got == ref["lights"]).mean() >= 0.999
    L = dirs.shape[0]
    k8 = chunked.any_hit_chunked(scene, p.repeat(L, 1), dirs.reshape(-1, 3), 1e-4,
                                 mags.reshape(-1)).numpy()
    np.testing.assert_array_equal(got.reshape(-1), k8)


@pytest.mark.parametrize("name", FIXTURES)
def test_chunked_route_matches_raytpu(name):
    """``render_image`` through the chunked route (plain K8 then plain K10)
    against raytpu's chunked route in interpret mode and its jnp renderer;
    no kernel launches on the CPU."""
    scene, cfg = _scene(name), RenderConfig(width=W, height=H)
    before = (chunked.CHUNKED_MIN_T_LAUNCHES, chunked.CHUNKED_ANYHIT_LAUNCHES,
              chunked.CHUNKED_SHADE_LAUNCHES)
    img = cuda_kernel.render_image(scene, cfg).numpy()
    _close(img, _raytpu("route", name)["route"])
    _close(img, _raytpu("jnp", name)["jnp"])
    assert before == (chunked.CHUNKED_MIN_T_LAUNCHES, chunked.CHUNKED_ANYHIT_LAUNCHES,
                      chunked.CHUNKED_SHADE_LAUNCHES)


@pytest.mark.parametrize("name", FIXTURES)
def test_shade_rays_matches_raytpu(name):
    """``chunked.shade_rays`` (K8 and K9 through the renderer's hooks)
    against raytpu's ``shade_rays`` with its kernels as hooks, and against
    the chunked route."""
    scene, cfg = _scene(name), RenderConfig(width=W, height=H)
    ro, rd, *_ = _queries(name)
    got = math3d.quantize_u8(chunked.shade_rays(scene, ro, rd, cfg)).numpy().reshape(H, W, 3)
    _close(got, _raytpu("shade_rays", name)["shade_rays"].reshape(H, W, 3))
    _close(got, cuda_kernel.render_image(scene, cfg).numpy())


def test_k10_plain_matches_the_eager_shade_tail():
    """K10's plain version on K8's records against the eager shade tail
    (``renderer.shade_from_records``) on bunny_l12 in every lighting mode
    and without shadows, and with a directional light, within the
    megakernel budget (the two round Cook-Torrance's diffuse term in their
    own orders)."""
    from raytpu_torch.core.types import LightingMode

    cases = ([("bunny_l12", mode, True) for mode in LightingMode]
             + [("bunny_l12", LightingMode.COMBINED, False),
                ("bunny_l12_sun", LightingMode.COMBINED, True)])
    for name, mode, shadows in cases:
        scene = _scene(name)
        _, rd, rec, *_ = _queries(name)
        cfg = RenderConfig(width=W, height=H, lighting_mode=mode, shadows=shadows)
        got = chunked.shadow_shade_chunked(scene, rec, rd, cfg)
        want = renderer.shade_from_records(scene, rec, rd, cfg)
        _close(math3d.quantize_u8(got).numpy()[None], math3d.quantize_u8(want).numpy()[None])


def test_profile_stages_reports_raytpu_keys():
    """The per-stage profiler returns raytpu's report keys and stages, which
    raytpu's ``format_report`` reads as the port's does; eager and kernel
    prefixes (here the plain versions) on a small frame."""
    spec = scenes.get("reference")
    scene = _scene("reference_s106")
    cfg = RenderConfig(width=16, height=12)
    for kernels in (False, True):
        report = stage_profile.profile_stages(spec, scene, cfg, kernels=kernels, frames=2,
                                              repeats=1)
        assert {"frame_ms", "stages_ms", "cumulative_ms", "primary_rays_per_s",
                "stage_rays_per_s"} <= set(report)
        assert tuple(report["stages_ms"]) == tuple(report["cumulative_ms"]) == jstage_profile.STAGES
        assert set(report["stage_rays_per_s"]) == {"closest_hit", "shadow"}
        assert report["device"] == "cpu" and report["frame_ms"] > 0.0
        assert stage_profile.format_report(report) == jstage_profile.format_report(report)
    fns = stage_profile.prefix_fns(cfg, kernels=True)
    assert torch.equal(fns["shade"](scene), cuda_kernel.render_image_f32(scene, cfg).sum())


def test_25_lights_raise():
    """raytpu's chunked kernels take at most 24 lights; so do the port's: 25
    raise ValueError before any launch, 24 render."""
    l24, l25 = _scene("lights_24"), _scene("lights_25")
    cfg = RenderConfig(width=8, height=8)
    assert cuda_kernel.render_image(l24, cfg).shape == (8, 8, 3)
    with pytest.raises(ValueError, match="at most 24 lights"):
        cuda_kernel.render_image(l25, cfg)
    p, dirs, mags = torch.zeros((4, 3)), torch.ones((25, 4, 3)), torch.ones((25, 4))
    with pytest.raises(ValueError, match="at most 24 lights"):
        chunked.any_hit_lights_chunked(l25, p, dirs, mags, 1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """A wrapper takes its plain version only for CPU tensors: tensors on any
    other device than CUDA raise before a launch."""
    scene = _scene("reference_s106")
    blobs = [b.to("meta") for b in packed.soft_packs(scene)]
    ro, rd = torch.zeros((4, 3), device="meta"), torch.ones((4, 3), device="meta")
    wl = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    cnt = torch.ones((1,), dtype=torch.int32, device="meta")
    before = (chunked.CHUNKED_MIN_T_LAUNCHES, chunked.CHUNKED_ANYHIT_LAUNCHES,
              chunked.CHUNKED_SHADE_LAUNCHES)
    with pytest.raises(ValueError, match="K8 runs on CUDA"):
        chunked.chunked_min_t(ro, rd, None, *blobs, wl, cnt, 1e-4, False)
    boxes = accel.open_normal_boxes(-(-blobs[2].shape[0] // accel.GROUP), "meta")
    for b in (None, boxes, boxes[:, :accel.BOX_COLS]):  # no records, the normal ones, kappa's
        with pytest.raises(ValueError, match="K9 runs on CUDA"):
            chunked.any_hit_lights(ro, rd[None], torch.ones((1, 4), device="meta"), *blobs, b,
                                   wl[:, None], cnt[:, None], 1e-4)
    with pytest.raises(ValueError, match="hard shadows"):
        chunked.render_image_chunked_f32(scene, RenderConfig(width=8, height=8,
                                                             soft_shadows=True))
    assert before == (chunked.CHUNKED_MIN_T_LAUNCHES, chunked.CHUNKED_ANYHIT_LAUNCHES,
                      chunked.CHUNKED_SHADE_LAUNCHES)


@pytest.mark.cuda
def test_chunked_kernels_match_plain_versions_on_the_card():
    """K8 (both modes), K9 and K10 against their plain versions on a card,
    each launched once per call, K9 equal to its plain version on every
    (light, ray) pair, and K8, K9 and K10 equal bit for bit to themselves
    over records that pass every listed group (K8 and K9 also without
    records); run on
    a machine with a card with
    ``pytest -m cuda tests/test_torch_chunked.py -p no:xdist``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for name in (*FIXTURES, "bunny_l12_sun"):
        scene = convert.scene_from_arrays(_arrays(name), dev)
        for cfg in (RenderConfig(width=64, height=32), RenderConfig(width=50, height=37)):
            ro, rd = renderer.generate_rays(scene.camera, cfg)
            if cfg.width % 32 == 0 and cfg.height % 32 == 0:
                rd = packed.mega2_fold(rd, cfg.height, cfg.width)
            ro = ro.expand_as(rd).contiguous()
            blobs = packed.soft_packs(scene)
            counts = [chunked.CHUNKED_MIN_T_LAUNCHES, chunked.CHUNKED_ANYHIT_LAUNCHES,
                      chunked.CHUNKED_SHADE_LAUNCHES]
            t, idx, normal, mat = chunked.scene_min_t(scene, ro, rd, cfg.ray_min)
            tp, idxp, normalp, matp = plain.chunked_min_t_plain(ro, rd, None, *blobs, cfg.ray_min,
                                                                False)
            same = idx == idxp
            assert same.float().mean() >= 0.9999
            both = same & torch.isfinite(tp)
            assert ((t - tp).abs() <= 1e-6 * tp.abs())[both].all()
            assert torch.equal(mat[same], matp[same])
            rec = chunked.closest_hit_chunked(scene, ro, rd, cfg.ray_min)
            p, dirs, mags = (x.contiguous()
                             for x in renderer.shadow_query_inputs(scene, rec, cfg))
            L = dirs.shape[0]
            ts, *_ = chunked.scene_min_t(scene, p.repeat(L, 1), dirs.reshape(-1, 3), cfg.ray_min,
                                         mags.reshape(-1), shadow=True)
            tsp, *_ = plain.chunked_min_t_plain(p.repeat(L, 1), dirs.reshape(-1, 3),
                                                mags.reshape(-1), *blobs, cfg.ray_min, True)
            assert (torch.isfinite(ts) == torch.isfinite(tsp)).float().mean() >= 0.9999
            occ = chunked.any_hit_lights_chunked(scene, p, dirs, mags, cfg.ray_min)
            occp = packed.any_hit_lights_plain(p, dirs, mags, *blobs, cfg.ray_min)
            assert (occ == occp).float().mean() >= 0.999
            # K9 on the walk: every pair the plain version's, and its own
            # launches over every listed triangle (no records; open records)
            assert torch.equal(occ, occp)
            boxes, wl, cnt = chunked.shadow_inputs(scene, p, dirs, mags, cfg.ray_min)
            opened = accel.open_normal_boxes(-(-blobs[2].shape[0] // accel.GROUP), dev)
            for b in (None, opened):
                assert torch.equal(occ, chunked.any_hit_lights(p, dirs, mags, *blobs, b, wl, cnt,
                                                               cfg.ray_min))
            colors = chunked.shadow_shade_chunked(scene, rec, rd, cfg)
            colors_p = plain.shadow_shade_plain(
                rec.hit, rec.normal, rec.point, rec.material, rd, p, dirs, mags,
                plain.pack_lights(scene.lights), plain.material_table(scene.materials), *blobs,
                cfg)
            _close(math3d.quantize_u8(colors).cpu().numpy()[None],
                   math3d.quantize_u8(colors_p).cpu().numpy()[None])
            # the box tests drop no occluder: K10 over records that pass every
            # group of every listed chunk gives the same bits
            boxes, wl, cnt = chunked.shadow_inputs(scene, p, dirs, mags, cfg.ray_min)
            args = (rec.hit, rec.normal.contiguous(), rec.point.contiguous(), rec.material, rd, p,
                    dirs, mags, plain.pack_lights(scene.lights),
                    plain.material_table(scene.materials), *blobs)
            every = accel.open_normal_boxes(-(-blobs[2].shape[0] // accel.GROUP), dev)
            got = chunked.shadow_shade(*args, boxes, wl, cnt, cfg)
            assert torch.equal(got, colors)
            assert torch.equal(got, chunked.shadow_shade(*args, every, wl, cnt, cfg))
            torch.cuda.synchronize()
            assert [chunked.CHUNKED_MIN_T_LAUNCHES, chunked.CHUNKED_ANYHIT_LAUNCHES,
                    chunked.CHUNKED_SHADE_LAUNCHES] == [counts[0] + 3, counts[1] + 3,
                                                        counts[2] + 3]
            # K8's walks drop no winner and no first occluder: both modes
            # equal, bit for bit, its fold over every listed triangle
            # (without records) and its walk over records that pass every group
            records = chunked.frame_records(scene)
            bounds = None if records is None else records[:2]
            wl, cnt = packed.closest_worklists(scene, ro, rd, cfg.ray_min, group=chunked.CHUNK,
                                               group_bounds=bounds)
            ps, ds, ms = p.repeat(L, 1), dirs.reshape(-1, 3), mags.reshape(-1).contiguous()
            wl_s, cnt_s = packed.closest_worklists(scene, ps, ds, cfg.ray_min, ms,
                                                   group=chunked.CHUNK, group_bounds=bounds)
            for b in (None, every):
                got = chunked.chunked_min_t(ro, rd, None, *blobs, wl, cnt, cfg.ray_min, False, b)
                for a, c in zip(got, (t, idx, normal, mat)):
                    assert torch.equal(a.view(torch.int32), c.view(torch.int32))
                got_s = chunked.chunked_min_t(ps, ds, ms, *blobs, wl_s, cnt_s, cfg.ray_min, True,
                                              b)[0]
                assert torch.equal(got_s.view(torch.int32), ts.view(torch.int32))
