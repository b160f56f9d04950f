"""The streamed whole-frame route of raytpu_torch (K11a and K11b, here their
plain versions) against raytpu's ``render_image_mega3_f32``, and the tile
ranges of K1, K2 and K11 that the px-sharded render runs.

On the CPU the K11 wrappers take their plain versions, which are K2's (the
kernels compute K2's function from K2's worklists, only the staging of the
triangles differs); the test marked ``cuda`` holds the kernels against the
plain versions and against K2 on a card.  raytpu's references run its
Pallas kernels in interpret mode, as its own tests do on the CPU
(tests/test_pallas.py:238-287), jitted and compiled at XLA's backend
optimisation level 0, in worker processes started as the module starts
(tests/torch_jobs.py: niced, one thread each).

Tolerances:
  * the route against raytpu's mega3 (its "fine" worklist mode, the one
    the default constants give optional): the uint8 images equal, and the
    float32 images within 1e-6 absolute, because raytpu's XLA shading and
    the port's torch shading round a few operations differently (at most
    4.2e-7 on values <= 1 at 48x24, no u8 step);
  * lighting modes and W1 against raytpu's jnp ``render_image``: the
    megakernel budget, <= 1% of pixels off by more than one u8 step, mean
    absolute difference <= 0.5 (tests/test_pallas.py:31);
  * tile ranges against the whole frame: equal, bit for bit.

raytpu's "coarse" and "coarse2" modes are forced as its own tests force
them (its module constants ``MEGA3_FINE_MAX_G`` = 8, then also
``MEGA3_WL_SMEM_ENTRIES`` = 1); each reference takes 100-140 s of one CPU
core to trace and compile, so that comparison is marked ``slow``.
"""

import jax
import numpy as np
import pytest
import torch
import torch_jobs

from raytpu.core import math3d as jmath3d
from raytpu.core import scenes as jscenes
from raytpu.core.types import LightingMode as JLightingMode
from raytpu.core.types import RenderConfig as JRenderConfig
from raytpu.render import pallas_kernel as pk
from raytpu.render import renderer as jrenderer
from raytpu_torch.core import math3d, scenes
from raytpu_torch.core.types import LightingMode, RenderConfig
from raytpu_torch.ops import accel
from raytpu_torch.parallel import sharding
from raytpu_torch.render import cuda_kernel, mega2, mega3, packed, plain

torch.set_num_threads(2)

FAST_COMPILE = {"xla_backend_optimization_level": 0}
JOB_WORKERS = 3
#: optional at 64x32 (two 32x32 tiles) and 48x24 (row-major tiles, ragged)
FINE_SIZES = ((64, 32), (48, 24))
MODES = (("no_shadows", 32, 24), ("observed_area", 32, 24))
_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        _CACHE[name] = scenes.get(name).build("cpu")
    return _CACHE[name]


def _cfg(kind):
    if kind == "no_shadows":
        return RenderConfig(width=32, height=24, shadows=False)
    return RenderConfig(width=32, height=24, lighting_mode=LightingMode.OBSERVED_AREA)


# -- raytpu's references, computed in worker processes -------------------------


def _raytpu_job(kind, w, h):
    """One of raytpu's references on its own scene:

      * "fine", "coarse", "coarse2": ``render_image_mega3_f32`` of optional
        at w x h, float32, in that worklist mode;
      * "no_shadows", "observed_area", "w1": the jnp ``render_image``, uint8.
    """
    if kind in ("coarse", "coarse2"):
        pk.MEGA3_FINE_MAX_G = 8
    if kind == "coarse2":
        pk.MEGA3_WL_SMEM_ENTRIES = 1
    if kind in ("fine", "coarse", "coarse2"):
        js, cfg = jscenes.get("optional").build(), JRenderConfig(width=w, height=h)
        fn = lambda s: pk.render_image_mega3_f32(s, cfg)  # noqa: E731
    else:
        js = jscenes.get("w1" if kind == "w1" else "optional").build()
        cfg = JRenderConfig(width=w, height=h, shadows=kind != "no_shadows",
                            lighting_mode=(JLightingMode.OBSERVED_AREA if kind == "observed_area"
                                           else JLightingMode.COMBINED))
        fn = lambda s: jrenderer.render_image(s, cfg)  # noqa: E731
    return np.asarray(jax.jit(fn).lower(js).compile(compiler_options=FAST_COMPILE)(js))


def _jobs():
    """The references of the tests that run by default, the longest first."""
    return ([("fine", w, h) for w, h in FINE_SIZES] + [(k, w, h) for k, w, h in MODES]
            + [("w1", 32, 24)])


@pytest.fixture(scope="module", autouse=True)
def _raytpu_jobs(request):
    """Submit raytpu's references to worker processes as the module starts
    (the port-only tests run first, meanwhile), unless none of its selected
    tests needs them; stop the workers when it ends."""
    mine = [i for i in request.session.items if i.module is request.module]
    if all(i.get_closest_marker("cuda") or i.get_closest_marker("slow") for i in mine):
        yield
        return
    ex = torch_jobs.pool(JOB_WORKERS)
    _CACHE["jobs"] = {job: ex.submit(_raytpu_job, *job) for job in _jobs()}
    try:
        yield
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _raytpu(*job):
    return _CACHE["jobs"][job].result()


def _close(a, b, budget=0.01, mean_max=0.5):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    flipped = (d > 1).any(axis=-1).mean()
    assert flipped <= budget, f"{flipped:.4%} pixels differ by more than 1 (max {d.max()})"
    assert d.mean() <= mean_max, f"mean abs diff {d.mean():.4f}"


def _matches_raytpu_mega3(img, ref):
    """The port's float32 image against raytpu's mega3: uint8 equal,
    float32 within 1e-6 (the module docstring says why)."""
    assert img.shape == ref.shape
    np.testing.assert_array_equal(math3d.quantize_u8(torch.from_numpy(img)).numpy(),
                                  np.asarray(jmath3d.quantize_u8(ref)))
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6)


# -- port only: tile ranges, packing, limits ------------------------------------


def _whole_and_ranges(fn, scene, w, h, split):
    """``fn``'s whole frame, and the frame from tiles [0, split) and [split,
    nt + 1) (one tile past the frame) concatenated, in row-major order."""
    cfg = RenderConfig(width=w, height=h)
    nt = mega2.num_tiles(cfg)
    whole = fn(scene, cfg)
    a, b = fn(scene, cfg, tile0=0, tiles=split), fn(scene, cfg, tile0=split, tiles=nt + 1 - split)
    assert a.shape == (split * 1024, 3) and b.shape == ((nt + 1 - split) * 1024, 3)
    flat = torch.cat([a, b])
    assert not flat[w * h:].any()  # rays past the frame are black
    flat = flat[:w * h]
    if fn is not cuda_kernel.render_image_mega_f32 and mega2.is_tiled(cfg):
        flat = packed.mega2_unfold_rows(flat, h, w)
    return whole, flat.reshape(h, w, 3)


@pytest.mark.parametrize("route,name", [
    ("K1", "reference"), ("K2", "bunny"), ("K11", "bunny"), ("K11", "w4_test")])
@pytest.mark.parametrize("size", [(64, 32), (50, 37)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_ranges_equal_the_whole_frame(route, name, size):
    """K1's, K2's and K11's tile ranges (plain), two ranges concatenated,
    equal the whole frame bit for bit, tiled and row-major, with the ragged
    last tile and a padded tile past the frame; w4_test's 38 triangles take
    the unculled worklists."""
    fn = {"K1": cuda_kernel.render_image_mega_f32, "K2": mega2.render_image_mega2_f32,
          "K11": mega3.render_image_mega3_f32}[route]
    whole, flat = _whole_and_ranges(fn, _scene(name), *size, split=1)
    assert torch.equal(flat, whole)


def test_groups_pad_with_degenerate_triangles():
    """bunny's 292 triangles are not a multiple of 8: the blob has 37
    groups, the last padded with all-zero triangles, which every camera ray
    misses; the image equals K2's, which never reads past the last
    triangle."""
    scene, cfg = _scene("bunny"), RenderConfig(width=48, height=24)
    buf, counts = plain.mega_pack(scene, cfg)
    blob = mega3.pack_groups(buf, counts)
    assert blob.shape == (37, 160) and blob.is_contiguous()
    tri = plain.mega_unpack(buf, counts)[3]
    assert torch.equal(blob.reshape(-1, 20)[:292], tri)
    pad = blob.reshape(-1, 20)[292:]
    assert pad.shape == (4, 20) and not pad.any()
    ro, rd = plain.camera_rays(plain.mega_unpack(buf, counts)[0], torch.arange(48),
                               torch.zeros(48, dtype=torch.long), 48, 24)
    t, _ = plain.closest_plain(torch.zeros((0, 11)), torch.zeros((0, 11)), pad, ro, rd, 1e-4)
    assert torch.isinf(t).all()
    assert torch.equal(mega3.render_image_mega3_f32(scene, cfg),
                       mega2.render_image_mega2_f32(scene, cfg))
    # no triangles at all: one all-zero group that no worklist lists
    w2 = _scene("w2")
    assert mega3.pack_groups(*plain.mega_pack(w2, cfg)).shape == (1, 160)
    assert torch.equal(mega3.render_image_mega3_f32(w2, cfg),
                       mega2.render_image_mega2_f32(w2, cfg))


def test_limits_raise_before_any_launch():
    """More than 1,048,576 triangles (raytpu's ceiling) or 32 lights, and
    soft shadows, raise before any launch; the wrappers refuse tensors that
    are neither on a card nor on the CPU; the sharded render reaches K11
    only by name."""
    cfg = RenderConfig(width=32, height=24)
    scene = _scene("bunny")
    buf, counts = plain.mega_pack(scene, cfg)
    blob = mega3.pack_groups(buf, counts)
    records = accel.normal_boxes(scene.triangles)[2]
    wl, cnt = mega2.primary_worklists(scene, cfg)
    before = (mega3.MEGA3_CLOSEST_LAUNCHES, mega3.MEGA3_SHADE_LAUNCHES)
    for bad in ((0, 5, mega3.MAX_TRIS + 1, 3), (0, 5, 292, mega3.MAX_LIGHTS + 1)):
        with pytest.raises(ValueError, match="mega3 takes"):
            mega3.mega3_closest(buf, bad, blob, records, wl, cnt, cfg)
    with pytest.raises(ValueError, match="hard shadows"):
        mega3.render_image_mega3_f32(scene, RenderConfig(width=32, height=24, soft_shadows=True))
    with pytest.raises(ValueError, match="CUDA"):
        mega3.mega3_closest(buf.to("meta"), counts, blob.to("meta"), records.to("meta"),
                            wl.to("meta"), cnt.to("meta"), cfg)
    assert (mega3.MEGA3_CLOSEST_LAUNCHES, mega3.MEGA3_SHADE_LAUNCHES) == before
    for name in ("reference", "bunny", "optional"):
        assert cuda_kernel.route_kind(_scene(name), cfg) != "mega3"
    assert sharding._fused_kind(scene, cfg) == "mega2"


# -- the route against raytpu --------------------------------------------------


@pytest.mark.parametrize("size", FINE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k11_route_matches_raytpu_mega3(size):
    """The K11 route (plain) on optional against raytpu's
    ``render_image_mega3_f32`` in interpret mode, on the tiled (64x32) and
    row-major (48x24) raygen; no kernel launches on the CPU."""
    w, h = size
    before = (mega3.MEGA3_CLOSEST_LAUNCHES, mega3.MEGA3_SHADE_LAUNCHES)
    img = mega3.render_image_mega3_f32(_scene("optional"), RenderConfig(width=w, height=h))
    assert (mega3.MEGA3_CLOSEST_LAUNCHES, mega3.MEGA3_SHADE_LAUNCHES) == before
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    _matches_raytpu_mega3(img.numpy(), _raytpu("fine", w, h))


@pytest.mark.slow
def test_k11_route_matches_raytpu_coarse_modes():
    """raytpu's coarse and coarse2 worklist modes (forced as
    tests/test_pallas.py forces them) give the image the port's single
    worklist form gives, on optional at 64x32.  Run by name: ``pytest -m
    slow tests/test_torch_mega3.py`` (about 150 s, two workers)."""
    img = mega3.render_image_mega3_f32(_scene("optional"), RenderConfig(width=64, height=32))
    with torch_jobs.pool(2) as ex:
        refs = {kind: ex.submit(_raytpu_job, kind, 64, 32) for kind in ("coarse", "coarse2")}
        for kind, ref in refs.items():
            _matches_raytpu_mega3(img.numpy(), ref.result())


@pytest.mark.parametrize("kind", [k for k, _, _ in MODES])
def test_k11_lighting_modes_match_raytpu_jnp(kind):
    """Without shadows (the shadow culls skipped: empty worklists) and in
    observed-area mode, the K11 route against raytpu's jnp renderer."""
    cfg = _cfg(kind)
    if kind == "no_shadows":
        wl, cnt = mega2.shadow_worklists(_scene("optional"), cfg,
                                         torch.zeros((mega2.num_tiles(cfg), 6)))
        assert wl.shape[-1] == 0 and not cnt.any()
    img = math3d.quantize_u8(mega3.render_image_mega3_f32(_scene("optional"), cfg)).numpy()
    _close(img, _raytpu(kind, 32, 24))


def test_k11_without_lights_is_black():
    """W1 (no lights, no triangles): a black frame, as raytpu's jnp
    renderer gives."""
    cfg = RenderConfig(width=32, height=24)
    img = math3d.quantize_u8(mega3.render_image_mega3_f32(_scene("w1"), cfg)).numpy()
    assert not img.any()
    np.testing.assert_array_equal(img, _raytpu("w1", 32, 24))


@pytest.mark.cuda
def test_k11_matches_plain_versions_and_k2_on_the_card():
    """K11a and K11b against their plain versions and against K2a and K2b on
    a card, on bunny and optional at 64x32 and 50x37 and a tile range;
    one launch of each a frame.  Run on a machine with a card with
    ``pytest -m cuda tests/test_torch_mega3.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for name in ("bunny", "optional"):
        scene = scenes.get(name).build(dev)
        for w, h in ((64, 32), (50, 37)):
            cfg = RenderConfig(width=w, height=h)
            buf, counts = plain.mega_pack(scene, cfg)
            blob = mega3.pack_groups(buf, counts)
            wl, cnt = mega2.primary_worklists(scene, cfg)
            records = accel.normal_boxes(scene.triangles)[2]
            before = (mega3.MEGA3_CLOSEST_LAUNCHES, mega3.MEGA3_SHADE_LAUNCHES)
            acc, bounds = mega3.mega3_closest(buf, counts, blob, records, wl, cnt, cfg)
            acc2, bounds2 = mega2.mega2_closest(buf, counts, records, wl, cnt, cfg)
            assert torch.equal(acc, acc2) and torch.equal(bounds, bounds2)
            acc_p, _ = mega2.mega2_closest_plain(buf, counts, cfg)
            assert (acc[0] == acc_p[0]).float().mean() >= 0.9999
            wl_s, cnt_s = mega2.shadow_worklists(scene, cfg, bounds)
            boxes = packed.shadow_records(records)
            img = mega3.mega3_shade(buf, counts, blob, boxes, wl_s, cnt_s, acc, cfg)
            assert (mega3.MEGA3_CLOSEST_LAUNCHES, mega3.MEGA3_SHADE_LAUNCHES) == (
                before[0] + 1, before[1] + 1)
            assert torch.equal(img, mega2.mega2_shade(buf, counts, records, wl_s, cnt_s, acc, cfg))
            ref = mega2.mega2_shade_plain(buf, counts, acc_p, cfg)
            _close(math3d.quantize_u8(img).cpu().numpy(), math3d.quantize_u8(ref).cpu().numpy())
            whole, flat = _whole_and_ranges(mega3.render_image_mega3_f32, scene, w, h, split=1)
            assert torch.equal(flat, whole)
