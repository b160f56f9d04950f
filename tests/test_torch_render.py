"""raytpu_torch.render against raytpu: the eager path and the megakernel's
plain version (what csrc/mega.cu computes, which the CPU takes in its place)
against raytpu's jnp renderer, the port's scalar oracle (equal to raytpu's
bit for bit, tests/test_torch_oracle.py) and the committed goldens.

Budgets, all counted on uint8 images, pixel by pixel, where a pixel differs
when some channel differs by more than one step:
  * megakernel budget (tests/test_pallas.py:_close): <= 1% of pixels, mean
    absolute difference <= 0.5;
  * oracle budget (tests/test_render_vs_oracle.py:_compare): the same;
  * golden budget (tests/test_golden.py:_check_golden): <= 0.2% of pixels,
    mean absolute difference <= 0.1.
None is exact: XLA fuses and contracts raytpu's arithmetic in its own way
and the port rounds as raytpu_torch/core/math3d.py says, so a closest-hit or
shadow decision on a near-tie can go the other way on a boundary pixel.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu.core import scenes as jscenes
from raytpu.core.types import LightingMode as JLightingMode
from raytpu.core.types import RenderConfig as JRenderConfig
from raytpu.core.types import SceneBuilder as JSceneBuilder
from raytpu_torch.app import cli
from raytpu_torch.core import convert, math3d, scenes
from raytpu_torch.core.types import LightingMode, RenderConfig
from raytpu_torch.oracle import render_oracle
from raytpu_torch.render import cuda_kernel, renderer
from raytpu_torch.utils import image as image_io

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "golden"

_JAX_SCENES = {}
_JAX_IMAGES = {}


def _directional_scene():
    b = JSceneBuilder()
    lam = b.add_lambert((0.8, 0.7, 0.6), 1.0)
    phong = b.add_lambert_phong((0.2, 0.3, 0.9), 0.7, 0.5, 30.0)
    floor = b.add_lambert((0.4, 0.45, 0.5), 1.0)
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), floor)
    b.add_sphere((-0.8, 0.0, 4.0), 1.0, lam)
    b.add_sphere((0.9, -0.3, 3.5), 0.7, phong)
    b.add_directional_light((0.3, -1.0, 0.2), 2.5, (1.0, 0.95, 0.9))
    b.add_point_light((0.0, 3.0, 1.0), 20.0, (0.6, 0.7, 1.0))
    b.set_camera((0.0, 0.5, -2.0), fov_degrees=50.0)
    return b.build()


def _jax_scene(name):
    if name not in _JAX_SCENES:
        _JAX_SCENES[name] = (_directional_scene() if name == "directional"
                             else jscenes.get(name).build())
    return _JAX_SCENES[name]


def _port_scene(name):
    """The raytpu scene, carried across, so both render the same data."""
    return convert.scene_from_arrays(convert.scene_to_arrays(_jax_scene(name)), "cpu")


def _jax_config(cfg):
    return JRenderConfig(width=cfg.width, height=cfg.height,
                         lighting_mode=JLightingMode(int(cfg.lighting_mode)), shadows=cfg.shadows)


def _oracle_image(name, cfg):
    """The port's scalar oracle render of the scene carried across from
    raytpu, computed once per module."""
    key = (name, cfg)
    if key not in _JAX_IMAGES:
        _JAX_IMAGES[key] = render_oracle(_port_scene(name), cfg)
    return _JAX_IMAGES[key]


def _close(a, b, budget, mean_max):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    flipped = (d > 1).any(axis=-1).mean()
    assert flipped <= budget, f"{flipped:.4%} pixels differ by more than 1 (max {d.max()})"
    assert d.mean() <= mean_max, f"mean abs diff {d.mean():.4f}"


def _port_images(scene, cfg):
    eager = renderer.render_image(scene, cfg).numpy()
    plain = math3d.quantize_u8(cuda_kernel.render_image_mega_f32_plain(scene, cfg)).numpy()
    return {"eager": eager, "mega plain": plain}


JNP_SIZES = [(32, 24), (50, 37)]


def _jnp_references():
    """raytpu's jnp render of the reference scene at both JNP_SIZES, from one
    compile: its render_image is generate_rays -> render_pixels_f32 ->
    quantize_u8, and render_pixels_f32 shades any flat batch of rays, so the
    two frames' rays go through it as one batch."""
    if "jnp" not in _JAX_IMAGES:
        import jax
        import jax.numpy as jnp

        from raytpu.core import math3d as jmath3d
        from raytpu.render import renderer as jrenderer

        cfgs = [_jax_config(RenderConfig(width=w, height=h)) for w, h in JNP_SIZES]

        @jax.jit
        def frames(scene):
            rays = [jrenderer.generate_rays(scene.camera, c) for c in cfgs]
            rd = jnp.concatenate([d for _, d in rays])
            return jmath3d.quantize_u8(jrenderer.render_pixels_f32(scene, rays[0][0], rd, cfgs[0]))

        flat = np.asarray(frames(_jax_scene("reference")))
        starts = np.cumsum([0] + [w * h for w, h in JNP_SIZES])
        _JAX_IMAGES["jnp"] = {(w, h): flat[s:s + w * h].reshape(h, w, 3)
                              for (w, h), s in zip(JNP_SIZES, starts)}
    return _JAX_IMAGES["jnp"]


@pytest.mark.parametrize("size", JNP_SIZES)
def test_port_matches_raytpu_jnp_render(size):
    """K1's own reference in tests/test_pallas.py: raytpu's jnp renderer;
    50x37 = 1850 rays leaves a ragged edge."""
    cfg = RenderConfig(width=size[0], height=size[1])
    ref = _jnp_references()[size]
    for name, img in _port_images(_port_scene("reference"), cfg).items():
        _close(img, ref, 0.01, 0.5)


ORACLE_CASES = [("reference", RenderConfig(width=32, height=24, lighting_mode=m)) for m in LightingMode]
ORACLE_CASES += [
    ("reference", RenderConfig(width=32, height=24, shadows=False)),
    ("w2", RenderConfig(width=32, height=24)),
    ("w3_test", RenderConfig(width=32, height=24)),
    ("directional", RenderConfig(width=32, height=24)),
]


@pytest.mark.parametrize("name,cfg", ORACLE_CASES,
                         ids=[f"{n}-{c.lighting_mode.name.lower()}-shadows{int(c.shadows)}"
                              for n, c in ORACLE_CASES])
def test_port_matches_oracle(name, cfg):
    ref = _oracle_image(name, cfg)
    assert ref.any()
    for img in _port_images(_port_scene(name), cfg).values():
        _close(img, ref, 0.01, 0.5)


#: registry scenes past K1's 72 primitives; tests/test_torch_bigmesh.py
#: holds their routes' plain versions against the eager path and raytpu
BIG_MESH_SCENES = {"bunny", "optional", "bunny50k", "bunny300k"}


def test_eager_and_plain_agree_on_every_scene():
    """The eager path and K1's plain version are two formulations of one
    render: the megakernel budget holds between them on every port scene
    that K1 serves.  The eager path in chunks of 100 rays renders the same
    image."""
    cfg = RenderConfig(width=24, height=18)
    for name in sorted(set(scenes.REGISTRY) - BIG_MESH_SCENES):
        scene = scenes.get(name).build("cpu")
        assert cuda_kernel.route_kind(scene, cfg) == "mega", name
        imgs = _port_images(scene, cfg)
        _close(imgs["eager"], imgs["mega plain"], 0.01, 0.5)
        chunked = renderer.render_image(scene, RenderConfig(width=24, height=18, ray_chunk=100))
        np.testing.assert_array_equal(chunked.numpy(), imgs["eager"])


# 64k-ray chunks: rays are independent, so the image is the same as in one
# chunk (test_eager_and_plain_agree_on_every_scene checks that), and the
# chunk's temporaries stay in the CPU's cache, which makes the test faster
GOLDEN_CHUNK = 1 << 16


@pytest.mark.parametrize("golden,t", [("reference_640x480.png", 0.0),
                                      ("reference_t1.25_640x480.png", 1.25)])
def test_eager_path_matches_committed_golden(golden, t):
    spec = scenes.get("reference")
    img = renderer.render_image(spec.animate(spec.build("cpu"), t),
                                RenderConfig(width=640, height=480, ray_chunk=GOLDEN_CHUNK))
    _close(img.numpy(), image_io.read_png(str(GOLDEN / golden)), 0.002, 0.1)


def test_eager_ssaa_matches_committed_golden():
    img = renderer.render_image_ssaa(scenes.get("reference").build("cpu"),
                                     RenderConfig(width=320, height=240, ray_chunk=GOLDEN_CHUNK),
                                     samples=2)
    _close(img.numpy(), image_io.read_png(str(GOLDEN / "reference_ssaa2_320x240.png")), 0.002, 0.1)


def test_png_reader_matches_pil_and_undoes_every_filter(tmp_path):
    from PIL import Image

    name = GOLDEN / "reference_ssaa2_320x240.png"
    np.testing.assert_array_equal(image_io.read_png(str(name)), np.asarray(Image.open(name)))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (10, 7, 3), dtype=np.uint8)
    # PIL picks its filters per row; a smooth image makes it use all five
    grad = np.clip(np.add.outer(np.arange(40), np.arange(30))[..., None] * [3, 5, 7], 0, 255)
    for arr in (img, grad.astype(np.uint8)):
        path = tmp_path / "pil.png"
        Image.fromarray(arr).save(path, optimize=False)
        np.testing.assert_array_equal(image_io.read_png(str(path)), arr)
        for ext in ("png", "bmp"):
            mine = tmp_path / f"mine.{ext}"
            image_io.write_image(str(mine), arr)
            np.testing.assert_array_equal(np.asarray(Image.open(mine).convert("RGB")), arr)
            back = image_io.read_png(str(mine)) if ext == "png" else image_io.read_bmp(str(mine))
            np.testing.assert_array_equal(back, arr)


def test_png_reader_undoes_each_filter_type(tmp_path):
    """Rows written with filters 0-4 by hand decode to the original image."""
    import struct
    import zlib

    rng = np.random.default_rng(1)
    h, w = 5, 6
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    x = img.astype(np.int32)
    rows = []
    for y in range(h):
        ftype = y % 5
        a = np.zeros_like(x[y])
        a[1:] = x[y, :-1]
        b = x[y - 1] if y else np.zeros_like(x[y])
        c = np.zeros_like(x[y])
        if y:
            c[1:] = x[y - 1, :-1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [np.zeros_like(a), a, b, (a + b) // 2, paeth][ftype]
        rows.append(bytes([ftype]) + ((x[y] - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    path = tmp_path / "filters.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(image_io.read_png(str(path)), img)


def test_cli_renders_on_the_cpu_when_asked(tmp_path):
    shot = tmp_path / "shot.bmp"
    assert cli.main(["--device", "cpu", "--scene", "reference", "--size", "32x24", "--frames", "2",
                     "--mode", "brdf", "--no-shadows", "--screenshot", str(shot)]) == 0
    assert image_io.read_bmp(str(shot)).shape == (24, 32, 3)
    assert cli.main(["--device", "cpu", "--size", "32x"]) != 0


def test_benchmark_report_has_the_reference_format(tmp_path):
    from raytpu_torch.utils.profiling import Benchmark

    bench = Benchmark(num_samples=2)
    bench.start()
    assert not bench.record(30.0) and bench.record(40.0)
    bench.write(str(tmp_path / "benchmark.txt"))
    assert (tmp_path / "benchmark.txt").read_text().splitlines() == [
        "FPS BENCHMARK of 2 frames", "HIGH: 40.0", "LOW: 30.0", "AVERAGE: 35.0"]


def test_no_fallback_to_the_cpu():
    """Without a card the CLI refuses to run unless asked for the CPU, a scene
    built for the default device does not quietly land on the CPU, and the
    megakernel wrapper takes its plain version only for a CPU scene."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    assert cli.main(["--scene", "reference", "--size", "32x24"]) != 0
    with pytest.raises((RuntimeError, AssertionError)):
        scenes.get("reference").build()
    cfg = RenderConfig(width=32, height=24)
    with pytest.raises(ValueError, match="cuda"):
        cuda_kernel.render_image_f32(scenes.get("reference").build("cpu").to("meta"), cfg)
    scene = scenes.get("reference").build("cpu")
    buf, counts = cuda_kernel.mega_pack(scene, cfg)
    out = torch.empty((24, 32, 3))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernel.launch_mega(buf, counts, cfg, out)
    assert cuda_kernel.MEGA_LAUNCHES == 0


def test_chunked_route_renders():
    """Every route renders: soft shadows through the eager path, and a scene
    past the megakernel's 72 primitives and mega2's 16 spheres through the
    chunked route (K8 and K10, here their plain versions), within the
    megakernel budget of the eager path."""
    scene = scenes.get("reference").build("cpu")
    assert cuda_kernel.route_kind(scene, RenderConfig()) == "mega"
    soft = RenderConfig(width=8, height=6, soft_shadows=True)
    assert cuda_kernel.route_kind(scene, soft) == "jnp"  # soft shadows: the eager path
    assert torch.equal(cuda_kernel.render_image_f32(scene, soft),
                       renderer.render_image_f32(scene, soft))
    arrays = convert.scene_to_arrays(scene)
    n = 80  # past the megakernel's 72 primitives, past mega2's 16 spheres
    arrays["spheres.center"] = np.zeros((n, 3), np.float32) + [0.0, 1.0, 4.0]
    arrays["spheres.radius"] = np.full((n,), 0.5, np.float32)
    arrays["spheres.material"] = np.zeros((n,), np.int32)
    big = convert.scene_from_arrays(arrays, "cpu")
    assert cuda_kernel.route_kind(big, RenderConfig()) == "chunked"
    cfg = RenderConfig(width=8, height=6)
    _close(cuda_kernel.render_image(big, cfg).numpy(), renderer.render_image(big, cfg).numpy(),
           0.01, 0.5)


@pytest.mark.parametrize("w,h,tile0,tiles", [(640, 480, 0, None), (64, 32, 0, None),
                                              (50, 37, 0, None), (640, 480, 5, 296),
                                              (50, 37, 1, 2), (64, 32, 0, 2)])
def test_megakernel_writes_every_pixel_once(w, h, tile0, tiles):
    """The twin of K1's thread-to-ray map (``cuda_kernel.mega_rays``): every
    output row is written by one thread, and each pixel of the frame, or
    of the tile range's rays, is rendered once at its row-major row (32x32
    pixel tiles with 8x4 pixel warps for a whole frame of multiples of 32,
    row-major rays otherwise, padded rays past the frame black)."""
    n_out = w * h if tiles is None else tiles * 1024
    row, px, py, valid = cuda_kernel.mega_rays(w, h, tile0, n_out)
    assert torch.equal(torch.sort(row).values, torch.arange(n_out))
    assert ((px >= 0) & (px < w) & (py >= 0) & (py < h)).all()
    rid = py * w + px
    if tiles is None:
        assert valid.all() and torch.equal(rid, row)
        if w % 32 == 0 and h % 32 == 0:  # a warp's 32 lanes: an 8x4 pixel block
            blocks = torch.stack([px, py], 1).reshape(-1, 32, 2)
            span = blocks.amax(1) - blocks.amin(1)
            assert (span == torch.tensor([7, 3])).all()
    else:
        want = tile0 * 1024 + row
        assert torch.equal(valid, want < w * h)
        assert torch.equal(rid[valid], want[valid])


@pytest.mark.cuda
def test_megakernel_matches_plain_version_on_the_card():
    """K1 on the card against its plain version (megakernel budget), on the
    whole frame, a ragged frame and a tile range with a padded tile, and
    the whole frame equal bit for bit to its tile ranges; run on a machine
    with a card with ``pytest -m cuda tests/test_torch_render.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    spec = scenes.get("reference")
    scene = spec.animate(spec.build("cuda"), 1.25)
    for cfg in (RenderConfig(width=640, height=480), RenderConfig(width=50, height=37)):
        before = cuda_kernel.MEGA_LAUNCHES
        a = cuda_kernel.render_image(scene, cfg)
        assert cuda_kernel.MEGA_LAUNCHES == before + 1
        b = math3d.quantize_u8(cuda_kernel.render_image_mega_f32_plain(scene, cfg))
        _close(a.cpu().numpy(), b.cpu().numpy(), 0.01, 0.5)
        nt = -(-(cfg.width * cfg.height) // 1024)
        whole = cuda_kernel.render_image_mega_f32(scene, cfg)
        ranges = [cuda_kernel.render_image_mega_f32(scene, cfg, tile0=t0, tiles=k)
                  for t0, k in ((0, 1), (1, nt))]  # the second ends past the frame
        flat = torch.cat(ranges)
        assert torch.equal(flat[:cfg.width * cfg.height].reshape(whole.shape), whole)
        assert not flat[cfg.width * cfg.height:].any()
        got = math3d.quantize_u8(ranges[1])
        want = math3d.quantize_u8(cuda_kernel.render_image_mega_f32_plain(scene, cfg, 1, nt))
        _close(got.cpu().numpy(), want.cpu().numpy(), 0.01, 0.5)
