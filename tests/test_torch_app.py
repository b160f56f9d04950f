"""The port's app shell: its CLI (``raytpu_torch.app.cli``), the fly camera
(``core/camera.py``) and the viewer (``app/interactive.py``), held to
``tests/test_app.py``'s cases for raytpu's and against raytpu where both
compute the same thing.  Everything runs in this process on the CPU
(``--device cpu``), where the kernel route takes the kernels' plain versions.

Budgets, on uint8 images (pixels differing by more than one step):
  * golden budget (tests/test_golden.py): <= 0.2% of pixels, mean <= 0.1;
  * megakernel budget (tests/test_pallas.py): <= 1% of pixels, mean <= 0.5.
The fly camera's state is held to 1e-6 relative: both packages update it in
float64 from a float32 forward vector, whose sine and cosine XLA and numpy
may round differently in the last bit.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu.core import camera as jcamera
from raytpu.core import math3d as jmath3d
from raytpu.core import scenes as jscenes
from raytpu.core.types import Camera as JCamera
from raytpu.core.types import RenderConfig as JRenderConfig
from raytpu.render import renderer as jrenderer
from raytpu_torch.app import cli
from raytpu_torch.app.interactive import FramePipeline
from raytpu_torch.core import camera, convert, math3d, scenes
from raytpu_torch.core.types import Camera, RenderConfig
from raytpu_torch.render import cuda_kernel, renderer
from raytpu_torch.utils import image as image_io
from raytpu_torch.utils.profiling import FrameTimer

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "golden"


def _run(capsys, *args):
    rc = cli.main(["--device", "cpu", *args])
    return rc, capsys.readouterr().out


def _close(a, b, budget, mean_max):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    flipped = (d > 1).any(axis=-1).mean()
    assert flipped <= budget, f"{flipped:.4%} pixels differ by more than 1 (max {d.max()})"
    assert d.mean() <= mean_max, f"mean abs diff {d.mean():.4f}"


def test_cli_screenshot_and_benchmark(tmp_path, capsys):
    shot, bench_out = tmp_path / "shot.bmp", tmp_path / "benchmark.txt"
    rc, out = _run(capsys, "--scene", "w2", "--size", "64x48", "--benchmark", "2",
                   "--benchmark-out", str(bench_out), "--screenshot", str(shot))
    assert rc == 0
    img = image_io.read_bmp(str(shot))
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8 and img.any()
    lines = bench_out.read_text().splitlines()
    assert len(lines) == 4
    assert lines[0].startswith("FPS BENCHMARK of ")
    high, low, avg = (float(line.split(": ")[1]) for line in lines[1:])
    assert [line.split(": ")[0] for line in lines[1:]] == ["HIGH", "LOW", "AVERAGE"]
    assert low <= avg <= high
    assert "**BENCHMARK STARTED" in out and "**BENCHMARK FINISHED**" in out


def test_cli_bmp_screenshot(tmp_path, capsys):
    shot = tmp_path / "RayTracing_Buffer.bmp"
    assert _run(capsys, "--scene", "sphere", "--size", "32x24", "--screenshot", str(shot))[0] == 0
    data = shot.read_bytes()
    assert data[:2] == b"BM" and len(data) >= 32 * 24 * 3


@pytest.mark.parametrize("name", ["eager", "kernel"])
def test_cli_renderer_flag(tmp_path, capsys, name):
    shot = tmp_path / "s.png"
    rc, out = _run(capsys, "--scene", "sphere", "--size", "32x24", "--renderer", name,
                   "--screenshot", str(shot))
    assert rc == 0 and f"backend={name}" in out and shot.exists()


def test_cli_lighting_mode_and_shadow_flags(tmp_path, capsys):
    imgs = {}
    for name, flags in (("combined", []), ("observed_area", ["--mode", "observed_area"]),
                        ("no_shadows", ["--no-shadows"])):
        shot = tmp_path / f"{name}.bmp"
        assert _run(capsys, "--scene", "w2", "--size", "32x24", "--screenshot", str(shot),
                    *flags)[0] == 0
        imgs[name] = image_io.read_bmp(str(shot))
    assert (imgs["combined"] != imgs["observed_area"]).any()
    assert (imgs["combined"] != imgs["no_shadows"]).any()


def test_cli_soft_shadows_flag(tmp_path, capsys):
    imgs = {}
    for name, flags in (("hard", []), ("soft", ["--soft-shadows", "--soft-beta", "40"])):
        shot = tmp_path / f"{name}.bmp"
        assert _run(capsys, "--scene", "w2", "--size", "32x24", "--screenshot", str(shot),
                    *flags)[0] == 0
        imgs[name] = image_io.read_bmp(str(shot))
    assert (imgs["hard"] != imgs["soft"]).any()


@pytest.mark.parametrize("flags", [["--size", "banana"], ["--size", "0x0"], ["--ssaa", "0"],
                                   ["--frames-per-dispatch", "0"]])
def test_cli_invalid_flags(capsys, flags):
    assert _run(capsys, *flags)[0] == 2


def test_cli_stats_line(capsys):
    rc, out = _run(capsys, "--scene", "sphere", "--size", "32x24", "--frames", "2")
    assert rc == 0 and "primary_rays/s=" in out and "frames=2 " in out


@pytest.mark.parametrize("frames,dispatches", [(6, 2), (5, 2)])
def test_cli_frames_per_dispatch(tmp_path, capsys, frames, dispatches):
    """K frames a dispatch with one host read each; the tail dispatch renders
    only the frames still due, so exactly --frames frames are counted."""
    shot = tmp_path / "shot.png"
    rc, out = _run(capsys, "--scene", "w4_test", "--size", "32x24", "--frames", str(frames),
                   "--frames-per-dispatch", "3", "--screenshot", str(shot))
    assert rc == 0 and f"frames={frames} dispatches={dispatches} " in out
    assert image_io.read_png(str(shot)).shape == (24, 32, 3)


def test_cli_benchmark_counts_whole_dispatches(capsys):
    rc, out = _run(capsys, "--scene", "sphere", "--size", "16x12", "--benchmark", "1",
                   "--benchmark-out", os.devnull, "--frames-per-dispatch", "4")
    frames, dispatches = (int(out.split(f"{k}=")[1].split()[0]) for k in ("frames", "dispatches"))
    assert rc == 0 and frames == 4 * dispatches


def test_cli_kernel_route_ssaa_matches_committed_golden(tmp_path, capsys):
    """--ssaa 2 through the kernel route (K1's plain version here): one
    frame at t = 0 of the 640x480 supersampled grid, box filtered."""
    shot = tmp_path / "ssaa.png"
    rc, out = _run(capsys, "--scene", "reference", "--size", "320x240", "--ssaa", "2",
                   "--frames", "1", "--screenshot", str(shot))
    assert rc == 0 and "backend=kernel ssaa=2" in out
    _close(image_io.read_png(str(shot)),
           image_io.read_png(str(GOLDEN / "reference_ssaa2_320x240.png")), 0.002, 0.1)


def test_ssaa_render_fn_matches_raytpu_jnp_ssaa():
    """render_image_ssaa through the kernel route (bunny: K2's plain
    version) against raytpu's jnp SSAA, and on a ragged supersampled grid."""
    jscene = jscenes.get("bunny").build()
    scene = convert.scene_from_arrays(convert.scene_to_arrays(jscene), "cpu")
    want = np.asarray(jrenderer.render_image_ssaa(jscene, JRenderConfig(width=64, height=48), 2))
    got = renderer.render_image_ssaa(scene, RenderConfig(width=64, height=48), 2,
                                     render_fn=cuda_kernel.render_image_f32)
    _close(got.numpy(), want, 0.01, 0.5)
    ragged = renderer.render_image_ssaa(scene, RenderConfig(width=25, height=19), 2,
                                        render_fn=cuda_kernel.render_image_f32)
    eager = renderer.render_image_ssaa(scene, RenderConfig(width=25, height=19), 2)
    assert ragged.shape == (19, 25, 3)
    _close(ragged.numpy(), eager.numpy(), 0.01, 0.5)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        b = rng.random(8) < 0.4
        yield dict(forward=bool(b[0]), backward=bool(b[1]), right=bool(b[2]), left=bool(b[3]),
                   shift=bool(b[4]), lmb=bool(b[5]), rmb=bool(b[6]),
                   mouse_dx=float(rng.normal(0, 4)), mouse_dy=float(rng.normal(0, 4)))


def test_fly_camera_matches_raytpu():
    fly = camera.FlyCamera(origin=(0.0, 1.0, -5.0), fov_degrees=60.0)
    jfly = jcamera.FlyCamera(origin=(0.0, 1.0, -5.0), fov_degrees=60.0)
    for i, kw in enumerate(_inputs(50)):
        dt = 1 / 60 + 0.001 * (i % 7)
        fly = fly.update(camera.CameraInput(**kw), dt)
        jfly = jfly.update(jcamera.CameraInput(**kw), dt)
        np.testing.assert_allclose(fly.origin, jfly.origin, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose([fly.pitch, fly.yaw], [jfly.pitch, jfly.yaw], rtol=1e-6,
                                   atol=1e-9)
    assert fly.pitch != 0.0 and fly.yaw != 0.0
    cam, jcam = fly.camera("cpu"), jfly.camera()
    for name in ("origin", "forward", "fov_scale"):
        np.testing.assert_allclose(getattr(cam, name).numpy(), np.asarray(getattr(jcam, name)),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pitch,yaw", [(0.0, 0.0), (0.3, -1.2), (-1.1, 2.5)])
def test_orientation_and_rotations_match_raytpu(pitch, yaw):
    fwd = Camera.create(device="cpu").with_orientation(pitch, yaw).forward
    jfwd = JCamera.create().with_orientation(pitch, yaw).forward
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(math3d.mat_rotation(pitch, yaw, 0.7, device="cpu").numpy(),
                               np.asarray(jmath3d.mat_rotation(pitch, yaw, 0.7)), atol=1e-6)
    cam = Camera.create(device="cpu").with_fov(45.0)
    assert float(cam.fov_scale) == float(JCamera.create().with_fov(45.0).fov_scale)


def test_frame_pipeline_shows_each_frame_one_step_late():
    spec = scenes.get("w4_test")
    scene = spec.build("cpu")
    cfg = RenderConfig(width=24, height=16)
    fly = camera.FlyCamera(origin=tuple(scene.camera.origin.tolist()))
    seq = []
    for kw in _inputs(4, seed=1):
        fly = fly.update(camera.CameraInput(**kw), 1 / 30)
        seq.append(spec.animate(scene, math3d.scalar(len(seq) / 30, "cpu"))
                   .with_camera(fly.camera("cpu")))
    frames = [cuda_kernel.render_image(s, cfg).numpy() for s in seq]
    pipe = FramePipeline(cuda_kernel.render_image)
    shown = [pipe.step(s, cfg) for s in seq]
    for got, want in zip(shown, [frames[0]] + frames[:-1]):
        np.testing.assert_array_equal(got, want)
    sync = FramePipeline(cuda_kernel.render_image, sync=True)
    for s, want in zip(seq, frames):
        np.testing.assert_array_equal(sync.step(s, cfg), want)
    assert len({f.tobytes() for f in frames}) > 1


def test_frame_timer_window_and_upper_bound():
    timer = FrameTimer(fps_window=0.0, elapsed_upper_bound=1e-9)
    timer.tick()
    assert timer.fps_window_closed and timer.elapsed == 1e-9 and timer.dfps > 0


@pytest.mark.parametrize("sync", [False, True], ids=["double_buffered", "sync"])
def test_interactive_headless_smoke(monkeypatch, capsys, sync):
    pytest.importorskip("pygame")
    from raytpu_torch.app import interactive

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("SDL_AUDIODRIVER", "dummy")
    args = ["--device", "cpu", "--scene", "sphere", "--size", "32x24", "--max-frames", "2"]
    assert interactive.main(args + ["--sync"] * sync) == 0
    assert "raytpu_torch interactive: sphere 32x24" in capsys.readouterr().out
