"""The port's sharding over ``torch.distributed`` against its own single-
process renders and against raytpu's sharded train step.

Two worker processes (``parallel.launch.spawn``, gloo on the CPU) run every
sharded case of the file in one launch, started as the module starts:
reference and bunny at 64x48 on a (px, prim) = (2, 1) mesh (the fused
whole-frame kernels, here their plain versions, each rank a tile range)
and on (1, 2) (the triangles split across the processes, the closest hits
merged by an all-gather), bunny with nine more lights on (1, 2) (each
shard's shadows through K9), bunny at 64x32 through the fused K11 tiles by
name, and one sharded SGD step on reference's materials at 32x24, px = 2.
Meanwhile two more processes run raytpu's ``make_sharded_train_step`` with
``optax.sgd`` on a 2-device slice of a virtual CPU mesh, as
tests/test_sharding.py does, and raytpu's jnp ``render_image`` of reference
and bunny at 64x48.

Tolerances: images bit for bit against the port's single-process renders
(tests/test_sharding.py:37-69), and within tests/test_torch_mega3.py's
budget against raytpu's images (the packages round the shading in
different op orders); the train
step as tests/test_torch_grad.py holds its SGD steps to raytpu's: the loss
within rtol 2e-2 and each parameter's change within rtol 2e-2, atol 3e-3
of its largest change (the two packages shade in different op orders, so
gradients differ in their last bits and near-ties of the soft path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_jobs

from raytpu.core import scenes as jscenes
from raytpu.core.types import RenderConfig as JRenderConfig
from raytpu.grad import diff_render as jdr
from raytpu.parallel.sharding import make_mesh as jmake_mesh
from raytpu.parallel.training import make_sharded_train_step as jmake_sharded_train_step
from raytpu.render import renderer as jrenderer
from raytpu_torch.app import cli
from raytpu_torch.core import convert, math3d, scenes
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.parallel import launch, make_mesh, sharding
from raytpu_torch.parallel.scaling import scaling_report
from raytpu_torch.render import cuda_kernel, mega3, renderer

torch.set_num_threads(2)

FAST_COMPILE = {"xla_backend_optimization_level": 0}
RENDER_CASES = [{"name": f"{scene}_{mesh}", "scene": scene, "size": [64, 48], "mesh": mesh}
                for scene in ("reference", "bunny") for mesh in ("px", "prim")]
#: nine white point lights (the chunked fixtures'): 12 lights in all, past
#: K4's 8, so every prim shard's shadows take K9
NINE_LIGHTS = [[x, 8.0, z] for x in (-3.0, 0.0, 3.0) for z in (0.0, 3.0, 6.0)]
CASES = RENDER_CASES + [
    {"name": "bunny_l12_prim", "scene": "bunny", "size": [64, 48], "mesh": "prim",
     "lights": NINE_LIGHTS},
    {"name": "bunny_mega3", "scene": "bunny", "size": [64, 32], "mesh": "px", "kind": "mega3"},
    {"name": "train", "scene": "reference", "size": [32, 24], "mesh": "px", "train": "material"},
]
_CACHE = {}


def _worker_init():
    jax.config.update("jax_num_cpu_devices", 2)


def _raytpu_sharded_step():
    """One step of raytpu's sharded train step on a (2, 1) mesh, reference's
    materials at 32x24 to a black target: the loss and each parameter's
    change."""
    js, cfg = jscenes.get("reference").build(), JRenderConfig(width=32, height=24)
    opt = optax.sgd(1e-2)
    params = jdr.material_params(js)
    step = jmake_sharded_train_step(cfg, opt, jdr.material_params, jdr.merge_material_params,
                                    jmake_mesh(px=2, prim=1, devices=jax.devices()[:2]))
    args = (params, opt.init(params), js, jnp.zeros((24, 32, 3), jnp.float32))
    new, _, loss = step.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return {"loss": float(loss),
            "deltas": {k: np.asarray(new[k]) - np.asarray(params[k]) for k in params}}


def _raytpu_image(name):
    """raytpu's jnp ``render_image`` of a registry scene at 64x48, uint8."""
    js, cfg = jscenes.get(name).build(), JRenderConfig(width=64, height=48)
    fn = jax.jit(lambda s: jrenderer.render_image(s, cfg))
    return np.asarray(fn.lower(js).compile(compiler_options=FAST_COMPILE)(js))


def _failed_launch(outdir):
    """The error of a launch whose one worker dies (an unknown scene)."""
    bad = [{"name": "bad", "scene": "no_such_scene", "size": [8, 8], "mesh": "px"}]
    try:
        launch.spawn(1, outdir, "cpu", bad, timeout=120.0)
    except RuntimeError as e:
        return e
    return None


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The two ranks' results and outputs, raytpu's sharded step and its
    images of reference and bunny, and the error of a launch whose worker
    dies (started alongside, so that its process start costs nothing)."""
    out = tmp_path_factory.mktemp("ranks")
    with torch_jobs.pool(2, _worker_init) as ex, torch_jobs.niced_threads(2) as th:
        ref = ex.submit(_raytpu_sharded_step)
        images = {name: ex.submit(_raytpu_image, name) for name in ("reference", "bunny")}
        failed = th.submit(_failed_launch, str(tmp_path_factory.mktemp("bad")))
        ranks = th.submit(launch.spawn, 2, str(out), "cpu", CASES, timeout=300.0)
        return {"results": ranks.result(), "dir": out, "raytpu_step": ref.result(),
                "raytpu_images": {k: v.result() for k, v in images.items()},
                "failed_launch": failed.result()}


def _scene(name):
    if name not in _CACHE:
        _CACHE[name] = scenes.get(name).build("cpu")
    return _CACHE[name]


def _images(launched, name):
    return [np.load(launched["dir"] / f"{name}_p{r}.npy") for r in range(2)]


def _close(a, b, budget=0.01, mean_max=0.5):
    """tests/test_torch_mega3.py's budget: <= 1% of pixels off by more than
    one u8 step, mean abs diff <= 0.5."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    flipped = (d > 1).any(axis=-1).mean()
    assert flipped <= budget, f"{flipped:.4%} pixels differ by more than 1 (max {d.max()})"
    assert d.mean() <= mean_max, f"mean abs diff {d.mean():.4f}"


@pytest.mark.parametrize("case", RENDER_CASES, ids=lambda c: c["name"])
def test_sharded_images_bit_identical(launched, case):
    """(2, 1) meshes render through the fused tile ranges and equal the
    single-process routed render (K1 for reference, K2 for bunny); (1, 2)
    meshes merge per-shard closest hits and equal the eager render; both
    ranks hold the same image, equal to this process's render."""
    cfg = RenderConfig(width=64, height=48)
    scene = _scene(case["scene"])
    for r in launched["results"]:
        res = r["cases"][case["name"]]
        assert res["mesh"] == ({"px": 2, "prim": 1} if case["mesh"] == "px"
                               else {"px": 1, "prim": 2})
        assert res["identical"], res
    a, b = _images(launched, case["name"])
    np.testing.assert_array_equal(a, b)
    ref = cuda_kernel.render_image(scene, cfg) if case["mesh"] == "px" else \
        renderer.render_image(scene, cfg)
    np.testing.assert_array_equal(a, ref.numpy())
    if case["mesh"] == "px":
        assert sharding._fused_kind(scene, cfg) == ("mega" if case["scene"] == "reference"
                                                    else "mega2")
    _close(a, launched["raytpu_images"][case["scene"]])


def test_prim_sharded_many_lights(launched):
    """bunny with 12 lights on (1, 2): each shard's shadows go through K9
    (K4 takes at most 8 lights) and OR over prim; both ranks' images equal
    the single-process eager render, which each rank rendered."""
    scene = convert.with_point_lights(_scene("bunny"), NINE_LIGHTS)
    assert scene.lights.count == 12 and not sharding._mega2_fits(scene)
    a, b = _images(launched, "bunny_l12_prim")
    np.testing.assert_array_equal(a, b)
    for r in launched["results"]:
        res = r["cases"]["bunny_l12_prim"]
        assert res["reference"] == "eager" and res["identical"], res


@pytest.mark.parametrize("lights", [0, 9, 22])
def test_sharded_shadow_hooks(monkeypatch, lights):
    """The sharded render's shadow hooks on one rank: K4 for every light
    within its limits (reference's 3 lights), K9 past them (12 lights), and
    K9's 24-light cap raises past it (25 lights), as raytpu's does; no
    light goes one at a time through the eager any-hit."""
    positions = [[-3.0 + 1.5 * (k % 5), 8.0, float(k // 5)] for k in range(lights)]
    scene = convert.with_point_lights(_scene("reference"), positions) if lights else \
        _scene("reference")
    calls = []
    for mod, name in ((sharding.packed, "any_hit_lights_mega2"),
                      (sharding.chunked, "any_hit_lights_chunked"),
                      (sharding.chunked, "any_hit_chunked"),
                      (sharding.intersect, "any_hit")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (calls.append(_n),
                                                                         _f(*a, **k))[1])
    cfg = RenderConfig(width=32, height=24)
    mesh = sharding.Mesh(1, 2)  # shard 0 of 2 without a group: its collectives are the identity
    if scene.lights.count > 24:
        with pytest.raises(ValueError, match="24 lights"):
            sharding.render_pixels_sharded(scene, cfg, mesh)
        assert calls == ["any_hit_lights_chunked"]  # K9's wrapper refused before a launch
        return
    img = sharding.render_pixels_sharded(scene, cfg, mesh)
    assert img.shape == (24, 32, 3) and torch.isfinite(img).all()
    assert calls == ["any_hit_lights_mega2" if scene.lights.count <= 8
                     else "any_hit_lights_chunked"]


def test_fused_px_mega3_bit_identical(launched):
    """bunny's px-fused render through K11's tile ranges, by name, equals
    the whole-frame ``render_image_mega3_f32`` (tests/test_sharding.py:53)."""
    ref = math3d.quantize_u8(mega3.render_image_mega3_f32(
        _scene("bunny"), RenderConfig(width=64, height=32))).numpy()
    for img in _images(launched, "bunny_mega3"):
        np.testing.assert_array_equal(img, ref)
    assert all(r["cases"]["bunny_mega3"]["identical"] for r in launched["results"])


def test_prim_sharding_pads_non_divisible_triangles(launched):
    """reference's 3 triangles do not split over 2 ranks: the shards are
    padded with degenerate triangles, which always miss, and the (1, 2)
    image is the single-process one."""
    tris = _scene("reference").triangles
    assert tris.count % 2 == 1
    padded = sharding._pad_triangles(tris, 2)
    assert padded.count == 4 and not padded.v0[3:].any() and not padded.normal[3:].any()
    assert all(r["cases"]["reference_prim"]["identical"] for r in launched["results"])


def test_sharded_sgd_step_matches_raytpu(launched):
    """One sharded SGD step (px = 2) equals the port's single-process step
    on both ranks and matches raytpu's sharded step with ``optax.sgd``
    within the tolerance the module docstring states."""
    ref = launched["raytpu_step"]
    deltas = [np.load(launched["dir"] / f"train_p{r}.npz") for r in range(2)]
    for r in launched["results"]:
        res = r["cases"]["train"]
        assert res["params_equal_on_ranks"] and res["mesh"] == {"px": 2, "prim": 1}
        np.testing.assert_allclose(res["loss_sharded"], res["loss_single"], rtol=1e-5)
        assert res["delta_diff_over_largest"] <= 1e-4
        np.testing.assert_allclose(res["loss_sharded"], ref["loss"], rtol=2e-2)
    for key, want in ref["deltas"].items():
        got = deltas[0][key]
        np.testing.assert_array_equal(got, deltas[1][key])
        assert np.isfinite(got).all() and np.abs(want).max() > 0
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=3e-3 * scale + 1e-8)


def test_single_process_mesh_and_cli_shard():
    """Without a process group the mesh is 1x1 and its collectives are the
    identity; the scaling harness runs on it; ``--shard 1x1`` renders on
    the CPU, and ``--shard 2x1`` without a group's address refuses; soft
    shadows over triangle shards refuse."""
    mesh = make_mesh()
    assert mesh.shape == {"px": 1, "prim": 1} and mesh.px_group is None
    with pytest.raises(ValueError):
        make_mesh(prim=2)
    cfg = RenderConfig(width=32, height=24)
    with pytest.raises(ValueError, match="soft"):  # a shard holds part of every transmittance
        sharding.render_pixels_sharded(_scene("bunny"), RenderConfig(32, 24, soft_shadows=True),
                                       sharding.Mesh(1, 2))
    np.testing.assert_array_equal(sharding.render_image_sharded(_scene("bunny"), cfg, mesh),
                                  cuda_kernel.render_image(_scene("bunny"), cfg))
    rows = scaling_report(size=(32, 24), frames=1, device="cpu")
    assert [r["devices"] for r in rows] == [1]
    assert rows[0]["primary_rays_per_s"] > 0 and rows[0]["efficiency"] == 1.0
    argv = ["--device", "cpu", "--scene", "reference", "--size", "32x24"]
    assert cli.main(argv + ["--shard", "1x1"]) == 0
    assert cli.main(argv + ["--shard", "2x1"]) == 2


def test_a_failed_worker_raises(launched):
    """A worker that dies stops the launch with its log's tail."""
    err = launched["failed_launch"]
    assert isinstance(err, RuntimeError) and "no_such_scene" in str(err), err
