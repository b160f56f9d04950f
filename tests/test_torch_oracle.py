"""raytpu_torch.oracle against raytpu.oracle, and the port's eager renderer
against the port's oracle.

Tolerances:
  * the two oracles: equal bit for bit (both are numpy float32 scalar code,
    statement for statement, on the same scene arrays);
  * eager render against the oracle: tests/test_render_vs_oracle.py's
    _compare budget, <= 1% of pixels off by more than one u8 step in some
    channel, mean absolute difference <= 0.5.

The scenes are built by the port and carried across to raytpu's dataclasses
(tests/test_torch_mesh.py's ``_jax_scene`` pattern), so both oracles read the
same arrays.  w1 (no lights: every pixel black), w2, w3_test and reference
run in all four lighting modes and with shadows off at 16x12; bunny (292
triangles, 6-7 s a shadowed 16x12 frame in either oracle on one CPU core)
in the combined mode with shadows only, raytpu's frame computed in a
spawned worker while the other cases run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jobs

from raytpu.core import types as jtypes
from raytpu.oracle import render_oracle as jax_oracle
from raytpu_torch.core import convert, scenes
from raytpu_torch.core.types import LightingMode, RenderConfig
from raytpu_torch.oracle import render_oracle
from raytpu_torch.render import renderer

torch.set_num_threads(2)

_SCENES = {}


def _port_scene(name):
    if name not in _SCENES:
        _SCENES[name] = scenes.get(name).build("cpu")
    return _SCENES[name]


def _jax_scene(scene):
    """raytpu's Scene holding the arrays of a port scene (or the arrays)."""
    arrays = scene if isinstance(scene, dict) else convert.scene_to_arrays(scene)
    groups = {g: getattr(jtypes, cls.__name__)(**{
        f.name: jnp.asarray(arrays[f"{g}.{f.name}"]) for f in dataclasses.fields(cls)})
        for g, cls in convert.GROUPS.items()}
    return jtypes.Scene(**groups)


def _jax_config(cfg):
    return jtypes.RenderConfig(width=cfg.width, height=cfg.height,
                               lighting_mode=jtypes.LightingMode(int(cfg.lighting_mode)),
                               shadows=cfg.shadows)


def _raytpu_oracle(arrays, cfg):
    """raytpu's oracle on the scene arrays, in a worker process."""
    return jax_oracle(_jax_scene(arrays), _jax_config(cfg))


#: the case whose raytpu frame a worker renders as the module starts
BUNNY = ("bunny", RenderConfig(width=16, height=12))
_JOBS = {}


@pytest.fixture(scope="module", autouse=True)
def _raytpu_bunny(request):
    """Start raytpu's bunny frame in one spawned worker, unless the bunny
    case was deselected; stop the worker when the module ends."""
    if not any("bunny" in i.name for i in request.session.items if i.module is request.module):
        yield
        return
    ex = torch_jobs.pool(1)
    try:
        _JOBS[BUNNY] = ex.submit(_raytpu_oracle, convert.scene_to_arrays(_port_scene("bunny")),
                                 BUNNY[1])
        yield
    finally:
        _JOBS.clear()
        ex.shutdown(wait=True, cancel_futures=True)


_SMALL = [RenderConfig(width=16, height=12, lighting_mode=m) for m in LightingMode]
_SMALL.append(RenderConfig(width=16, height=12, shadows=False))
CASES = [(n, c) for n in ("w1", "w2", "w3_test", "reference") for c in _SMALL]
CASES.append(BUNNY)


@pytest.mark.parametrize("name", ["w3_test", "reference"])
def test_eager_render_within_budget_of_oracle(name):
    cfg = RenderConfig(width=40, height=30)
    scene = _port_scene(name)
    golden = render_oracle(scene, cfg)
    fast = renderer.render_image(scene, cfg).numpy()
    assert fast.shape == golden.shape == (30, 40, 3)
    diff = np.abs(fast.astype(int) - golden.astype(int))
    assert (diff > 1).any(axis=-1).mean() <= 0.01
    assert diff.mean() <= 0.5


def test_oracle_reads_scenes_on_any_device_through_the_arrays():
    """The oracle takes any object with Scene's field names: a raytpu scene
    gives the same bytes as the port's."""
    scene = _port_scene("w3_test")
    cfg = RenderConfig(width=8, height=6)
    np.testing.assert_array_equal(render_oracle(_jax_scene(scene), cfg), render_oracle(scene, cfg))


@pytest.mark.parametrize("name,cfg", CASES,
                         ids=[f"{n}-{c.lighting_mode.name.lower()}-shadows{int(c.shadows)}"
                              for n, c in CASES])
def test_oracle_equals_raytpu_bit_for_bit(name, cfg):
    """Last in the module, bunny last of all: its raytpu frame comes from the
    worker started as the module began."""
    scene = _port_scene(name)
    got = render_oracle(scene, cfg)
    job = _JOBS.get((name, cfg))
    want = job.result() if job else jax_oracle(_jax_scene(scene), _jax_config(cfg))
    assert got.dtype == want.dtype == np.uint8 and got.shape == (cfg.height, cfg.width, 3)
    assert got.any() == (scene.lights.count > 0)
    np.testing.assert_array_equal(got, want)
