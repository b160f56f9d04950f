"""The port's examples (examples/torch_*.py) end to end on the CPU, on
tests/test_examples.py's arguments and checks, and the inverse-rendering
set-up against raytpu's.

Tolerances: the first-step loss of the port's inverse-rendering set-up (the
same scene, perturbation and soft-shadow config) within 1e-5 relative of
raytpu's; the examples' own checks are tests/test_examples.py's (exit code
0, the strip written, the printed lines).  The three example runs start
together as the module starts, in niced subprocesses of one thread each
(tests/torch_jobs.py).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jobs

from raytpu.core import scenes as jscenes
from raytpu.core.types import RenderConfig as JRenderConfig
from raytpu.grad import diff_render as jdr

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))

import torch_inverse_rendering  # noqa: E402

from raytpu_torch.grad import diff_render as dr  # noqa: E402


def _start(script, *args):
    return torch_jobs.popen([sys.executable, str(REPO / "examples" / script), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)


def _finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Every example run of the module, started at once; waited for, and
    killed if still running, when the module ends."""
    tmp = tmp_path_factory.mktemp("examples")
    ckpt = tmp / "ckpts"
    resume = ["--size", "32x24", "--device", "cpu", "--out", str(tmp / "resume.png"),
              "--checkpoint-dir", str(ckpt), "--checkpoint-every", "5"]
    procs = {
        "inverse": _start("torch_inverse_rendering.py", "--steps", "30", "--size", "32x24",
                          "--device", "cpu", "--out", str(tmp / "inverse.png")),
        "geometry": _start("torch_geometry_fit.py", "--steps", "40", "--size", "32x24",
                           "--noise", "0.08", "--device", "cpu", "--out", str(tmp / "geometry.png")),
        "resume_first": _start("torch_inverse_rendering.py", "--steps", "10", *resume),
    }
    out = {"tmp": tmp, "ckpt": ckpt, "procs": procs, "resume": resume}
    try:
        yield out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


def test_inverse_rendering_first_loss_matches_raytpu():
    """First in the module: it runs while the examples do."""
    cfg, _, target, broken = torch_inverse_rendering.setup("32x24", "cpu")
    with torch.no_grad():
        loss = float(dr.image_loss(broken, target, cfg))

    jcfg = JRenderConfig(width=32, height=24, soft_shadows=True, soft_beta=60.0)
    truth = jscenes.get("w3_test").build()
    jtarget = jdr.render_soft(truth, jcfg)
    rng = np.random.default_rng(0)
    color = jnp.clip(truth.materials.color + jnp.asarray(
        rng.uniform(-0.5, 0.5, truth.materials.color.shape), jnp.float32), 0.05, 1.0)
    position = truth.lights.position + jnp.asarray(torch_inverse_rendering.LIGHT_OFFSETS,
                                                   jnp.float32)
    jbroken = dataclasses.replace(
        truth, materials=dataclasses.replace(truth.materials, color=color),
        lights=dataclasses.replace(truth.lights, position=position))
    np.testing.assert_array_equal(broken.materials.color.numpy(), np.asarray(color))
    np.testing.assert_array_equal(broken.lights.position.numpy(), np.asarray(position))
    want = float(jdr.image_loss(jbroken, jtarget, jcfg))
    assert loss > 0
    np.testing.assert_allclose(loss, want, rtol=1e-5)


def test_inverse_rendering_example(runs):
    rc, out, err = _finish(runs["procs"]["inverse"])
    assert rc == 0, err[-2000:]
    assert (runs["tmp"] / "inverse.png").exists()
    assert "final loss" in out


def test_geometry_fit_example(runs):
    rc, out, err = _finish(runs["procs"]["geometry"], timeout=600)
    assert rc == 0, (out[-1000:], err[-2000:])
    assert (runs["tmp"] / "geometry.png").exists()
    assert "vertex RMSE" in out


def test_inverse_rendering_checkpoint_resume(runs):
    rc, out, err = _finish(runs["procs"]["resume_first"])
    assert rc == 0, err[-2000:]
    assert (runs["ckpt"] / "step_10").exists()
    second = runs["procs"]["resume_second"] = _start("torch_inverse_rendering.py", "--steps", "15",
                                                     *runs["resume"])
    rc, out, err = _finish(second)
    assert rc == 0, err[-2000:]
    assert "resumed from checkpoint step 10" in out
    assert (runs["ckpt"] / "step_15").exists()
