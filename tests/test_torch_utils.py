"""raytpu_torch.utils (checkpoint, debug, profiling.trace) and the math3d
and BRDF functions against raytpu's.

Tolerances:
  * checkpoints: every tensor restored bit for bit; a resumed SGD run equals
    the uninterrupted one bit for bit;
  * the port's two SGD steps against raytpu's two ``optax.sgd`` steps on the
    same scene: tests/test_torch_grad.py's, losses rtol 2e-2, parameter
    updates rtol 2e-2 and atol 3e-3 of their largest;
  * ``validate_scene``: the same list of problems as raytpu's;
  * math3d and the BRDF terms: rtol 1e-6 (atol 1e-6 where a value is near 0)
    on tests/test_math3d.py's and tests/test_shading.py's cases and seeded
    inputs; ggx_distribution and cook_torrance on the seeded inputs rtol 1e-5
    (ggx's denominator cancels, see the test).

raytpu's ``validate_scene`` compiles its checks anew for each leaf shape
(~13 s over the twelve registry scenes), so a spawned worker runs it while
the other tests do.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_jobs

from raytpu.core import math3d as jmath3d
from raytpu.core import types as jtypes
from raytpu.grad import diff_render as jdr
from raytpu.ops import shading as jshading
from raytpu.utils import debug as jdebug
from raytpu_torch.core import convert, math3d, scenes
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.grad import diff_render as dr
from raytpu_torch.ops import shading
from raytpu_torch.utils import checkpoint, debug, profiling

torch.set_num_threads(2)


def _jax_scene(scene):
    """raytpu's Scene holding the arrays of a port scene (or the arrays)."""
    arrays = scene if isinstance(scene, dict) else convert.scene_to_arrays(scene)
    groups = {g: getattr(jtypes, cls.__name__)(**{
        f.name: jnp.asarray(arrays[f"{g}.{f.name}"]) for f in dataclasses.fields(cls)})
        for g, cls in convert.GROUPS.items()}
    return jtypes.Scene(**groups)


def _raytpu_validate_registry():
    """raytpu's ``validate_scene`` of every registry scene, built by the
    port, in a worker process: {name: problems}."""
    return {name: jdebug.validate_scene(_jax_scene(scenes.get(name).build("cpu")))
            for name in scenes.REGISTRY}


_JOBS = {}


@pytest.fixture(scope="module", autouse=True)
def _raytpu_jobs(request):
    """Start raytpu's registry audit in one spawned worker as the module
    starts, unless its test was deselected; stop the worker when it ends."""
    if not any("registry" in i.name for i in request.session.items if i.module is request.module):
        yield
        return
    ex = torch_jobs.pool(1)
    try:
        _JOBS["registry"] = ex.submit(_raytpu_validate_registry)
        yield
    finally:
        _JOBS.clear()
        ex.shutdown(wait=True, cancel_futures=True)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    else:
        assert a == b


# -- checkpoint (tests/test_checkpoint.py's cases) ------------------------------


@pytest.fixture(scope="module")
def adam_bundle():
    """(params, Adam state, step) after one real Adam step on w3_test."""
    scene = scenes.get("w3_test").build("cpu")
    params = dr.trainable(dr.material_params(scene))
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    sum(v.sum() for v in params.values()).backward()
    opt.step()
    return {"params": {k: v.detach() for k, v in params.items()}, "opt_state": opt.state_dict(),
            "step": 7}


def test_save_restore_roundtrip(tmp_path, adam_bundle):
    path = tmp_path / "ckpt"
    checkpoint.save(str(path), adam_bundle)
    restored = checkpoint.restore(str(path), like=adam_bundle)
    _equal_trees(restored, adam_bundle)
    assert restored["step"] == 7
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt"]  # no temporary left behind


def test_restore_without_like(tmp_path, adam_bundle):
    path = tmp_path / "ckpt2"
    checkpoint.save(str(path), {"params": adam_bundle["params"]})
    restored = checkpoint.restore(str(path))
    assert restored["params"]["color"].device.type == "cpu"
    assert torch.equal(restored["params"]["color"], adam_bundle["params"]["color"])


def test_restore_checks_like(tmp_path, adam_bundle):
    path = tmp_path / "ckpt4"
    checkpoint.save(str(path), adam_bundle)
    wrong_shape = dict(adam_bundle, params={"color": torch.zeros(2, 3),
                                            "params": adam_bundle["params"]["params"]})
    with pytest.raises(ValueError, match="color"):
        checkpoint.restore(str(path), like=wrong_shape)
    with pytest.raises(ValueError, match="keys"):
        checkpoint.restore(str(path), like={"params": adam_bundle["params"]})
    wrong_dtype = dict(adam_bundle, params={k: v.double() for k, v in adam_bundle["params"].items()})
    with pytest.raises(ValueError):
        checkpoint.restore(str(path), like=wrong_dtype)


def test_save_overwrites(tmp_path):
    path = tmp_path / "ckpt3"
    checkpoint.save(str(path), {"step": 1})
    checkpoint.save(str(path), {"step": 2})
    assert checkpoint.restore(str(path))["step"] == 2
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt3"]


def test_manager_keep_policy_and_resume(tmp_path, adam_bundle):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run"), keep=2)
    for step in (1, 5, 9):
        mgr.save_step(step, dict(adam_bundle, step=step))
    kept = sorted(d.name for d in (tmp_path / "run").iterdir() if d.name.startswith("step_"))
    assert kept == ["step_5", "step_9"]
    step, restored = mgr.restore_latest(like=adam_bundle)
    assert step == 9 and restored["step"] == 9
    _equal_trees(restored["params"], adam_bundle["params"])


def test_manager_empty_root(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore_latest() == (None, None)
    assert checkpoint.latest_step(str(tmp_path / "nonexistent")) is None


def test_resume_continues_training(tmp_path):
    """Two SGD steps, interrupted and resumed through a checkpoint, equal two
    uninterrupted steps bit for bit, and raytpu's two ``optax.sgd`` steps
    (tests/test_checkpoint.py's set-up) within the gradient tolerance."""
    cfg = RenderConfig(width=16, height=12, soft_shadows=True)
    scene = scenes.get("sphere").build("cpu")
    target = torch.zeros((12, 16, 3))

    def fresh():
        params = dr.trainable(dr.material_params(scene))
        opt = torch.optim.SGD(params.values(), lr=1e-2)
        return params, opt, dr.make_train_step(cfg, opt, dr.merge_material_params)

    p_ref, _, step_ref = fresh()
    losses = [float(step_ref(p_ref, scene, target)) for _ in range(2)]

    p1, opt1, step1 = fresh()
    step1(p1, scene, target)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "resume"))
    mgr.save_step(1, {"params": {k: v.detach() for k, v in p1.items()},
                      "opt_state": opt1.state_dict()})
    p2, opt2, step2 = fresh()
    _, state = mgr.restore_latest(like={"params": p2, "opt_state": opt2.state_dict()})
    with torch.no_grad():
        for k, v in p2.items():
            v.copy_(state["params"][k])
    opt2.load_state_dict(state["opt_state"])
    loss2 = float(step2(p2, scene, target))
    assert loss2 == losses[1]
    for k in p_ref:
        assert torch.equal(p2[k], p_ref[k]), k

    js = _jax_scene(scene)
    opt = optax.sgd(1e-2)
    jstep = jdr.make_train_step(jtypes.RenderConfig(width=16, height=12, soft_shadows=True), opt,
                                jdr.material_params, jdr.merge_material_params)
    jp = jdr.material_params(js)
    js_state = opt.init(jp)
    jlosses = []
    for _ in range(2):
        jp, js_state, jloss = jstep(jp, js_state, js, jnp.zeros((12, 16, 3), jnp.float32))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    p0 = dr.material_params(scene)
    for k in p_ref:
        got = (p_ref[k] - p0[k]).detach().numpy()
        want = np.asarray(jp[k]) - p0[k].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=3e-3 * np.abs(want).max() + 1e-8)


# -- debug -----------------------------------------------------------------------




def test_validate_scene_matches_raytpu_on_faults():
    s = scenes.get("w3_test").build("cpu")
    center = s.spheres.center.clone()
    center[0, 1] = float("nan")
    bad = dataclasses.replace(s, spheres=dataclasses.replace(
        s.spheres, center=center, material=torch.full_like(s.spheres.material, 99)))
    got = debug.validate_scene(bad)
    assert got == jdebug.validate_scene(_jax_scene(bad))
    assert got == ["non-finite: .spheres.center", "spheres: material index out of range [0, 4)"]
    b = scenes.get("bunny").build("cpu")
    tris = dataclasses.replace(b.triangles, normal=b.triangles.normal * 2.0)
    skew = dataclasses.replace(b, triangles=tris)
    assert debug.validate_scene(skew) == jdebug.validate_scene(_jax_scene(skew))
    assert debug.validate_scene(skew) == ["triangles: non-unit face normals"]


def test_assert_finite_tree_names_the_path():
    s = scenes.get("w3_test").build("cpu")
    debug.assert_finite_tree(s, "scene")
    debug.assert_finite_tree({"a": [torch.ones(2), 3]}, "state")
    center = s.spheres.center.clone()
    center[1, 2] = float("inf")
    bad = dataclasses.replace(s, spheres=dataclasses.replace(s.spheres, center=center))
    with pytest.raises(FloatingPointError, match=r"non-finite values in scene\.spheres\.center$") as e:
        debug.assert_finite_tree(bad, "scene")
    with pytest.raises(FloatingPointError) as je:
        jdebug.assert_finite_tree(_jax_scene(bad), "scene")
    assert str(e.value) == str(je.value)
    with pytest.raises(FloatingPointError, match=r"state\['p'\]\[1\]"):
        debug.assert_finite_tree({"p": [torch.ones(1), torch.tensor([float("nan")])]}, "state")


def test_nan_check_raises_in_forward_and_backward():
    with debug.nan_check():
        torch.sqrt(torch.tensor([4.0])) + 1.0  # finite: nothing raised
    with pytest.raises(FloatingPointError, match="log"):
        with debug.nan_check():
            torch.log(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError):  # raytpu's, under jax_debug_nans
        with jdebug.nan_check():
            jnp.log(jnp.asarray([-1.0], jnp.float32))
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="nan"):
        with debug.nan_check():
            y = (torch.sqrt(x) * 0.0).sum()  # 0 forward; 0/0 in sqrt's backward
            y.backward()


# -- profiling.trace ---------------------------------------------------------------


def test_trace_writes_chrome_json_naming_aten_ops(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as t:
        torch.ones(8) + torch.ones(8)
    events = json.loads(open(t["path"]).read())["traceEvents"]
    assert any(e.get("name") == "aten::add" for e in events)
    assert list((tmp_path / "tr").iterdir()) == [tmp_path / "tr" / t["path"].split("/")[-1]]


# -- math3d and the BRDF terms -----------------------------------------------------


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=rtol, atol=atol)


def _seeded(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_math3d_matches_raytpu():
    # tests/test_math3d.py's cases
    s = math3d.mat_scale((2.0, 2.0, 2.0), "cpu")
    r = math3d.mat_rotation_y(float(np.float32(np.pi / 2)), "cpu")
    t = math3d.mat_translation((0.0, 0.0, 5.0), "cpu")
    p = math3d.transform_point(math3d.srt(s, r, t), torch.tensor([1.0, 0.0, 0.0]))
    _close(p, [0.0, 0.0, 3.0], atol=1e-5)
    t2 = math3d.mat_translation(torch.tensor([1.0, 2.0, 3.0]), "cpu")
    _close(math3d.transform_point(t2, torch.ones(3)), [2, 3, 4])
    _close(math3d.transform_vector(t2, torch.ones(3)), [1, 1, 1])
    for fn in ("mat_translation", "mat_scale"):
        v = (0.5, -1.25, 3.0)
        _close(getattr(math3d, fn)(v, "cpu"), getattr(jmath3d, fn)(v))
    js = jmath3d.srt(jmath3d.mat_scale((1.0, 2.0, 3.0)), jmath3d.mat_rotation_y(0.7),
                     jmath3d.mat_translation((1.0, -1.0, 2.0)))
    ts = math3d.srt(math3d.mat_scale((1.0, 2.0, 3.0), "cpu"), math3d.mat_rotation_y(0.7, "cpu"),
                    math3d.mat_translation((1.0, -1.0, 2.0), "cpu"))
    _close(ts, js, atol=1e-6)
    # seeded vectors
    a, b, f = _seeded(0, 64, 3), _seeded(1, 64, 3), _seeded(2, 64, 1)
    ta, tb, tf = map(torch.from_numpy, (a, b, f))
    _close(math3d.sqr_magnitude(ta), jmath3d.sqr_magnitude(a))
    _close(math3d.reflect(ta, tb), jmath3d.reflect(a, b), atol=1e-6)
    _close(math3d.project(ta, tb), jmath3d.project(a, b), atol=1e-6)
    _close(math3d.reject(ta, tb), jmath3d.reject(a, b), atol=1e-6)
    _close(math3d.lerp(ta, tb, tf), jmath3d.lerp(a, b, f), atol=1e-6)


def _v(*xs):
    return np.asarray([xs], np.float32)


def _both(fn, *args):
    """(port's, raytpu's) value of a BRDF term on the same float32 inputs."""
    return (getattr(shading, fn)(*[torch.from_numpy(np.asarray(a)) for a in args]),
            getattr(jshading, fn)(*[jnp.asarray(a) for a in args]))


def test_brdf_terms_match_raytpu_on_test_shading_cases():
    one, half, up = np.asarray([1.0], np.float32), np.asarray([0.5], np.float32), _v(0, 1, 0)
    cases = [
        ("lambert", half, _v(0.2, 0.4, 0.8)),
        ("phong", one, one, _v(0, -1, 0), _v(0, -1, 0), up),  # the clamped reflect
        ("phong", half, np.asarray([3.0], np.float32), up, _v(0, -1, 0), up),
        ("fresnel_schlick", _v(0, 0, 1), _v(0, 0, 1), _v(0.04, 0.04, 0.04)),
        ("fresnel_schlick", _v(0, 0, 1), _v(1, 0, 0), _v(0.04, 0.04, 0.04)),
        ("ggx_distribution", _v(0, 0, 1), _v(0, 0, 1), half),
        ("schlick_ggx_geometry", _v(0, 0, 1), _v(0, 0, 1), half),
        ("schlick_ggx_geometry", _v(0, 0, 1), _v(1, 0, 0), half),
        ("cook_torrance", _v(1, 0, 0), np.zeros(1, np.float32), one, _v(0, 0, -1), _v(0, 0, -1),
         _v(0, 0, -1)),
    ]
    for fn, *args in cases:
        got, want = _both(fn, *args)
        _close(got, want, atol=1e-6)
    got, _ = _both("cook_torrance", _v(1, 0, 0), np.zeros(1, np.float32), one, _v(0, 0, -1),
                   _v(0, 0, -1), _v(0, 0, -1))
    assert got[0, 0] > got[0, 1] == got[0, 2] > 0


def test_brdf_terms_match_raytpu_on_seeded_inputs():
    rng = np.random.default_rng(3)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    R = 256
    n, l, v = unit(R), unit(R), unit(R)
    l = np.where((l * n).sum(1, keepdims=True) < 0, -l, l)  # lights above the surface
    v = np.where((v * n).sum(1, keepdims=True) < 0, -v, v)
    rough = rng.uniform(0.1, 1.0, R).astype(np.float32)
    metal = np.where(rng.uniform(size=R) < 0.5, 0.0, 1.0).astype(np.float32)
    albedo = rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32)
    kd = rng.uniform(0.0, 1.0, R).astype(np.float32)
    exp = rng.uniform(0.0, 40.0, R).astype(np.float32)
    h = (v + l) / np.linalg.norm(v + l, axis=1, keepdims=True).astype(np.float32)
    cases = [("lambert", kd, albedo), ("phong", kd, exp, l, v, n),
             ("fresnel_schlick", h.astype(np.float32), v, albedo),
             ("ggx_distribution", n, h.astype(np.float32), rough),
             ("schlick_ggx_geometry", n, l, rough), ("smith_geometry", n, v, l, rough),
             ("cook_torrance", albedo, metal, rough, n, l, v)]
    for fn, *args in cases:
        got, want = _both(fn, *args)
        # ggx's denominator ndh*ndh*(sqr_a - 1) + 1 cancels near ndh = 1, where
        # XLA's fused multiply-adds and the port's separate roundings part by
        # up to 7.3e-6 of the value (in D, and so in cook_torrance)
        ggx = fn in ("ggx_distribution", "cook_torrance")
        _close(got, want, rtol=1e-5 if ggx else 1e-6, atol=1e-6)


def test_validate_scene_matches_raytpu_on_every_registry_scene():
    """Last in the module: raytpu's lists come from the worker."""
    got = {name: debug.validate_scene(scenes.get(name).build("cpu")) for name in scenes.REGISTRY}
    assert len(got) == 12
    assert got == _JOBS["registry"].result()
    assert all(v == [] for v in got.values())
