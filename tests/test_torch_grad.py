"""The differentiable soft-shadow path of raytpu_torch against raytpu's jnp
path: the soft transmittance, its VJP (plain K5, K6 and K7, and the
autograd Function around them), ``render_soft_f32``'s image and gradients,
the inverse-rendering step, and the guards that keep gradients finite.

On the CPU every kernel wrapper takes its plain version, so the kernel
route (``kernels=True``) runs the plain versions; the test marked ``cuda``
holds the kernels against them on a card.  raytpu is never run through its
Pallas kernels here: its jnp reference is what they reproduce
(raytpu/grad/soft.py:1-10), and its interpret mode is slow.  raytpu's
references are jitted functions that take seconds each to trace and
compile, so they run in worker processes (``_raytpu_jobs``,
tests/torch_jobs.py: niced, one thread each), started as the module
starts, while the tests that need no reference run here; each is compiled
at XLA's backend optimisation level 0, which compiles in a third of the
time and changes raytpu's float32 rounding far inside the
tolerances.

Tolerances (raytpu's own):
  * transmittance, eager and plain K5, against ``soft._jnp_ref``: rtol 1e-4,
    atol 5e-4 (tests/test_soft_pallas.py:46; beta = 300 turns ulp-level
    differences of a grazing ray's margin into ~1e-4);
  * plain K6, plain K7 and the Function's cotangents against ``jax.vjp`` of
    ``_jnp_ref``: atol 1e-3 after dividing by each output's largest
    magnitude, on every element (test_soft_pallas.py:169,194).  Both sides
    run in float64: in float32 a ray that grazes the edge two triangles
    share has cotangents thousands of times their sum, which cancel, and
    float32 rounding of the barycentric margins decides the rest.  On
    optional at 32x24 (light 2, ray 236, g_dirs y, -8.65 in float64, of a
    largest 516) raytpu's float32 misses the float64 value by 3.6e-4 of the
    largest, by 1.75e-3 on another ray when compiled at level 0, and the
    port's by 1.5e-3.  The float32 arithmetic of the kernels is held to the
    plain versions on the card, 1e-4;
  * ``render_soft_f32``'s image and gradients against raytpu's
    ``render_soft_f32(kernels=False)``: rtol 2e-2, atol 3e-3 (of the
    largest gradient, for gradients; tests/test_grad_fast.py:65): both drop
    the same zero-a.e. boundary terms, and what is left is float32
    rounding.  For the image that holds on all but 1% of the pixels (the
    megakernel budget of tests/test_pallas.py): rounding decides a
    near-tie of two primitives (a room corner, where two planes meet at t
    equal to 2e-7 relative) and a soft-shadow gate at t = tmin on a
    grazing ray, and either changes a pixel by up to 5%.  The gradients
    compared are those of the loss over the pixels where the images agree;
  * ``payload_grad=False`` against True on material gradients: rtol 1e-4
    (test_soft_pallas.py:405);
  * the central finite difference of one mesh vertex: rtol 0.08
    (tests/test_grad.py:31);
  * on the card, K5 within 1e-5 of its plain version, K6 and K7 within
    1e-4 of each output's largest magnitude: K7 sums with atomics in an
    order that changes from run to run.  The Function against plain
    autograd of the eager transmittance, both float32 on the card: 1e-3 of
    each output's largest magnitude, the VJP tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_jobs

from raytpu.core import types as jtypes
from raytpu.grad import diff_render as jdr
from raytpu.grad.soft import _jnp_ref
from raytpu_torch.app import cli
from raytpu_torch.core import convert, scenes
from raytpu_torch.core.types import CullMode, RenderConfig, SceneBuilder
from raytpu_torch.grad import diff_render as dr
from raytpu_torch.grad import fast
from raytpu_torch.grad import soft as gsoft
from raytpu_torch.ops import accel, intersect
from raytpu_torch.render import packed, renderer, soft

torch.set_num_threads(2)

BETA_RENDER = 40.0  # tests/test_grad_fast.py:20
BETA = float(RenderConfig().soft_beta)  # the transmittance tests' sharpness, 300
W, H = 32, 24
NAMES = ["w3_test", "reference", "bunny", "optional"]
#: the render tests' scenes and route: the eager route under 256 triangles
#: (reference, also eager, adds no route and costs a raytpu compile), the
#: kernel route, here the plain versions, above
KERNEL_ROUTE = {"w3_test": False, "bunny": True, "optional": True}
#: the transmittance and VJP tests add a scene whose shadow rays cross a
#: plane just before their light, so that g_mags is not zero
SOFT_NAMES = [*NAMES, "far_plane"]
FAST_COMPILE = {"xla_backend_optimization_level": 0}
JOB_WORKERS = 4
TRAIN_LR, TRAIN_STEPS = 0.05, 3
_CACHE = {}


def _far_plane_scene():
    """A floor, a wall and a sphere lit by a point light 3 cm below the
    floor: the shadow rays from the sphere and the wall cross the floor
    just before the light, where the plane's margin is the light's
    distance minus t (``soft_dray``'s far-end branch, the one that writes
    g_mags).  A second light above keeps the image lit."""
    b = SceneBuilder()
    lam = b.add_lambert((0.8, 0.7, 0.6), 1.0)
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), lam)
    b.add_plane((0.0, 0.0, 8.0), (0.0, 0.0, -1.0), lam)
    b.add_sphere((0.0, -0.1, 5.0), 0.8, lam)
    b.add_point_light((0.3, -1.03, 5.2), 30.0, (1.0, 1.0, 1.0))
    b.add_point_light((0.0, 3.0, 3.0), 30.0, (1.0, 0.9, 0.8))
    b.set_camera((0.0, 0.5, 0.0), fov_degrees=60.0)
    return b.build("cpu")


def _scene(name):
    if ("scene", name) not in _CACHE:
        _CACHE[("scene", name)] = (_far_plane_scene() if name == "far_plane"
                                   else scenes.get(name).build("cpu"))
    return _CACHE[("scene", name)]


def _jax_scene(arrays):
    """raytpu's Scene from a port scene's arrays (``convert.scene_to_arrays``),
    leaf for leaf."""
    return jtypes.Scene(**{g: getattr(jtypes, cls.__name__)(**{
        f.name: jnp.asarray(arrays[f"{g}.{f.name}"]) for f in dataclasses.fields(cls)})
        for g, cls in convert.GROUPS.items()})


def _double(x):
    """A scene (or any nest of tensor dataclasses) with its floating tensors
    in float64."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _double(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x.double() if torch.is_floating_point(x) else x


def _all_params(mod, scene):
    """Every parameter group, keyed by group (materials and lights both have a "color")."""
    return {"material": mod.material_params(scene), "light": mod.light_params(scene),
            "geometry": mod.geometry_params(scene)}


def _merge_all(mod, scene, p):
    scene = mod.merge_material_params(scene, p["material"])
    return mod.merge_geometry_params(mod.merge_light_params(scene, p["light"]), p["geometry"])


def _trainable_all(scene):
    return {g: dr.trainable(d) for g, d in _all_params(dr, scene).items()}


def _shadow_inputs(scene, w=32, h=24):
    """The port's shadow queries of its eager closest hit at w x h."""
    cfg = RenderConfig(width=w, height=h)
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rec = intersect.closest_hit(scene, ro.reshape(-1, 3), rd, cfg.ray_min)
    p, dirs, mags = renderer.shadow_query_inputs(scene, rec, cfg)
    return p.contiguous(), dirs.contiguous(), mags.contiguous()


def _jcfg(w, h, beta=BETA_RENDER):
    return jtypes.RenderConfig(width=w, height=h, soft_shadows=True, soft_beta=beta)


def _inputs(name):
    """The seeded inputs of scene ``name``: its shadow queries at W x H with
    a cotangent for them ``(p, dirs, mags, g)``, and the render's loss
    weights (H, W, 3)."""
    if ("inputs", name) not in _CACHE:
        rng = np.random.default_rng(7)
        p, dirs, mags = _shadow_inputs(_scene(name))
        g = rng.uniform(-1.0, 1.0, tuple(mags.shape)).astype(np.float32)
        wt = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
        _CACHE[("inputs", name)] = ((p, dirs, mags, torch.from_numpy(g)), wt)
    return _CACHE[("inputs", name)]


def _train_pick(mod, s):
    return {**mod.material_params(s), "position": s.lights.position}


def _train_merge(mod, s, p):
    lights = dataclasses.replace(s.lights, position=p["position"])
    return dataclasses.replace(mod.merge_material_params(s, p), lights=lights)


def _train_target():
    return np.random.default_rng(5).uniform(0.0, 0.5, (H, W, 3)).astype(np.float32)


# -- raytpu's references, computed in worker processes -------------------------


def _raytpu_trans(arrays, p, dirs, mags, g):
    """raytpu's transmittance of the shadow queries in float32, and its VJP
    in float64 for the cotangent ``g`` in (p, dirs, mags, v0, v1, v2)."""

    def run(js, p, dirs, mags, g):
        def trans_fn(pp, dd, mm, v0, v1, v2):
            tris = dataclasses.replace(js.triangles, v0=v0, v1=v1, v2=v2)
            return _jnp_ref(1e-4, BETA, dataclasses.replace(js, triangles=tris), pp, dd, mm)

        trans, vjp = jax.vjp(trans_fn, p, dirs, mags, js.triangles.v0, js.triangles.v1,
                             js.triangles.v2)
        return trans, vjp(g)

    args = (_jax_scene(arrays), p, dirs, mags, g)
    trans = jax.jit(lambda js, p, dirs, mags: _jnp_ref(1e-4, BETA, js, p, dirs, mags)).lower(
        *args[:4]).compile(compiler_options=FAST_COMPILE)(*args[:4])
    with jax.enable_x64(True):
        args64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64) if np.issubdtype(
                np.asarray(x).dtype, np.floating) else x), args)
        vjp64 = jax.jit(run).lower(*args64).compile(compiler_options=FAST_COMPILE)(*args64)[1]
        return {"trans": np.asarray(trans), "vjp64": [np.asarray(x) for x in vjp64]}


def _raytpu_render(arrays, wt, port_img):
    """raytpu's soft render at W x H and the gradients, in every parameter
    group, of sum(image * wt) over the pixels where the port's image
    ``port_img`` agrees with it (``off`` marks the others)."""

    def run(js, params, wt):
        def loss(prm):
            img = jdr.render_soft_f32(_merge_all(jdr, js, prm), _jcfg(W, H), kernels=False)
            return jnp.sum(img * wt), img

        (_, img), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return img, grads

    js = _jax_scene(arrays)
    params = _all_params(jdr, js)
    fn = jax.jit(run).lower(js, params, wt).compile(compiler_options=FAST_COMPILE)
    img, grads = fn(js, params, wt)
    img = np.asarray(img)
    off = (np.abs(port_img - img) > 3e-3 + 2e-2 * np.abs(img)).any(axis=-1)
    if off.any():
        grads = fn(js, params, wt * ~off[:, :, None])[1]
    return {"img": img, "off": off, "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _raytpu_train(arrays, target):
    """TRAIN_STEPS of raytpu's ``make_train_step`` with ``optax.sgd`` on a
    material and light-position fit: the losses and the last parameters."""
    js = _jax_scene(arrays)
    opt = optax.sgd(TRAIN_LR)
    step = jdr.make_train_step(_jcfg(W, H), opt, functools.partial(_train_pick, jdr),
                               functools.partial(_train_merge, jdr))
    params = _train_pick(jdr, js)
    state = opt.init(params)
    step = step.lower(params, state, js, target).compile(compiler_options=FAST_COMPILE)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, js, target)
        losses.append(float(loss))
    return {"losses": losses, "params": jax.tree_util.tree_map(np.asarray, params)}


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
        for name in SOFT_NAMES:
            arrays = convert.scene_to_arrays(_scene(name))
            (p, dirs, mags, g), _ = _inputs(name)
            jobs[f"trans {name}"] = ex.submit(_raytpu_trans, arrays, p.numpy(), dirs.numpy(),
                                            mags.numpy(), g.numpy())
        for name in ("optional", "bunny", "w3_test"):  # the longest first
            scene, wt = _scene(name), _inputs(name)[1]
            cfg = RenderConfig(width=W, height=H, soft_beta=BETA_RENDER)
            with torch.no_grad():
                img = dr.render_soft_f32(scene, cfg, kernels=KERNEL_ROUTE[name]).numpy()
            jobs[f"render {name}"] = ex.submit(_raytpu_render, convert.scene_to_arrays(scene),
                                             wt, img)
        jobs["train"] = ex.submit(_raytpu_train, convert.scene_to_arrays(_scene("bunny")),
                                  _train_target())
        yield
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _raytpu(key):
    return _CACHE["jobs"][key].result()


def _scaled_close(a, b, atol=1e-3):
    """|a - b| <= atol * max|b| on every element."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    if not a.size:
        return
    err = np.abs(a - b) / max(np.abs(b).max(), 1e-6)
    worst = np.unravel_index(err.argmax(), err.shape)
    assert err.max() <= atol, (f"{int((err > atol).sum())} of {err.size} beyond {atol}, "
                               f"worst {err.max():.3e} at {worst}")


def _grads_close(got, want, rtol=2e-2, atol=3e-3):
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    assert np.isfinite(got).all()
    scale = np.abs(want).max(initial=0.0) + 1e-12
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale + 1e-8)


def test_tile_feed_matches_the_eager_route():
    """At 64x32 (two 32x32 pixel blocks) the kernel route feeds the kernels
    in tile order and unfolds the image; image and gradients equal the
    eager route's, which renders row-major."""
    scene = _scene("bunny")
    cfg = RenderConfig(width=64, height=32, soft_beta=BETA_RENDER)
    wt = torch.from_numpy(np.random.default_rng(11).uniform(0.0, 1.0, (32, 64, 3))
                          .astype(np.float32))
    out = {}
    for kernels in (True, False):
        params = _trainable_all(scene)
        img = dr.render_soft_f32(_merge_all(dr, scene, params), cfg, kernels=kernels)
        (img * wt).sum().backward()
        out[kernels] = (img.detach(), params)
    np.testing.assert_allclose(out[True][0].numpy(), out[False][0].numpy(), rtol=1e-4, atol=1e-5)
    for group, keys in out[False][1].items():
        for key, ref in keys.items():
            got = out[True][1][group][key].grad
            assert (got is None) == (ref.grad is None), key
            if got is not None:
                _grads_close(got.numpy(), ref.grad.numpy())


def test_detached_closest_hit_matches_closest_hit():
    """The detached winner search, eager and through K3 (plain), re-derives
    the eager closest hit's records on bunny."""
    scene = _scene("bunny")
    ro, rd = renderer.generate_rays(scene.camera, RenderConfig(width=32, height=24))
    ro = ro.expand_as(rd).contiguous()
    want = intersect.closest_hit(scene, ro, rd, 1e-4)
    for got in (fast.detached_closest_hit(scene, ro, rd, 1e-4),
                fast.detached_closest_hit(scene, ro, rd, 1e-4, min_t_fn=dr._kernel_min_t)):
        hit = want.hit
        assert torch.equal(got.hit, hit) and torch.equal(got.material[hit], want.material[hit])
        torch.testing.assert_close(got.t[hit], want.t[hit], rtol=1e-5, atol=0.0)
        torch.testing.assert_close(got.normal[hit], want.normal[hit], rtol=0.0, atol=1e-5)
        torch.testing.assert_close(got.point[hit], want.point[hit], rtol=0.0, atol=1e-5)


def test_payload_grad_off_keeps_material_grads():
    """``payload_grad=False`` (the closest hit from K3's payload) renders the
    same image and gives the same material gradients; occluder geometry
    still gets gradients through the transmittance."""
    scene = _scene("bunny")
    cfg = RenderConfig(width=64, height=32, soft_beta=BETA_RENDER)
    out = {}
    for pg in (True, False):
        params = dr.trainable({**dr.material_params(scene), **dr.geometry_params(scene)})
        img = dr.render_soft_f32(dr.merge_geometry_params(dr.merge_material_params(scene, params),
                                                          params), cfg, kernels=True,
                                 payload_grad=pg)
        img.mean().backward()
        out[pg] = (img.detach(), {k: v.grad for k, v in params.items()})
    assert float((out[True][0] - out[False][0]).abs().max()) < 1e-3
    for key in ("color", "params"):
        np.testing.assert_allclose(out[False][1][key].numpy(), out[True][1][key].numpy(),
                                   rtol=1e-4, atol=1e-7)
    g_pos = out[False][1]["mesh_positions"]
    assert torch.isfinite(g_pos).all() and float(g_pos.abs().sum()) > 0


def test_mesh_vertex_gradient_matches_finite_difference():
    """A central difference of one mesh vertex through the kernel route's
    transmittance (K5 forward, K7 backward, here plain) on bunny, the loss
    weighting the shadow queries of the floor and walls, where the bunny's
    soft shadow falls: positions -> face normals -> world triangles ->
    Function.  (The queries from the bunny itself start on it, where moving
    a vertex flips its triangles' t-gates, a jump the gradient omits.)"""
    scene = _scene("bunny")
    cfg = RenderConfig(width=W, height=H)
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rec = intersect.closest_hit(scene, ro.reshape(-1, 3), rd, cfg.ray_min)
    p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    tmat = intersect.scene_t_matrix(scene, ro.reshape(-1, 3), rd, 1e-4, intersect.INF, False)
    S, P = scene.spheres.count, scene.planes.count
    on_plane = rec.hit & (tmat.argmin(dim=1) >= S) & (tmat.argmin(dim=1) < S + P)
    wt = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 1.0, tuple(mags.shape))) * on_plane

    def loss(pos):
        s = scene.with_meshes(scene.meshes.with_positions(pos))
        trans = gsoft.soft_trans_lights(True, 1e-4, BETA_RENDER, s, p, dirs, mags)
        return (trans.double() * wt).sum()

    pos0 = scene.meshes.positions.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(pos0), pos0)
    vi = int(g.abs().sum(dim=1).argmax())
    eps, checked = 2e-3, 0
    for c in range(3):
        d = torch.zeros_like(pos0)
        d[vi, c] = eps
        with torch.no_grad():
            fd = float(loss(pos0 + d) - loss(pos0 - d)) / (2 * eps)
        if abs(fd) < 5e-3 and abs(float(g[vi, c])) < 5e-3:
            continue  # both ~0: uninformative
        np.testing.assert_allclose(float(g[vi, c]), fd, rtol=0.08, atol=1e-4 + 0.02 * abs(fd))
        checked += 1
    assert checked >= 1


def _four_kinds_scene():
    """Every material kind on a sphere, a Lambert floor, a two-sided
    triangle and a culled one, a point and a directional light."""
    b = SceneBuilder()  # material 0: solid red
    lam = b.add_lambert((0.8, 0.7, 0.6), 1.0)
    phong = b.add_lambert_phong((0.2, 0.5, 0.9), 0.8, 0.5, 20.0)
    ct_metal = b.add_cook_torrance((0.9, 0.8, 0.3), 1.0, 0.3)
    ct_plastic = b.add_cook_torrance((0.3, 0.6, 0.3), 0.0, 0.6)
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), lam)
    b.add_sphere((-1.5, 0.0, 5.0), 0.8, 0)
    b.add_sphere((0.0, 0.0, 5.0), 0.8, phong)
    b.add_sphere((1.5, 0.0, 5.0), 0.8, ct_metal)
    b.add_sphere((0.0, 1.4, 5.5), 0.6, ct_plastic)
    for cull, x in ((CullMode.NONE, -1.0), (CullMode.BACK_FACE, 1.0)):
        m = b.add_triangle_mesh(cull, lam)
        m.append_triangle((x - 0.5, 2.2, 4.0), (x + 0.5, 2.2, 4.0), (x, 3.0, 4.5))
    b.add_point_light((0.0, 5.0, 1.0), 40.0, (1.0, 1.0, 1.0))
    b.add_directional_light((0.3, -1.0, 0.4), 1.5, (1.0, 0.9, 0.8))
    b.set_camera((0.0, 1.0, -1.0), fov_degrees=60.0)
    return b.build("cpu")


@pytest.mark.parametrize("kernels", [False, True])
def test_gradients_are_finite_on_every_material_kind(kernels):
    """Every parameter's gradient is finite on a scene of all four material
    kinds, through the eager route and the kernel route."""
    scene = _four_kinds_scene()
    assert sorted(set(scene.materials.kind.tolist())) == [0, 1, 2, 3]
    params = _trainable_all(scene)
    cfg = RenderConfig(width=32, height=24)
    img = dr.render_soft_f32(_merge_all(dr, scene, params), cfg, kernels=kernels)
    assert torch.isfinite(img).all() and float(img.detach().max()) > 0
    img.sum().backward()
    for group in params.values():
        for key, v in group.items():
            assert v.grad is not None and torch.isfinite(v.grad).all(), key
    assert float(params["light"]["position"].grad.abs().sum()) > 0
    assert float(params["geometry"]["mesh_positions"].grad.abs().sum()) > 0


def test_material_fit_reaches_no_backward_kernel(monkeypatch):
    """A material fit needs no gradient upstream of the transmittance, so
    neither K6 nor K7 runs; a light and mesh fit runs each once per step."""
    calls = {"K6": 0, "K7": 0}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(soft, "soft_dray", counted("K6", soft.soft_dray))
    monkeypatch.setattr(soft, "soft_dprim", counted("K7", soft.soft_dprim))
    scene = _scene("bunny")
    cfg = RenderConfig(width=32, height=24)
    target = torch.zeros((24, 32, 3))
    fits = [(dr.material_params, dr.merge_material_params, {"K6": 0, "K7": 0}),
            (lambda s: {**dr.light_params(s), **dr.geometry_params(s)},
             lambda s, p: dr.merge_geometry_params(dr.merge_light_params(s, p), p),
             {"K6": 1, "K7": 1})]
    for pick, merge, want in fits:
        calls.update(K6=0, K7=0)
        params = dr.trainable(pick(scene))
        step = dr.make_train_step(cfg, torch.optim.SGD(params.values(), lr=1e-2), merge,
                                  kernels=True)
        loss = step(params, scene, target)
        assert torch.isfinite(loss) and calls == want


def test_soft_worklists_leave_out_only_the_clipped_tail():
    """The soft worklists are K4's culls over boxes widened by
    ``chunk_soft_slack`` (raytpu's slack, equal to it here): every group
    they leave out of a (tile, light) occludes each of the tile's shadow
    rays by less than sigmoid(-20) ~ 2e-9.  K4's own worklists (no slack)
    are narrower."""
    from raytpu.ops import accel as jaccel

    scene = _scene("bunny")
    js = _jax_scene(convert.scene_to_arrays(scene))
    np.testing.assert_allclose(
        accel.chunk_soft_slack(scene.triangles, BETA, accel.GROUP).numpy(),
        np.asarray(jaccel.chunk_soft_slack(js.triangles, BETA, accel.GROUP, 20.0)), rtol=1e-6)
    p, dirs, mags = _shadow_inputs(scene, 64, 32)
    wl, cnt = soft.soft_worklists(scene, p, dirs, mags, 1e-4, BETA)
    wl4, cnt4 = packed.shadow_worklists(scene, p, dirs, mags, 1e-4)
    assert bool((cnt >= cnt4).all()) and bool((cnt > cnt4).any())
    tri = packed.soft_packs(scene)[2]
    T, nt = tri.shape[0], wl.shape[0]
    group = torch.arange(T) // accel.GROUP
    worst = 0.0
    for li in range(dirs.shape[0]):
        o, d, mag = soft._ray_cols(p, dirs, mags, li)
        occ = soft._tri_soft(soft._rows(tri, 13), o, d, 1e-4, mag, BETA)[0]  # (R, T)
        for ti in range(nt):
            listed = torch.zeros(-(-T // accel.GROUP), dtype=torch.bool)
            listed[wl[ti, li, :cnt[ti, li]].long()] = True
            left_out = occ[ti * 1024:(ti + 1) * 1024][:, ~listed[group]]
            worst = max(worst, float(left_out.max()) if left_out.numel() else 0.0)
    assert worst < 1e-8


def test_with_positions_and_normalize_safe_match_raytpu():
    """``Meshes.with_positions`` recomputes the face normals as raytpu does;
    ``normalize_safe`` divides by the norm clamped at 1e-20, so a zero
    vector normalizes to zero, not NaN."""
    from raytpu.core import math3d as jmath3d
    from raytpu_torch.core import math3d

    scene = _scene("bunny")
    js = _jax_scene(convert.scene_to_arrays(scene))
    pos = scene.meshes.positions * 1.01
    got = scene.meshes.with_positions(pos).face_normal.numpy()
    want = np.asarray(js.meshes.with_positions(jnp.asarray(pos.numpy())).face_normal)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=2e-6)
    v = np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 4.0], [1e-3, -2e-3, 5e-4]], np.float32)
    n = math3d.normalize_safe(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(n, np.asarray(jmath3d.normalize_safe(jnp.asarray(v))), rtol=1e-6)
    assert np.isfinite(n).all() and not n[0].any()


def test_cli_renders_soft_shadows(tmp_path):
    """``--soft-shadows`` and ``--soft-beta`` reach the render: the image
    differs from the hard-shadow one."""
    shots = {}
    for extra in ([], ["--soft-shadows", "--soft-beta", "8"]):
        shot = tmp_path / f"shot{len(extra)}.png"
        assert cli.main(["--device", "cpu", "--scene", "w3_test", "--size", "32x24",
                         "--screenshot", str(shot), *extra]) == 0
        shots[len(extra)] = shot.read_bytes()
    assert shots[0] != shots[3]


def test_grad_support_zeroes_the_sigmoid_and_its_derivative():
    """The gradient records' support (``accel.GRAD_SUPPORT``): in float32,
    wherever beta * margin lies below -GRAD_SUPPORT, the soft sigmoid of
    K5-K7's arithmetic (``soft._soft_occ``) and its derivative are exactly
    0.0f, so every partial of the soft VJP is; at -88 (inside the support)
    both are not, nor at K5's support (-20), where the factor 1 - occ is
    already exactly 1.  At beta = 300 the records' m = support / beta is
    0.3, about 0.6 of a group's longest edge in their pad."""
    bm = torch.cat([-accel.GRAD_SUPPORT - torch.logspace(-5, 6, 200),
                    torch.tensor([float(np.nextafter(np.float32(-accel.GRAD_SUPPORT),
                                                     np.float32(-np.inf)))])])
    for beta in (BETA, 40.0, 8.0, 1e4):
        margin = bm / beta
        prod = beta * margin  # the product soft_occ rounds
        sel = prod < -accel.GRAD_SUPPORT
        assert int(sel.sum()) > 150
        occ, docc = soft._soft_occ(margin[sel], torch.ones_like(margin[sel], dtype=torch.bool),
                                   beta)
        assert bool((occ == 0.0).all()) and bool((docc == 0.0).all())
        inside = torch.tensor([-88.0, -accel.SOFT_SUPPORT]) / beta
        occ, docc = soft._soft_occ(inside, torch.ones(2, dtype=torch.bool), beta)
        assert bool((occ > 0.0).all()) and bool((docc > 0.0).all())
        assert bool(((1.0 - occ)[1:] == 1.0).all())
    assert abs(accel.GRAD_SUPPORT / BETA - 0.3) < 1e-12


def test_soft_wrappers_refuse_what_the_kernels_do_not_take():
    """K5-K7's wrappers take their plain versions only for CPU tensors:
    tensors on any other device than CUDA raise before a launch, and no
    launch is counted."""
    scene = _scene("bunny")
    p, dirs, mags = _shadow_inputs(scene, 8, 8)
    blobs = packed.soft_packs(scene)
    boxes, wl, cnt = soft.soft_boxes(scene, p, dirs, mags, 1e-4, 300.0)
    g = torch.ones_like(mags)
    meta = [x.to("meta") for x in (p, dirs, mags, g, *blobs, boxes, wl, cnt)]
    mp, md, mm, mg, ms, mpl, mt, mb, mwl, mcnt = meta
    before = (soft.SOFT_TRANS_LAUNCHES, soft.SOFT_DRAY_LAUNCHES, soft.SOFT_DRAY_SUM_LAUNCHES,
              soft.SOFT_DPRIM_LAUNCHES)
    with pytest.raises(ValueError, match="K5 runs on CUDA"):
        soft.soft_trans_lights_cuda(mp, md, mm, ms, mpl, mt, mb, mwl, mcnt, 1e-4, 300.0)
    with pytest.raises(ValueError, match="K6 runs on CUDA"):
        soft.soft_dray(mp, md, mm, mg, mg, ms, mpl, mt, mwl, mcnt, 1e-4, 300.0, mb)
    with pytest.raises(ValueError, match="K7 runs on CUDA"):
        soft.soft_dprim(mp, md, mm, mg, mg, mt, mwl, mcnt, 1e-4, 300.0)
    with pytest.raises(ValueError, match="K7 runs on CUDA"):
        soft.soft_dprim(mp, md, mm, mg, mg, mt, mwl, mcnt, 1e-4, 300.0, mb)
    assert (soft.SOFT_TRANS_LAUNCHES, soft.SOFT_DRAY_LAUNCHES, soft.SOFT_DRAY_SUM_LAUNCHES,
            soft.SOFT_DPRIM_LAUNCHES) == before


def _dray_walk_twin(p, dirs, mags, g, trans, sph, pln, tri, boxes, tmin, beta):
    """A torch twin of K6's walk: ``soft.soft_dray_plain``'s arithmetic and
    order of sums, over a row listing every group in ascending order, where
    each (ray, light) takes a group's triangles only if its segment crosses
    the group's gradient record (``accel.segment_box_test``, the kernels'
    per-ray test): a skipped group adds nothing.  Returns the sums and the
    share of (ray, light, group) triples skipped."""
    L, R, T = dirs.shape[0], p.shape[0], tri.shape[0]
    inv_col = torch.arange(T) // accel.GROUP
    g_p = torch.zeros((R, 3), dtype=torch.float32)
    g_dirs, g_mags, skipped = [], [], 0.0
    for li in range(L):
        o, d, mag = soft._ray_cols(p, dirs, mags, li)
        crosses = accel.segment_box_test(p, accel.inv_dir(dirs[li]), mags[li], boxes,
                                         d=dirs[li])  # (R, ceil(T/8))
        skipped += float((~crosses).float().mean()) / L
        gob = (-g[li] * trans[li])[:, None]
        gp = [torch.zeros((R,), dtype=torch.float32) for _ in range(3)]
        gl = [torch.zeros_like(gp[0]) for _ in range(3)]
        gm = torch.zeros_like(gp[0])
        if sph.shape[0]:
            sr = soft._rows(sph, 4)
            occ, docc, Lv, proj = soft._sphere_soft(sr, o, d, tmin, mag, beta)
            c2 = 2.0 * (-(gob / (1.0 - occ) * docc) / sr[3])
            for c in range(3):
                gp[c] = gp[c] + (-c2 * (Lv[c] - proj * d[c])).sum(dim=1)
                gl[c] = gl[c] + (-c2 * proj * Lv[c]).sum(dim=1)
        if pln.shape[0]:
            pl = soft._rows(pln, 4)
            occ, docc, t, den, near = soft._plane_soft(pl, o, d, tmin, mag, beta)
            g_m = gob / (1.0 - occ) * docc
            g_t = torch.where(near, g_m, -g_m)
            for c in range(3):
                gp[c] = gp[c] + (-(g_t / den) * pl[c]).sum(dim=1)
                gl[c] = gl[c] + ((-g_t * t / den) * pl[c]).sum(dim=1)
            gm = gm + torch.where(near, 0.0, g_m).sum(dim=1)
        for a, b in soft.plain._tri_chunks(T, R, p.device):
            k = soft._rows(tri[a:b], 13)
            occ, docc, u, v, w, inv_a, h, s, q = soft._tri_soft(k, o, d, tmin, mag, beta)
            g_nu, g_nv, g_a = soft._tri_grad(u, v, w, inv_a, gob / (1.0 - occ) * docc)
            e1d = soft._cross3(k[3], k[4], k[5], *d)
            e2s = soft._cross3(k[6], k[7], k[8], *s)
            e21 = soft._cross3(k[6], k[7], k[8], k[3], k[4], k[5])
            walked = crosses[:, inv_col[a:b]]
            for c in range(3):
                gp[c] = gp[c] + torch.where(walked, g_nu * h[c] + g_nv * e1d[c], 0.0).sum(dim=1)
                gl[c] = gl[c] + torch.where(
                    walked, g_nu * e2s[c] + g_nv * q[c] + g_a * e21[c], 0.0).sum(dim=1)
        g_p = g_p + torch.stack(gp, dim=1)
        g_dirs.append(torch.stack(gl, dim=1))
        g_mags.append(gm)
    return (g_p, torch.stack(g_dirs), torch.stack(g_mags)), skipped


def test_k6_walk_twin_equals_the_plain_version():
    """K6's walk skips, per (ray, light), the groups whose gradient record
    (``soft.grad_boxes``) its segment misses; their partials are all
    exactly 0.0f, so the torch twin of the walk (``_dray_walk_twin``)
    equals ``soft_dray_plain`` bit for bit on bunny's soft shadow queries
    and cotangent, while skipping most groups."""
    (p, dirs, mags, g), _ = _inputs("bunny")
    scene = _scene("bunny")
    sph, pln, tri = packed.soft_packs(scene)
    trans = soft.soft_trans_plain(p, dirs, mags, sph, pln, tri, 1e-4, BETA)
    want = soft.soft_dray_plain(p, dirs, mags, g, trans, sph, pln, tri, 1e-4, BETA)
    got, skipped = _dray_walk_twin(p, dirs, mags, g, trans, sph, pln, tri,
                                   soft.grad_boxes(scene, BETA), 1e-4, BETA)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(want[0].abs().max()) > 0.0 and skipped > 0.5


def test_soft_dray_refuses_to_run_without_the_gradient_records():
    """K6 walks the gradient records (``soft.grad_boxes``): a call on
    tensors off the CPU without them raises before a launch, on any
    device; with them, tensors off CUDA still raise."""
    scene = _scene("bunny")
    p, dirs, mags = _shadow_inputs(scene, 8, 8)
    blobs = packed.soft_packs(scene)
    wl, cnt = soft.soft_worklists(scene, p, dirs, mags, 1e-4, BETA)
    boxes = soft.grad_boxes(scene, BETA)
    g = torch.ones_like(mags)
    mp, md, mm, mg, ms, mpl, mt, mwl, mcnt, mb = (
        x.to("meta") for x in (p, dirs, mags, g, *blobs, wl, cnt, boxes))
    before = soft.SOFT_DRAY_LAUNCHES
    with pytest.raises(ValueError, match="K6 walks the gradient records"):
        soft.soft_dray(mp, md, mm, mg, mg, ms, mpl, mt, mwl, mcnt, 1e-4, BETA)
    with pytest.raises(ValueError, match="K6 runs on CUDA"):
        soft.soft_dray(mp, md, mm, mg, mg, ms, mpl, mt, mwl, mcnt, 1e-4, BETA, mb)
    assert soft.SOFT_DRAY_LAUNCHES == before


@pytest.mark.parametrize("name", SOFT_NAMES)
def test_soft_transmittance_matches_raytpu(name):
    """The eager transmittance, plain K5 and the Function's forward against
    raytpu's jnp reference on the same shadow queries."""
    want = _raytpu(f"trans {name}")["trans"]
    (p, dirs, mags, _), _ = _inputs(name)
    scene = _scene(name)
    eager = gsoft.soft_trans_lights(False, 1e-4, BETA, scene, p, dirs, mags)
    plain_k5 = soft.soft_trans_plain(p, dirs, mags, *packed.soft_packs(scene), 1e-4, BETA)
    function = gsoft.soft_trans_lights(True, 1e-4, BETA, scene, p, dirs, mags)
    for got in (eager, plain_k5, function):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=5e-4)
    assert 0.0 < float(want.min()) < 1.0  # some shadow lies in view


@pytest.mark.parametrize("name", SOFT_NAMES)
def test_soft_vjp_matches_raytpu(name):
    """The Function's backward, which on CPU tensors is plain K6 and plain
    K7 with ``_scene_cotangent``, and plain autograd of the eager
    transmittance against ``jax.vjp`` of raytpu's jnp reference (the rays'
    cotangents and the vertices'), both in float64; the Function's sphere
    and plane cotangents against plain autograd's."""
    want = _raytpu(f"trans {name}")["vjp64"]  # p, dirs, mags, v0, v1, v2
    scene = _double(_scene(name))
    p, dirs, mags, g = (x.double() for x in _inputs(name)[0])
    grads = {}
    for kernels in (True, False):
        leaves = [x.detach().clone().requires_grad_(True) for x in (
            p, dirs, mags, scene.triangles.v0, scene.triangles.v1, scene.triangles.v2,
            scene.spheres.center, scene.spheres.radius, scene.planes.origin, scene.planes.normal)]
        s = dataclasses.replace(
            scene, triangles=dataclasses.replace(scene.triangles, v0=leaves[3], v1=leaves[4],
                                                 v2=leaves[5]),
            spheres=dataclasses.replace(scene.spheres, center=leaves[6], radius=leaves[7]),
            planes=dataclasses.replace(scene.planes, origin=leaves[8], normal=leaves[9]))
        out = gsoft.soft_trans_lights(kernels, 1e-4, BETA, s, *leaves[:3])
        got = torch.autograd.grad(out, leaves, g, allow_unused=True)
        grads[kernels] = [torch.zeros_like(x) if d is None else d for d, x in zip(got, leaves)]
        for d, ref in zip(grads[kernels], want):
            _scaled_close(d.numpy(), ref)
    for d, ref in zip(grads[True][6:], grads[False][6:]):
        _scaled_close(d.numpy(), ref.numpy())
    if name == "far_plane":  # the plane's far-end branch is held against non-zero values
        assert np.abs(want[2]).max() > 0.0


@pytest.mark.parametrize("name", list(KERNEL_ROUTE))
def test_render_soft_matches_raytpu(name):
    """``render_soft_f32``'s image and the gradients of every material,
    light and geometry parameter against raytpu's jnp path: the eager route
    on w3_test (under 256 triangles), the kernel route, here the plain
    versions, on bunny and optional."""
    res = _raytpu(f"render {name}")
    scene, wt = _scene(name), _inputs(name)[1]
    params = _trainable_all(scene)
    cfg = RenderConfig(width=W, height=H, soft_beta=BETA_RENDER)
    img = dr.render_soft_f32(_merge_all(dr, scene, params), cfg, kernels=KERNEL_ROUTE[name])
    got, want = img.detach().numpy(), res["img"]
    off = (np.abs(got - want) > 3e-3 + 2e-2 * np.abs(want)).any(axis=-1)
    assert off.mean() <= 0.01, f"{off.sum()} pixels beyond the tolerance"
    # the gradients of the loss over the pixels both render alike
    (img * torch.from_numpy(wt * ~res["off"][:, :, None])).sum().backward()
    for group, refs in res["grads"].items():
        assert set(refs) == set(params[group])
        for key, ref in refs.items():
            got = params[group][key].grad
            got = np.zeros_like(ref) if got is None else got.numpy()
            _grads_close(got, ref)
    assert np.abs(res["grads"]["light"]["position"]).max() > 0
    assert np.abs(res["grads"]["material"]["color"]).max() > 0


def test_train_step_sgd_matches_optax():
    """Three SGD steps of a material and light fit from the same carried
    scene: the port with ``torch.optim.SGD`` through the kernel route
    (plain), raytpu with ``optax.sgd`` through its jnp path."""
    ref = _raytpu("train")
    scene = _scene("bunny")
    cfg = RenderConfig(width=W, height=H, soft_beta=BETA_RENDER)
    params = dr.trainable(_train_pick(dr, scene))
    step = dr.make_train_step(cfg, torch.optim.SGD(params.values(), lr=TRAIN_LR),
                              functools.partial(_train_merge, dr), kernels=True)
    target = torch.from_numpy(_train_target())
    losses = [float(step(params, scene, target)) for _ in range(TRAIN_STEPS)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=2e-2)  # the images' tolerance
    p0 = _train_pick(dr, scene)
    for key in params:
        _grads_close((params[key] - p0[key]).detach().numpy(), ref["params"][key] - p0[key].numpy())
    assert losses[-1] < losses[0]


@pytest.mark.cuda
def test_soft_kernels_match_plain_versions_on_the_card():
    """K5, K6 and K7 against their plain versions on a card, on bunny's,
    optional's and far_plane's shadow queries at 64x32 (two tiles) and 50x37
    (ragged), and K7 against its walk over records that pass every group;
    and the Function (the kernels, with the sphere and plane
    cotangents of ``_scene_cotangent``) against plain autograd of the eager
    transmittance on w3_test and far_plane (spheres and planes, no
    triangle) and reference (all three).  Run on a machine with a card with
    ``pytest -m cuda tests/test_torch_grad.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for name in ("bunny", "optional", "far_plane"):
        scene = _scene(name).to(dev)
        blobs = packed.soft_packs(scene)
        for w, h in ((64, 32), (50, 37)):
            p, dirs, mags = _shadow_inputs(scene, w, h)
            g = torch.rand(mags.shape, device=dev) * 2.0 - 1.0
            before = (soft.SOFT_TRANS_LAUNCHES, soft.SOFT_DRAY_LAUNCHES, soft.SOFT_DPRIM_LAUNCHES)
            trans, (_, wl, cnt) = soft.soft_trans_lights_kernel(scene, p, dirs, mags, 1e-4, BETA)
            grad_boxes = soft.grad_boxes(scene, BETA)
            ray = soft.soft_dray(p, dirs, mags, g, trans, *blobs, wl, cnt, 1e-4, BETA, grad_boxes)
            prim = soft.soft_dprim(p, dirs, mags, g, trans, blobs[2], wl, cnt, 1e-4, BETA,
                                   grad_boxes)
            torch.cuda.synchronize()
            assert (soft.SOFT_TRANS_LAUNCHES, soft.SOFT_DRAY_LAUNCHES,
                    soft.SOFT_DPRIM_LAUNCHES) == tuple(b + 1 for b in before)
            ref = soft.soft_trans_plain(p, dirs, mags, *blobs, 1e-4, BETA)
            assert float((trans - ref).abs().max()) <= 1e-5
            # the per-ray soft test skips only factors of exactly 1: K5 over
            # records that pass every group gives the same bits
            every = accel.open_normal_boxes(-(-blobs[2].shape[0] // accel.GROUP), dev)
            assert torch.equal(trans, soft.soft_trans_lights_cuda(p, dirs, mags, *blobs, every, wl,
                                                                  cnt, 1e-4, BETA))
            ray_ref = soft.soft_dray_plain(p, dirs, mags, g, trans, *blobs, 1e-4, BETA)
            prim_ref = soft.soft_dprim_plain(p, dirs, mags, g, trans, blobs[2], 1e-4, BETA)
            # K7's gradient walk skips only partials of exactly 0: over
            # records that pass every group it adds the same partials
            prim_every = soft.soft_dprim(p, dirs, mags, g, trans, blobs[2], wl, cnt, 1e-4, BETA,
                                         every)
            for got, want in (*zip(ray, ray_ref), (prim, prim_ref), (prim, prim_every)):
                assert got.shape == want.shape
                if want.numel():  # far_plane has no triangle
                    scale = max(float(want.abs().max()), 1e-6)
                    assert float((got - want).abs().max()) <= 1e-4 * scale
            if name == "far_plane":
                assert float(ray_ref[2].abs().max()) > 0.0  # the far-end branch ran
    for name in ("w3_test", "reference", "far_plane"):
        scene = _scene(name).to(dev)
        p, dirs, mags = _shadow_inputs(scene, 64, 32)
        g = torch.rand(mags.shape, device=dev) * 2.0 - 1.0
        grads = {}
        for kernels in (True, False):
            leaves = [x.detach().clone().requires_grad_(True) for x in (
                p, dirs, mags, scene.spheres.center, scene.spheres.radius, scene.planes.origin,
                scene.planes.normal)]
            s = dataclasses.replace(
                scene, spheres=dataclasses.replace(scene.spheres, center=leaves[3],
                                                   radius=leaves[4]),
                planes=dataclasses.replace(scene.planes, origin=leaves[5], normal=leaves[6]))
            out = gsoft.soft_trans_lights(kernels, 1e-4, BETA, s, *leaves[:3])
            grads[kernels] = torch.autograd.grad(out, leaves, g)
        for got, want in zip(grads[True], grads[False]):
            scale = max(float(want.abs().max()), 1e-6)
            assert torch.isfinite(got).all() and float((got - want).abs().max()) <= 1e-3 * scale
        if name == "far_plane":  # the sphere and plane cotangents are not all zero
            assert all(float(x.abs().max()) > 0.0 for x in grads[False][3:])


@pytest.mark.cuda
def test_k6_walk_is_deterministic_on_the_card():
    """K6 on the gradient records: within 1e-4 of each output's largest
    magnitude of its plain version, and two launches, and its walk over
    records that pass every group (the same partials in the same order),
    equal to it bit for bit (no atomics), on bunny's and optional's shadow
    queries at 64x32 and 50x37 (a ragged last tile).  Run on a machine with
    a card with ``pytest -m cuda tests/test_torch_grad.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for name in ("bunny", "optional"):
        scene = _scene(name).to(dev)
        blobs = packed.soft_packs(scene)
        boxes = soft.grad_boxes(scene, BETA)
        every = accel.open_normal_boxes(boxes.shape[0], dev)
        for w, h in ((64, 32), (50, 37)):
            p, dirs, mags = _shadow_inputs(scene, w, h)
            g = torch.rand(mags.shape, generator=torch.Generator(device=dev).manual_seed(3),
                           device=dev) * 2.0 - 1.0
            trans, (_, wl, cnt) = soft.soft_trans_lights_kernel(scene, p, dirs, mags, 1e-4, BETA)
            args = (p, dirs, mags, g, trans, *blobs, wl, cnt, 1e-4, BETA)
            before = (soft.SOFT_DRAY_LAUNCHES, soft.SOFT_DRAY_SUM_LAUNCHES)
            first, second = soft.soft_dray(*args, boxes), soft.soft_dray(*args, boxes)
            assert (soft.SOFT_DRAY_LAUNCHES, soft.SOFT_DRAY_SUM_LAUNCHES) == (before[0] + 2,
                                                                            before[1] + 2)
            opened = soft.soft_dray(*args, every)
            want = soft.soft_dray_plain(p, dirs, mags, g, trans, *blobs, 1e-4, BETA)
            for a, b, o, ref in zip(first, second, opened, want):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
                assert torch.equal(a.view(torch.int32), o.view(torch.int32))
                scale = max(float(ref.abs().max()), 1e-6)
                assert float((a - ref).abs().max()) <= 1e-4 * scale

