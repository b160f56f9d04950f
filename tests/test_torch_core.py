"""raytpu_torch.core against raytpu.core: the scene schema carried across leaf
for leaf, the builders, the animation and the math conventions.

Every port scene is built twice, once by raytpu and carried across through
``scene_from_arrays``, once by the port's own ``SceneBuilder``.  The builder's
arrays must agree exactly (both builders round the same float64 literals to
float32 with numpy); the world-space triangles are recomputed by tensor ops
on both sides, whose sums round in another order, so they agree to 1e-6.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core import math3d as jmath3d
from raytpu.core import scenes as jscenes
from raytpu_torch.core import convert, math3d, scenes
from raytpu_torch.core.types import CullMode, SceneBuilder

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT_SCENES = ["sphere", "phong", "w1", "w2", "w3_test", "w3", "reference"]
WORLD_TRIANGLE_LEAVES = ("triangles.v0", "triangles.v1", "triangles.v2", "triangles.normal")

_JAX_SCENES = {}


def _jax_arrays(name, t=None):
    """np.asarray of every leaf of raytpu's scene ``name`` (animated to ``t``)."""
    if name not in _JAX_SCENES:
        _JAX_SCENES[name] = jscenes.get(name).build()
    scene = _JAX_SCENES[name]
    if t is not None:
        scene = jscenes.get(name).animate(scene, t)
    return convert.scene_to_arrays(scene)


@pytest.mark.parametrize("name", PORT_SCENES)
def test_scene_carry_across_matches_port_builder(name):
    ref = _jax_arrays(name)
    assert sorted(ref) == sorted(convert.leaf_names())
    carried = convert.scene_to_arrays(convert.scene_from_arrays(ref, "cpu"))
    own = convert.scene_to_arrays(scenes.get(name).build("cpu"))
    for key in convert.leaf_names():
        np.testing.assert_array_equal(carried[key], ref[key], err_msg=key)
        assert own[key].dtype == ref[key].dtype and own[key].shape == ref[key].shape, key
        if key in WORLD_TRIANGLE_LEAVES:
            np.testing.assert_allclose(own[key], ref[key], rtol=0, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(own[key], ref[key], err_msg=key)


@pytest.mark.parametrize("t", [0.0, 1.25])
def test_update_matches_raytpu(t):
    """Scene.update(t): every mesh yaws by (cos t + 1)/2 * 2pi, and the world
    triangles follow; 1e-6 as for the builder's world triangles."""
    ref = _jax_arrays("reference", t)
    spec = scenes.get("reference")
    mine = convert.scene_to_arrays(spec.animate(spec.build("cpu"), t))
    for key in ("meshes.rotation",) + WORLD_TRIANGLE_LEAVES:
        np.testing.assert_allclose(mine[key], ref[key], rtol=0, atol=1e-6, err_msg=key)
    for key in ("triangles.cull", "triangles.material"):
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)


def test_update_takes_a_device_tensor_time():
    spec = scenes.get("reference")
    scene = spec.build("cpu")
    a = spec.animate(scene, torch.tensor(1.25))
    b = spec.animate(scene, 1.25)
    np.testing.assert_array_equal(a.triangles.v1.numpy(), b.triangles.v1.numpy())


def test_scene_from_arrays_names_missing_leaves():
    arrays = dict(_jax_arrays("w2"))
    del arrays["camera.fov_scale"]
    with pytest.raises(KeyError, match="camera.fov_scale"):
        convert.scene_from_arrays(arrays, "cpu")


@pytest.mark.parametrize("faces", [256, 257])
def test_builder_reorders_meshes_over_256_faces(faces):
    """Up to 256 faces the soup keeps insertion order; past that the builder
    reorders it, face tables with it, by raytpu's SAH leaf order (raytpu's
    own spatial_permutation on the same soup, native library and all)."""
    from raytpu.ops import accel as jaccel

    rng = np.random.default_rng(faces)
    b = SceneBuilder()
    m = b.add_triangle_mesh(CullMode.NONE, 0)
    soup = rng.uniform(-3.0, 3.0, (faces, 3, 3)).astype(np.float32)
    for tri in soup:
        m.append_triangle(*tri)
    scene = b.build("cpu")
    perm = jaccel.spatial_permutation(soup) if faces > 256 else np.arange(faces)
    assert faces == 256 or not np.array_equal(perm, np.arange(faces))
    tr = scene.triangles
    np.testing.assert_array_equal(np.stack([tr.v0.numpy(), tr.v1.numpy(), tr.v2.numpy()], axis=1),
                                  soup[perm])
    world = scene.meshes.world_triangles()
    np.testing.assert_array_equal(world.v0.numpy(), tr.v0.numpy())
    np.testing.assert_array_equal(world.normal.numpy(), tr.normal.numpy())


def test_quantize_u8_truncates():
    x = torch.tensor([0.0, 0.5, 0.999, 1.0, 127.9 / 255.0], dtype=torch.float32)
    assert math3d.quantize_u8(x).tolist() == [0, 127, 254, 255, 127]
    rng = np.random.default_rng(0)
    v = rng.uniform(0.0, 1.0, size=(256, 3)).astype(np.float32)
    np.testing.assert_array_equal(math3d.quantize_u8(torch.from_numpy(v)).numpy(),
                                  np.asarray(jmath3d.quantize_u8(v)))


def test_max_to_one_matches_raytpu():
    rng = np.random.default_rng(1)
    v = rng.uniform(0.0, 3.0, size=(512, 3)).astype(np.float32)
    v[:8] = 0.0  # black pixels: the double-where keeps them at 0
    mine = math3d.max_to_one(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(jmath3d.max_to_one(v)))
    assert mine.max() <= 1.0 and not np.isnan(mine).any()


def _constants(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and isinstance(v, (int, float, tuple))}


def test_math3d_constants_match_raytpu():
    """Every public constant of raytpu's math3d exists in the port's, equal,
    and the port has no other."""
    mine, theirs = _constants(math3d), _constants(jmath3d)
    assert set(theirs) >= {"PI", "PI_DIV_2", "TO_DEGREES", "UNIT_X"}
    assert mine == theirs


def test_row_vector_matrices_match_raytpu():
    """mat_rotation_y, then a point and a vector through it with a
    translation row: row-vector order, p @ M[:3, :3] + M[3, :3]."""
    p = np.asarray([[1.0, 2.0, 3.0], [-0.5, 0.25, 4.0]], np.float32)

    @jax.jit
    def ref(yaw):
        m = jmath3d.mat_rotation_y(yaw).at[3, :3].set(jnp.asarray([0.5, -1.0, 2.0]))
        return m, jmath3d.transform_point(m, p), jmath3d.transform_vector(m, p)

    for yaw in (0.0, 0.7, -2.1):
        m_r, point_r, vec_r = (np.asarray(x) for x in ref(np.float32(yaw)))
        m = math3d.mat_rotation_y(yaw, device="cpu")
        m[3, :3] = torch.tensor([0.5, -1.0, 2.0])
        np.testing.assert_allclose(m.numpy(), m_r, rtol=0, atol=1e-7)
        np.testing.assert_allclose(math3d.transform_point(m, torch.from_numpy(p)).numpy(), point_r,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(math3d.transform_vector(m, torch.from_numpy(p)).numpy(), vec_r,
                                   rtol=0, atol=1e-6)


def test_fma_rounds_once():
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 is no float32: rounded on its own the
    # product loses its 2^-24 before the add; fused, the sum keeps it
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    c = torch.tensor([-1.0], dtype=torch.float32)
    assert float(a * a + c) == 2.0 ** -11
    assert float(math3d.fma(a, a, c)) == 2.0 ** -11 + 2.0 ** -24


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_raytpu():
    files = [f for f in sorted((REPO / "raytpu_torch").rglob("*.py"))
             if "_build" not in f.relative_to(REPO).parts] + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "raytpu")]
    assert not bad, bad
