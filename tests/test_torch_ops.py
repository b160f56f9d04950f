"""raytpu_torch.ops against raytpu.ops on seeded rays.

The f32-ops tolerance: ``rtol=1e-5, atol=1e-6`` on entries finite on both
sides, and identical hit/miss masks except on at most 0.1% of entries.  Not
exact, because the two round differently: the port fuses dot and cross
products into fused multiply-adds (raytpu_torch/core/math3d.py says why),
and XLA contracts raytpu's jitted ops into its own choice of them.  A ray
that grazes a primitive's boundary can then land on the other side of it.
raytpu's ops run jitted: one compile costs less than dispatching them one
by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.types import SceneBuilder as JSceneBuilder
from raytpu.ops import intersect as jint
from raytpu.ops import shading as jshade
from raytpu_torch.core import convert
from raytpu_torch.core.types import Lights, Materials
from raytpu_torch.ops import intersect, shading

torch.set_num_threads(2)

R = 4096
TMIN = 1e-4
MASK_BUDGET = 1e-3


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rays(seed, n=R):
    """Origins near the world origin, directions toward the primitives' box."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    target = rng.uniform([-4.0, -4.0, 3.0], [4.0, 4.0, 9.0], (n, 3))
    return ro, _unit(target - ro)


def _prims(seed):
    rng = np.random.default_rng(seed)
    box_lo, box_hi = [-4.0, -4.0, 3.0], [4.0, 4.0, 9.0]
    centers = rng.uniform(box_lo, box_hi, (8, 3)).astype(np.float32)
    radii = rng.uniform(0.3, 1.5, 8).astype(np.float32)
    p_origin = rng.uniform(box_lo, box_hi, (6, 3)).astype(np.float32)
    p_normal = _unit(rng.normal(size=(6, 3)))
    v0 = rng.uniform(box_lo, box_hi, (12, 3)).astype(np.float32)
    v1 = (v0 + rng.uniform(-2.0, 2.0, (12, 3))).astype(np.float32)
    v2 = (v0 + rng.uniform(-2.0, 2.0, (12, 3))).astype(np.float32)
    t_normal = _unit(np.cross(v1 - v0, v2 - v0))
    cull = np.arange(12, dtype=np.int32) % 3  # front, back, none
    return centers, radii, p_origin, p_normal, v0, v1, v2, t_normal, cull


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check_t(mine, ref):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape
    fin_m, fin_r = np.isfinite(mine), np.isfinite(ref)
    assert fin_r.sum() >= 200, "the seeded rays should hit something"
    assert (fin_m != fin_r).mean() <= MASK_BUDGET
    both = fin_m & fin_r
    np.testing.assert_allclose(mine[both], ref[both], rtol=1e-5, atol=1e-6)


def _random_scene():
    """Random spheres and triangles in three cull modes, plus a tie far to
    the side: two identical spheres centred at (100, 0, -5) and the plane
    z = -4, which a ray from (100, 0, 0) along -z meets all three at t = 4.
    Returns (raytpu scene, port scene carried across, plane table)."""
    c, r, po, pn, v0, v1, v2, _, cull = _prims(1)
    b = JSceneBuilder()
    mats = [b.add_lambert((0.8, 0.3, 0.2), 1.0), b.add_cook_torrance((0.9, 0.9, 0.9), 1.0, 0.6),
            b.add_lambert_phong((0.2, 0.3, 0.9), 0.7, 0.5, 30.0)]
    for i in range(8):
        b.add_sphere(tuple(c[i]), float(r[i]), mats[i % 3])
    b.add_sphere((100.0, 0.0, -5.0), 1.0, mats[0])
    b.add_sphere((100.0, 0.0, -5.0), 1.0, mats[1])
    b.add_plane((0.0, 0.0, -4.0), (0.0, 0.0, 1.0), mats[2])
    for i in range(12):
        b.add_triangle_mesh(int(cull[i]), mats[i % 3]).append_triangle(v0[i], v1[i], v2[i])
    js = b.build()
    return js, convert.scene_from_arrays(convert.scene_to_arrays(js), "cpu"), (po, pn)


TIE_RAYS = (np.asarray([[100.0, 0.0, 0.0]] * 2, np.float32),
            np.asarray([[0.0, 0.0, -1.0], [0.0, 0.6, -0.8]], np.float32))  # a tie; the plane only

_REF = {}


def _reference():
    """Inputs and raytpu's outputs for every intersection test of this
    module, from one jitted call (one compile)."""
    if not _REF:
        js, ts, (po, pn) = _random_scene()
        ro, rd = _rays(0)
        ro, rd = np.concatenate([ro, TIE_RAYS[0]]), np.concatenate([rd, TIE_RAYS[1]])
        tmax = np.random.default_rng(2).uniform(1.0, 12.0, ro.shape[0]).astype(np.float32)

        @jax.jit
        def ref(js, po, pn, ro, rd, tmax):
            sph, tr = js.spheres, js.triangles
            out = {"closest": jint.closest_hit(js, ro, rd, TMIN),
                   "any": jint.any_hit(js, ro, rd, TMIN, tmax)}
            out["sphere"] = jint.sphere_t(sph.center, sph.radius, ro, rd, TMIN, jnp.inf)
            out["plane"] = jint.plane_t(po, pn, ro, rd, TMIN, jnp.inf)
            for shadow in (False, True):
                out[f"tri_{shadow}"] = jint.triangle_t(tr.v0, tr.v1, tr.v2, tr.normal, tr.cull,
                                                    ro, rd, TMIN, jnp.inf, shadow)
            return out

        out = jax.tree_util.tree_map(np.asarray, ref(js, po, pn, ro, rd, tmax))
        _REF.update(scene=ts, planes=(po, pn), ro=ro, rd=rd, tmax=tmax, out=out)
    return _REF


def test_sphere_and_plane_t_match_raytpu():
    ref = _reference()
    sph, (po, pn) = ref["scene"].spheres, ref["planes"]
    ro, rd = _t(ref["ro"]), _t(ref["rd"])
    tm = float("inf")
    _check_t(intersect.sphere_t(sph.center, sph.radius, ro, rd, TMIN, tm).numpy(),
             ref["out"]["sphere"])
    # t = num / dot(rd, n): where the ray runs nearly parallel to the plane
    # the denominator cancels and its last bit moves t by more than 1e-5,
    # so those entries (|dot(rd, n)| < 0.05, about 5%) are left out
    grazing = np.abs(ref["rd"] @ pn.T) < 0.05
    mine = intersect.plane_t(_t(po), _t(pn), ro, rd, TMIN, tm).numpy()
    _check_t(np.where(grazing, np.inf, mine), np.where(grazing, np.inf, ref["out"]["plane"]))


@pytest.mark.parametrize("shadow_pass", [False, True])
def test_triangle_t_matches_raytpu_in_every_cull_mode(shadow_pass):
    ref = _reference()
    tr = ref["scene"].triangles
    mine = intersect.triangle_t(tr.v0, tr.v1, tr.v2, tr.normal, tr.cull, _t(ref["ro"]),
                                _t(ref["rd"]), TMIN, float("inf"), shadow_pass).numpy()
    tri_ref = ref["out"][f"tri_{shadow_pass}"]
    _check_t(mine, tri_ref)
    for mode in range(3):  # each cull mode is hit by some rays
        assert np.isfinite(tri_ref[:, tr.cull.numpy() == mode]).any()


def test_closest_hit_matches_raytpu():
    ref = _reference()
    rec = ref["out"]["closest"]
    mine = intersect.closest_hit(ref["scene"], _t(ref["ro"]), _t(ref["rd"]), TMIN)
    hit_r, hit_m = rec.hit, mine.hit.numpy()
    assert hit_r.mean() > 0.2
    same = hit_r == hit_m
    assert 1.0 - same.mean() <= MASK_BUDGET
    _check_t(mine.t.numpy(), rec.t)
    agree = same & hit_r & (mine.material.numpy() == rec.material)
    assert agree.sum() >= (1.0 - MASK_BUDGET) * hit_r.sum()
    # the point o + t*d inherits t's tolerance times t; a sphere's normal
    # (p - c)/r that times 2/r; plane and triangle normals are table rows
    scene = ref["scene"]
    idx = intersect.scene_t_matrix(scene, _t(ref["ro"]), _t(ref["rd"]), TMIN, float("inf"),
                                   shadow_pass=False).argmin(dim=1).numpy()[agree]
    t = rec.t[agree][:, None]
    tol_p = 1e-5 * t + 1e-6
    assert (np.abs(mine.point.numpy()[agree] - rec.point[agree]) <= tol_p).all()
    dn = np.abs(mine.normal.numpy()[agree] - rec.normal[agree])
    in_s = idx < scene.spheres.count
    r = scene.spheres.radius.numpy()[idx[in_s]][:, None]
    assert (dn[in_s] <= 2.0 * tol_p[in_s] / r + 1e-6).all()
    assert (dn[~in_s] == 0.0).all()


def test_closest_hit_first_primitive_wins_ties():
    """The tie rays: two identical spheres and a plane at t = 4.  The first
    in sphere -> plane -> triangle order wins, as in raytpu; the second ray
    meets only the plane."""
    ref = _reference()
    rec = ref["out"]["closest"]
    mine = intersect.closest_hit(ref["scene"], _t(ref["ro"]), _t(ref["rd"]), TMIN)
    sph_mat = ref["scene"].spheres.material.tolist()
    plane_mat = ref["scene"].planes.material.tolist()
    assert mine.material[-2:].tolist() == rec.material[-2:].tolist() == [sph_mat[8], plane_mat[0]]
    assert float(mine.t[-2]) == float(rec.t[-2]) == 4.0
    tmat = intersect.scene_t_matrix(ref["scene"], _t(TIE_RAYS[0]), _t(TIE_RAYS[1]), TMIN,
                                    float("inf"), shadow_pass=False)
    assert tmat[0, 8:11].tolist() == [4.0, 4.0, 4.0]


def test_any_hit_matches_raytpu():
    ref = _reference()
    any_r = ref["out"]["any"]
    mine = intersect.any_hit(ref["scene"], _t(ref["ro"]), _t(ref["rd"]), TMIN,
                             _t(ref["tmax"])).numpy()
    assert 0.05 < any_r.mean() < 0.95
    assert (mine != any_r).mean() <= MASK_BUDGET


def _shade_inputs(seed, n=2048):
    rng = np.random.default_rng(seed)
    nrm = _unit(rng.normal(size=(n, 3)))
    l = _unit(nrm + rng.normal(size=(n, 3)))  # mostly in the normal's hemisphere
    v = _unit(nrm + rng.normal(size=(n, 3)))
    return nrm, l, v


def test_shade_matches_raytpu_for_all_four_kinds():
    kind = np.asarray([0, 1, 2, 3, 3, 3], np.int32)
    color = np.asarray([[1, 0, 0], [0.49, 0.57, 0.57], [0.2, 0.2, 0.9],
                        [0.972, 0.96, 0.915], [0.75, 0.75, 0.75], [0.75, 0.75, 0.75]], np.float32)
    params = np.asarray([[0, 0, 0], [1, 0, 0], [0.6, 0.8, 60.0],
                         [1.0, 0.6, 0], [0.0, 1.0, 0], [0.0, 0.6, 0]], np.float32)
    nrm, l, v = _shade_inputs(10)
    idx = (np.arange(nrm.shape[0]) % kind.shape[0]).astype(np.int32)
    from raytpu.core.types import Materials as JMaterials

    ref = np.asarray(jax.jit(jshade.shade)(JMaterials(kind=jnp.asarray(kind), color=jnp.asarray(color),
                                                      params=jnp.asarray(params)), idx, nrm, l, v))
    mine = shading.shade(Materials(kind=_t(kind), color=_t(color), params=_t(params)),
                         _t(idx), _t(nrm), _t(l), _t(v)).numpy()
    assert np.isfinite(mine).all()
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-6)


def test_light_queries_match_raytpu():
    """direction_to_light and radiance, point and directional lights."""
    from raytpu.core.types import Lights as JLights

    pos = np.asarray([[0.0, 5.0, 5.0], [0.0, 0.0, 0.0]], np.float32)
    direc = np.asarray([[0.0, 0.0, 1.0], _unit(np.asarray([0.3, -1.0, 0.2]))], np.float32)
    col = np.asarray([[1.0, 0.61, 0.45], [1.0, 0.95, 0.9]], np.float32)
    inten = np.asarray([50.0, 2.5], np.float32)
    kind = np.asarray([0, 1], np.int32)
    jl = JLights(position=jnp.asarray(pos), direction=jnp.asarray(direc), color=jnp.asarray(col),
                 intensity=jnp.asarray(inten), kind=jnp.asarray(kind))
    tl = Lights(position=_t(pos), direction=_t(direc), color=_t(col), intensity=_t(inten),
                kind=_t(kind))
    pts = np.random.default_rng(11).uniform(-4.0, 4.0, (512, 3)).astype(np.float32)
    @jax.jit
    def ref_fn(lights, p):
        return [(*jshade.direction_to_light(lights, li, p), jshade.radiance(lights, li, p))
                for li in range(2)]

    for li, (l_r, m_r, rad_r) in enumerate(ref_fn(jl, pts)):
        l_m, m_m = shading.direction_to_light(tl, li, _t(pts))
        np.testing.assert_allclose(l_m.numpy(), np.asarray(l_r), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m_m.numpy(), np.asarray(m_r), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(shading.radiance(tl, li, _t(pts)).numpy(),
                                   np.asarray(rad_r), rtol=1e-5, atol=1e-6)
