"""raytpu_torch.native against raytpu.native, and the port's assets against
raytpu's.

Tolerances: none.  The library is a copy of raytpu's source built with the
same flags, so the BVH closest hit gives the same ids and the same t bit for
bit, the Morton order the same permutation and the BMP writer the same
bytes; the assets and ``make_assets``' output are byte-identical to raytpu's.
The random soups and rays are tests/test_native.py's.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest

from raytpu.native import runtime as jrt
from raytpu_torch.assets import make_assets
from raytpu_torch.core import obj
from raytpu_torch.native import runtime as rt
from raytpu_torch.ops import accel
from raytpu_torch.utils.image import read_bmp

RAYTPU_ASSETS = Path(jrt.__file__).resolve().parent.parent / "assets"


def _random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 1, 3))
    return (base + rng.uniform(-0.5, 0.5, (n, 3, 3))).astype(np.float32)


def test_available_builds_here():
    assert rt.available() and jrt.available()


def test_bvh_closest_hit_equals_raytpu():
    tris = _random_tris(300, seed=1)
    nb, nm, order = rt.build_bvh(tris)
    hits = 0
    rng = np.random.default_rng(2)
    rays = []
    for _ in range(50):  # tests/test_native.py's rays
        ro = rng.uniform(-15, 15, 3).astype(np.float32)
        rd = rng.normal(size=3).astype(np.float32)
        rays.append((ro, rd / np.linalg.norm(rd)))
    for i in range(50):  # and 50 aimed at centroids, so that most hit
        ro = rng.uniform(-15, 15, 3).astype(np.float32)
        rd = tris[i * 6].mean(axis=0) - ro
        rays.append((ro, (rd / np.linalg.norm(rd)).astype(np.float32)))
    for ro, rd in rays:
        tid, t = rt.bvh_closest_hit(tris, nb, nm, order, ro, rd)
        jtid, jt = jrt.bvh_closest_hit(tris, nb, nm, order, ro, rd)
        assert tid == jtid
        assert np.float32(t).tobytes() == np.float32(jt).tobytes()
        hits += tid >= 0
    assert hits >= 40
    with pytest.raises(ValueError):
        rt.bvh_closest_hit(tris[:10], nb, nm, order, ro, rd)


def test_morton_order_equals_raytpu():
    tris = _random_tris(512)
    perm = rt.morton_order(tris)
    np.testing.assert_array_equal(perm, jrt.morton_order(tris))
    np.testing.assert_array_equal(accel.morton_permutation(tris), perm)
    assert sorted(perm.tolist()) == list(range(512))


def test_write_bmp_equals_raytpu_and_reads_back(tmp_path):
    img = np.random.default_rng(0).uniform(0, 255, (33, 47, 3)).astype(np.uint8)
    ours, theirs = tmp_path / "port.bmp", tmp_path / "raytpu.bmp"
    rt.write_bmp(str(ours), img)
    jrt.write_bmp(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(read_bmp(str(ours)), img)
    with pytest.raises(ValueError):
        rt.write_bmp(str(ours), img.astype(np.float32))


def test_monotonic_does_not_decrease():
    a = rt.monotonic()
    b = rt.monotonic()
    assert b >= a


def test_bindings_raise_where_the_library_does_not_build(tmp_path, monkeypatch):
    """No fallback: a library that cannot build makes ``available()`` false
    and every binding raise."""
    monkeypatch.setattr(rt, "_lib", None)
    monkeypatch.setattr(rt, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(rt, "GXX_FLAGS", ["--no-such-flag"])
    assert not rt.available()
    with pytest.raises(RuntimeError):
        rt.monotonic()
    with pytest.raises(RuntimeError):
        rt.morton_order(_random_tris(4))


def test_make_assets_writes_raytpu_files(tmp_path):
    assert make_assets.main(["--out", str(tmp_path)]) == 0
    for name in ("simple_quad.obj", "simple_cube.obj", "icosphere.obj"):
        assert (tmp_path / name).read_bytes() == (RAYTPU_ASSETS / name).read_bytes(), name


def test_bundled_assets_equal_raytpu():
    ours = sorted(p.name for p in obj.ASSET_DIR.glob("*.obj"))
    assert ours == sorted(p.name for p in RAYTPU_ASSETS.glob("*.obj"))
    assert len(ours) == 6
    for name in ours:
        assert filecmp.cmp(obj.ASSET_DIR / name, RAYTPU_ASSETS / name, shallow=False), name


def test_asset_search_order(tmp_path, monkeypatch):
    """raytpu's order: RAYTPU_ASSETS, the bundled assets, RAYTPU_EXTRA_ASSETS."""
    first, extra = tmp_path / "first", tmp_path / "extra"
    first.mkdir()
    extra.mkdir()
    (first / "simple_quad.obj").write_text("v 0 0 0\n")
    (extra / "only_extra.obj").write_text("v 0 0 0\n")
    monkeypatch.setenv("RAYTPU_ASSETS", str(first))
    monkeypatch.setenv("RAYTPU_EXTRA_ASSETS", str(extra))
    assert obj.resolve_asset("simple_quad.obj") == str(first / "simple_quad.obj")
    assert obj.resolve_asset("icosphere.obj") == str(obj.ASSET_DIR / "icosphere.obj")
    assert obj.resolve_asset("only_extra.obj") == str(extra / "only_extra.obj")
    monkeypatch.delenv("RAYTPU_ASSETS")
    assert obj.resolve_asset("simple_quad.obj") == str(obj.ASSET_DIR / "simple_quad.obj")
    with pytest.raises(FileNotFoundError):
        obj.resolve_asset("no_such_mesh.obj")
