"""Wavefront OBJ loading with the reference parser's semantics.

Counterpart of ``raytpu/core/obj.py``.  The reference parser (reference:
source/Utils.h:377-451) reads only ``v`` and ``f`` records, takes the first
'/'-delimited field of each face index, converts 1-based to 0-based, and
recomputes per-face normals as ``normalize(cross(v1-v0, v2-v0))``.

``parse_obj`` uses the native parser (``raytpu_torch.native``), as raytpu
does when its library is built, so both packages give the same arrays.  The
bundled assets are the port's own (``raytpu_torch/assets``, copies of
raytpu's).
"""

from __future__ import annotations

import os
from pathlib import Path

#: the bundled assets
ASSET_DIR = Path(__file__).resolve().parent.parent / "assets"


def asset_dirs() -> list[str]:
    """Directories searched for an asset, in raytpu's order: ``RAYTPU_ASSETS``,
    then the bundled assets, then ``RAYTPU_EXTRA_ASSETS`` (read at each call)."""
    return [os.environ.get("RAYTPU_ASSETS", ""), str(ASSET_DIR),
            os.environ.get("RAYTPU_EXTRA_ASSETS", "")]


def resolve_asset(filename: str) -> str:
    """``filename`` itself if it is a file, else the first asset of that name
    in ``asset_dirs()``."""
    p = Path(filename)
    if p.is_file():
        return str(p)
    dirs = asset_dirs()
    for d in dirs:
        if d and (Path(d) / filename).is_file():
            return str(Path(d) / filename)
    raise FileNotFoundError(f"OBJ asset not found: {filename} (searched {dirs})")


def parse_obj(path: str):
    """Parse an OBJ file -> ``(positions (V,3) f32, normals (F,3) f32,
    indices (3F,) i32)`` with per-face normals, mirroring ``Utils::ParseOBJ``.

    Always the native parser: its normals are rounded by C++ float math,
    and raytpu takes it whenever its library builds; a parser rounding
    otherwise could change a normal's last bit."""
    from raytpu_torch.native import runtime

    return runtime.parse_obj(resolve_asset(path))
