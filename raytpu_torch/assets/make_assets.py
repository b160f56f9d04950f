"""Write the procedural OBJ assets: simple_quad, simple_cube, icosphere.

Counterpart of ``raytpu/assets/make_assets.py``; the files it writes are
byte-identical to the ones bundled beside it.  The course meshes
(lowpoly_bunny2, Assignment3D1, simple_object) are bundled as they are.

    python -m raytpu_torch.assets.make_assets [--out DIR]

``--out`` defaults to this package's directory.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent


def _write(out: Path, name: str, verts, faces):
    lines = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts]
    lines += [f"f {f[0]+1} {f[1]+1} {f[2]+1}" for f in faces]
    (out / name).write_text("\n".join(lines) + "\n")
    print(f"{name}: {len(verts)} verts, {len(faces)} faces")


def quad(out: Path = OUT):
    v = [(-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1)]
    f = [(0, 1, 2), (0, 2, 3)]
    _write(out, "simple_quad.obj", v, f)


def cube(out: Path = OUT):
    v = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    f = [
        (0, 1, 3), (0, 3, 2),  # -x
        (4, 6, 7), (4, 7, 5),  # +x
        (0, 4, 5), (0, 5, 1),  # -y
        (2, 3, 7), (2, 7, 6),  # +y
        (0, 2, 6), (0, 6, 4),  # -z
        (1, 5, 7), (1, 7, 3),  # +z
    ]
    _write(out, "simple_cube.obj", v, f)


def icosphere(out: Path = OUT, subdiv=2, name="icosphere.obj"):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
         (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
         (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
        float,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [tuple(x) for x in v]
    faces = list(f)
    cache = {}

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(verts[a]) + np.asarray(verts[b])
            m /= np.linalg.norm(m)
            verts.append(tuple(m))
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        nf = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = nf
    _write(out, name, verts, faces)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(OUT), help="directory to write into")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    quad(out)
    cube(out)
    icosphere(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
