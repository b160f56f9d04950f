"""K4's time on one CUDA card with parts of its design taken out: what each
part of the shadow walk (raytpu_torch/render/csrc/shadow.cuh) buys.

    python3 shadow_ablation.py       # prints one JSON line

Each variant is packed.cu built with one change to shadow.cuh or
packed.cu (nvcc, the package's flags, one library per variant under
raytpu_torch/_build/ablation, all compiled at once).  K4 runs on the shadow
queries of frame 0 of bunny50k and bunny300k at 640x480, as chip_smoke.py
phase 4 forms them, timed with CUDA events (REPEATS runs of ITERS launches);
each variant's (L, R) answer must equal the design's:

  design        the kernel as committed;
  no_bundle     no test of the warp's bundle: every listed entry goes to
                each ray's box test;
  no_ray_box    no per-ray box test: a warp runs a group's triangles for
                every live lane wherever the bundle test passes;
  no_boxes      neither test: every listed triangle, with the warp-granular
                exit, 128-thread blocks and 8x4 pixel warps kept;
  no_warp_exit  a warp walks its whole row even when every lane is resolved;
  rows          each warp takes a row of 32 pixels, not an 8x4 block;
  block1024     one 1024-thread block per (tile, light), not eight of 128.

The variants are replacements of exact lines of the committed shadow.cuh
and packed.cu: the script raises when one of those lines has changed, and
the variants must then be restated against the new sources.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
REPEATS, ITERS = 3, 5
SCENES = ("bunny50k", "bunny300k")
RAY_BOX = "const bool pass = live && seg_box(bj, o, inv, mag);"
#: variant -> [(file, text in the design, text in the variant)]
VARIANTS = {
    "design": [],
    "no_bundle": [("shadow.cuh", "cand = bundle_box(q, b);", "cand = true;")],
    "no_ray_box": [("shadow.cuh", RAY_BOX, "const bool pass = live;")],
    "no_boxes": [("shadow.cuh", "cand = bundle_box(q, b);", "cand = true;"),
                 ("shadow.cuh", RAY_BOX, "const bool pass = live;")],
    "no_warp_exit": [("shadow.cuh", "if (__all_sync(kFullWarp, !live)) return occ;", "")],
    "rows": [("shadow.cuh", "return ((warp / 4) * 4 + lane / 8) * 32 + (warp % 4) * 8 + lane % 8;",
              "return warp * 32 + lane;")],
    "block1024": [("packed.cu", "constexpr int kBlock = 128;", "constexpr int kBlock = 1024;"),
                  ("packed.cu", "__launch_bounds__(kBlock, 4) packed_anyhit_kernel",
                   "__launch_bounds__(kBlock, 1) packed_anyhit_kernel")],
}


def build_variants(out: Path) -> dict:
    """{variant: library path}, every variant compiled at once."""
    from raytpu_torch.render import build

    csrc = REPO / "raytpu_torch" / "render" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for name, patches in VARIANTS.items():
        src = out / name
        src.mkdir(parents=True)
        for f in ("common.cuh", "shadow.cuh", "packed.cu"):
            shutil.copy(csrc / f, src / f)
        for f, old, new in patches:
            text = (src / f).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {f} no longer holds {old!r}")
            (src / f).write_text(text.replace(old, new))
        lib = src / "libk4.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", str(src / "packed.cu"), "-o",
             str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        entry = next(i for i, ln in enumerate(lines) if "Compiling entry" in ln and "anyhit" in ln)
        libs[name] = (lib, next(ln.strip() for ln in lines[entry:] if "registers" in ln))
    return libs


def k4_inputs(scene, cfg):
    """K4's arguments on the scene's frame 0, as chip_smoke.py phase 4."""
    from raytpu_torch.ops import accel
    from raytpu_torch.render import packed, renderer

    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    ro = ro.expand_as(rd).contiguous()
    t, _, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, cfg.ray_min)
    rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
    p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    glo, ghi, boxes = accel.group_boxes(scene.triangles)
    wl, cnt = packed.shadow_worklists(scene, p, dirs, mags, cfg.ray_min, group_bounds=(glo, ghi))
    return p, dirs, mags, packed.soft_packs(scene), boxes, wl, cnt


def main() -> int:
    import torch

    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import build
    from raytpu_torch.utils.profiling import device_ms

    if not torch.cuda.is_available():
        print("shadow_ablation: this needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = build_variants(build.BUILD_DIR / "ablation")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = RenderConfig()
    out = {"card": smi, "k4_registers": {n: r for n, (_, r) in libs.items()}, "ms": {}}
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fns = {}
    for name, (lib, _) in libs.items():
        fn = ctypes.CDLL(str(lib)).raytpu_packed_anyhit
        fn.argtypes = [c_ptr, c_ptr, c_ptr, c_int, c_int, c_ptr, c_int, c_ptr, c_int, c_ptr,
                       c_int, c_ptr, c_ptr, c_ptr, c_int, c_float, c_ptr, c_ptr]
        fn.restype = c_int
        fns[name] = fn
    for scene_name in SCENES:
        p, dirs, mags, (sph, pln, tri), boxes, wl, cnt = k4_inputs(scenes.get(scene_name).build(dev),
                                                                   cfg)
        L, R = dirs.shape[:2]
        answers, ms = {}, {}
        for name, fn in fns.items():
            occ = torch.empty((L, R), dtype=torch.uint8, device=dev)

            def launch():
                err = fn(p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(),
                         sph.shape[0], pln.data_ptr(), pln.shape[0], tri.data_ptr(), tri.shape[0],
                         boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(), wl.shape[-1],
                         float(cfg.ray_min), occ.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")

            launch()
            torch.cuda.synchronize()
            answers[name] = occ.clone()
            ms[name] = sorted(device_ms(launch, iters=ITERS, warmup=1) for _ in range(REPEATS))
        for name, occ in answers.items():
            differ = int((occ != answers["design"]).sum())
            if differ:
                raise AssertionError(f"{scene_name} {name}: {differ} pairs differ from the design")
        out["ms"][scene_name] = {n: {"median": v[len(v) // 2], "min": v[0], "max": v[-1]}
                                 for n, v in ms.items()}
    out["answers_equal_to_design"] = True
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
