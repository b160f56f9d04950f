"""Multi-process execution: the worker body and a launcher that spawns it.

Counterpart of ``raytpu/parallel/launch.py``.  Every worker joins one
``torch.distributed`` group (``multihost.initialize``, gloo, TCP on
localhost), then runs a list of cases, each on its own (px, prim) mesh of
all the ranks:

  * a render case renders a scene sharded (``sharding.render_image_sharded``)
    and holds it against the same rank's single-process render, pixel for
    pixel (``"ref"``: the routed, eager, or one-rank sharded render, or a
    fused kind's); ``"lights"`` appends white point lights at the given
    positions to the registry scene;
  * a train case takes one sharded SGD step (``training.
    make_sharded_train_step``) and one single-process step
    (``diff_render.make_train_step``) from the same parameters.

With two ranks the default cases put px across the processes (the image
gather and the gradient all-reduce cross them) and then prim (the
closest-hit merge's all-gather crosses them), as raytpu's two layouts do
(raytpu/parallel/launch.py:115-125).  Each rank writes
``result_p<rank>.json`` and, per case, its image or parameters as ``.npy``
into ``--outdir``; the kernels' launches during each sharded call are in
the result.

  worker:    python -m raytpu_torch.parallel.launch --rank I --world-size N
             --init-method tcp://127.0.0.1:PORT --outdir DIR [--device cpu]
  launcher:  python -m raytpu_torch.parallel.launch --spawn N --outdir DIR
             (spawns N workers on this host, waits, raises if one dies)
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

from raytpu_torch.render import launch_counts

#: raytpu's worker: reference at 64x48 on both layouts, one material step
#: at 32x24 (raytpu/parallel/launch.py:68)
DEFAULT_CASES = (
    {"name": "pod", "scene": "reference", "size": [64, 48], "mesh": "px"},
    {"name": "xprim", "scene": "reference", "size": [64, 48], "mesh": "prim"},
    {"name": "train", "scene": "reference", "size": [32, 24], "mesh": "px", "train": "material"},
)


def _mesh_shape(spec: str, world: int):
    """"px": every rank on the px axis, (world, 1); "prim": (1, world)."""
    return {"px": (world, 1), "prim": (1, world)}[spec]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _delta(before: dict) -> dict:
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _render_case(case, scene, cfg, mesh, device):
    """The sharded image, the single-process one, and the sharded call's
    launches and seconds."""
    from raytpu_torch.core import math3d
    from raytpu_torch.parallel import sharding
    from raytpu_torch.render import cuda_kernel, renderer

    kind = case.get("kind")
    if kind:  # a fused kind by name (raytpu's gated sharded_px_fused_mega3)
        def render():
            return math3d.quantize_u8(sharding._render_fused_px(scene, cfg, mesh, kind))
    else:
        def render():
            return sharding.render_image_sharded(scene, cfg, mesh)
    render()  # warm-up: the kernels built, the caches filled
    _sync(device)
    before = launch_counts()
    t0 = time.perf_counter()
    img = render()
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = _delta(before)
    ref_kind = case.get("ref") or kind or ("route" if mesh.prim == 1 else "eager")
    if ref_kind == "route":
        ref = cuda_kernel.render_image(scene, cfg)
    elif ref_kind == "eager":
        ref = renderer.render_image(scene, cfg)
    elif ref_kind == "single":  # the sharded path's own hooks on one rank
        ref = sharding.render_image_sharded(scene, cfg, sharding.Mesh(1, 1))
    else:
        ref = math3d.quantize_u8(sharding._FUSED[ref_kind](scene, cfg))
    img, ref = img.cpu().numpy(), ref.cpu().numpy()
    return img, {"reference": ref_kind, "identical": bool((img == ref).all()),
                 "pixels_differ": int((img != ref).any(axis=-1).sum()), "launches": launches,
                 "seconds": seconds}


def _train_case(case, scene, cfg, mesh, device):
    """One sharded SGD step (learning rate 1e-2, raytpu's) and one
    single-process step from the same parameters, to a black target:
    losses, parameter changes, launches."""
    import torch

    from raytpu_torch.grad import diff_render as dr
    from raytpu_torch.parallel.training import make_sharded_train_step

    pick = getattr(dr, f"{case['train']}_params")
    merge = getattr(dr, f"merge_{case['train']}_params")
    target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=device)
    lr = 1e-2
    p0 = {k: v.detach().clone() for k, v in pick(scene).items()}
    params = dr.trainable(p0)
    step = make_sharded_train_step(cfg, torch.optim.SGD(params.values(), lr=lr), merge, mesh)
    _sync(device)
    before = launch_counts()
    t0 = time.perf_counter()
    loss = float(step(params, scene, target))
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = _delta(before)
    single = dr.trainable(p0)
    step1 = dr.make_train_step(cfg, torch.optim.SGD(single.values(), lr=lr), merge)
    loss1 = float(step1(single, scene, target))
    deltas = {k: (params[k] - p0[k]).detach().cpu().numpy() for k in params}
    deltas1 = {k: (single[k] - p0[k]).detach().cpu().numpy() for k in single}
    worst = max(float(np.abs(deltas[k] - deltas1[k]).max()
                      / (np.abs(deltas1[k]).max(initial=0.0) + 1e-12)) for k in deltas)
    return deltas, {"loss_sharded": loss, "loss_single": loss1, "launches": launches,
                    "seconds": seconds, "delta_diff_over_largest": worst,
                    "params_equal_on_ranks": None}


def run_worker(rank: int, world_size: int, init_method: str, outdir: str, device: str = "cuda",
               cases=DEFAULT_CASES) -> dict:
    """The worker body: join the group, run every case, write the result."""
    import torch
    import torch.distributed as dist

    from raytpu_torch.core import convert, scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.parallel import multihost, sharding

    if device == "cpu":
        torch.set_num_threads(1)
    multihost.initialize(init_method, world_size, rank)  # one rank: no group
    world = dist.group.WORLD if dist.is_initialized() else None
    assert (dist.get_world_size() if world else 1) == world_size
    dev = torch.device(device)
    built = {}
    result = {"rank": rank, "world_size": world_size, "device": str(dev),
              "backend": dist.get_backend() if world else None, "cases": {}}
    for case in cases:
        px, prim = _mesh_shape(case["mesh"], world_size)
        mesh = sharding.make_mesh(px=px, prim=prim)
        key = (case["scene"], json.dumps(case.get("lights")))
        if key not in built:
            built[key] = scenes.get(case["scene"]).build(device)
            if case.get("lights"):
                built[key] = convert.with_point_lights(built[key], case["lights"])
        scene = built[key]
        cfg = RenderConfig(width=case["size"][0], height=case["size"][1])
        run = _train_case if case.get("train") else _render_case
        out, res = run(case, scene, cfg, mesh, dev)
        res["mesh"] = mesh.shape
        if case.get("train"):
            # every rank's parameter changes, gathered: equal on every rank
            flat = torch.cat([torch.as_tensor(v).reshape(-1) for v in out.values()])
            every = sharding.all_gather(flat, world, world_size)
            res["params_equal_on_ranks"] = bool((every == every[0]).all())
            np.savez(os.path.join(outdir, f"{case['name']}_p{rank}.npz"), **out)
        else:
            np.save(os.path.join(outdir, f"{case['name']}_p{rank}.npy"), out)
        result["cases"][case["name"]] = res
    with open(os.path.join(outdir, f"result_p{rank}.json"), "w") as f:
        json.dump(result, f)
    if world:
        dist.barrier()
        dist.destroy_process_group()
    return result


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(num_processes: int, outdir: str, device: str = "cuda", cases=None,
          timeout: float = 600.0) -> list:
    """Start ``num_processes`` workers on this host, wait for all of them and
    return their results.  Raises as soon as one fails, with its log's tail,
    or when the time is up; kills the others either way."""
    os.makedirs(outdir, exist_ok=True)
    init = f"tcp://127.0.0.1:{free_port()}"
    procs, logs = [], []
    for rank in range(num_processes):
        cmd = [sys.executable, "-m", "raytpu_torch.parallel.launch", "--rank", str(rank),
               "--world-size", str(num_processes), "--init-method", init, "--outdir", outdir,
               "--device", device]
        if cases is not None:
            cmd += ["--cases", json.dumps(list(cases))]
        # a log file, not a pipe: a chatty worker must not block on a full
        # pipe while its siblings wait in a collective
        logs.append(os.path.join(outdir, f"worker_p{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    try:
        while True:
            rcs = [p.poll() for p in procs]
            for rank, rc in enumerate(rcs):
                if rc not in (None, 0):
                    with open(logs[rank]) as f:
                        tail = "\n".join(f.read().strip().splitlines()[-15:])
                    raise RuntimeError(f"worker {rank} failed (rc={rc}):\n{tail}")
            if all(rc == 0 for rc in rcs):
                break
            if time.time() > deadline:
                stuck = [r for r, rc in enumerate(rcs) if rc is None]
                raise RuntimeError(f"workers {stuck} timed out after {timeout}s (logs: {logs})")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank in range(num_processes):
        with open(os.path.join(outdir, f"result_p{rank}.json")) as f:
            results.append(json.load(f))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytpu_torch.parallel.launch")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world-size", type=int, default=2)
    p.add_argument("--init-method", default=None, help="e.g. tcp://127.0.0.1:29500")
    p.add_argument("--outdir", default="raytpu_torch_ranks")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--cases", default=None, help="the cases as a JSON list (default: raytpu's)")
    p.add_argument("--spawn", type=int, default=0,
                   help="launcher mode: spawn N workers on this host and wait")
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    cases = DEFAULT_CASES if args.cases is None else json.loads(args.cases)
    if args.spawn:
        results = spawn(args.spawn, args.outdir, args.device, cases, args.timeout)
        print(json.dumps(results, indent=1))
        ok = all(c.get("identical", True) and c.get("params_equal_on_ranks", True) is not False
                 for r in results for c in r["cases"].values())
        return 0 if ok else 1
    if args.rank is None or args.init_method is None:
        p.error("a worker needs --rank and --init-method (or use --spawn N)")
    os.makedirs(args.outdir, exist_ok=True)
    print(json.dumps(run_worker(args.rank, args.world_size, args.init_method, args.outdir,
                                args.device, cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
