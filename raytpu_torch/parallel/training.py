"""The sharded inverse-rendering train step.

Counterpart of ``raytpu/parallel/training.py``.  The rays (the batch) are
split over the ``px`` ranks and the scene parameters are replicated: each
rank renders its ray block on the differentiable path
(``grad.diff_render``: on CUDA, K3's winner search and K5 in the forward,
K6 and K7 in the backward), backpropagates its share of the loss, and the
gradients are summed over ``px`` and averaged over ``prim`` before the
optimizer steps, so the parameters stay equal on every rank.  The
all-reduce runs after the backward; overlapping it with the backward, as
XLA does for raytpu, is later work.
"""

from __future__ import annotations

import dataclasses

import torch

from raytpu_torch.core.types import RenderConfig
from raytpu_torch.grad import diff_render
from raytpu_torch.parallel.sharding import Mesh, _pad_rows, all_reduce
from raytpu_torch.render import packed, renderer


def make_sharded_train_step(config: RenderConfig, optimizer: torch.optim.Optimizer, merge_fn,
                            mesh: Mesh, **kw):
    """``make_train_step`` with the rays split over ``mesh``'s px axis:
    ``step(params, scene, target) -> loss``, ``target`` the (H, W, 3)
    float32 image, the loss the whole image's mean squared error on every
    rank.  ``params``, ``optimizer`` and ``merge_fn`` are as for
    ``diff_render.make_train_step``, and ``kw`` goes to
    ``diff_render.soft_backends`` (``kernels``, ``payload_grad``)."""
    cfg = dataclasses.replace(config, soft_shadows=True)

    def step(params: dict, scene, target):
        optimizer.zero_grad(set_to_none=True)
        s = merge_fn(scene, params)
        closest_fn, soft_multi_fn = diff_render.soft_backends(s, cfg, **kw)
        ro, rd = renderer.generate_rays(s.camera, cfg)
        n = rd.shape[0]
        tgt = target.reshape(-1, 3)
        # kernels: rays and target rows in 32x32 pixel blocks, for tight cull
        # cones in each block (the loss is a masked sum: order-free)
        if soft_multi_fn is not None and cfg.height % 32 == 0 and cfg.width % 32 == 0:
            rd = packed.mega2_fold(rd, cfg.height, cfg.width)
            tgt = packed.mega2_fold(tgt, cfg.height, cfg.width)
        rd, tgt = _pad_rows(rd, mesh.px, value=1.0), _pad_rows(tgt, mesh.px)
        block = rd.shape[0] // mesh.px
        lo = mesh.px_index * block
        rd_l, tgt_l = rd[lo:lo + block], tgt[lo:lo + block]
        valid = (torch.arange(lo, lo + block, device=rd.device) < n)[:, None]
        rcfg = cfg if soft_multi_fn is None else dataclasses.replace(cfg, ray_chunk=block)
        colors = renderer.render_pixels_f32(s, ro, rd_l, rcfg, closest_fn=closest_fn,
                                            soft_multi_fn=soft_multi_fn)
        loss = torch.where(valid, (colors - tgt_l) ** 2, 0.0).sum() / (n * 3.0)
        loss.backward()
        for p in params.values():  # every rank reduces every leaf, in one order
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = all_reduce(all_reduce(g, mesh.px_group) / mesh.prim, mesh.prim_group)
        optimizer.step()
        total = all_reduce(loss.detach(), mesh.px_group)
        return all_reduce(total, mesh.prim_group) / mesh.prim

    return step
