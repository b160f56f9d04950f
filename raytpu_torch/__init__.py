"""raytpu_torch — raytpu's Whitted ray tracer ported to PyTorch and CUDA.

A second package beside ``raytpu`` (the JAX reference it is held against),
with the same layout:
  raytpu_torch.core    — math conventions, scene schema and builder, the OBJ
                         loader, scenes, the carry-across from raytpu's
                         scene arrays
  raytpu_torch.native  — the host library (OBJ parser, SAH and Morton
                         orders, the CPU BVH closest hit, the BMP writer,
                         a monotonic clock), a copy of raytpu's, built with g++
  raytpu_torch.oracle  — the scalar numpy renderer, the ground truth
  raytpu_torch.assets  — the OBJ assets (copies of raytpu's) and make_assets
  raytpu_torch.ops     — batched intersection and shading on tensors, and
                         the triangle order and cull glue (accel)
  raytpu_torch.render  — the eager renderer; the router and the hand-written
                         CUDA kernels (csrc/: K1 mega.cu, K2a/K2b mega2.cu,
                         K3/K4 packed.cu, K5/K6/K7 soft.cu, K8/K9/K10
                         chunked.cu, K11a/K11b mega3.cu, P1/P2 probes.cu)
                         with their plain versions, built by render/build.py
  raytpu_torch.grad    — the differentiable soft-shadow renderer and its
                         train step
  raytpu_torch.parallel — the (px, prim) sharded render and train step
  raytpu_torch.probes  — the measurement probes P1 (the fold loop) and P2
                         (the shared-memory copy ring)
  raytpu_torch.utils   — image IO (BMP, PNG without PIL), timers, ray stats,
                         the profiler trace, the per-stage profiler,
                         checkpoints and the NaN checks
  raytpu_torch.app     — the command line and the viewer

It imports torch, numpy and the standard library, never jax or raytpu.
Entry points run on CUDA unless the caller asks for the CPU.
"""

from raytpu_torch.core.types import (  # noqa: F401
    Camera,
    CullMode,
    LightingMode,
    LightKind,
    MaterialKind,
    RenderConfig,
    Scene,
    SceneBuilder,
)
