"""raytpu_torch — raytpu's Whitted ray tracer ported to PyTorch and CUDA.

A second package beside ``raytpu`` (the JAX reference it is held against),
with the same layout:
  raytpu_torch.core    — math conventions, scene schema and builder, scenes,
                         the carry-across from raytpu's scene arrays
  raytpu_torch.ops     — batched intersection and shading on tensors
  raytpu_torch.render  — the eager renderer; the router and the hand-written
                         CUDA megakernel (csrc/mega.cu), built by render/build.py
  raytpu_torch.utils   — image IO (BMP, PNG without PIL), timers and ray stats
  raytpu_torch.app     — the command line

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
