"""``render_image`` / ``render_image_f32`` route like raytpu's Pallas entry
points: the megakernel for scenes of <= 72 primitives and <= 8 lights.  The
eager path is ``raytpu_torch.render.renderer``."""

from raytpu_torch.render.cuda_kernel import render_image, render_image_f32  # noqa: F401
from raytpu_torch.render.renderer import generate_rays, render_image_ssaa  # noqa: F401
