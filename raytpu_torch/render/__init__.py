"""``render_image`` / ``render_image_f32`` route like raytpu's Pallas entry
points: K1 (``csrc/mega.cu``) for scenes of <= 72 primitives and <= 8
lights, K2a + K2b (``mega2.py``) up to 9,600 triangles, K3 + K4
(``packed.py``) up to 1M, K8 + K10 (``chunked.py``) past their sphere, plane
and light caps up to 32,768 triangles.  The eager path is
``raytpu_torch.render.renderer``."""

from raytpu_torch.render.cuda_kernel import render_image, render_image_f32  # noqa: F401
from raytpu_torch.render.renderer import generate_rays, render_image_ssaa  # noqa: F401
