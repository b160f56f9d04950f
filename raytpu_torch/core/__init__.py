from raytpu_torch.core import convert, math3d, scenes, types  # noqa: F401
