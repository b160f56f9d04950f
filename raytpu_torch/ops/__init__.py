from raytpu_torch.ops import intersect, shading  # noqa: F401
