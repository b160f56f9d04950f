from raytpu_torch.utils import image, profiling  # noqa: F401
