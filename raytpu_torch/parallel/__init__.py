"""Pixel x primitive sharding over ``torch.distributed`` (counterpart of
``raytpu/parallel``)."""

from raytpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    render_image_sharded,
    render_pixels_sharded,
)
