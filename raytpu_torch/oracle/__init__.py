"""The port's ground truth: a scalar numpy renderer (``cpu.render_oracle``)."""

from raytpu_torch.oracle.cpu import render_oracle  # noqa: F401
