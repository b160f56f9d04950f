"""The differentiable renderer: soft shadows, gradients and inverse rendering."""

from raytpu_torch.grad.diff_render import image_loss, make_train_step, render_soft  # noqa: F401
