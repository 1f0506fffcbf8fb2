from .upscale import upscale_bilinear, pack_rgb565, render_rgb565, render_rgb8

__all__ = ["upscale_bilinear", "pack_rgb565", "render_rgb565", "render_rgb8"]
