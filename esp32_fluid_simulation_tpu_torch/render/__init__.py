from .upscale import upscale_bilinear, pack_rgb565, render_rgb565, render_rgb8
from .smoke import heat_colormap, render_smoke

__all__ = ["upscale_bilinear", "pack_rgb565", "render_rgb565", "render_rgb8",
           "heat_colormap", "render_smoke"]
