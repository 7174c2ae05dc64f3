from . import camera, cuda_sampler
from .raster import Overlay, render, render_batch_banked

__all__ = ["camera", "cuda_sampler", "render", "render_batch_banked",
           "Overlay"]
