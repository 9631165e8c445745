"""beta_recsys_tpu_torch — the PyTorch/CUDA port of beta_recsys_tpu.

The JAX package beside it is the reference. This package mirrors its layout
(config/, data/, datasets/, models/, ops/, core/, recommenders/) in PyTorch
idiom and imports torch, numpy, scipy and the standard library only. Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .device import resolve_device

__all__ = ["resolve_device"]
