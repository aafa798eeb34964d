"""PyTorch + CUDA port of emotiongestures_tpu's serving path.

wav -> mel (hand-written CUDA kernel) -> emotion CVAE prior -> gesture
generator (hand-written CUDA fused attention). The JAX package beside this
one is the reference it is tested against; this package imports none of it
and no JAX.
"""
from .core.device import resolve_device

__all__ = ["resolve_device"]
