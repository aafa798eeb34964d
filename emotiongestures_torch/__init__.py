"""PyTorch + CUDA port of emotiongestures_tpu: its serving path and its
diversity evaluation.

wav -> mel (hand-written CUDA kernel) -> emotion CVAE prior -> gesture
generator (hand-written CUDA fused attention), and the eval CLI around it
(FGD autoencoder, skeleton classifier, host metrics, beat alignment). The
fused SE-ResNet stage kernel stands beside the audio encoder's stage-3 tail.
The JAX package beside this one is the reference it is tested against; this
package imports none of it and no JAX.
"""
from .core.device import resolve_device

__all__ = ["resolve_device"]
