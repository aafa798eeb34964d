"""PyTorch + CUDA port of emotiongestures_tpu: its serving path, its
diversity evaluation and its GAN trainer.

wav -> mel (hand-written CUDA kernel) -> emotion CVAE prior -> gesture
generator (hand-written CUDA fused attention), and the eval CLI around it
(FGD autoencoder, skeleton classifier, host metrics, beat alignment). The
fused SE-ResNet stage kernel stands beside the audio encoder's stage-3 tail.
The port trains as well as serves: `train/gan.py` and
`cli/train_emotion_gesture.py` train the generator against the motion
discriminator with Adam on the staged LR, in fp32 or with a bf16 copy of
fp32 master weights, with checkpoints and resume. In train mode BatchNorm
follows flax, not torch: the batch's biased variance normalises and goes
into the running statistics, with momentum 0.9 on the old value.
The JAX package beside this one is the reference it is tested against; this
package imports none of it and no JAX.
"""
from .core.device import resolve_device

__all__ = ["resolve_device"]
