"""Reference quirks that the baseline families share, kept on purpose
(port of emotiongestures_tpu/models/baselines/quirks.py)."""
from __future__ import annotations

import torch.nn as nn


def leaky_relu_true(x):
    """The reference writes ``nn.LeakyReLU(True)`` at 17 sites, meaning
    ``inplace=True``; LeakyReLU's first positional parameter is
    ``negative_slope``, so the slope is 1.0 and the activation is the
    identity. Kept for weight parity with the reference and the JAX package.
    Sites: model/embedding_net.py:57,60,149,185,192; model/motion_ae.py:48,
    51,83,90; model/multimodal_context_net.py:118,235,238; and the
    Full_model/embedding_net.py copy."""
    return x


class LeakyReLUTrue(nn.Module):
    """`leaky_relu_true` as a module, for the reference's Sequentials."""

    def forward(self, x):
        return leaky_relu_true(x)
