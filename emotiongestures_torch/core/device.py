"""The port's device rule.

Every entry point runs on the CUDA card unless its caller asks for the CPU
(`device="cpu"`, or `--device cpu` on the command line). Without a card, a
call that did not ask for the CPU raises; it never carries on there quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Raise when CUDA is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: emotiongestures_torch runs on the card unless "
            "it is asked for the CPU (device='cpu', or --device cpu)")
    return dev


def fp32_exact_on_cuda() -> None:
    """Full fp32 on the card: cuDNN convolutions otherwise default to TF32
    (`torch.backends.cudnn.allow_tf32` is True), which keeps ~3 digits.
    Matmuls already default to full fp32 and are pinned so as well."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
