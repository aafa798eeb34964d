"""Power mel spectrogram: the CUDA kernel `csrc/mel.cu`, its plain PyTorch
version, and the frontend functions built on them.

Replaces the TPU kernel emotiongestures_tpu/ops/pallas_mel.py::_mel_kernel
(driven there by melspectrogram_pallas, batched_melspectrogram_pallas and
extract_melspectrogram_pallas). The function is bound by memory on an H100
(~0.1 ms at the serving batch of 1024 four-second clips: 0.27 GB of padded
waves in, 0.07 GB of mel out). The kernel computes it with a real FFT in
shared memory (a 512-point complex FFT in three radix-8 passes and a split
step) and a banded filterbank, one block per tile of 8 frames of one clip;
the header of `csrc/mel.cu` gives the design. The TPU kernel's DFT as
two dense GEMMs stays only in the plain version, the counterpart of the JAX
package's `melspectrogram_mxu`.

`mel_power` is the wrapper: for a CPU tensor it takes `mel_power_plain`; for
a CUDA tensor it launches the kernel or raises. `launches` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.device import resolve_device
from . import cuda_lib
from .mel import (HOP, N_FFT, N_MELS, SR, banded_filterbank,
                  batched_power_to_db, dft_matrices, fft_twiddles,
                  hann_periodic, mel_filterbank, n_frames_of, pad_center,
                  power_to_db, stockham_twiddles)

launches = 0

_consts: dict = {}


def _operands(device: torch.device):
    """Constants on `device`: the window; for the plain version the DFT
    matrices and the transposed filterbank; for the kernel the twiddle
    tables and the banded filterbank."""
    key = str(device)
    if key not in _consts:
        cos_m, sin_m = dft_matrices(N_FFT)
        fb = mel_filterbank(SR, N_FFT, N_MELS).T.astype(np.float32)
        bands, band_w = banded_filterbank(fb)
        t = {
            "win": torch.tensor(hann_periodic(N_FFT).astype(np.float32)),
            "cos": torch.from_numpy(cos_m),
            "sin": torch.from_numpy(sin_m),
            "fb": torch.from_numpy(np.ascontiguousarray(fb)),
            "tw": torch.from_numpy(fft_twiddles(N_FFT)),
            "ptw": torch.from_numpy(stockham_twiddles()),
            "bands": torch.from_numpy(bands),
            "band_w": torch.from_numpy(band_w),
        }
        _consts[key] = {k: v.to(device) for k, v in t.items()}
    return _consts[key]


def mel_power_plain(padded: torch.Tensor, n_frames: int,
                    hop: int = HOP) -> torch.Tensor:
    """(B, S) reflect-padded waves -> (B, n_frames, 128) power mel, fp32:
    frames x hann, @ cos and @ -sin, re^2 + im^2, @ filterbank."""
    ops = _operands(padded.device)
    frames = padded.float().unfold(-1, N_FFT, hop)[:, :n_frames]
    x = frames * ops["win"]
    re = x @ ops["cos"]
    im = x @ ops["sin"]
    return (re * re + im * im) @ ops["fb"]


def mel_power(padded: torch.Tensor, n_frames: int,
              hop: int = HOP) -> torch.Tensor:
    """The kernel's wrapper; same contract as `mel_power_plain`."""
    global launches
    if padded.device.type == "cpu":
        return mel_power_plain(padded, n_frames, hop)
    if padded.device.type != "cuda":
        raise RuntimeError(f"mel_power: no kernel for {padded.device}")
    if padded.dtype != torch.float32 or padded.ndim != 2:
        raise ValueError("mel_power: expects (B, S) float32 waves, got "
                         f"{tuple(padded.shape)} {padded.dtype}")
    B, S = padded.shape
    if n_frames < 1 or (n_frames - 1) * hop + N_FFT > S:
        raise ValueError(f"mel_power: {n_frames} frames of {N_FFT} at hop "
                         f"{hop} do not fit in {S} samples")
    if hop < 4 or hop > N_FFT or hop % 4:
        raise ValueError(f"mel_power: the kernel takes a hop that is a "
                         f"multiple of 4 from 4 to {N_FFT}, got {hop}")
    if not padded.is_contiguous() or S % 4 or padded.data_ptr() % 16:
        # rows of the kernel's input start 16-byte aligned
        buf = torch.zeros(B, (S + 3) // 4 * 4, device=padded.device)
        buf[:, :S] = padded
        padded = buf
    ops = _operands(padded.device)
    out = torch.empty(B * n_frames, N_MELS, device=padded.device)
    lib = cuda_lib.load("mel")
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    p = ctypes.c_void_p
    code = lib.eg_mel(
        p(padded.data_ptr()), padded.stride(0), B, n_frames, hop,
        p(ops["win"].data_ptr()), p(ops["tw"].data_ptr()),
        p(ops["ptw"].data_ptr()), p(ops["bands"].data_ptr()),
        p(ops["band_w"].data_ptr()), p(out.data_ptr()), p(stream))
    cuda_lib.check_launch(code, "mel kernel")
    launches += 1
    return out.view(B, n_frames, N_MELS)


def _waves(y, device) -> torch.Tensor:
    if isinstance(y, torch.Tensor):
        return y.float()
    return torch.as_tensor(np.asarray(y, np.float32),
                           device=resolve_device(device))


def batched_melspectrogram(waves, use_kernel: bool = True,
                           device=None) -> torch.Tensor:
    """(B, n) waves -> (B, 128, n_frames) power mel. All clips' frames go
    through one kernel launch. A tensor stays on its device; a numpy array
    goes to `device` (the card unless the CPU is asked for)."""
    w = _waves(waves, device)
    padded = pad_center(w)
    n_frames = n_frames_of(padded.shape[-1])
    fn = mel_power if use_kernel else mel_power_plain
    return fn(padded, n_frames).transpose(1, 2)


def melspectrogram(y, use_kernel: bool = True, device=None) -> torch.Tensor:
    """(n,) wave -> (128, n_frames) power mel."""
    return batched_melspectrogram(_waves(y, device)[None], use_kernel)[0]


def extract_melspectrogram(y, use_kernel: bool = True,
                           device=None) -> torch.Tensor:
    """The reference pipeline: power mel -> power_to_db(ref=max) ->
    float16, (128, n_frames)."""
    return power_to_db(melspectrogram(y, use_kernel, device)).half()


def batched_log_melspectrogram(waves, use_kernel: bool = True,
                               device=None) -> torch.Tensor:
    """(B, n) -> (B, 128, n_frames) log-mel in fp32, power_to_db per clip."""
    return batched_power_to_db(batched_melspectrogram(waves, use_kernel,
                                                      device))
