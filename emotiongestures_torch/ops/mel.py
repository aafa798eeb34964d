"""Mel-spectrogram frontend in PyTorch, librosa-compatible.

The port of emotiongestures_tpu/ops/mel.py: the reference computes
    melspec = librosa.feature.melspectrogram(y, sr=16000, n_fft=1024,
                                             hop_length=512, power=2)
    log_melspec = librosa.power_to_db(melspec, ref=np.max).astype(float16)
with a periodic Hann window, center=True reflect padding and the Slaney
filterbank. This module holds the host-side pieces (filterbank, window, DFT
matrices, the CUDA kernel's twiddle and band tables, padding, power_to_db,
lengths); `ops/fused_mel.py` holds the power mel itself: the CUDA kernel
and its plain matmul-DFT version (frames @ cos, frames @ -sin, power,
@ filterbank), the counterpart of the JAX package's `melspectrogram_mxu`.
The fp64 numpy oracle (`_melspectrogram_np`, `_power_to_db_np`, framing) is
copied for the host data and the beat metric.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000
N_FFT = 1024
HOP = 512
N_MELS = 128


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = SR, n_fft: int = N_FFT, n_mels: int = N_MELS,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalised triangular filterbank (n_mels, 1 + n_fft // 2),
    as librosa.filters.mel(htk=False, norm='slaney'), in float64."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0, sr / 2.0, n_bins)
    mel_f = _mel_to_hz_slaney(np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float64)


def hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int = N_FFT):
    """Real DFT as two (n_fft, 1 + n_fft // 2) float32 operands: cos and
    -sin (the sign of the forward transform's imaginary part)."""
    n_bins = 1 + n_fft // 2
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def fft_twiddles(n_fft: int = N_FFT) -> np.ndarray:
    """(n_fft / 4, 2) float32 table of exp(-2 pi i k / n_fft), k < n_fft / 4,
    computed in float64: the twiddles of the CUDA mel kernel's split step,
    which takes the bins in pairs (k, n_fft / 2 - k)."""
    ang = 2.0 * np.pi * np.arange(n_fft // 4) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def stockham_twiddles() -> np.ndarray:
    """(2, 7, 64, 2) float32: the twiddles of the second and third radix-8
    Stockham passes of the CUDA mel kernel's 512-point complex FFT,
    [p, r - 1, j] = exp(-2 pi i (j % Ns) r / (8 Ns)) with Ns = 8, 64,
    computed in float64."""
    j = np.arange(64)[None, :]
    r = np.arange(1, 8)[:, None]
    ang = np.stack([2.0 * np.pi * (j % ns) * r / (8 * ns) for ns in (8, 64)])
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


def banded_filterbank(fb_t: np.ndarray):
    """The (n_bins, n_mels) filterbank as bands for the CUDA mel kernel:
    `bands` (n_mels, 4) int32 rows of (first bin, length, offset into
    `weights`, 0) and the packed float32 `weights`. Each filter's nonzeros
    must be one contiguous run of bins."""
    fb_t = np.asarray(fb_t, np.float32)
    bands, weights = [], []
    offset = 0
    for m in range(fb_t.shape[1]):
        nz = np.flatnonzero(fb_t[:, m])
        if nz.size == 0 or nz[-1] - nz[0] + 1 != nz.size:
            raise ValueError(f"filter {m} is not one contiguous run of bins")
        bands.append((nz[0], nz.size, offset, 0))
        weights.append(fb_t[nz, m])
        offset += nz.size
    return (np.asarray(bands, np.int32),
            np.concatenate(weights).astype(np.float32))


def _frame_np(y: np.ndarray, n_fft: int, hop: int, center: bool,
              pad_mode: str) -> np.ndarray:
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return y[idx]


def _melspectrogram_np(y: np.ndarray, sr: int = SR, n_fft: int = N_FFT,
                       hop: int = HOP, n_mels: int = N_MELS,
                       center: bool = True,
                       pad_mode: str = "reflect") -> np.ndarray:
    """The fp64 numpy power mel of one wave, (n_mels, n_frames): the host
    path of the synthetic dataset and of the beat metric."""
    frames = _frame_np(np.asarray(y, np.float64), n_fft, hop, center,
                       pad_mode)
    spec = np.fft.rfft(frames * hann_periodic(n_fft), axis=-1)
    power = np.abs(spec) ** 2  # (T, n_bins)
    return mel_filterbank(sr, n_fft, n_mels) @ power.T


def _power_to_db_np(S, ref=None, amin=1e-10, top_db=80.0):
    S = np.asarray(S, dtype=np.float64)
    ref_value = np.max(S) if ref is None else ref
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def pad_center(waves: torch.Tensor, n_fft: int = N_FFT,
               center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """(B, n) -> (B, n + n_fft) with librosa's center padding."""
    if not center:
        return waves
    return F.pad(waves[:, None, :], (n_fft // 2, n_fft // 2),
                 mode=pad_mode)[:, 0, :]


def n_frames_of(n_padded: int, n_fft: int = N_FFT, hop: int = HOP) -> int:
    return 1 + (n_padded - n_fft) // hop


def power_to_db(S: torch.Tensor, amin: float = 1e-10,
                top_db: float | None = 80.0) -> torch.Tensor:
    """librosa.power_to_db with ref=np.max over the whole of `S` (one clip)."""
    ref = torch.max(S)
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, torch.max(log_spec) - top_db)
    return log_spec


def batched_power_to_db(S: torch.Tensor, amin: float = 1e-10,
                        top_db: float | None = 80.0) -> torch.Tensor:
    """power_to_db per clip of a (B, ...) batch: the max is taken per clip,
    as the JAX package's vmapped frontend does."""
    dims = tuple(range(1, S.ndim))
    ref = torch.amax(S, dim=dims, keepdim=True)
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    if top_db is not None:
        log_spec = torch.maximum(
            log_spec, torch.amax(log_spec, dim=dims, keepdim=True) - top_db)
    return log_spec


def calc_spectrogram_length_from_motion_length(n_frames: int, fps: int) -> int:
    """(n / fps * 16000 - 1024) / 512 + 1: 60 frames at 15 fps -> 124."""
    return int(round((n_frames / fps * SR - N_FFT) / HOP + 1))


def make_audio_fixed_length(audio: np.ndarray,
                            expected_len: int) -> np.ndarray:
    """Pad (symmetric) or trim a wave to `expected_len` samples
    (utils/train_utils_BEAT.py:193-226)."""
    n_padding = expected_len - len(audio)
    if n_padding > 0:
        audio = np.pad(audio, (0, n_padding), mode="symmetric")
    else:
        audio = audio[:expected_len]
    return audio
