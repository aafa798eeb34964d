"""Beat-alignment metric (model/Beat_score_v2.py:51-197) with a
self-owned, librosa-equivalent onset stack (librosa is not a dependency;
SURVEY.md §2.6 row 'librosa mel/onset').

Pipeline per clip (BeatAligner.load_audio):
  onset_strength : mel spectral flux — n_fft=2048, hop=512, 128 mels,
                   dB, positive first difference, mean over mels,
                   centered like librosa (lag + n_fft//(2*hop) shift)
  onset_detect   : peak_pick with librosa's default windows scaled by
                   sr/hop (pre_max 0.03s, pre_avg/post_avg 0.1s,
                   wait 0.03s, delta 0.07 on a max-normalised envelope)
  onset_backtrack: roll each onset to the preceding local minimum
  rms            : frame RMS from the STFT (scale-free for backtracking)

Pose side (load_pose): 8 limb groups from 6-d rotation slices
[18:42] and [150:174], velocity-norm local minima (order=2), exactly the
reference's slicing (Beat_score_v2.py:102-127 — including its quirk of
windowing only the right-side beats by [t_start, t_end]).

Score: GAHR soft recall exp(-d^2 / 2 sigma^2), averaged over
3 onset variants x 8 limbs / 24 (Beat_score_v2.py:182-193).

A copy of emotiongestures_tpu/eval/beat.py: the host stack and BeatAligner
as they are (numpy/scipy), and `batched_onset_frontend` in torch on the
batch's device (the JAX package computes it with XLA matmuls outside any
Pallas kernel; here the DFT is torch.matmul).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import maximum_filter1d
from scipy.signal import argrelextrema

from ..core.device import resolve_device
from ..ops import mel as M

HOP = 512
N_FFT_ONSET = 2048
SR = 16000


def onset_strength(y: np.ndarray, sr: int = SR) -> np.ndarray:
    """Mel spectral flux, librosa.onset.onset_strength-equivalent."""
    S = M._melspectrogram_np(y, sr=sr, n_fft=N_FFT_ONSET, hop=HOP,
                             n_mels=128)
    S_db = M._power_to_db_np(S, top_db=None)
    lag = 1
    diff = S_db[:, lag:] - S_db[:, :-lag]
    env = np.maximum(0.0, diff).mean(axis=0)
    # librosa pads (lag + n_fft // (2 * hop)) zeros at the start and trims
    # to the original frame count so envelope frames align with time 0
    pad = lag + N_FFT_ONSET // (2 * HOP)
    env = np.concatenate([np.zeros(pad), env])[: S_db.shape[1]]
    return env


def peak_pick(x: np.ndarray, pre_max: int, post_max: int, pre_avg: int,
              post_avg: int, delta: float, wait: int) -> np.ndarray:
    """librosa.util.peak_pick-equivalent greedy peak detector."""
    if len(x) == 0:
        return np.array([], dtype=int)
    max_length = pre_max + post_max
    max_origin = int(np.ceil(0.5 * (pre_max - post_max)))
    mov_max = maximum_filter1d(x, max(max_length, 1), mode="constant",
                               origin=max_origin, cval=-np.inf)
    avg_length = pre_avg + post_avg
    if avg_length > 0:
        # librosa's exact windowed mean with shrinking edges, vectorised
        # via a prefix sum: mean over x[max(0,i-pre_avg):min(n,i+post_avg)]
        n = len(x)
        csum = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
        i = np.arange(n)
        lo = np.maximum(0, i - pre_avg)
        hi = np.minimum(n, i + post_avg)
        width = hi - lo
        mov_avg = np.where(
            width > 0,
            (csum[hi] - csum[lo]) / np.maximum(width, 1),
            x,
        )
    else:
        mov_avg = x.copy()
    peaks = []
    last = -1 - wait
    for i in range(len(x)):
        if x[i] != mov_max[i]:
            continue
        if x[i] < mov_avg[i] + delta:
            continue
        if i - last <= wait:
            continue
        peaks.append(i)
        last = i
    return np.asarray(peaks, dtype=int)


def onset_detect(onset_envelope: np.ndarray, sr: int = SR,
                 hop_length: int = HOP) -> np.ndarray:
    """librosa.onset.onset_detect(backtrack=False)-equivalent."""
    env = onset_envelope.astype(np.float64)
    if env.max() > 0:
        env = env / env.max()  # librosa normalize=True
    return peak_pick(
        env,
        pre_max=int(0.03 * sr // hop_length),
        post_max=int(0.00 * sr // hop_length + 1),
        pre_avg=int(0.10 * sr // hop_length),
        post_avg=int(0.10 * sr // hop_length + 1),
        delta=0.07,
        wait=int(0.03 * sr // hop_length),
    )


def onset_backtrack(events: np.ndarray, energy: np.ndarray) -> np.ndarray:
    """Roll each detected onset back to the preceding energy minimum
    (librosa.onset.onset_backtrack-equivalent)."""
    if len(events) == 0:
        return events
    minima = np.flatnonzero(
        (energy[1:-1] <= energy[:-2]) & (energy[1:-1] < energy[2:])
    ) + 1
    minima = np.concatenate([[0], minima])
    # for each event, the largest minimum <= event
    idx = np.searchsorted(minima, events, side="right") - 1
    return minima[np.maximum(idx, 0)]


def stft_rms(y: np.ndarray, n_fft: int = N_FFT_ONSET,
             hop: int = HOP) -> np.ndarray:
    """Frame RMS from the magnitude STFT (librosa.feature.rms(S=|S|))."""
    frames = M._frame_np(np.asarray(y, np.float64), n_fft, hop, True,
                         "reflect")
    win = M.hann_periodic(n_fft)
    spec = np.abs(np.fft.rfft(frames * win, axis=-1)) ** 2
    spec[:, 0] *= 0.5
    spec[:, -1] *= 0.5
    power = 2.0 * spec.sum(axis=1) / n_fft**2
    return np.sqrt(power)


def frames_to_time(frames, sr: int = SR, hop_length: int = HOP):
    return np.asarray(frames) * hop_length / sr


# ---------------------------------------------------------------------------
# Batched frontend on the card: every clip's onset envelope and frame RMS in
# one pass (shared DFT matmuls); only the sequential peak-pick stays on the
# host.
# ---------------------------------------------------------------------------


def batched_onset_frontend(waves, device=None):
    """(B, n) waves -> (env (B, T), rms (B, T)) fp64 numpy arrays, computed
    in one pass on `device` (the card unless the CPU is asked for).

    The DFT runs in fp32, so spectrally sparse signals (pure tones) whose
    true mel power sits below the fp32 noise floor (~1e-9 of peak) read
    that floor instead of fp64's clamped 1e-10, and their onsets can differ
    from the fp64 host path; broadband signals (speech) give the same onsets
    (tests/test_golden_audio.py holds the JAX frontend to that)."""
    dev = resolve_device(device)
    w = torch.as_tensor(np.ascontiguousarray(waves, dtype=np.float32),
                        device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cos_m, sin_m = M.dft_matrices(N_FFT_ONSET)
    win = torch.as_tensor(M.hann_periodic(N_FFT_ONSET), **f32)
    fb = torch.as_tensor(M.mel_filterbank(SR, N_FFT_ONSET, 128), **f32)
    half = N_FFT_ONSET // 2
    padded = F.pad(w[:, None, :], (half, half), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT_ONSET, HOP) * win   # (B, T, n_fft)
    re = frames @ torch.as_tensor(cos_m, device=dev)
    im = frames @ torch.as_tensor(sin_m, device=dev)
    power = re * re + im * im                            # (B, T, n_bins)
    # mel flux envelope (onset_strength, top_db=None), ref = max per clip
    S = power @ fb.T                                     # (B, T, n_mels)
    ref = torch.amax(S, dim=(1, 2), keepdim=True)
    S_db = 10.0 * torch.log10(torch.clamp(S, min=1e-10))
    S_db = S_db - 10.0 * torch.log10(torch.clamp(ref, min=1e-10))
    env = torch.clamp(S_db[:, 1:] - S_db[:, :-1], min=0.0).mean(dim=2)
    pad = 1 + N_FFT_ONSET // (2 * HOP)
    env = torch.cat([env.new_zeros(env.shape[0], pad), env],
                    dim=1)[:, : S_db.shape[1]]
    # frame RMS (stft_rms)
    p = power.clone()
    p[..., 0] *= 0.5
    p[..., -1] *= 0.5
    rms = torch.sqrt(2.0 * p.sum(dim=2) / N_FFT_ONSET ** 2)
    return (env.double().cpu().numpy(), rms.double().cpu().numpy())


class BeatAligner:
    """alignment(sigma, order) (model/Beat_score_v2.py:51-197)."""

    def __init__(self, sigma: float = 0.3, order: int = 2):
        self.sigma = sigma
        self.order = order

    def load_audio(self, wave: np.ndarray, t_start: int = 0,
                   sr_audio: int = SR):
        short_y = np.asarray(wave, dtype=np.float64)[t_start * sr_audio:]
        oenv = onset_strength(short_y, sr_audio)
        onset_raw = onset_detect(oenv, sr_audio)
        onset_bt = onset_backtrack(onset_raw, oenv)
        rms = stft_rms(short_y)
        onset_bt_rms = onset_backtrack(onset_raw, rms)
        return onset_raw, onset_bt, onset_bt_rms

    def load_audio_from_env(self, oenv: np.ndarray, rms: np.ndarray):
        """Same as load_audio, but from a precomputed envelope/RMS pair
        (see batched_onset_frontend — the on-device batch path)."""
        onset_raw = onset_detect(oenv)
        onset_bt = onset_backtrack(onset_raw, oenv)
        onset_bt_rms = onset_backtrack(onset_raw, rms)
        return onset_raw, onset_bt, onset_bt_rms

    def load_pose(self, pose: np.ndarray, t_start: int, t_end: int,
                  pose_fps: int = 15):
        """pose: (T, 282); returns 8 limb beat index arrays in the
        reference's order (right arm/shoulder/forearm/wrist, then left)."""
        data = np.concatenate([pose[:, 18:42], pose[:, 150:174]], axis=1)
        vel = data[1:, :] - data[:-1, :]

        def limb(lo):
            return np.linalg.norm(vel[:, lo : lo + 6], axis=1)

        v_r_shoulder, v_r_arm, v_r_forearm, v_r_wrist = (
            limb(0), limb(6), limb(12), limb(18))
        v_l_shoulder, v_l_arm, v_l_forearm, v_l_wrist = (
            limb(24), limb(30), limb(36), limb(42))

        def beats(v, windowed):
            vv = v[t_start * pose_fps : t_end * pose_fps] if windowed else v
            return argrelextrema(vv, np.less, order=self.order)[0]

        # reference windows only the right side (Beat_score_v2.py:115-126)
        return (
            beats(v_r_arm, True), beats(v_r_shoulder, True),
            beats(v_r_forearm, True), beats(v_r_wrist, True),
            beats(v_l_arm, False), beats(v_l_shoulder, False),
            beats(v_l_forearm, False), beats(v_l_wrist, False),
        )

    @staticmethod
    def motion_frames2time(frames, offset: float, pose_fps: int):
        return np.asarray(frames) / pose_fps + offset

    @staticmethod
    def GAHR(a, b, sigma: float) -> float:
        """Soft nearest-beat recall of b against a
        (Beat_score_v2.py:169-180) — the reference's double python loop
        vectorised as one broadcasted |a - b| min-reduce (identical
        math; exp(-inf) = 0 when a is empty, matching the loop)."""
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if len(b) == 0:
            return 0.0
        if len(a) == 0:
            return 0.0  # loop form: l2_min stays inf -> every term exp(-inf)
        l2_min = np.abs(a[None, :] - b[:, None]).min(axis=1)
        return float(np.mean(np.exp(-(l2_min**2) / (2 * sigma**2))))

    def calculate_align(self, onset_raw, onset_bt, onset_bt_rms,
                        pose_beats, pose_fps: int = 15) -> float:
        """pose_beats: the 8-tuple from load_pose. Average GAHR over
        3 onset sets x 8 limbs / 24 (Beat_score_v2.py:182-193)."""
        total = 0.0
        for audio_beat in (onset_raw, onset_bt, onset_bt_rms):
            audio_bt = frames_to_time(audio_beat)
            for pose_beat in pose_beats:
                pose_bt = self.motion_frames2time(pose_beat, 0, pose_fps)
                total += self.GAHR(pose_bt, audio_bt, self.sigma)
        return total / 24.0

    def score_batch(self, audio_batch: np.ndarray, pose_batch: np.ndarray,
                    t_start: int = 0, t_end: int = 4,
                    pose_fps: int = 15,
                    device_frontend: bool = False, device=None) -> float:
        """Mean alignment over a batch (the eval loop test_...py:243-250).

        `device_frontend=True` computes every clip's onset envelope and
        frame-RMS in one pass on `device` (batched_onset_frontend) instead
        of per-clip host numpy: the same math in fp32."""
        audio_batch = np.asarray(audio_batch)
        if device_frontend:
            waves = audio_batch[:, t_start * SR:]
            envs, rmss = batched_onset_frontend(waves, device)
        total = 0.0
        for i, (wave, pose) in enumerate(zip(audio_batch, pose_batch)):
            if device_frontend:
                onsets = self.load_audio_from_env(envs[i], rmss[i])
            else:
                onsets = self.load_audio(wave, t_start)
            beats = self.load_pose(pose, t_start, t_end, pose_fps)
            total += self.calculate_align(*onsets, beats, pose_fps)
        return total / len(audio_batch)
