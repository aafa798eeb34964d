"""The serving path as one object: waves -> log-mel (CUDA mel kernel) ->
EmotionCVAEv3.sample -> GestureTransformer, the forward that the JAX
package's bench.py::_build_forward times and its eval CLI's eval_batch wraps.

    server = GestureServer(fused_attention=True, precision="bfloat16")
    poses, emo, sem, logits, text_emb = server.generate(waves, y, text, prior)

`precision="bfloat16"` is the JAX serving recipe: generator parameters in
bf16 with BatchNorm statistics in fp32, the CVAE cast whole, and the inputs
spec, prior and y cast to bf16. For full fp32 on the card under
`precision="float32"`, the caller turns TF32 off with
`core.device.fp32_exact_on_cuda()`: that switch holds for the whole process,
so the server leaves it to the program that owns the process.
"""
from __future__ import annotations

import torch

from .core import precision as prec
from .core.device import resolve_device
from .models.cvae import EmotionCVAEv3
from .models.generator import GestureTransformer
from .nn.transformer import MultiHeadAttention
from .ops.fused_mel import batched_log_melspectrogram
from .ops.mel import calc_spectrogram_length_from_motion_length

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def set_fused_attention(model: torch.nn.Module, fused: bool) -> None:
    """Route every attention sublayer of `model` through the fused kernel
    (True) or the einsum path (False); the weights stay as they are."""
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.fused = fused


class GestureServer:
    def __init__(self, n_words: int = 64, frames: int = 60,
                 pose_dim: int = 282, prior_frames: int = 10,
                 d_model: int = 512, d_inner: int = 2048, n_layers: int = 3,
                 n_head: int = 8, d_k: int = 64, fused_attention: bool = True,
                 precision: str = "float32", device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.dtype = DTYPES[precision]
        self.spec_len = calc_spectrogram_length_from_motion_length(frames, 15)
        torch.manual_seed(seed)
        self.gen = GestureTransformer(
            n_words=n_words, frames=frames, pose_dim=pose_dim,
            prior_frames=prior_frames, d_model=d_model, d_inner=d_inner,
            n_layers=n_layers, n_head=n_head, d_k=d_k, d_v=d_k,
            spec_len=self.spec_len, fused_attention=fused_attention,
            device=self.device)
        self.vae = EmotionCVAEv3(frames=frames, feat_dim=d_model,
                                 device=self.device)
        if self.dtype == torch.bfloat16:
            prec.bf16_params_(self.gen)
            prec.cast_all_(self.vae, torch.bfloat16)

    def spectrogram(self, waves: torch.Tensor) -> torch.Tensor:
        """(B, n) waves -> (B, 128, spec_len) fp32 log-mel, per clip."""
        spec = batched_log_melspectrogram(waves.to(self.device))
        return spec[..., : self.spec_len]

    @torch.no_grad()
    def forward_spec(self, spec, y, text, prior, noise=None, generator=None):
        """The diverse forward from a spectrogram: CVAE prior sample, then
        the generator. `noise` (B, 32) replaces the prior's z when given."""
        spec, y, text, prior = (t.to(self.device)
                                for t in (spec, y, text, prior))
        if noise is not None:
            noise = noise.to(self.device)
        spec, prior, y = prec.cast_inputs(self.dtype, spec, prior, y)
        sampled = self.vae.sample(y, noise=noise, generator=generator)
        return self.gen(spec, text, prior, sampled)

    @torch.no_grad()
    def generate(self, waves, y, text, prior, noise=None, generator=None):
        """(B, n) waves, (B, 8) one-hot emotions, (B, frames) word ids,
        (B, prior_frames, pose_dim) seed poses -> the generator's outputs,
        poses (B, frames, pose_dim) first."""
        return self.forward_spec(self.spectrogram(waves), y, text, prior,
                                 noise, generator)
