"""Post-LN transformer blocks (port of emotiongestures_tpu/nn/transformer.py).

Reference semantics kept:
  * bias-free Q/K/V/out projections, post-LN residual blocks;
  * the decoder does cross-attention + FFN only and gets no positional
    encoding (Full_model/Layers.py:50-58, Models_memory.py:410-424);
  * the final encoder/decoder LayerNorm of the reference is never applied,
    so it is not built here either.

`MultiHeadAttention(fused=True)` sends eval-mode, unmasked calls with
d_k == d_v, Lq <= 64, Lk <= 64 and input widths == d_model to the fused
sublayer (`ops/fused_attention.py`: the CUDA kernel on the card, its plain
version on the CPU), the JAX package's routing rule exactly. Other calls take
the einsum path, whose products promote types as jnp's do.

Under tensor parallelism (`parallel/tensor.py::shard_module` sets
`n_model` and `model_index`) each block holds its shard at the same
attribute names: H / n_model heads of the Q/K/V rows and of fc's columns,
d_inner / n_model of w_1's rows and bias and of w_2's columns. The input
enters through `mesh.model_copy`, the partial output of fc or w_2 leaves
through `mesh.model_sum`, and w_2's bias, dropout, residual and LayerNorm
follow on the whole width, as in one process. The attention dropout's mask
is this rank's heads of the draw for all heads; a fused call runs the
kernel's partial-heads form and its residual LayerNorm.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.layers import (Dropout, LayerNorm, Linear, promoted,
                           sinusoid_position_table)
from ..ops.fused_attention import (fused_attention, fused_attention_partial,
                                   residual_layer_norm)
from ..parallel import mesh


def _mm(x, weight):
    """x @ W^T in the promoted type (the JAX raw-kernel product)."""
    dt = promoted(x, weight)
    return x.to(dt) @ weight.to(dt).T


def _model_inputs(q, k, v):
    """q, k, v through model_copy, each distinct tensor once."""
    q_in = mesh.model_copy(q)
    k_in = q_in if k is q else mesh.model_copy(k)
    v_in = k_in if v is k else (q_in if v is q else mesh.model_copy(v))
    return q_in, k_in, v_in


class MultiHeadAttention(nn.Module):
    n_model, model_index = 1, 0  # the model group (parallel/tensor.py)

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dropout: float = 0.1, attn_dropout: float = 0.1,
                 fused: bool = False):
        super().__init__()
        self.n_head, self.d_model, self.d_k, self.d_v = n_head, d_model, d_k, d_v
        self.fused = fused
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)
        self.dropout = Dropout(dropout)
        self.attn_dropout = Dropout(attn_dropout)
        for lin in (self.w_qs, self.w_ks, self.w_vs, self.fc):
            nn.init.xavier_uniform_(lin.weight)

    def can_fuse(self, q, k, mask) -> bool:
        return (self.fused and not self.training and mask is None
                and self.d_k == self.d_v and q.shape[1] <= 64
                and k.shape[1] <= 64
                and q.shape[-1] == k.shape[-1] == self.d_model)

    def forward(self, q, k, v, mask=None):
        H, dk, dv = self.n_head // self.n_model, self.d_k, self.d_v
        grid = self.n_model > 1
        if self.can_fuse(q, k, mask) and grid:
            q = q.contiguous()
            part = fused_attention_partial(
                q, k.contiguous(), self.w_qs.weight, self.w_ks.weight,
                self.w_vs.weight, self.fc.weight, n_head_local=H, d_k=dk)
            out = residual_layer_norm(mesh.model_sum(part), q,
                                      self.layer_norm.weight,
                                      self.layer_norm.bias)
            return out, None
        if self.can_fuse(q, k, mask):
            out = fused_attention(
                q.contiguous(), k.contiguous(), self.w_qs.weight,
                self.w_ks.weight, self.w_vs.weight, self.fc.weight,
                self.layer_norm.weight, self.layer_norm.bias,
                n_head=H, d_k=dk)
            return out, None

        B, Lq, _ = q.shape
        Lk = k.shape[1]
        residual = q
        if grid:
            q, k, v = _model_inputs(q, k, v)
        qh = _mm(q, self.w_qs.weight).view(B, Lq, H, dk)
        kh = _mm(k, self.w_ks.weight).view(B, Lk, H, dk)
        vh = _mm(v, self.w_vs.weight).view(B, Lk, H, dv)
        qh = qh * (1.0 / math.sqrt(dk))
        dt = promoted(qh, kh)
        attn = torch.einsum("bqhd,bkhd->bhqk", qh.to(dt), kh.to(dt))
        if mask is not None:
            attn = attn.masked_fill(mask == 0, -1e9)
        attn = self.attn_dropout(torch.softmax(attn, dim=-1))
        dt = promoted(attn, vh)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(dt), vh.to(dt))
        out = _mm(out.reshape(B, Lq, H * dv), self.fc.weight)
        if grid:
            out = mesh.model_sum(out)
        out = self.dropout(out) + residual
        mean = out.mean(-1, keepdim=True)
        var = ((out - mean) ** 2).mean(-1, keepdim=True)
        normed = (out - mean) * torch.rsqrt(var + 1e-6)
        return normed * self.layer_norm.weight + self.layer_norm.bias, attn


class PositionwiseFeedForward(nn.Module):
    n_model, model_index = 1, 0  # the model group (parallel/tensor.py)

    def __init__(self, d_in: int, d_hid: int, dropout: float = 0.1):
        super().__init__()
        self.w_1 = Linear(d_in, d_hid)
        self.w_2 = Linear(d_hid, d_in)
        self.layer_norm = LayerNorm(d_in, eps=1e-6)
        self.dropout = Dropout(dropout)
        for lin in (self.w_1, self.w_2):
            nn.init.xavier_uniform_(lin.weight)

    def forward(self, x):
        residual = x
        if self.n_model > 1:
            h = torch.relu(self.w_1(mesh.model_copy(x)))
            part = F.linear(h, self.w_2.weight.to(h.dtype))
            x = mesh.model_sum(part) + self.w_2.bias.to(h.dtype)
        else:
            x = self.w_2(torch.relu(self.w_1(x)))
        return self.layer_norm(self.dropout(x) + residual)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, d_inner, n_head, d_k, d_v, dropout=0.1,
                 fused=False):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                           dropout=dropout, fused=fused)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, dropout)

    def forward(self, x, slf_attn_mask=None):
        x, attn = self.slf_attn(x, x, x, mask=slf_attn_mask)
        return self.pos_ffn(x), attn


class DecoderLayer(nn.Module):
    """Cross-attention + FFN only."""

    def __init__(self, d_model, d_inner, n_head, d_k, d_v, dropout=0.1,
                 fused=False):
        super().__init__()
        self.enc_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                           dropout=dropout, fused=fused)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, dropout)

    def forward(self, dec_input, enc_output, dec_enc_attn_mask=None):
        x, attn = self.enc_attn(dec_input, enc_output, enc_output,
                                mask=dec_enc_attn_mask)
        return self.pos_ffn(x), attn


class PositionalEncoding(nn.Module):
    """The fixed sinusoid table added to the input (Models_memory.py:25-48).
    The table is built when called, not held: the reference's `pos_table`
    buffer is no state_dict entry of the port (utils/weights.py drops it on
    import)."""

    def __init__(self, d_hid: int, n_position: int = 200):
        super().__init__()
        self.d_hid, self.n_position = d_hid, n_position

    def forward(self, x):
        table = sinusoid_position_table(self.n_position, self.d_hid)
        return x + table[: x.shape[1]].to(x.device, x.dtype)


class TransformerEncoder(nn.Module):
    """pos-enc -> dropout -> N x EncoderLayer."""

    def __init__(self, n_layers, n_head, d_k, d_v, d_model, d_inner,
                 dropout=0.1, n_position=200, fused=False):
        super().__init__()
        self.position_enc = PositionalEncoding(d_model, n_position)
        self.dropout = Dropout(dropout)
        self.layer_stack = nn.ModuleList([
            EncoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout, fused)
            for _ in range(n_layers)])

    def forward(self, src_seq, src_mask=None):
        x = self.dropout(self.position_enc(src_seq))
        for layer in self.layer_stack:
            x, _ = layer(x, slf_attn_mask=src_mask)
        return x


class TransformerDecoder(nn.Module):
    """N x DecoderLayer cross-attending enc_output; no positional encoding."""

    def __init__(self, n_layers, n_head, d_k, d_v, d_model, d_inner,
                 dropout=0.1, fused=False):
        super().__init__()
        self.layer_stack = nn.ModuleList([
            DecoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout, fused)
            for _ in range(n_layers)])

    def forward(self, trg_seq, enc_output, dec_enc_attn_mask=None):
        x = trg_seq
        for layer in self.layer_stack:
            x, _ = layer(x, enc_output, dec_enc_attn_mask=dec_enc_attn_mask)
        return x


def get_pad_mask(seq: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """(B, 1, L) bool, True off the padding (Models_memory.py:13-14); the
    main path uses no mask."""
    return (seq != pad_idx)[:, None, :]


def get_subsequent_mask(seq: torch.Tensor) -> torch.Tensor:
    """(1, L, L) bool lower triangle: position i sees positions <= i
    (Models_memory.py:17-22); the main path uses no mask."""
    n = seq.shape[1]
    return torch.tril(torch.ones((1, n, n), dtype=torch.bool,
                                 device=seq.device))
