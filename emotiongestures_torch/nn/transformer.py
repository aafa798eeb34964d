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
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..core.layers import LayerNorm, Linear, promoted, sinusoid_position_table
from ..ops.fused_attention import fused_attention


def _mm(x, weight):
    """x @ W^T in the promoted type (the JAX raw-kernel product)."""
    dt = promoted(x, weight)
    return x.to(dt) @ weight.to(dt).T


class MultiHeadAttention(nn.Module):
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
        self.dropout = nn.Dropout(dropout)
        self.attn_dropout = nn.Dropout(attn_dropout)
        for lin in (self.w_qs, self.w_ks, self.w_vs, self.fc):
            nn.init.xavier_uniform_(lin.weight)

    def can_fuse(self, q, k, mask) -> bool:
        return (self.fused and not self.training and mask is None
                and self.d_k == self.d_v and q.shape[1] <= 64
                and k.shape[1] <= 64
                and q.shape[-1] == k.shape[-1] == self.d_model)

    def forward(self, q, k, v, mask=None):
        H, dk, dv = self.n_head, self.d_k, self.d_v
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
        out = self.dropout(out) + residual
        mean = out.mean(-1, keepdim=True)
        var = ((out - mean) ** 2).mean(-1, keepdim=True)
        normed = (out - mean) * torch.rsqrt(var + 1e-6)
        return normed * self.layer_norm.weight + self.layer_norm.bias, attn


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in: int, d_hid: int, dropout: float = 0.1):
        super().__init__()
        self.w_1 = Linear(d_in, d_hid)
        self.w_2 = Linear(d_hid, d_in)
        self.layer_norm = LayerNorm(d_in, eps=1e-6)
        self.dropout = nn.Dropout(dropout)
        for lin in (self.w_1, self.w_2):
            nn.init.xavier_uniform_(lin.weight)

    def forward(self, x):
        residual = x
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


class TransformerEncoder(nn.Module):
    """pos-enc -> dropout -> N x EncoderLayer."""

    def __init__(self, n_layers, n_head, d_k, d_v, d_model, d_inner,
                 dropout=0.1, n_position=200, fused=False):
        super().__init__()
        self.d_model, self.n_position = d_model, n_position
        self.dropout = nn.Dropout(dropout)
        self.layer_stack = nn.ModuleList([
            EncoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout, fused)
            for _ in range(n_layers)])

    def forward(self, src_seq, src_mask=None):
        table = sinusoid_position_table(self.n_position, self.d_model)
        x = src_seq + table[: src_seq.shape[1]].to(src_seq.device,
                                                   src_seq.dtype)
        x = self.dropout(x)
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
