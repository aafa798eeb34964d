"""Seq2Seq baseline (port of emotiongestures_tpu/models/baselines/
seq2seq.py; reference model/seq2seq_net.py): a bidirectional GRU text
encoder, Bahdanau attention and an autoregressive GRU decoder, teacher-
forced for the first n_pre_poses frames.

As in the JAX package, `input_lengths` is taken and not used: the encoder
runs the whole padded sequence (padding tokens are index-0 embeddings), no
pack_padded_sequence. The decode loop calls the one decoder step n_frames -
1 times, so in train mode its BatchNorm writes its running statistics at
every step, as the reference's and the JAX package's do. The decoder's
optional speaker table (`speaker_embedding`, which Seq2SeqNet never builds)
has no JAX table; its name is the port's choice.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...core.device import resolve_device
from ...core.layers import BatchNorm, Linear
from ...nn.gru import GRU, GRUCellStack, sum_bidirectional


class EncoderRNN(nn.Module):
    """(seq2seq_net.py:14-56): embedding -> bidirectional GRU, directions
    summed. Returns (outputs (B, T, H), final (2 n_layers, B, H))."""

    def __init__(self, n_words, embed_size=300, hidden_size=200, n_layers=2,
                 dropout=0.1):
        super().__init__()
        self.hidden_size = hidden_size
        self.embedding = nn.Embedding(n_words, embed_size)
        nn.init.normal_(self.embedding.weight, std=1.0)
        self.gru = GRU(embed_size, hidden_size, n_layers, bidirectional=True,
                       dropout=dropout)

    def forward(self, tokens, input_lengths=None):
        outputs, hidden = self.gru(self.embedding(tokens))
        return sum_bidirectional(outputs, self.hidden_size), hidden


class Attn(nn.Module):
    """Bahdanau additive attention (seq2seq_net.py:59-89): hidden (B, H),
    encoder outputs (B, T, H) -> weights (B, 1, T)."""

    def __init__(self, hidden_size):
        super().__init__()
        self.attn = Linear(2 * hidden_size, hidden_size)
        self.v = nn.Parameter(torch.randn(hidden_size) / hidden_size ** 0.5)

    def forward(self, hidden, encoder_outputs):
        h = hidden[:, None].expand(-1, encoder_outputs.shape[1], -1)
        energy = torch.tanh(self.attn(torch.cat([h, encoder_outputs], 2)))
        return torch.softmax(energy @ self.v, dim=1)[:, None]


class BahdanauAttnDecoderRNN(nn.Module):
    """One attention decoder step (seq2seq_net.py:92-187): context from the
    last layer's hidden state, [motion ⊕ context (⊕ speaker)] -> Linear ->
    BatchNorm -> ReLU -> the GRU stack -> Linear to the output."""

    def __init__(self, input_size, hidden_size, output_size, n_layers=2,
                 dropout_p=0.1, speaker_embed_size=None, n_speakers=0):
        super().__init__()
        self.attn = Attn(hidden_size)
        d = input_size + hidden_size
        self.speaker_embedding = None
        if speaker_embed_size:
            self.speaker_embedding = nn.Embedding(n_speakers,
                                                  speaker_embed_size)
            nn.init.normal_(self.speaker_embedding.weight, std=1.0)
            d += speaker_embed_size
        self.pre_linear = nn.Sequential(Linear(d, hidden_size),
                                        BatchNorm(hidden_size), nn.ReLU())
        self.gru = GRUCellStack(hidden_size, hidden_size, n_layers)
        self.out = Linear(hidden_size, output_size)

    def forward(self, motion_input, last_hidden, encoder_outputs,
                vid_indices=None):
        attn_weights = self.attn(last_hidden[-1], encoder_outputs)
        context = (attn_weights @ encoder_outputs)[:, 0]
        rnn_input = [motion_input, context]
        if self.speaker_embedding is not None:
            rnn_input.append(self.speaker_embedding(vid_indices))
        x = self.pre_linear(torch.cat(rnn_input, dim=1))
        new_hidden, out = self.gru(last_hidden, x)
        return self.out(out), new_hidden, attn_weights


class Seq2SeqGenerator(nn.Module):
    """The reference's wrapper around the decoder step (its `decoder`
    attribute, seq2seq_net.py:190-214), kept for the state_dict names."""

    def __init__(self, pose_dim, hidden_size, n_layers, dropout):
        super().__init__()
        self.decoder = BahdanauAttnDecoderRNN(pose_dim, hidden_size,
                                              pose_dim, n_layers, dropout)

    def forward(self, *args):
        return self.decoder(*args)


class Seq2SeqNet(nn.Module):
    """(seq2seq_net.py:217-254). forward(in_text (B, T) int, in_lengths,
    poses (B, n_frames, pose_dim), vid_indices=None) -> (B, n_frames,
    pose_dim); frame 0 is poses[:, 0], frames past n_pre_poses decode from
    the previous output. The decoder starts from the encoder's first
    n_layers final states ([l0_fwd, l0_bwd, ...]), as the reference does.
    `gan_noise_size` is taken for the API and, as in the JAX package, not
    used."""

    def __init__(self, n_words, pose_dim=282, n_frames=60, n_pre_poses=10,
                 hidden_size=200, n_layers=2, dropout=0.1,
                 word_embed_size=300, gan_noise_size=0, device=None):
        super().__init__()
        self.n_frames, self.n_pre_poses, self.n_layers = (
            n_frames, n_pre_poses, n_layers)
        self.encoder = EncoderRNN(n_words, word_embed_size, hidden_size,
                                  n_layers, dropout)
        self.decoder = Seq2SeqGenerator(pose_dim, hidden_size, n_layers,
                                        dropout)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, in_text, in_lengths, poses, vid_indices=None):
        encoder_outputs, encoder_hidden = self.encoder(in_text, in_lengths)
        hidden = encoder_hidden[: self.n_layers]
        outputs = [poses[:, 0]]
        decoder_input = poses[:, 0]
        for t in range(1, self.n_frames):
            out, hidden, _ = self.decoder(decoder_input, hidden,
                                          encoder_outputs, vid_indices)
            outputs.append(out)
            decoder_input = poses[:, t] if t < self.n_pre_poses else out
        return torch.stack(outputs, dim=1)
