"""GRU layers for the baseline models (port of emotiongestures_tpu/nn/gru.py):
seq2seq, trimodal, hierarchy and the embedding net.

torch.nn.GRU semantics, batch first: several layers, optionally
bidirectional with the final hidden state laid out [l0_fwd, l0_bwd, l1_fwd,
...], dropout between layers only. The recurrence is cuDNN's on the card
(the JAX package runs it as a flax lax.scan, in no Pallas kernel). The
parameters keep torch's names (`weight_ih_l0`, `bias_hh_l1_reverse`, ...),
the reference's layout, so state_dicts load with strict=True; the JAX
package's GRUCell folds the r and z gates' two biases into one, which
utils/weights.py puts on the input side.

Dropout between layers follows core.layers.Dropout, not cuDNN's: in train
mode with p > 0 the layers run one at a time and the masks come from the
generator that `core.layers.dropout_generator` sets, as everywhere else in
the port.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.layers import Dropout


class GRU(nn.GRU):
    """x (B, T, C) -> (outputs (B, T, H * dirs), final (layers * dirs, B,
    H)); `h0` as torch's, zeros when None."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__(input_size, hidden_size, n_layers, batch_first=True,
                         bidirectional=bidirectional)
        self.between = Dropout(dropout)

    def forward(self, x, h0=None):
        if not (self.training and self.between.p > 0 and self.num_layers > 1):
            return super().forward(x, h0)
        dirs = 2 if self.bidirectional else 1
        per_layer = len(self._flat_weights) // self.num_layers
        finals = []
        for k in range(self.num_layers):
            if k:
                x = self.between(x)
            h = None if h0 is None else h0[k * dirs:(k + 1) * dirs]
            if h is None:
                h = x.new_zeros(dirs, x.shape[0], self.hidden_size)
            weights = self._flat_weights[k * per_layer:(k + 1) * per_layer]
            x, hk = torch._VF.gru(x, h.contiguous(), weights, True, 1, 0.0,
                                  True, self.bidirectional, True)
            finals.append(hk)
        return x, torch.cat(finals)


def sum_bidirectional(outputs: torch.Tensor, hidden_size: int) -> torch.Tensor:
    """The reference's recurring `out[..., :H] + out[..., H:]`."""
    return outputs[..., :hidden_size] + outputs[..., hidden_size:]


class GRUCellStack(nn.GRU):
    """A stack of GRU layers advanced one step at a time (the seq2seq
    decoder's `nn.GRU` on a length-1 sequence, model/seq2seq_net.py:181),
    with no dropout between the layers, as in the JAX package."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1):
        super().__init__(input_size, hidden_size, n_layers, batch_first=True)

    def forward(self, carry, x):
        """carry (n_layers, B, H), x (B, C) -> (new carry, output (B, H))."""
        out, new = super().forward(x[:, None], carry.contiguous())
        return new, out[:, 0]
