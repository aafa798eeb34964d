"""Weights carried across from the JAX package.

`generator_state_from_jax`, `cvae_v3_state_from_jax`, `fgd_ae_state_from_jax`,
`skeleton_classifier_state_from_jax`, `emotion_net_state_from_jax`,
`disnet_state_from_jax`, `motion_discriminator_state_from_jax` and
`pose_discriminator_state_from_jax` take the JAX `{"params": ...,
"batch_stats": ...}` trees (nested mappings of arrays; anything `np.asarray`
reads) and return state_dicts in the reference PyTorch layout, which is the
port's own, so `load_state_dict(strict=True)` checks the structure.
`load_reference_checkpoint` reads such a state_dict from a `.pth` file, the
model of the newest checkpoint in a directory the port's trainers wrote, or
the params and batch_stats of an orbax checkpoint the JAX package wrote
(utils/orbax.py) through the table `jax_table` names; `adam_state_from_jax`
maps that checkpoint's optax Adam moments onto a torch Adam.

A declarative (torch_key, jax_path, kind) table drives it. This is the
port's own copy of the tables of emotiongestures_tpu/utils/torch_port.py
(generator_mapping, cvae_v3_mapping, fgd_ae_mapping,
skeleton_classifier_mapping, emotion_net_mapping, disnet_mapping,
pose_discriminator_mapping, flax_table_to_torch_state); a test holds the two
copies to the same keys and arrays. The JAX package has no table for MotionDiscriminator; its table here
is the mapping tests/test_torch_parity.py builds against the reference.
Layout kinds:
  dense    jax (in, out)          -> torch (out, in)
  conv2d   jax (kh, kw, in, out)  -> torch (out, in, kh, kw)
  conv1d   jax (k, in, out)       -> torch (out, in, k)
  dense1x1 jax dense (in, out)    -> torch conv1d (out, in, 1)
  g        jax (out,)             -> torch (out, 1, 1)   weight-norm gain
  convT1d  jax ConvTranspose (k, in, out) -> torch (in, out, k), flipped
           along k: torch's transposed conv is the gradient form, which
           flips the kernel against lax.conv_transpose's correlation
  conv3d   jax (kd, kh, kw, in, out) -> torch (out, in, kd, kh, kw)
  convT2d  jax ConvTranspose (kh, kw, in, out) -> torch (in, out, kh, kw),
           flipped along kh and kw (as convT1d)
  raw      the same layout
GRUs are no layout permute: the JAX package's GRUCell has one bias for the
r and z gates where torch has two, so `gru_state` writes it on the input
side and zeros on the hidden side (utils/torch_port.py::gru_cell_to_torch).

The model zoo's tables (the generator variants, the MLP CVAEs, the
baselines) are copies of the JAX package's where it has one. Where it has
none (PriorConvEncoder, SPMemoryV2, AudioConvEncoder, the speaker paths,
PoseDecoderFC / PoseDecoderGRU / ContextEncoder and so EmbeddingNet's
`speech` mode, the legacy factories), the names are the port's choice,
given in each module's docstring; whether a reference `.pth` loads into
those is unverified.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from . import orbax
from .checkpoint import latest_step, load_model

TO_TORCH = {
    "raw": lambda x: np.asarray(x),
    "dense": lambda x: np.asarray(x).T,
    "conv2d": lambda x: np.transpose(np.asarray(x), (3, 2, 0, 1)),
    "conv1d": lambda x: np.transpose(np.asarray(x), (2, 1, 0)),
    "dense1x1": lambda x: np.asarray(x).T[:, :, None],
    "g": lambda x: np.asarray(x).reshape(-1, 1, 1),
    "convT1d": lambda x: np.transpose(np.asarray(x)[::-1], (1, 2, 0)),
    "conv3d": lambda x: np.transpose(np.asarray(x), (4, 3, 0, 1, 2)),
    "convT2d": lambda x: np.transpose(np.asarray(x)[::-1, ::-1],
                                      (2, 3, 0, 1)),
}


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def linear(table, prefix, path):
    table.append((_key(prefix, "weight"), ("params",) + path + ("kernel",),
                  "dense"))
    table.append((_key(prefix, "bias"), ("params",) + path + ("bias",),
                  "raw"))


def seq_linears(table, prefix, base, names):
    """nn.Sequential(Linear, x, Linear, x, ...): Linears at 0, 2, 4, ..."""
    for i, name in enumerate(names):
        linear(table, _key(prefix, str(2 * i)), base + (name,))


def batchnorm(table, prefix, path):
    bn = path + ("BatchNorm_0",)
    table += [
        (_key(prefix, "weight"), ("params",) + bn + ("scale",), "raw"),
        (_key(prefix, "bias"), ("params",) + bn + ("bias",), "raw"),
        (_key(prefix, "running_mean"), ("batch_stats",) + bn + ("mean",),
         "raw"),
        (_key(prefix, "running_var"), ("batch_stats",) + bn + ("var",),
         "raw"),
    ]


def conv(table, prefix, path, kind="conv2d", bias=True):
    # core.layers.Conv wraps a flax Conv_0 (ConvTranspose_0 when transposed)
    child = "ConvTranspose_0" if kind.startswith("convT") else "Conv_0"
    table.append((_key(prefix, "weight"),
                  ("params",) + path + (child, "kernel"), kind))
    if bias:
        table.append((_key(prefix, "bias"),
                      ("params",) + path + (child, "bias"), "raw"))


def resnet_se(table, prefix, base, layers=(3, 4, 6)):
    conv(table, _key(prefix, "conv1"), base + ("conv1",))
    batchnorm(table, _key(prefix, "bn1"), base + ("bn1",))
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            jb = base + (f"layer{stage + 1}_block{b}",)
            tp = _key(prefix, f"layer{stage + 1}.{b}")
            conv(table, f"{tp}.conv1", jb + ("conv1",), bias=False)
            conv(table, f"{tp}.conv2", jb + ("conv2",), bias=False)
            batchnorm(table, f"{tp}.bn1", jb + ("bn1",))
            batchnorm(table, f"{tp}.bn2", jb + ("bn2",))
            linear(table, f"{tp}.se.fc.0", jb + ("se", "fc1"))
            linear(table, f"{tp}.se.fc.2", jb + ("se", "fc2"))
            if b == 0 and stage > 0:
                conv(table, f"{tp}.downsample.0", jb + ("downsample_conv",),
                     bias=False)
                batchnorm(table, f"{tp}.downsample.1",
                          jb + ("downsample_bn",))


def mha(table, prefix, base):
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        table.append((f"{prefix}.{name}.weight",
                      ("params",) + base + (name, "kernel"), "dense"))
    table.append((f"{prefix}.layer_norm.weight",
                  ("params",) + base + ("layer_norm", "scale"), "raw"))
    table.append((f"{prefix}.layer_norm.bias",
                  ("params",) + base + ("layer_norm", "bias"), "raw"))


def transformer_layers(table, prefix, base, n_layers, attn_name="slf_attn"):
    for i in range(n_layers):
        jb = base + (f"layer_{i}",)
        tp = _key(prefix, f"layer_stack.{i}")
        mha(table, f"{tp}.{attn_name}", jb + (attn_name,))
        ffn = jb + ("pos_ffn",)
        linear(table, f"{tp}.pos_ffn.w_1", ffn + ("w_1",))
        linear(table, f"{tp}.pos_ffn.w_2", ffn + ("w_2",))
        table.append((f"{tp}.pos_ffn.layer_norm.weight",
                      ("params",) + ffn + ("layer_norm", "scale"), "raw"))
        table.append((f"{tp}.pos_ffn.layer_norm.bias",
                      ("params",) + ffn + ("layer_norm", "bias"), "raw"))


def tcn(table, prefix, base, params, n_levels):
    """`params` is the JAX TCN's params subtree (its downsample is
    optional: it exists where in/out channel counts differ)."""
    for i in range(n_levels):
        jb = base + (f"block{i}",)
        tp = _key(prefix, f"network.{i}")
        for c in ("conv1", "conv2"):
            table += [
                (f"{tp}.{c}.weight_v", ("params",) + jb + (c, "v"), "conv1d"),
                (f"{tp}.{c}.weight_g", ("params",) + jb + (c, "g"), "g"),
                (f"{tp}.{c}.bias", ("params",) + jb + (c, "bias"), "raw"),
            ]
        if "downsample" in params[f"block{i}"]:
            table.append((f"{tp}.downsample.weight",
                          ("params",) + jb + ("downsample", "kernel"),
                          "dense1x1"))
            table.append((f"{tp}.downsample.bias",
                          ("params",) + jb + ("downsample", "bias"), "raw"))


def prior_encoder_table(t, variant="memory"):
    """The generator's prior_seq_encoder entries for `variant`."""
    pe = ("prior_seq_encoder",)
    if variant == "base":
        for i in (1, 2):
            conv(t, f"prior_seq_encoder.conv{i}", pe + (f"conv{i}",),
                 "conv1d")
            batchnorm(t, f"prior_seq_encoder.bn{i}", pe + (f"bn{i}",))
        linear(t, "prior_seq_encoder.fc1", pe + ("fc1",))
        linear(t, "prior_seq_encoder.fc2", pe + ("fc2",))
        return
    conv(t, "prior_seq_encoder.pred_conv.0", pe + ("pred_conv1",), "conv1d")
    batchnorm(t, "prior_seq_encoder.pred_conv.2", pe + ("pred_bn1",))
    conv(t, "prior_seq_encoder.pred_conv.3", pe + ("pred_conv2",), "conv1d")
    batchnorm(t, "prior_seq_encoder.pred_conv.5", pe + ("pred_bn2",))
    sp = "prior_seq_encoder.spatial_memory"
    if variant == "memory":
        seq_linears(t, f"{sp}.spatial_chunk_encoder",
                    pe + ("spatial_memory",), ("enc_fc1", "enc_fc2"))
    else:
        for i in (1, 2):
            conv(t, f"{sp}.conv{i}", pe + ("spatial_memory", f"conv{i}"),
                 "conv1d")
            batchnorm(t, f"{sp}.bn{i}", pe + ("spatial_memory", f"bn{i}"))
    if variant in ("memory", "padding_initial"):
        tm = "prior_seq_encoder.temporal_memory"
        seq_linears(t, f"{tm}.temporal_chunk_encoder",
                    pe + ("temporal_memory",), ("chunk_fc1", "chunk_fc2"))
        seq_linears(t, f"{tm}.temporal_memory_encoder",
                    pe + ("temporal_memory",), ("mem_fc1", "mem_fc2"))
    seq_linears(t, "prior_seq_encoder.post_header", pe,
                ("post_fc1", "post_fc2"))


def generator_table(variables, n_layers: int = 3, tcn_layers: int = 3,
                    variant: str = "memory"):
    """The table for GestureTransformer(variant=...): the JAX package's
    generator_mapping for "memory"; the other variants differ only in the
    prior encoder (`prior_encoder_table`)."""
    t = []
    t.append(("text_encoder.embedding.weight",
              ("params", "text_encoder", "embedding"), "raw"))
    tcn(t, "text_encoder.tcn", ("text_encoder", "tcn"),
        variables["params"]["text_encoder"]["tcn"], tcn_layers)
    linear(t, "text_encoder.fc1.0", ("text_encoder", "fc1"))
    linear(t, "text_encoder.decoder", ("text_encoder", "decoder"))

    resnet_se(t, "audio_encoder.feat_extractor",
              ("audio_encoder", "feat_extractor"))
    conv(t, "audio_encoder.final_conv1", ("audio_encoder", "final_conv1"))
    batchnorm(t, "audio_encoder.bn1", ("audio_encoder", "bn1"))
    linear(t, "audio_encoder.fc1", ("audio_encoder", "fc1"))
    linear(t, "audio_encoder.fc2", ("audio_encoder", "fc2"))

    prior_encoder_table(t, variant)
    seq_linears(t, "emotion_proj", ("emotion_proj",), ("fc1", "fc2"))
    seq_linears(t, "semantic_proj", ("semantic_proj",), ("fc1", "fc2"))
    seq_linears(t, "fusion_proj", ("fusion_proj",), ("fc1", "fc2"))
    seq_linears(t, "emotion_classifer_header", (),
                ("emotion_clf_fc1", "emotion_clf_fc2", "emotion_clf_fc3",
                 "emotion_clf_fc4"))
    seq_linears(t, "post_projector", (),
                ("post_fc1", "post_fc2", "post_fc3", "post_fc4"))

    transformer_layers(t, "encoder", ("encoder",), n_layers, "slf_attn")
    transformer_layers(t, "decoder", ("decoder",), n_layers, "enc_attn")
    return t


def cvae_v3_table():
    """The table for EmotionCVAEv3 (CAVE/BEAT_CVAE.py:312-460)."""
    t = []
    for i, seq in enumerate((0, 3, 6, 9)):
        conv(t, f"Encoder.{seq}", ("encoder", f"conv{i}"), "conv1d")
        batchnorm(t, f"Encoder.{seq + 2}", ("encoder", f"bn{i}"))
    seq_linears(t, "Posterior_Y_embedding", ("y_embed",), ("fc1", "fc2"))
    seq_linears(t, "fc_mu", ("fc_mu",), ("fc0", "fc1"))
    seq_linears(t, "fc_var", ("fc_var",), ("fc0", "fc1"))
    seq_linears(t, "fusion_z_posterior", ("fusion",), ("fc0", "fc1"))
    for i, seq in enumerate((0, 3)):
        conv(t, f"Decoder.{seq}", ("decoder", f"deconv{i}"), "convT1d")
        batchnorm(t, f"Decoder.{seq + 2}", ("decoder", f"bn{i}"))
    for i, seq in enumerate((6, 9)):
        conv(t, f"Decoder.{seq}", ("decoder", f"conv{i}"), "conv1d")
        batchnorm(t, f"Decoder.{seq + 2}", ("decoder", f"bn{i + 2}"))
    conv(t, "Decoder.12", ("decoder", "conv_out"), "conv1d")
    return t


def fgd_ae_table():
    """The table for FGDAutoEncoder (model/FGD.py:26-82): Encoder/Decoder
    Sequentials with Dropout at the odd indices."""
    t = []
    seq_linears(t, "Encoder", (), ("enc_fc1", "enc_fc2", "enc_fc3"))
    seq_linears(t, "Decoder", (), ("dec_fc1", "dec_fc2", "dec_fc3"))
    return t


def skeleton_classifier_table(n_layers: int = 3):
    """The table for SkeletonTransformer (skeleton_classifer/Models.py:
    199-283)."""
    t = []
    linear(t, "prior_seq_encoder.fc1", ("prior_fc1",))
    linear(t, "prior_seq_encoder.fc2", ("prior_fc2",))
    seq_linears(t, "post_projector", (),
                ("post_fc1", "post_fc2", "post_fc3", "post_fc4", "post_fc5"))
    transformer_layers(t, "encoder", ("encoder",), n_layers, "slf_attn")
    return t


def emotion_net_table():
    """The table for EmotionNet (model/audio_emotion_classifer.py:17-49):
    the 4-stage SE-ResNet, the misspelled `emotion_eocder_fc` MLP and
    `last_fc`."""
    t = []
    resnet_se(t, "emotion_encoder", ("emotion_encoder",), (3, 4, 6, 3))
    seq_linears(t, "emotion_eocder_fc", (),
                ("fc0", "fc1", "fc2", "fc3", "fc4"))
    linear(t, "last_fc", ("last_fc",))
    return t


def disnet_table():
    """The table for DisNet (model/audio_emotion_classifer.py:51-70)."""
    t = []
    seq_linears(t, "dis_fc", (), ("fc1", "fc2", "fc3"))
    return t


def motion_discriminator_table(n_layers: int = 2):
    """The table for MotionDiscriminator (Models_memory.py:569-618)."""
    t = []
    transformer_layers(t, "encoder", ("encoder",), n_layers, "slf_attn")
    linear(t, "fc1.0", ("fc1",))
    seq_linears(t, "fc2", (), ("fc2_0", "fc2_1", "fc2_2", "fc2_3", "fc2_4",
                               "fc2_out"))
    return t


def pose_discriminator_table(n_layers: int = 3):
    """The table for PoseDiscriminator (Models.py:482-510)."""
    t = []
    transformer_layers(t, "encoder", ("encoder",), n_layers, "slf_attn")
    seq_linears(t, "fc", (), ("fc1", "fc2"))
    return t


def audio_conv_encoder_table(prefix=""):
    """AudioConvEncoder (the port's names: the JAX module's)."""
    t = []
    for i in (1, 2):
        conv(t, _key(prefix, f"conv{i}"), (f"conv{i}",))
        batchnorm(t, _key(prefix, f"bn{i}"), (f"bn{i}",))
    linear(t, _key(prefix, "fc1"), ("fc1",))
    linear(t, _key(prefix, "fc2"), ("fc2",))
    return t


_STACK5 = ("fc0", "fc1", "fc2", "fc3", "fc4")


def cvae_v1_table():
    """EmotionCVAEv1 (CAVE/BEAT_CVAE.py:30-154): single-Linear fc_mu /
    fc_var."""
    t = []
    seq_linears(t, "Encoder", ("encoder",), _STACK5)
    seq_linears(t, "Posterior_Y_embedding", ("y_embed",), ("fc1", "fc2"))
    linear(t, "fc_mu", ("fc_mu", "fc0"))
    linear(t, "fc_var", ("fc_var", "fc0"))
    seq_linears(t, "Decoder", ("decoder",), _STACK5)
    seq_linears(t, "fusion_z_posterior", ("fusion",), ("fc0", "fc1"))
    return t


def cvae_v2_table():
    """EmotionCVAEv2 (CAVE/BEAT_CVAE.py:157-308)."""
    t = []
    seq_linears(t, "Encoder", ("encoder",), _STACK5)
    seq_linears(t, "Posterior_Y_embedding", ("y_embed",), ("fc1", "fc2"))
    seq_linears(t, "fc_mu", ("fc_mu",), _STACK5)
    seq_linears(t, "fc_var", ("fc_var",), _STACK5)
    seq_linears(t, "Decoder", ("decoder",), _STACK5)
    seq_linears(t, "fusion_z_posterior", ("fusion",),
                ("fc0", "fc1", "fc2", "fc3"))
    return t


def hand_cvae_table():
    """HandCVAE (Full_model/BEAT_CVAE.py:30-149)."""
    t = []
    seq_linears(t, "Encoder", ("encoder",), _STACK5)
    seq_linears(t, "Posterior_Y_embedding", ("y_embed",), ("fc0", "fc1"))
    linear(t, "fc_mu", ("fc_mu", "fc0"))
    linear(t, "fc_var", ("fc_var", "fc0"))
    seq_linears(t, "Decoder", ("decoder",), _STACK5)
    seq_linears(t, "fusion_z_posterior", ("fusion",), ("fc0", "fc1"))
    return t


# --- the baselines (models/baselines/) -------------------------------------


def _gru_cell(cell):
    """One JAX GRUCell -> torch's (weight_ih, weight_hh, bias_ih, bias_hh):
    gates in torch's (r, z, n) order; the cell's r / z bias on the input
    side, zeros for the hidden side's, the n gate's two biases as they are
    (n = tanh(W_in x + b_in + r * (W_hn h + b_hn)) in both)."""
    w_ih = np.concatenate([np.asarray(cell[g]["kernel"]).T
                           for g in ("ir", "iz", "in")], axis=0)
    w_hh = np.concatenate([np.asarray(cell[g]["kernel"]).T
                           for g in ("hr", "hz", "hn")], axis=0)
    b_ih = np.concatenate([np.asarray(cell[g]["bias"])
                           for g in ("ir", "iz", "in")], axis=0)
    zeros = np.zeros(w_hh.shape[1], dtype=b_ih.dtype)
    b_hh = np.concatenate([zeros, zeros, np.asarray(cell["hn"]["bias"])])
    return w_ih, w_hh, b_ih, b_hh


def gru_state(out: dict, prefix: str, gru_params, n_layers: int,
              bidirectional: bool = False) -> dict:
    """Write torch nn.GRU entries for a JAX GRU (cells `l{k}_fwd` /
    `l{k}_bwd`) or GRUCellStack (cells `l{k}`) into `out`."""
    for k in range(n_layers):
        for rev in ((False, True) if bidirectional else (False,)):
            if bidirectional:
                name = f"l{k}_{'bwd' if rev else 'fwd'}"
            else:
                name = f"l{k}" if f"l{k}" in gru_params else f"l{k}_fwd"
            suffix = f"l{k}" + ("_reverse" if rev else "")
            for w, a in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                            _gru_cell(gru_params[name])):
                out[_key(prefix, f"{w}_{suffix}")] = _tensor(a)
    return out


def _gru_model_state(variables, table, grus) -> dict:
    """A table's entries, then each (prefix, JAX path, layers,
    bidirectional) GRU's."""
    out = state_from_table(variables, table)
    for prefix, path, n_layers, bidir in grus:
        gru_state(out, prefix, _get(variables["params"], path), n_layers,
                  bidir)
    return out


def seq2seq_state_from_jax(variables, n_layers: int = 2) -> dict:
    """Seq2SeqNet (model/seq2seq_net.py:217); the JAX package's
    flax_seq2seq_to_torch_state."""
    out = {"encoder.embedding.weight": _tensor(np.asarray(
        variables["params"]["encoder"]["embedding"]))}
    gru_state(out, "encoder.gru", variables["params"]["encoder"]["gru"],
              n_layers, bidirectional=True)
    t = []
    dec = ("decoder",)
    linear(t, "decoder.decoder.pre_linear.0", dec + ("pre_linear",))
    batchnorm(t, "decoder.decoder.pre_linear.1", dec + ("pre_bn",))
    linear(t, "decoder.decoder.attn.attn", dec + ("attn", "attn"))
    t.append(("decoder.decoder.attn.v", ("params",) + dec + ("attn", "v"),
              "raw"))
    linear(t, "decoder.decoder.out", dec + ("out",))
    out.update(state_from_table(variables, t))
    gru_state(out, "decoder.decoder.gru",
              variables["params"]["decoder"]["gru"], n_layers)
    return out


def _conv_norm_relu(t, prefix, path, kind="conv1d"):
    conv(t, f"{prefix}.0", path + ("conv",), kind)
    batchnorm(t, f"{prefix}.1", path + ("bn",))


def s2g_generator_table():
    """S2GGenerator (model/speech2gesture.py:202-240)."""
    t = []
    ae = ("audio_encoder",)
    for i in range(8):
        _conv_norm_relu(t, f"audio_encoder.first_net.{i}",
                        ae + (f"first_{i}",), "conv2d")
    _conv_norm_relu(t, "audio_encoder.down1.0", ae + ("down1_0",))
    _conv_norm_relu(t, "audio_encoder.down1.1", ae + ("down1_1",))
    for i in range(2, 7):
        _conv_norm_relu(t, f"audio_encoder.down{i}", ae + (f"down{i}",))
    for i in range(1, 6):
        _conv_norm_relu(t, f"audio_encoder.up{i}.conv",
                        ae + (f"up{i}", "conv"))
    linear(t, "pre_pose_encoder.0", ("pre_fc1",))
    batchnorm(t, "pre_pose_encoder.1", ("pre_bn",))
    linear(t, "pre_pose_encoder.3", ("pre_fc2",))
    for i in range(4):
        _conv_norm_relu(t, f"decoder.{i}", (f"dec_{i}",))
    conv(t, "final_out", ("final_out",), "conv1d")
    return t


def s2g_discriminator_table():
    """S2GDiscriminator (model/speech2gesture.py:243-259)."""
    t = []
    conv(t, "net.0", ("conv1",), "conv1d")
    _conv_norm_relu(t, "net.2", ("cnr1",))
    _conv_norm_relu(t, "net.3", ("cnr2",))
    conv(t, "net.4", ("out",), "conv1d")
    return t


def s2g_generator_state_from_jax(variables) -> dict:
    return state_from_table(variables, s2g_generator_table())


def s2g_discriminator_state_from_jax(variables) -> dict:
    return state_from_table(variables, s2g_discriminator_table())


def wav_encoder_table(t, prefix, path):
    """WavEncoder (multimodal_context_net.py:13-40)."""
    for i, seq in enumerate((0, 3, 6, 9)):
        conv(t, f"{prefix}.feat_extractor.{seq}", path + (f"conv{i}",),
             "conv1d")
        if i < 3:
            batchnorm(t, f"{prefix}.feat_extractor.{seq + 1}",
                      path + (f"bn{i}",))
    linear(t, f"{prefix}.fc1.0", path + ("fc1",))


def text_encoder_tcn32_table(t, params, prefix, path, n_layers):
    """TextEncoderTCN32 (multimodal_context_net.py:43-77); `params` is the
    JAX params tree (the TCN's downsamples are optional)."""
    t.append((f"{prefix}.embedding.weight",
              ("params",) + path + ("embedding",), "raw"))
    tcn(t, f"{prefix}.tcn", path + ("tcn",), _get(params, path + ("tcn",)),
        n_layers)
    linear(t, f"{prefix}.fc1.0", path + ("fc1",))
    linear(t, f"{prefix}.decoder", path + ("decoder",))


def speaker_table(t, prefix=""):
    """The speaker latent: the table, its Linear, mu and logvar (the JAX
    package's names for the hierarchy generator; the port's choice for the
    trimodal one)."""
    t.append((_key(prefix, "speaker_embedding.0.weight"),
              ("params", "speaker_embedding"), "raw"))
    linear(t, _key(prefix, "speaker_embedding.1"), ("speaker_fc",))
    linear(t, _key(prefix, "speaker_mu"), ("speaker_mu",))
    linear(t, _key(prefix, "speaker_logvar"), ("speaker_logvar",))


def trimodal_generator_state_from_jax(variables, n_layers: int = 4) -> dict:
    """PoseGenerator (multimodal_context_net.py:80-179): the JAX package's
    table for input_context "both" without speakers, with the audio and
    text encoders and the speaker latent wherever the params have them."""
    p = variables["params"]
    t = []
    if "audio_encoder" in p:
        wav_encoder_table(t, "audio_encoder", ("audio_encoder",))
    if "text_encoder" in p:
        text_encoder_tcn32_table(t, p, "text_encoder", ("text_encoder",),
                                 n_layers)
    linear(t, "out.0", ("out_fc1",))
    linear(t, "out.2", ("out_fc2",))
    if "speaker_embedding" in p:
        speaker_table(t)
    return _gru_model_state(variables, t, [("gru", ("gru",), n_layers,
                                            True)])


def _gru_discriminator_state(variables, n_layers, pre_conv=False):
    t = []
    if pre_conv:
        for i, seq in enumerate((0, 3, 6)):
            conv(t, f"pre_conv.{seq}", (f"conv{i}",), "conv1d")
            if i < 2:
                batchnorm(t, f"pre_conv.{seq + 1}", (f"bn{i}",))
    linear(t, "out", ("out",))
    linear(t, "out2", ("out2",))
    return _gru_model_state(variables, t, [("gru", ("gru",), n_layers,
                                            True)])


def trimodal_discriminator_state_from_jax(variables,
                                          n_layers: int = 4) -> dict:
    """TrimodalDiscriminator (multimodal_context_net.py:182-223)."""
    return _gru_discriminator_state(variables, n_layers)


def conv_discriminator_state_from_jax(variables) -> dict:
    """ConvDiscriminator (multimodal_context_net.py:226-272)."""
    return _gru_discriminator_state(variables, 4, pre_conv=True)


def hierarchy_discriminator_state_from_jax(variables,
                                           n_layers: int = 4) -> dict:
    """HierarchicalDiscriminator (hierarchy_net.py:166-208)."""
    return _gru_discriminator_state(variables, n_layers)


def hierarchy_conv_discriminator_state_from_jax(variables) -> dict:
    """HierarchicalConvDiscriminator (hierarchy_net.py:211-255)."""
    return _gru_discriminator_state(variables, 4, pre_conv=True)


def _deconv_net(t, prefix, path):
    """The decoders' transposed-conv tail (embedding_net.py:196-205 ==
    motion_ae.py:94-103)."""
    for seq, name, kind in ((0, "d1", "convT1d"), (3, "d2", "convT1d"),
                            (6, "c1", "conv1d"), (7, "c2", "conv1d")):
        conv(t, _key(prefix, f"net.{seq}"), path + (name,), kind)
        if seq in (0, 3):
            batchnorm(t, _key(prefix, f"net.{seq + 1}"),
                      path + (f"bn{1 if seq == 0 else 2}",))


def pose_encoder_conv_table(prefix="", path=()):
    """PoseEncoderConv (embedding_net.py:42-83)."""
    t = []
    for i in range(3):
        conv(t, _key(prefix, f"net.{i}.0"), path + (f"c{i + 1}", "conv"),
             "conv1d")
        batchnorm(t, _key(prefix, f"net.{i}.1"), path + (f"c{i + 1}", "bn"))
    conv(t, _key(prefix, "net.3"), path + ("c4",), "conv1d")
    linear(t, _key(prefix, "out_net.0"), path + ("out1",))
    batchnorm(t, _key(prefix, "out_net.1"), path + ("bn1",))
    linear(t, _key(prefix, "out_net.3"), path + ("out2",))
    batchnorm(t, _key(prefix, "out_net.4"), path + ("bn2",))
    linear(t, _key(prefix, "out_net.6"), path + ("out3",))
    linear(t, _key(prefix, "fc_mu"), path + ("fc_mu",))
    linear(t, _key(prefix, "fc_logvar"), path + ("fc_logvar",))
    return t


def _pre_pose_net(t, prefix, path):
    """The seed poses' code (the port's names)."""
    linear(t, _key(prefix, "pre_pose_net.0"), path + ("pre1",))
    batchnorm(t, _key(prefix, "pre_pose_net.1"), path + ("pre_bn",))
    linear(t, _key(prefix, "pre_pose_net.3"), path + ("pre2",))


def pose_decoder_conv_table(prefix="", path=(), use_pre_poses=False):
    """PoseDecoderConv (embedding_net.py:166-218); its pre-pose branch has
    the port's names."""
    t = []
    if use_pre_poses:
        _pre_pose_net(t, prefix, path)
    linear(t, _key(prefix, "pre_net.0"), path + ("pre_fc1",))
    batchnorm(t, _key(prefix, "pre_net.1"), path + ("pre_bn2",))
    linear(t, _key(prefix, "pre_net.3"), path + ("pre_fc2",))
    _deconv_net(t, prefix, path)
    return t


def pose_decoder_fc_table(prefix="", path=(), use_pre_poses=False):
    """PoseDecoderFC (embedding_net.py:86-128; the port's names)."""
    t = []
    if use_pre_poses:
        _pre_pose_net(t, prefix, path)
    for i in range(4):
        linear(t, _key(prefix, f"net.{3 * i}"), path + (f"fc{i}",))
        batchnorm(t, _key(prefix, f"net.{3 * i + 1}"), path + (f"bn{i}",))
    linear(t, _key(prefix, "net.12"), path + ("fc_out",))
    return t


def pose_decoder_gru_table(prefix="", path=()):
    """PoseDecoderGRU (embedding_net.py:131-163; the port's names) without
    its GRU, which `gru_state` writes."""
    t = []
    _pre_pose_net(t, prefix, path)
    linear(t, _key(prefix, "out.0"), path + ("out1",))
    linear(t, _key(prefix, "out.2"), path + ("out2",))
    return t


def context_encoder_table(params, prefix="", path=()):
    """ContextEncoder (embedding_net.py:221-260; the port's names) without
    its GRU."""
    t = []
    text_encoder_tcn32_table(t, params, _key(prefix, "text_encoder"),
                             path + ("text_encoder",), 3)
    wav_encoder_table(t, _key(prefix, "audio_encoder"),
                      path + ("audio_encoder",))
    linear(t, _key(prefix, "out.0"), path + ("out1",))
    batchnorm(t, _key(prefix, "out.1"), path + ("bn",))
    linear(t, _key(prefix, "out.3"), path + ("out2",))
    linear(t, _key(prefix, "fc_mu"), path + ("fc_mu",))
    linear(t, _key(prefix, "fc_logvar"), path + ("fc_logvar",))
    return t


def pose_encoder_conv_state_from_jax(variables) -> dict:
    return state_from_table(variables, pose_encoder_conv_table())


def pose_decoder_conv_state_from_jax(variables) -> dict:
    return state_from_table(variables, pose_decoder_conv_table())


def embedding_net_state_from_jax(variables, mode: str = "pose") -> dict:
    """EmbeddingNet (embedding_net.py:263-316). "pose": the JAX package's
    flax_embedding_net_pose_to_torch_state; otherwise the context encoder
    and the GRU decoder under the port's names."""
    t = pose_encoder_conv_table("pose_encoder", ("pose_encoder",))
    if mode == "pose":
        t += pose_decoder_conv_table("decoder", ("decoder",))
        return state_from_table(variables, t)
    t += context_encoder_table(variables["params"], "context_encoder",
                               ("context_encoder",))
    t += pose_decoder_gru_table("decoder", ("decoder",))
    return _gru_model_state(variables, t, [
        ("context_encoder.gru", ("context_encoder", "gru"), 2, False),
        ("decoder.gru", ("decoder", "gru"), 4, True)])


def motion_ae_table():
    """MotionAE (model/motion_ae.py:118-130)."""
    t = []
    en = ("encoder",)
    for i in range(3):
        conv(t, f"encoder.net.{i}.0", en + (f"c{i}",), "conv1d")
        batchnorm(t, f"encoder.net.{i}.1", en + (f"bn{i}",))
    conv(t, "encoder.net.3", en + ("c3",), "conv1d")
    linear(t, "encoder.out_net.0", en + ("fc1",))
    batchnorm(t, "encoder.out_net.1", en + ("fbn1",))
    linear(t, "encoder.out_net.3", en + ("fc2",))
    batchnorm(t, "encoder.out_net.4", en + ("fbn2",))
    linear(t, "encoder.out_net.6", en + ("fc3",))
    de = ("decoder",)
    linear(t, "decoder.pre_net.0", de + ("pre1",))
    batchnorm(t, "decoder.pre_net.1", de + ("pbn",))
    linear(t, "decoder.pre_net.3", de + ("pre2",))
    _deconv_net(t, "decoder", de)
    return t


def motion_ae_state_from_jax(variables) -> dict:
    return state_from_table(variables, motion_ae_table())


def hierarchy_wav_encoder_table(speakers: bool = False):
    """HierarchicalWavEncoder (hierarchy_net.py:17-26 around
    model/ResNetSE34V2.py:13-181 as `feat_extractor`)."""
    t = []
    resnet_se(t, "feat_extractor", (), (3, 4, 6, 3))
    for lvl in ("low", "mid", "high"):
        conv(t, f"feat_extractor.conv_{lvl}", (f"conv_{lvl}",))
        batchnorm(t, f"feat_extractor.bn_{lvl}", (f"bn_{lvl}",))
        linear(t, f"feat_extractor.fc_{lvl}", (f"fc_{lvl}",))
    if speakers:
        t.append(("feat_extractor.speaker_embedding.0.weight",
                  ("params", "speaker_embedding"), "raw"))
        linear(t, "feat_extractor.speaker_embedding.1", ("speaker_fc",))
        linear(t, "feat_extractor.fc1", ("fc1",))
        linear(t, "feat_extractor.fc2", ("fc2",))
    return t


def hierarchy_wav_encoder_state_from_jax(variables,
                                         speakers: bool = False) -> dict:
    return state_from_table(variables, hierarchy_wav_encoder_table(speakers))


def hierarchy_generator_state_from_jax(variables, n_layers: int = 4,
                                       tcn_layers: int = 4,
                                       speakers: bool = False) -> dict:
    """HierarchicalPoseGenerator (hierarchy_net.py:68-163)."""
    t = []
    text_encoder_tcn32_table(t, variables["params"], "text_encoder",
                             ("text_encoder",), tcn_layers)
    linear(t, "out.0", ("out_fc1",))
    linear(t, "out.2", ("out_fc2",))
    if speakers:
        speaker_table(t)
    return _gru_model_state(variables, t, [("gru", ("gru",), n_layers,
                                            True)])


def cvae_v1_state_from_jax(variables) -> dict:
    return state_from_table(variables, cvae_v1_table())


def cvae_v2_state_from_jax(variables) -> dict:
    return state_from_table(variables, cvae_v2_table())


def hand_cvae_state_from_jax(variables) -> dict:
    return state_from_table(variables, hand_cvae_table())


def legacy_seq_table(t, prefix, path, core, bias, normalizer=True, at=0):
    """A legacy factory's Sequential (the port's names): the core layer
    (`core`: "Linear", or the conv kinds) at index `at`, its BatchNorm
    after it. JAX: a _Seq whose core is Linear_0 or Conv_0 and whose norm
    is `norm`."""
    if core == "Linear":
        if bias:
            linear(t, _key(prefix, str(at)), path + ("Linear_0",))
        else:
            t.append((_key(prefix, f"{at}.weight"),
                      ("params",) + path + ("Linear_0", "kernel"), "dense"))
    else:
        conv(t, _key(prefix, str(at)), path + ("Conv_0",), core, bias)
    if normalizer:
        batchnorm(t, _key(prefix, str(at + 1)), path + ("norm",))
    return t


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def state_from_table(variables, table) -> dict:
    """Apply a (torch_key, jax_path, kind) table: {key: torch.Tensor}."""
    return {key: _tensor(TO_TORCH[kind](np.asarray(_get(variables, path))))
            for key, path, kind in table}


def generator_state_from_jax(variables, n_layers: int = 3,
                             tcn_layers: int = 3,
                             variant: str = "memory") -> dict:
    return state_from_table(variables, generator_table(
        variables, n_layers, tcn_layers, variant))


def cvae_v3_state_from_jax(variables) -> dict:
    return state_from_table(variables, cvae_v3_table())


def fgd_ae_state_from_jax(variables) -> dict:
    return state_from_table(variables, fgd_ae_table())


def skeleton_classifier_state_from_jax(variables, n_layers: int = 3) -> dict:
    return state_from_table(variables, skeleton_classifier_table(n_layers))


def emotion_net_state_from_jax(variables) -> dict:
    return state_from_table(variables, emotion_net_table())


def disnet_state_from_jax(variables) -> dict:
    return state_from_table(variables, disnet_table())


def motion_discriminator_state_from_jax(variables, n_layers: int = 2) -> dict:
    return state_from_table(variables, motion_discriminator_table(n_layers))


def pose_discriminator_state_from_jax(variables, n_layers: int = 3) -> dict:
    return state_from_table(variables, pose_discriminator_table(n_layers))


def load_reference_state(module, state: dict) -> None:
    """Load a reference-layout state_dict (a .pth of the reference or of
    this port): DataParallel `module.` prefixes are stripped, and the
    reference's entries the port does not build (BatchNorm
    `num_batches_tracked`, the positional table, the never-applied final
    LayerNorms) are dropped. Every key the module has must be present."""
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    own = module.state_dict()
    missing = [k for k in own if k not in state]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                       f"{missing[:5]}")
    module.load_state_dict({k: state[k] for k in own}, strict=True)


def jax_table(model: str, **geometry) -> Callable[[dict], list]:
    """The weight table of one of the models the JAX CLIs save, as a
    function of the JAX variables (the generator's TCN table reads them):
    "generator" (n_layers, tcn_layers, variant), "cvae" (v3), "cvae_v1",
    "cvae_v2", "fgd", "skeleton" (n_layers), "emotion_net" and
    "motion_discriminator" (n_layers)."""
    fixed = {"cvae": cvae_v3_table, "cvae_v1": cvae_v1_table,
             "cvae_v2": cvae_v2_table, "fgd": fgd_ae_table,
             "emotion_net": emotion_net_table}
    if model == "generator":
        return lambda variables: generator_table(variables, **geometry)
    if model == "skeleton":
        return lambda variables: skeleton_classifier_table(**geometry)
    if model == "motion_discriminator":
        return lambda variables: motion_discriminator_table(**geometry)
    if model in fixed and not geometry:
        return lambda variables: fixed[model]()
    raise ValueError(f"no JAX weight table for {model!r} with {geometry}")


def load_jax_variables(module, variables, table) -> None:
    """Load the JAX `{"params", "batch_stats"}` tree into `module` through
    `table(variables)`, with strict=True."""
    module.load_state_dict(state_from_table(variables, table(variables)),
                           strict=True)


def _adam_state(opt_state):
    """optax's scale_by_adam state ({count, mu, nu}) inside a restored
    opt_state (an optax chain is a list; empty states are None), or None."""
    if isinstance(opt_state, dict):
        if set(opt_state) == {"count", "mu", "nu"}:
            return opt_state
        children = opt_state.values()
    elif isinstance(opt_state, (list, tuple)):
        children = opt_state
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def adam_state_from_jax(optimizer, module, variables, opt_state,
                        table) -> dict:
    """A state_dict for the torch Adam `optimizer` of `module`'s parameters
    from optax's scale_by_adam state in `opt_state`: mu to exp_avg, nu to
    exp_avg_sq, count to step, each moment through the parameter's table
    entry. Raises KeyError or ValueError where the trees do not match."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise KeyError("no scale_by_adam state (count, mu, nu) in opt_state")
    entries = {key: (path, kind) for key, path, kind in table(variables)}
    names = {id(p): n for n, p in module.named_parameters()}
    count = float(np.asarray(adam["count"]))
    sd = optimizer.state_dict()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = {}
    for index, param in enumerate(params):
        path, kind = entries[names[id(param)]]
        if path[0] != "params":
            raise KeyError(f"{names[id(param)]} is not a parameter in JAX")
        moments = {}
        for torch_name, jax_name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            m = _tensor(TO_TORCH[kind](np.asarray(
                _get(adam[jax_name], path[1:]))))
            if tuple(m.shape) != tuple(param.shape):
                raise ValueError(f"{jax_name} of {names[id(param)]} has "
                                 f"shape {tuple(m.shape)}, the parameter "
                                 f"{tuple(param.shape)}")
            moments[torch_name] = m
        state[index] = {"step": torch.tensor(count), **moments}
    sd["state"] = state
    return sd


def load_orbax_model(module, path: Path, table, full: bool = False) -> dict:
    """Load the params and batch_stats of the orbax checkpoint `path` into
    `module` through `table`; returns the restored tree (all of it, the
    optimizer state too, when `full`)."""
    if table is None:
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package: reading it "
            "needs the module's weight table (utils.weights.jax_table)")
    tree = orbax.restore(path, only=None if full else ("params",
                                                      "batch_stats"))
    variables = {"params": tree["params"],
                 "batch_stats": tree.get("batch_stats") or {}}
    load_jax_variables(module, variables, table)
    return tree


def load_reference_checkpoint(module, path, allow_pickle: bool = False,
                              subdir: str | None = None,
                              table=None) -> Path:
    """Load weights into `module` from `path` and return what was read.

    A file is a reference-layout `.pth`: a plain state_dict, or the
    reference's rich dict whose `gen_dict` holds it
    (utils/train_utils.py:168-213), through `load_reference_state`.
    Tensors-only loading (`weights_only=True`) is the rule; a file that
    pickles other objects loads only with `allow_pickle=True`, since
    unpickling runs code from the file.

    A directory is tried as itself, then as `path/subdir` (the GAN
    trainers write their generator under `<model_save_path>/generator`).
    In each: the newest `checkpoint_iteration<N>.pt` of the port's
    trainers loads its "model" state_dict; else an orbax checkpoint of the
    JAX package (the directory itself, or its newest
    `checkpoint_iteration<N>`) loads its params and batch_stats through
    `table`, the module's `jax_table`, with strict=True."""
    p = Path(path)
    if p.is_dir():
        for cand in [p] + ([p / subdir] if subdir else []):
            step = latest_step(cand)
            if step is not None:
                return load_model(module, cand, step)
            found = orbax.find_checkpoint(cand)
            if found is not None:
                load_orbax_model(module, found, table)
                return found
        raise ValueError(
            f"{p} holds neither checkpoint_iteration<N>.pt files of the "
            "port's trainers nor an orbax checkpoint of the JAX package"
            + (f" (nor does {p / subdir})" if subdir else ""))
    try:
        raw = torch.load(p, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        if not allow_pickle:
            raise RuntimeError(
                f"{p} is not loadable as a tensors-only checkpoint (it "
                "pickles other objects); unpickling runs code from the file, "
                "so pass --allow_pickle only for a file you trust") from exc
        raw = torch.load(p, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "gen_dict" in raw:
        raw = raw["gen_dict"]
    load_reference_state(module, raw)
    return p
