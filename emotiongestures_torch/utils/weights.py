"""Weights carried across from the JAX package.

`generator_state_from_jax`, `cvae_v3_state_from_jax`, `fgd_ae_state_from_jax`,
`skeleton_classifier_state_from_jax`, `emotion_net_state_from_jax`,
`disnet_state_from_jax`, `motion_discriminator_state_from_jax` and
`pose_discriminator_state_from_jax` take the JAX `{"params": ...,
"batch_stats": ...}` trees (nested mappings of arrays; anything `np.asarray`
reads) and return state_dicts in the reference PyTorch layout, which is the
port's own, so `load_state_dict(strict=True)` checks the structure.
`load_reference_checkpoint` reads such a state_dict from a `.pth` file, or
the model of the newest checkpoint in a directory the port's trainers wrote.

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
  raw      the same layout
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from .checkpoint import latest_step, load_model

TO_TORCH = {
    "raw": lambda x: np.asarray(x),
    "dense": lambda x: np.asarray(x).T,
    "conv2d": lambda x: np.transpose(np.asarray(x), (3, 2, 0, 1)),
    "conv1d": lambda x: np.transpose(np.asarray(x), (2, 1, 0)),
    "dense1x1": lambda x: np.asarray(x).T[:, :, None],
    "g": lambda x: np.asarray(x).reshape(-1, 1, 1),
    "convT1d": lambda x: np.transpose(np.asarray(x)[::-1], (1, 2, 0)),
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
    child = "ConvTranspose_0" if kind == "convT1d" else "Conv_0"
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


def generator_table(variables, n_layers: int = 3, tcn_layers: int = 3):
    """The table for GestureTransformer(variant="memory")."""
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

    pe = ("prior_seq_encoder",)
    conv(t, "prior_seq_encoder.pred_conv.0", pe + ("pred_conv1",), "conv1d")
    batchnorm(t, "prior_seq_encoder.pred_conv.2", pe + ("pred_bn1",))
    conv(t, "prior_seq_encoder.pred_conv.3", pe + ("pred_conv2",), "conv1d")
    batchnorm(t, "prior_seq_encoder.pred_conv.5", pe + ("pred_bn2",))
    seq_linears(t, "prior_seq_encoder.spatial_memory.spatial_chunk_encoder",
                pe + ("spatial_memory",), ("enc_fc1", "enc_fc2"))
    seq_linears(t, "prior_seq_encoder.temporal_memory.temporal_chunk_encoder",
                pe + ("temporal_memory",), ("chunk_fc1", "chunk_fc2"))
    seq_linears(t, "prior_seq_encoder.temporal_memory.temporal_memory_encoder",
                pe + ("temporal_memory",), ("mem_fc1", "mem_fc2"))
    seq_linears(t, "prior_seq_encoder.post_header", pe,
                ("post_fc1", "post_fc2"))

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
                             tcn_layers: int = 3) -> dict:
    return state_from_table(variables,
                            generator_table(variables, n_layers, tcn_layers))


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


def load_reference_checkpoint(module, path, allow_pickle: bool = False,
                              subdir: str | None = None) -> Path:
    """Load weights into `module` from `path` and return the file read.

    A file is a reference-layout `.pth`: a plain state_dict, or the
    reference's rich dict whose `gen_dict` holds it
    (utils/train_utils.py:168-213), through `load_reference_state`.
    Tensors-only loading (`weights_only=True`) is the rule; a file that
    pickles other objects loads only with `allow_pickle=True`, since
    unpickling runs code from the file.

    A directory is one of the port's trainers' checkpoint directories: the
    newest `checkpoint_iteration<N>.pt` in `path`, else in `path/subdir`
    (the GAN trainer writes its generator under `<model_save_path>/
    generator`), loads its "model" state_dict with strict=True. A directory
    without one is the JAX package's orbax format, which the port does not
    read."""
    p = Path(path)
    if p.is_dir():
        for cand in [p] + ([p / subdir] if subdir else []):
            step = latest_step(cand)
            if step is not None:
                return load_model(module, cand, step)
        raise ValueError(
            f"{p} is a directory without checkpoint_iteration<N>.pt files: "
            "orbax checkpoints of the JAX package are not read by the "
            "PyTorch port; give a reference-layout .pth state_dict file or "
            "a directory the port's trainers wrote")
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
