"""The model zoo's baselines and building blocks against the JAX package at
fp32 on the CPU: nn/gru.py, the transformer leftovers (PositionalEncoding
and the masks), models/baselines/ (seq2seq, speech2gesture, trimodal,
hierarchy, the embedding net and the motion autoencoder, discriminators
included), models/legacy_submodules.py and TED's EmbeddingSpaceEvaluator.

Each case fills the JAX module's variables at a small width (the shapes of
its init, `fill`), moves its BatchNorm statistics and affine parameters
off their init values (test_torch_port_modules.py::perturb), carries the
weights across with the port's utils/weights.py and loads them with
strict=True, then runs both in eval mode and in train mode with dropout
off on both sides (flax's Dropout patched to identity, the port's p = 0),
where the running statistics each side writes are compared too. Random draws (speaker z, the context and
pose VAEs) are injected into both. The port's tables are held to the JAX
package's functions where it has one (same keys, in order, and arrays),
and to tables this file writes from the JAX modules' names where the port
chose the names.

Tolerances: every output within rtol 2e-4, atol 2e-5 of its largest entry
(the parity default); running statistics rtol 1e-4, atol 1e-6. seq2seq's
5-step autoregressive decode feeds each output back through a GRU, which
compounds the two packages' fp32 summation orders; it is held at the same
tolerance and needs no more. Batches are 8 rows: train-mode BatchNorm over
3 rows made PoseDecoderFC's four BatchNorms amplify rounding to 2e-5 of
the output's scale.
"""
from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_train_common as C
from test_torch_port_modules import perturb
from torch_port_train_common import one_torch_thread  # noqa: F401
from torch_port_zoo_common import rel_close

import emotiongestures_tpu.models.baselines.embedding_net as jemb
import emotiongestures_tpu.models.baselines.hierarchy as jhier
import emotiongestures_tpu.models.baselines.motion_ae as jmae
import emotiongestures_tpu.models.baselines.seq2seq as js2s
import emotiongestures_tpu.models.baselines.speech2gesture as js2g
import emotiongestures_tpu.models.baselines.trimodal as jtri
import emotiongestures_tpu.models.legacy_submodules as jleg
import emotiongestures_tpu.nn.gru as jgru
import emotiongestures_tpu.nn.transformer as jtr
from emotiongestures_tpu.eval import embedding_space_evaluator as jeval_mod
from emotiongestures_tpu.utils import torch_port as tp
from emotiongestures_torch.eval import embedding_space_evaluator as teval_mod
from emotiongestures_torch.models import legacy_submodules as tleg
from emotiongestures_torch.models.baselines import embedding_net as temb
from emotiongestures_torch.models.baselines import hierarchy as thier
from emotiongestures_torch.models.baselines import motion_ae as tmae
from emotiongestures_torch.models.baselines import quirks
from emotiongestures_torch.models.baselines import seq2seq as ts2s
from emotiongestures_torch.models.baselines import speech2gesture as ts2g
from emotiongestures_torch.models.baselines import trimodal as ttri
from emotiongestures_torch.nn import gru as tgru
from emotiongestures_torch.nn import transformer as ttr
from emotiongestures_torch.utils import weights as W

B = 8  # train-mode BatchNorm over fewer rows is ill-conditioned
R = np.random.RandomState(0)


def randn(*shape, scale=1.0, seed=None):
    r = R if seed is None else np.random.RandomState(seed)
    return (scale * r.randn(*shape)).astype(np.float32)


def tokens(n_words, *shape):
    return R.randint(1, n_words, shape)


def wave_len(frames):
    """The least raw-wave length WavEncoder turns into `frames` steps."""
    n = 1
    while True:
        l0 = (n + 3200 - 15) // 5 + 1
        l3 = ((((l0 - 15) // 6 + 1) - 15) // 6 + 1 - 15) // 6 + 1
        if l3 == frames:
            return n
        n += 1


@dataclass
class Case:
    jmod: object                 # the JAX module
    jargs: tuple                 # its inputs (numpy, ints or None)
    tmod: torch.nn.Module        # the port's module, on the CPU
    state: Callable              # JAX variables -> the port's state_dict
    targs: Optional[tuple] = None  # the port's inputs, if not jargs'
    tkw: dict = field(default_factory=dict)
    jkw: dict = field(default_factory=dict)
    noise: Optional[np.ndarray] = None  # what jax.random.normal returns
    jax_state: Optional[Callable] = None  # the JAX package's own table
    own_table: Optional[list] = None  # this file's JAX-side table
    port_table: Optional[list] = None  # the port's table of the same part
    to_jax: Callable = lambda out: out  # port output -> JAX layout
    jtrain: bool = True          # the JAX module takes `train`


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _with_grus(table, grus):
    def state(v):
        out = W.state_from_table(v, table)
        for prefix, path, n, bidir in grus:
            W.gru_state(out, prefix, _at(v["params"], path), n, bidir)
        return out
    return state


def _nchw(x):
    return np.ascontiguousarray(np.moveaxis(x, -1, 1))


def _own(*entries):
    """A JAX-side table from (kind, torch prefix, JAX path) entries, with
    the JAX package's own helpers."""
    t = []
    for kind, prefix, path in entries:
        if kind == "linear":
            tp._linear(t, prefix, path)
        elif kind == "bn":
            tp._bn(t, prefix, path)
        else:
            tp._conv(t, prefix, path, kind=kind)
    return t


def _pre_pose(prefix):
    return [("linear", f"{prefix}pre_pose_net.0", ("pre1",)),
            ("bn", f"{prefix}pre_pose_net.1", ("pre_bn",)),
            ("linear", f"{prefix}pre_pose_net.3", ("pre2",))]


def _case_gru():
    x = randn(B, 5, 4)
    return Case(jgru.GRU(8, 2, bidirectional=True, dropout=0.5), (x,),
                tgru.GRU(4, 8, 2, bidirectional=True, dropout=0.5),
                lambda v: W.gru_state({}, "", v["params"], 2, True))


def _case_gru_cells():
    carry, x = randn(2, B, 8), randn(B, 4)
    return Case(jgru.GRUCellStack(8, 2), (carry, x),
                tgru.GRUCellStack(4, 8, 2),
                lambda v: W.gru_state({}, "", v["params"], 2), jtrain=False)


def _case_seq2seq():
    text, lengths = tokens(20, B, 8), np.full((B,), 8)
    poses = randn(B, 6, 27)
    kw = dict(n_words=20, pose_dim=27, n_frames=6, n_pre_poses=3,
              hidden_size=32, n_layers=2, dropout=0.1, word_embed_size=16)
    return Case(js2s.Seq2SeqNet(**kw), (text, lengths, poses),
                ts2s.Seq2SeqNet(**kw, device="cpu"),
                lambda v: W.seq2seq_state_from_jax(v, 2),
                jax_state=lambda v: tp.flax_seq2seq_to_torch_state(v, 2))


def _case_s2g_generator():
    spec, pre = randn(B, 32, 40), randn(B, 4, 36)
    return Case(js2g.S2GGenerator(n_poses=34, pose_dim=36, n_pre_poses=4),
                (spec, pre), ts2g.S2GGenerator(34, 36, 4, device="cpu"),
                W.s2g_generator_state_from_jax,
                jax_state=lambda v: tp.flax_table_to_torch_state(
                    v, tp.s2g_generator_mapping()))


def _case_s2g_discriminator():
    return Case(js2g.S2GDiscriminator(pose_dim=36), (randn(B, 34, 36),),
                ts2g.S2GDiscriminator(36, device="cpu"),
                W.s2g_discriminator_state_from_jax,
                jax_state=lambda v: tp.flax_table_to_torch_state(
                    v, tp.s2g_discriminator_mapping()))


def _case_trimodal_generator():
    pre, text = randn(4, 60, 28), tokens(30, 4, 60)
    audio = randn(4, 64000)
    kw = dict(n_words=30, pose_dim=27, n_poses=60, hidden_size=32,
              n_layers=2, dropout=0.1)
    return Case(jtri.PoseGenerator(**kw), (pre, text, audio),
                ttri.PoseGenerator(**kw, device="cpu"),
                lambda v: W.trimodal_generator_state_from_jax(v, 2),
                jax_state=lambda v:
                tp.flax_trimodal_generator_to_torch_state(v, 2))


def _case_trimodal_generator_speakers():
    """The speaker z path (the port's names) with text only."""
    pre, text, vid = randn(B, 20, 28), tokens(30, B, 20), np.arange(B) % 4
    noise = randn(B, 16)
    kw = dict(n_words=30, pose_dim=27, n_poses=20, hidden_size=16,
              n_layers=2, dropout=0.1, input_context="text", n_speakers=4)
    return Case(jtri.PoseGenerator(**kw), (pre, text, None, vid),
                ttri.PoseGenerator(**kw, device="cpu"),
                lambda v: W.trimodal_generator_state_from_jax(v, 2),
                tkw={"noise": torch.from_numpy(noise)}, noise=noise,
                own_table=_own(("linear", "speaker_embedding.1",
                                ("speaker_fc",)),
                               ("linear", "speaker_mu", ("speaker_mu",)),
                               ("linear", "speaker_logvar",
                                ("speaker_logvar",))),
                port_table=[e for e in _speaker_table()
                            if e[0] != "speaker_embedding.0.weight"])


def _speaker_table():
    t = []
    W.speaker_table(t)
    return t


def _case_trimodal_discriminator():
    kw = dict(n_poses=60, hidden_size=32, n_layers=2, dropout=0.1)
    return Case(jtri.TrimodalDiscriminator(**kw), (randn(B, 60, 27),),
                ttri.TrimodalDiscriminator(27, **kw, device="cpu"),
                lambda v: W.trimodal_discriminator_state_from_jax(v, 2),
                jax_state=lambda v:
                tp.flax_trimodal_discriminator_to_torch_state(v, 2))


def _case_conv_discriminator():
    return Case(jtri.ConvDiscriminator(), (randn(B, 60, 27),),
                ttri.ConvDiscriminator(27, 60, device="cpu"),
                W.conv_discriminator_state_from_jax,
                jax_state=tp.flax_conv_discriminator_to_torch_state)


def _case_hierarchy_wav_encoder():
    spec, vid = randn(4, 32, 20), np.array([1, 3, 0, 2])
    return Case(jhier.HierarchicalWavEncoder(n_out=32, pose_level=3,
                                             n_speakers=4), (spec, vid),
                thier.HierarchicalWavEncoder(32, 3, 4, n_mels=32,
                                             spec_len=20, device="cpu"),
                lambda v: W.hierarchy_wav_encoder_state_from_jax(v, True),
                jax_state=lambda v:
                tp.flax_hierarchy_wav_encoder_to_torch_state(v, True))


def _case_hierarchy_generator():
    pre, text, audio = randn(B, 60, 28), tokens(20, B, 60), randn(B, 60, 32)
    vid, noise = np.arange(B) % 4, randn(B, 16)
    kw = dict(n_words=20, pose_dim=27, n_poses=60, hidden_size=32,
              n_layers=2, word_embed_size=16, n_speakers=4)
    return Case(jhier.HierarchicalPoseGenerator(**kw),
                (pre, text, audio, vid),
                thier.HierarchicalPoseGenerator(**kw, device="cpu"),
                lambda v: W.hierarchy_generator_state_from_jax(
                    v, 2, 2, speakers=True),
                tkw={"noise": torch.from_numpy(noise)}, noise=noise,
                jax_state=lambda v: tp.flax_hierarchy_generator_to_torch_state(
                    v, 2, 2, speakers=True))


def _case_hierarchy_discriminator():
    kw = dict(hidden_size=32, n_layers=2, n_poses=60, dropout=0.1)
    return Case(jhier.HierarchicalDiscriminator(**kw), (randn(B, 60, 27),),
                thier.HierarchicalDiscriminator(27, **kw, device="cpu"),
                lambda v: W.hierarchy_discriminator_state_from_jax(v, 2),
                jax_state=lambda v:
                tp.flax_hierarchy_discriminator_to_torch_state(v, 2))


def _case_hierarchy_conv_discriminator():
    return Case(jhier.HierarchicalConvDiscriminator(), (randn(B, 60, 27),),
                thier.HierarchicalConvDiscriminator(27, 60, device="cpu"),
                W.hierarchy_conv_discriminator_state_from_jax,
                jax_state=tp.flax_hierarchy_conv_discriminator_to_torch_state)


def _case_motion_ae():
    return Case(jmae.MotionAE(pose_dim=30, latent_dim=16),
                (randn(B, 34, 30),), tmae.MotionAE(30, 16, device="cpu"),
                W.motion_ae_state_from_jax,
                jax_state=tp.flax_motion_ae_to_torch_state)


def _case_embedding_net_pose():
    pre, poses = randn(B, 4, 27), randn(B, 34, 27)
    return Case(jemb.EmbeddingNet(n_words=5, pose_dim=27, n_frames=34),
                (None, None, pre, poses),
                temb.EmbeddingNet(5, 27, 34, device="cpu"),
                W.embedding_net_state_from_jax,
                jax_state=tp.flax_embedding_net_pose_to_torch_state)


def _case_embedding_net_speech():
    """`speech` mode: the context encoder and the GRU decoder (the port's
    names); the context VAE's draw injected."""
    text, audio = tokens(20, B, 20), randn(B, wave_len(20))
    pre, poses, noise = randn(B, 4, 27), randn(B, 20, 27), randn(B, 32)
    own = _own(("linear", "context_encoder.out.0", ("context_encoder",
                                                    "out1")),
               ("bn", "context_encoder.out.1", ("context_encoder", "bn")),
               ("linear", "context_encoder.out.3", ("context_encoder",
                                                    "out2")),
               ("linear", "context_encoder.fc_mu", ("context_encoder",
                                                    "fc_mu")),
               ("linear", "context_encoder.fc_logvar",
                ("context_encoder", "fc_logvar")),
               *[(k, p, ("decoder",) + j) for k, p, j in
                 _pre_pose("decoder.")],
               ("linear", "decoder.out.0", ("decoder", "out1")),
               ("linear", "decoder.out.2", ("decoder", "out2")))
    port = [e for e in W.context_encoder_table(
        {"context_encoder": {"text_encoder": {"tcn": {
            f"block{i}": {} for i in range(3)}}}},
        "context_encoder", ("context_encoder",))
        if e[0].startswith(("context_encoder.out", "context_encoder.fc"))]
    port += W.pose_decoder_gru_table("decoder", ("decoder",))
    return Case(jemb.EmbeddingNet(n_words=20, pose_dim=27, n_frames=20,
                                  mode="speech"),
                (text, audio, pre, poses),
                temb.EmbeddingNet(20, 27, 20, mode="speech", device="cpu"),
                lambda v: W.embedding_net_state_from_jax(v, "speech"),
                jkw={"input_mode": "speech"},
                tkw={"input_mode": "speech",
                     "context_noise": torch.from_numpy(noise)},
                noise=noise, own_table=own, port_table=port)


def _case_pose_encoder_variational():
    poses, noise = randn(B, 60, 10), randn(B, 32)
    return Case(jemb.PoseEncoderConv(latent_dim=32), (poses,),
                temb.PoseEncoderConv(60, 10),
                W.pose_encoder_conv_state_from_jax,
                jkw={"variational_encoding": True},
                tkw={"variational_encoding": True,
                     "noise": torch.from_numpy(noise)}, noise=noise,
                jax_state=tp.flax_pose_encoder_conv_to_torch_state)


def _case_pose_decoder_conv_pre():
    table = W.pose_decoder_conv_table(use_pre_poses=True)
    return Case(jemb.PoseDecoderConv(length=34, pose_dim=10,
                                     use_pre_poses=True),
                (randn(B, 32), randn(B, 4, 10)),
                temb.PoseDecoderConv(34, 10, use_pre_poses=True),
                lambda v: W.state_from_table(v, table),
                own_table=_own(*_pre_pose("")), port_table=table[:8])


def _case_pose_decoder_fc():
    table = W.pose_decoder_fc_table(use_pre_poses=True)
    own = _own(*_pre_pose(""), *[e for i in range(4) for e in (
        ("linear", f"net.{3 * i}", (f"fc{i}",)),
        ("bn", f"net.{3 * i + 1}", (f"bn{i}",)))],
        ("linear", "net.12", ("fc_out",)))
    return Case(jemb.PoseDecoderFC(gen_length=10, pose_dim=6,
                                   use_pre_poses=True),
                (randn(B, 32), randn(B, 4, 6)),
                temb.PoseDecoderFC(10, 6, use_pre_poses=True),
                lambda v: W.state_from_table(v, table), own_table=own,
                port_table=table)


def _case_pose_decoder_gru():
    table = W.pose_decoder_gru_table()
    own = _own(*_pre_pose(""), ("linear", "out.0", ("out1",)),
               ("linear", "out.2", ("out2",)))
    return Case(jemb.PoseDecoderGRU(gen_length=10, pose_dim=6,
                                    hidden_size=16),
                (randn(B, 32), randn(B, 4, 6)),
                temb.PoseDecoderGRU(10, 6, hidden_size=16),
                _with_grus(table, [("gru", ("gru",), 4, True)]),
                own_table=own, port_table=table)


# --- the legacy factories (NCHW in the port, NHWC in JAX) ------------------


def _legacy(jmod, x, tmod, entries, to_nchw=True):
    t = []
    for prefix, path, core, bias, normalizer, at in entries:
        W.legacy_seq_table(t, prefix, path, core, bias, normalizer, at)
    own = []
    for prefix, path, core, bias, normalizer, at in entries:
        p = f"{prefix}.{at}" if prefix else str(at)
        if core == "Linear":
            if bias:
                tp._linear(own, p, path + ("Linear_0",))
            else:
                own.append((f"{p}.weight", ("params",) + path
                            + ("Linear_0", "kernel"), "dense"))
        else:
            child = "ConvTranspose_0" if core == "convT2d" else "Conv_0"
            own.append((f"{p}.weight", ("params",) + path
                        + ("Conv_0", child, "kernel"), core))
            if bias:
                own.append((f"{p}.bias", ("params",) + path
                            + ("Conv_0", child, "bias"), "raw"))
        if normalizer:
            q = f"{prefix}.{at + 1}" if prefix else str(at + 1)
            tp._bn(own, q, path + ("norm",))
    return Case(jmod, (x,), tmod, lambda v: W.state_from_table(v, t),
                targs=(torch.from_numpy(_nchw(x)) if to_nchw
                       else torch.from_numpy(x),),
                own_table=own, port_table=t,
                to_jax=(lambda out: np.moveaxis(out, 1, -1)) if to_nchw
                else (lambda out: out))


def _case_legacy_linear():
    return _legacy(jleg.linear(16), randn(B + 2, 8), tleg.linear(8, 16),
                   [("", (), "Linear", False, True, 0)], to_nchw=False)


def _case_legacy_linear_plain():
    return _legacy(jleg.linear(16, activation=None, normalizer=False),
                   randn(B, 8), tleg.linear(8, 16, None, False),
                   [("", (), "Linear", True, False, 0)], to_nchw=False)


def _case_legacy_conv2d():
    return _legacy(jleg.conv2d(6, ksize=3, stride=2, padding=1),
                   randn(B, 9, 7, 4), tleg.conv2d(4, 6, 3, 2, 1),
                   [("", (), "conv2d", False, True, 0)])


def _case_legacy_conv3d():
    return _legacy(jleg.conv3d(5, normalizer=False), randn(B, 4, 5, 6, 3),
                   tleg.conv3d(3, 5, normalizer=False),
                   [("", (), "conv3d", True, False, 0)])


def _case_legacy_conv_transpose2d():
    return _legacy(jleg.conv_transpose2d(5), randn(B, 4, 5, 3),
                   tleg.conv_transpose2d(3, 5),
                   [("", (), "convT2d", False, True, 0)])


def _case_legacy_nn_conv2d():
    return _legacy(jleg.nn_conv2d(5), randn(B, 4, 3, 2),
                   tleg.nn_conv2d(2, 5),
                   [("", ("conv",), "conv2d", False, True, 1)])


def _case_legacy_residual_block():
    return _legacy(jleg.ResidualBlock(3), randn(B, 4, 5, 3, 3),
                   tleg.ResidualBlock(3),
                   [("block0", ("block0",), "conv3d", False, True, 0),
                    ("block1", ("block1",), "conv3d", False, True, 0)])


CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
         if name.startswith("_case_")}


def _flat(out):
    """The arrays of an output structure, in order, None dropped."""
    if out is None or isinstance(out, int):
        return []
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [out]


def fill(shapes, seed=0):
    """Weights for a JAX variables tree of these shapes (`jax.eval_shape`
    of its init; an eager flax init of these nets takes tens of seconds on
    the CPU): kernels and tables U(+-1/sqrt(fan in)), biases U(+-0.1),
    weight-norm gains U(0.5, 1.5), BatchNorm and LayerNorm at their init
    (perturb moves them)."""
    r = np.random.RandomState(seed)

    def leaf(path, sd):
        name, shape = path[-1], sd.shape
        if len(shape) >= 2:
            b = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return r.uniform(-b, b, shape).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(shape, np.float32)
        if name == "mean":
            return np.zeros(shape, np.float32)
        if name == "g":
            return r.uniform(0.5, 1.5, shape).astype(np.float32)
        return r.uniform(-0.1, 0.1, shape).astype(np.float32)

    def walk(tree, path=()):
        if hasattr(tree, "items"):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return leaf(path, tree)

    return walk(shapes)


RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(2)}


def prepared(name):
    """The case, its perturbed JAX variables, and the port module holding
    their weights (strict load)."""
    c = CASES[name]()
    args = [None if a is None else jnp.asarray(a) for a in c.jargs]
    variables = perturb(fill(jax.eval_shape(
        lambda: c.jmod.init(RNGS, *args, **c.jkw))))
    c.tmod.load_state_dict(c.state(variables), strict=True)
    return c, variables


def check_tables(name, c, variables):
    """Where the JAX package has a table, the port's copy gives the same
    keys in the same order and the same arrays; where the port chose the
    names, its table is the one this file writes from the JAX modules'
    names. (A building block with no table of its own, a GRU, is in
    torch's layout and held by the parity alone.)"""
    if c.jax_state is not None:
        ours, theirs = c.state(variables), c.jax_state(variables)
        assert list(ours) == list(theirs), name
        for k in theirs:
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(theirs[k]))
    if c.own_table is not None:
        assert c.port_table == c.own_table, name


def run_port(c, train):
    """The port module's outputs in eval or train mode (dropout off), and
    its state_dict after; the module is put back as it was."""
    before = {k: v.clone() for k, v in c.tmod.state_dict().items()}
    if train:
        C.no_dropout(c.tmod)
    c.tmod.train(train)
    targs = c.targs or tuple(None if a is None else torch.from_numpy(
        np.asarray(a)) for a in c.jargs)
    try:
        with torch.no_grad():
            got = c.tmod(*targs, **c.tkw)
        after = {k: v.clone() for k, v in c.tmod.state_dict().items()}
    finally:
        c.tmod.load_state_dict(before)
        c.tmod.eval()
    return got, before, after


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name, monkeypatch):
    """The weight table (check_tables), then eval mode and train mode with
    dropout off on both sides: every output, and in train mode the running
    statistics each side writes. Both JAX modes run in one jit."""
    c, variables = prepared(name)
    check_tables(name, c, variables)
    if c.noise is not None:
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, *a, **k: jnp.asarray(c.noise))
    C.patch_flax_dropout(monkeypatch)
    has_stats = "batch_stats" in variables
    kw = dict(c.jkw, rngs={"sample": jax.random.PRNGKey(3)})

    def both(v, *a):
        modes = []
        for train in (False, True):
            k = dict(kw)
            if c.jtrain:
                k["train"] = train
            if train and has_stats:
                k["mutable"] = ["batch_stats"]
            modes.append(c.jmod.apply(v, *a, **k))
        return modes

    args = [None if a is None else jnp.asarray(a) for a in c.jargs]
    # a fresh jit: traced under this test's patches
    want_eval, want_train = jax.jit(both)(
        jax.tree_util.tree_map(jnp.asarray, variables), *args)
    if has_stats:
        want_train, mutated = want_train
    for mode, want in (("eval", want_eval), ("train", want_train)):
        got, before, after = run_port(c, mode == "train")
        got, want = _flat(got), _flat(want)
        assert len(got) == len(want) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            g = c.to_jax(g.numpy())
            assert g.shape == np.shape(w), (name, i)
            rel_close(g, w, msg=f"{name} {mode} output {i}")
    if has_stats:
        stats = c.state({"params": variables["params"],
                         "batch_stats": mutated["batch_stats"]})
        buffers = [k for k in after if "running_" in k]
        assert buffers
        for k in buffers:
            np.testing.assert_allclose(after[k].numpy(), stats[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            assert not torch.equal(after[k], before[k]), k


def test_gru_layerwise_dropout_path():
    """Train mode with dropout between layers runs the layers one at a
    time (the masks from core.layers.Dropout's generator): at p -> 0 it is
    cuDNN's fused call, and with p = 0.5 the same generator seed gives the
    same masks."""
    from emotiongestures_torch.core.layers import dropout_generator

    torch.manual_seed(0)
    gru = tgru.GRU(4, 8, 3, bidirectional=True, dropout=1e-12).train()
    x = torch.from_numpy(randn(B, 5, 4))
    with torch.no_grad():
        a = gru(x)
        gru.between.p = 0.0
        b = gru(x)
        gru.between.p = 0.5
        runs = []
        for _ in range(2):
            with dropout_generator(gru, torch.Generator().manual_seed(7)):
                runs.append(gru(x))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    for u, v in zip(*runs):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert not torch.allclose(runs[0][0], b[0])


def test_sum_bidirectional_and_leaky_relu_true():
    x = torch.from_numpy(randn(B, 5, 12))
    torch.testing.assert_close(tgru.sum_bidirectional(x, 6),
                               x[..., :6] + x[..., 6:])
    np.testing.assert_array_equal(
        np.asarray(jgru.sum_bidirectional(jnp.asarray(x.numpy()), 6)),
        tgru.sum_bidirectional(x, 6).numpy())
    y = torch.tensor([-2.0, 0.0, 3.0])
    assert torch.equal(quirks.leaky_relu_true(y), y)
    assert torch.equal(quirks.LeakyReLUTrue()(y), y)
    # what the reference wrote: torch's LeakyReLU(True) has slope 1.0
    assert torch.equal(torch.nn.LeakyReLU(True)(y), y)


def test_positional_encoding_and_masks_match_jax():
    x = randn(2, 7, 16)
    got = ttr.PositionalEncoding(16, 20)(torch.from_numpy(x))
    want = jtr.PositionalEncoding(16, 20).apply({}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    seq = np.array([[3, 1, 0, 0], [2, 2, 2, 0]])
    np.testing.assert_array_equal(
        ttr.get_pad_mask(torch.from_numpy(seq), 0).numpy(),
        np.asarray(jtr.get_pad_mask(jnp.asarray(seq), 0)))
    np.testing.assert_array_equal(
        ttr.get_subsequent_mask(torch.from_numpy(seq)).numpy(),
        np.asarray(jtr.get_subsequent_mask(jnp.asarray(seq))))
    enc = ttr.TransformerEncoder(1, 2, 8, 8, 16, 32, n_position=20)
    assert not any("position" in k for k in enc.state_dict())


def test_resize_weights_match_jax_image_resize():
    """speech2gesture's make_1d: jax.image.resize's antialiased bilinear
    on both axes, upsampling and downsampling."""
    x = randn(2, 5, 14, 7)
    got = ts2g.resize_bilinear(torch.from_numpy(x), 34, 1)
    want = jax.image.resize(jnp.asarray(x), (2, 5, 34, 1), "bilinear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --- TED's EmbeddingSpaceEvaluator ----------------------------------------


@pytest.mark.parametrize("pose_dim", [27, 126])
def test_embedding_space_evaluator_matches_jax(pose_dim, monkeypatch):
    """4 pushes of 8 windows each into both evaluators on the same weights:
    Fréchet distance and feature distance within rtol 1e-3 (a covariance's
    sqrtm of fp32 features, computed from features that agree to ~1e-6),
    diversity within rtol 1e-4, the reconstruction diagnostics within rtol
    1e-4 and 1e-5 of the size of the sums they are differences of; then
    the Fréchet helper's failure value 100 reported as 1e10 by both."""
    net = (jmae.MotionAE(pose_dim=126, latent_dim=16) if pose_dim == 126
           else jemb.EmbeddingNet(n_words=64, pose_dim=pose_dim,
                                  n_frames=34))
    poses = jnp.zeros((1, 34, pose_dim))
    args = (poses,) if pose_dim == 126 else (None, None, poses[:, :4],
                                              poses)
    variables = perturb(fill(jax.eval_shape(
        lambda: net.init(RNGS, *args)), 5))
    jev = jeval_mod.EmbeddingSpaceEvaluator(
        pose_dim, latent_dim=16,
        variables=jax.tree_util.tree_map(jnp.asarray, variables))
    state = (W.motion_ae_state_from_jax(variables) if pose_dim == 126
             else W.embedding_net_state_from_jax(variables))
    tev = teval_mod.EmbeddingSpaceEvaluator(pose_dim, latent_dim=16,
                                            state_dict=state, device="cpu")
    r = np.random.RandomState(pose_dim)
    for _ in range(4):
        real = r.randn(8, 34, pose_dim).astype(np.float32)
        gen = (real + 0.3 * r.randn(8, 34, pose_dim)).astype(np.float32)
        jev.push_samples(gen, real)
        tev.push_samples(gen, real)
    assert tev.get_no_of_samples() == jev.get_no_of_samples() == 4
    np.testing.assert_allclose(tev.get_scores(), jev.get_scores(),
                               rtol=1e-3)
    np.testing.assert_allclose(tev.get_diversity_scores(),
                               jev.get_diversity_scores(), rtol=1e-4)
    # each diagnostic is a difference of two fp32 sums over a batch: held
    # at 1e-5 of the sums' own size, which untrained weights make large
    recon = tev.embed(real)[0]
    for name, err in (("recon_err_diff", tev._recon_err),
                      ("cos_err_diff", tev._cos_err)):
        np.testing.assert_allclose(getattr(tev, name), getattr(jev, name),
                                   rtol=1e-4,
                                   atol=1e-5 * abs(err(recon, real)),
                                   err_msg=name)
    monkeypatch.setattr(teval_mod, "calculate_frechet_distance",
                        lambda *a: 100)
    monkeypatch.setattr(jeval_mod, "calculate_frechet_distance",
                        lambda *a: 100)
    assert tev.get_scores()[0] == jev.get_scores()[0] == 1e10
    try:
        import umap  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tev.get_features_for_viz()
