"""The port's `convert_checkpoint` against the JAX package's, on the CPU, for
all seven kinds: the same reference `.pth` through the JAX converter (an
orbax TrainState, read back by the port's orbax reader and weight tables)
and through the port's converter (`checkpoint_iteration0.pt`) gives the
same weights, bit for bit, equal to the `.pth`'s. The `.pth` layouts
vary: a plain state_dict, a DataParallel `module.` prefix, and the
reference's rich dict with `gen_dict` and a pickled object beside it,
which both converters refuse without `--allow_pickle`.

Geometry is small (d_model 64); EmotionNet has no width flag, so both
converters build it for 8 x 8 spectrograms here (its 4096 x 2048 layer
stays). The JAX converter runs as it is but for its inits, which take
zeros of the right shapes instead of compiling (`fast_jax_converter`):
every leaf is overwritten from the .pth.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

from emotiongestures_torch.cli import convert_checkpoint as PCONV
from emotiongestures_torch.models.emotion_net import EmotionNet
from emotiongestures_torch.train.state import TrainState
from emotiongestures_torch.utils import weights as W
from emotiongestures_torch.utils.checkpoint import load_checkpoint, load_model
from emotiongestures_tpu.cli import convert_checkpoint as JCONV

TABLES = {"generator": W.jax_table("generator", n_layers=1),
          "fgd": W.jax_table("fgd"), "skeleton": W.jax_table("skeleton"),
          "cvae": W.jax_table("cvae"), "cvae_v1": W.jax_table("cvae_v1"),
          "cvae_v2": W.jax_table("cvae_v2"),
          "emotion_net": W.jax_table("emotion_net")}
LAYOUTS = {"generator": "module", "fgd": "plain", "skeleton": "plain",
           "cvae": "rich", "cvae_v1": "plain", "cvae_v2": "module",
           "emotion_net": "plain"}


class _ShapeInit:
    """A flax module whose init returns zeros of its variables' shapes
    (`jax.eval_shape`, no compile): the converter overwrites every leaf
    from the .pth, and a leaf it missed would read back as zeros and fail
    the comparison."""

    def __init__(self, module):
        self.apply = module.apply
        self.init = lambda *a: jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(module.init, *a))


@pytest.fixture
def fast_jax_converter(monkeypatch):
    """The JAX converter without its compiles (this CPU compiles each eager
    op of a flax init or an optax init anew): the init through
    `_ShapeInit`, the optimizer's zeros from `jax.eval_shape`. Both
    converters build EmotionNet for 8 x 8 spectrograms."""
    import jax.numpy as jnp

    from emotiongestures_tpu.train import state as jstate

    build = JCONV._build

    def jax_build(args):
        model, init_args, needs_sample, imp = build(args)
        if args.kind == "emotion_net":
            init_args = (jnp.zeros((1, 8, 8), jnp.float32),)
        return _ShapeInit(model), init_args, needs_sample, imp

    create = jstate.create_train_state

    def train_state(model, variables, tx):
        state = create(model, {"params": {}}, tx)
        zeros = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(tx.init, variables["params"]))
        return state.replace(params=variables["params"],
                             batch_stats=variables.get("batch_stats", {}),
                             opt_state=zeros)

    monkeypatch.setattr(JCONV, "_build", jax_build)
    monkeypatch.setattr(jstate, "create_train_state", train_state)
    port_build = PCONV.build_model
    monkeypatch.setattr(PCONV, "build_model", lambda args, device: (
        EmotionNet(spec_shape=(8, 8), device=device)
        if args.kind == "emotion_net" else port_build(args, device)))


def _argv(kind):
    """Small geometry; the v1 / v2 CVAEs are built for 512-wide features
    whatever --d_model says, so they keep 512."""
    d_model = "512" if kind in ("cvae_v1", "cvae_v2") else "64"
    return ["--pose_dim", "27", "--d_model", d_model, "--latent_dim", "128",
            "--gen_layers", "1", "--n_words", "16"]


def _reference_pth(kind, path):
    """A seeded port module of `kind` saved in the layout LAYOUTS names."""
    args = PCONV.build_parser().parse_args(
        ["--kind", kind, "--input", "x", "--output", "y", *_argv(kind)])
    torch.manual_seed(7)
    module = PCONV.build_model(args, "cpu")
    sd = module.state_dict()
    layout = LAYOUTS[kind]
    if layout == "module":
        obj = {f"module.{k}": v for k, v in sd.items()}
    elif layout == "rich":
        obj = {"gen_dict": sd, "args": argparse.Namespace(epochs=3)}
    else:
        obj = sd
    torch.save(obj, path)
    return sd


@pytest.mark.parametrize("kind", list(TABLES))
def test_both_converters_give_the_same_weights(kind, tmp_path,
                                               fast_jax_converter):
    pth = tmp_path / f"{kind}.pth"
    want = _reference_pth(kind, pth)
    argv = ["--kind", kind, "--input", str(pth), *_argv(kind)]
    if LAYOUTS[kind] == "rich":
        for conv in (JCONV, PCONV):
            extra = ["--device", "cpu"] if conv is PCONV else []
            with pytest.raises(Exception, match="allow_pickle"):
                conv.main(conv.build_parser().parse_args(
                    argv + ["--output", str(tmp_path / "refused")] + extra))
        argv.append("--allow_pickle")
    JCONV.main(JCONV.build_parser().parse_args(
        argv + ["--output", str(tmp_path / "jax")]))
    written = PCONV.main(PCONV.build_parser().parse_args(
        argv + ["--output", str(tmp_path / "port"), "--device", "cpu"]))
    assert written == tmp_path / "port" / "checkpoint_iteration0.pt"

    ported = torch.load(written, weights_only=True)
    assert ported["step"] == 0 and not ported["optimizer"]["state"]
    args = PCONV.build_parser().parse_args(argv + ["--output", "z"])
    module = PCONV.build_model(args, "cpu")
    load_model(module, tmp_path / "jax", table=TABLES[kind])
    from_jax = module.state_dict()
    assert set(from_jax) == set(ported["model"]) == set(want)
    for k in want:
        assert torch.equal(from_jax[k], want[k]), k
        assert torch.equal(ported["model"][k], want[k]), k


def test_converted_checkpoint_resumes(tmp_path, fast_jax_converter):
    """The .pt the port writes is what a trainer's --resume reads: the
    weights, step 0, and an Adam state the optimizer accepts."""
    pth = tmp_path / "fgd.pth"
    want = _reference_pth("fgd", pth)
    PCONV.main(PCONV.build_parser().parse_args(
        ["--kind", "fgd", "--input", str(pth), "--output",
         str(tmp_path / "fgd"), "--device", "cpu", *_argv("fgd")]))
    from emotiongestures_torch.train import fgd

    state = fgd.create_state(1, pose_dim=27, device="cpu")
    state, ok = load_checkpoint(state, tmp_path / "fgd")
    assert ok and state.step == 0
    for k, v in state.module.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert isinstance(state, TrainState)
    assert np.isfinite(float(fgd.train_step(
        state, torch.randn(4, 60, 27), 0)[1]["loss"]))
