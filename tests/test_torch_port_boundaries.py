"""Boundaries of the port: it stands without JAX and the JAX package, its
entry points default to the card, and a CPU tensor takes a kernel's plain
version without counting a launch."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "emotiongestures_torch"
FORBIDDEN = ("jax", "flax", "emotiongestures_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke, import in a process where
    jax, flax and emotiongestures_tpu cannot be imported."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'emotiongestures_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import emotiongestures_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'emotiongestures_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_port(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_default_to_cuda():
    """Without a card, an entry point that was not asked for the CPU
    raises instead of carrying on there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from emotiongestures_torch.cli import demo
    from emotiongestures_torch.cli import (
        test_emotion_gesture_diversity_iterative as eval_cli,
    )
    from emotiongestures_torch.eval.beat import batched_onset_frontend
    from emotiongestures_torch.models.cvae import EmotionCVAEv3
    from emotiongestures_torch.models.fgd_ae import FGDAutoEncoder
    from emotiongestures_torch.models.skeleton_classifier import (
        SkeletonTransformer,
    )
    from emotiongestures_torch.models.generator import GestureTransformer
    from emotiongestures_torch.ops.fused_mel import extract_melspectrogram
    from emotiongestures_torch.serving import GestureServer
    from emotiongestures_torch.cli import train_emotion_gesture as train_cli
    from emotiongestures_torch.models.discriminator import (
        MotionDiscriminator,
        PoseDiscriminator,
    )
    from emotiongestures_torch.train import gan
    from emotiongestures_torch.cli import train_auxiliary as aux_cli
    from emotiongestures_torch.cli import (
        train_audio_classifier_K_fold as kfold_cli,
    )
    from emotiongestures_torch.models.emotion_net import DisNet, EmotionNet
    from emotiongestures_torch.train import classifier, cvae, fgd, skeleton
    from emotiongestures_torch.data.preprocessing import DataPreprocessor

    calls = [
        lambda: GestureTransformer(n_words=8),
        lambda: EmotionCVAEv3(),
        lambda: GestureServer(),
        lambda: extract_melspectrogram(np.zeros(16000, np.float32)),
        lambda: demo.main(demo.build_parser().parse_args(["--out", "x"])),
        lambda: FGDAutoEncoder(),
        lambda: SkeletonTransformer(),
        lambda: batched_onset_frontend(np.zeros((1, 16000), np.float32)),
        lambda: eval_cli.main(eval_cli.build_parser().parse_args(
            ["--synthetic", "8", "--test_batch_size", "8"])),
        lambda: MotionDiscriminator(),
        lambda: PoseDiscriminator(),
        lambda: gan.create_states(gan.GANConfig(d_model=64, d_inner=128,
                                                n_layers=1)),
        lambda: train_cli.main(train_cli.build_parser().parse_args(
            ["--synthetic", "8", "--batch_size", "8"])),
        lambda: EmotionNet(spec_shape=(32, 32)),
        lambda: DisNet(),
        lambda: fgd.create_state(),
        lambda: skeleton.create_state(d_model=16, d_inner=32),
        lambda: cvae.create_state(feat_dim=16),
        lambda: classifier.create_state(spec_shape=(32, 32)),
        lambda: classifier.train_k_fold([], []),
        lambda: aux_cli.main(aux_cli.build_parser().parse_args(
            ["--model", "fgd", "--synthetic", "8", "--batch_size", "8"])),
        lambda: kfold_cli.main(kfold_cli.build_parser().parse_args(
            ["--synthetic", "8", "--batch_size", "8"])),
        # the real-data stack: the device frontends of the preprocessor,
        # and the four CLIs reading their stores (no --synthetic)
        lambda: DataPreprocessor("clips", "out", 60, 30, 15,
                                 spectrogram_frontend="pallas"),
        lambda: DataPreprocessor("clips", "out", 60, 30, 15,
                                 spectrogram_frontend="xla"),
        lambda: eval_cli.main(eval_cli.build_parser().parse_args([])),
        lambda: train_cli.main(train_cli.build_parser().parse_args([])),
        lambda: aux_cli.main(aux_cli.build_parser().parse_args(
            ["--model", "fgd"])),
        lambda: kfold_cli.main(kfold_cli.build_parser().parse_args([])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_codec_is_built_from_the_ports_own_source():
    """The batch gather the port loads is its own build of
    emotiongestures_torch/csrc/codec.cpp, never the JAX package's
    native/libegtp_codec.so."""
    from emotiongestures_torch.data import store

    assert store.CODEC_SRC == PORT / "csrc" / "codec.cpp"
    loaded = Path(store.native_codec()._name).resolve()
    assert loaded == store.codec_target().resolve()
    assert loaded.is_relative_to(PORT / "_build")
    assert store.codec_target().name.startswith("libegtp_codec-")


def test_cpu_tensors_take_plain_versions():
    from emotiongestures_torch.ops import fused_attention as FA
    from emotiongestures_torch.ops import fused_mel as FM
    from emotiongestures_torch.ops import fused_se_stage as FS
    from emotiongestures_torch.ops import mel as M

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 60, 128, generator=g)
    ws = [torch.randn(128, 128, generator=g) / 12 for _ in range(4)]
    s, b = torch.ones(128), torch.zeros(128)
    a0, m0, s0 = FA.launches, FM.launches, FS.launches
    got = FA.fused_attention(q, q, *ws, s, b, n_head=4, d_k=32)
    assert torch.equal(got, FA.fused_attention_plain(q, q, *ws, s, b, 4, 32))
    padded = M.pad_center(torch.randn(2, 16000, generator=g))
    n = M.n_frames_of(padded.shape[-1])
    assert torch.equal(FM.mel_power(padded, n), FM.mel_power_plain(padded, n))
    x = torch.relu(torch.randn(1, 4, 5, 128, generator=g))
    ops = (torch.randn(2, 3, 3, 128, 128, generator=g) / 34,
           torch.ones(2, 128), torch.zeros(2, 128),
           torch.randn(2, 3, 3, 128, 128, generator=g) / 34,
           torch.ones(2, 128), torch.zeros(2, 128),
           torch.randn(2, 128, 16, generator=g) / 11, torch.zeros(2, 16),
           torch.randn(2, 16, 128, generator=g) / 4, torch.zeros(2, 128))
    assert torch.equal(FS.fused_se_stage(x, *ops),
                       FS.fused_se_stage_plain(x, *ops))
    assert (FA.launches, FM.launches, FS.launches) == (a0, m0, s0)


def test_fused_routing_rule():
    """The JAX package's rule (nn/transformer.py:89-91): fused, eval mode,
    no mask, d_k == d_v, Lq and Lk <= 64, widths == d_model."""
    from emotiongestures_torch.nn.transformer import MultiHeadAttention

    m = MultiHeadAttention(2, 64, 32, 32, fused=True).eval()
    x, long = torch.zeros(1, 60, 64), torch.zeros(1, 65, 64)
    assert m.can_fuse(x, x, None)
    assert not m.can_fuse(x, long, None)
    assert not m.can_fuse(long, x, None)
    assert not m.can_fuse(x, x, torch.ones(1, 60, 60))
    assert not m.train().can_fuse(x, x, None)
    assert not MultiHeadAttention(2, 64, 32, 16, fused=True).eval() \
        .can_fuse(x, x, None)
    assert not MultiHeadAttention(2, 64, 32, 32).eval().can_fuse(x, x, None)


def test_render_flag_raises_clearly():
    from emotiongestures_torch.cli import demo

    args = demo.build_parser().parse_args(["--render", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="render"):
        demo.main(args)
