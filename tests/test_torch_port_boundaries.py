"""Boundaries of the port: it stands without JAX and the JAX package (and
without `flatbuffers`, `lmdb` and `pyarrow`, which the migration path does
not need, and `orbax`, `tensorstore` and `zstandard`, which reading the JAX
package's checkpoints does not need), its entry points default to the
card, and a CPU tensor takes a kernel's plain version without counting a
launch."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "emotiongestures_torch"
FORBIDDEN = ("jax", "flax", "emotiongestures_tpu", "flatbuffers", "lmdb",
             "pyarrow", "orbax", "tensorstore", "zstandard")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke, import in a process where
    jax, flax, emotiongestures_tpu, flatbuffers, lmdb, pyarrow, orbax,
    tensorstore and zstandard cannot be imported."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'emotiongestures_tpu',\n"
        "             'flatbuffers', 'lmdb', 'pyarrow', 'orbax',\n"
        "             'tensorstore', 'zstandard'):\n"
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


def test_orbax_checkpoint_reads_without_jax_orbax_tensorstore_zstandard():
    """The committed checkpoint the JAX package wrote restores, and loads
    into the port's CVAE, in a process where none of jax, flax, orbax,
    tensorstore, zstandard or emotiongestures_tpu can be imported."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'emotiongestures_tpu',\n"
        "             'orbax', 'tensorstore', 'zstandard'):\n"
        "    sys.modules[name] = None\n"
        "from emotiongestures_torch.models.cvae import EmotionCVAEv3\n"
        "from emotiongestures_torch.utils import orbax, weights\n"
        "d = 'tests/fixtures/orbax_jax/cvae'\n"
        "tree, path = orbax.restore_checkpoint(d)\n"
        "vae = EmotionCVAEv3(feat_dim=32, device='cpu')\n"
        "weights.load_reference_checkpoint(vae, d,\n"
        "                                  table=weights.jax_table('cvae'))\n"
        "print(path.name, int(tree['step']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["checkpoint_iteration2", "2"]


def _guarded_lmdb_imports(tree) -> set:
    """The `import lmdb` statements in `_iter_lmdb`'s try whose ImportError
    handler falls back to the pure-Python reader: the one place the `lmdb`
    package may be imported (where it is installed)."""
    ok = set()
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef) and fn.name == "_iter_lmdb"):
            continue
        for t in ast.walk(fn):
            if isinstance(t, ast.Try) and any(
                    isinstance(h.type, ast.Name) and h.type.id == "ImportError"
                    for h in t.handlers):
                ok.update(id(n) for n in t.body if isinstance(n, ast.Import)
                          and [a.name for a in n.names] == ["lmdb"])
    return ok


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_port(path):
    """No import of jax, flax, emotiongestures_tpu, flatbuffers, pyarrow,
    orbax, tensorstore or zstandard; `lmdb` only behind
    data/store.py::_iter_lmdb's guard."""
    tree = ast.parse(path.read_text())
    guarded = _guarded_lmdb_imports(tree) \
        if path == PORT / "data" / "store.py" else set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        if id(node) in guarded:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_lmdb_guard_is_found():
    """The guard above exempts exactly the one import in _iter_lmdb."""
    tree = ast.parse((PORT / "data" / "store.py").read_text())
    assert len(_guarded_lmdb_imports(tree)) == 1
    bare = ast.parse("import lmdb\ndef _iter_lmdb():\n    import lmdb\n")
    assert not _guarded_lmdb_imports(bare)


def test_entry_points_default_to_cuda():
    """Without a card, an entry point that was not asked for the CPU
    raises instead of carrying on there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from emotiongestures_torch.cli import demo
    from emotiongestures_torch.cli import (
        test_emotion_gesture_diversity_iterative as eval_cli,
    )
    from emotiongestures_torch.eval.beat import (
        BeatAlignerV1,
        batched_onset_frontend,
    )
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
    from emotiongestures_torch.cli import convert_checkpoint as convert_cli

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
        # data parallelism: --num_devices and the multi-host flags change
        # nothing of the rule
        lambda: eval_cli.main(eval_cli.build_parser().parse_args(
            ["--synthetic", "8", "--test_batch_size", "8", "--num_devices",
             "2"])),
        lambda: train_cli.main(train_cli.build_parser().parse_args(
            ["--synthetic", "8", "--batch_size", "8", "--num_devices", "2"])),
        lambda: train_cli.main(train_cli.build_parser().parse_args(
            ["--synthetic", "8", "--batch_size", "8",
             "--coordinator_address", "localhost:1", "--num_processes", "2",
             "--process_id", "0"])),
        lambda: aux_cli.main(aux_cli.build_parser().parse_args(
            ["--model", "fgd", "--synthetic", "8", "--batch_size", "8",
             "--num_devices", "2", "--coordinator_address", "localhost:1",
             "--num_processes", "2", "--process_id", "0"])),
        lambda: kfold_cli.main(kfold_cli.build_parser().parse_args(
            ["--synthetic", "8", "--batch_size", "8", "--num_devices",
             "2"])),
        # BEAT's 6-limb aligner on the card's onset frontend
        lambda: BeatAlignerV1().score_batch(
            np.zeros((1, 64000), np.float32), np.zeros((1, 60, 282)),
            device_frontend=True),
        # the checkpoint converter; the demo reading an orbax checkpoint
        # and rendering
        lambda: convert_cli.main(convert_cli.build_parser().parse_args(
            ["--kind", "fgd", "--input", "x.pth", "--output", "y"])),
        lambda: demo.main(demo.build_parser().parse_args(
            ["--out", "x", "--render", "--cvae_checkpoint",
             str(REPO / "tests" / "fixtures" / "orbax_jax" / "cvae")])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _zoo_factories():
    """The model zoo's public constructors and its two lifted CLI flags:
    name -> build(device)."""
    from emotiongestures_torch.cli import train_auxiliary as aux_cli
    from emotiongestures_torch.cli import train_emotion_gesture as train_cli
    from emotiongestures_torch.eval.embedding_space_evaluator import (
        EmbeddingSpaceEvaluator,
    )
    from emotiongestures_torch.models import baselines as bl
    from emotiongestures_torch.models.cvae import (
        EmotionCVAEv1,
        EmotionCVAEv2,
        HandCVAE,
    )
    from emotiongestures_torch.models.generator import GestureTransformer
    from emotiongestures_torch.train import cvae, gan

    def cli(mod, flags):
        def run(device):
            argv = flags + ([] if device is None else ["--device", device])
            return mod.main(mod.build_parser().parse_args(argv))
        return run

    small = dict(d_model=64, d_inner=128, n_layers=1)
    return {
        **{f"generator-{v}": (lambda v: lambda device: GestureTransformer(
            n_words=8, **small, variant=v, device=device))(v)
           for v in ("base", "spatial_memory", "padding_initial")},
        "cvae-v1": lambda device: EmotionCVAEv1(device=device),
        "cvae-v2": lambda device: EmotionCVAEv2(device=device),
        "hand-cvae": lambda device: HandCVAE(device=device),
        "cvae-state-v1": lambda device: cvae.create_state(
            version=1, device=device),
        "gan-states-base": lambda device: gan.create_states(
            gan.GANConfig(**small, variant="base"), device=device),
        "seq2seq": lambda device: bl.Seq2SeqNet(n_words=8, device=device),
        "s2g-generator": lambda device: bl.S2GGenerator(device=device),
        "s2g-discriminator": lambda device: bl.S2GDiscriminator(
            device=device),
        "trimodal-generator": lambda device: bl.PoseGenerator(
            n_words=8, device=device),
        "trimodal-discriminator": lambda device: bl.TrimodalDiscriminator(
            device=device),
        "conv-discriminator": lambda device: bl.ConvDiscriminator(
            device=device),
        "hierarchy-wav-encoder": lambda device: bl.HierarchicalWavEncoder(
            device=device),
        "hierarchy-generator": lambda device: bl.HierarchicalPoseGenerator(
            n_words=8, device=device),
        "hierarchy-discriminator": lambda device:
        bl.HierarchicalDiscriminator(device=device),
        "hierarchy-conv-discriminator": lambda device:
        bl.HierarchicalConvDiscriminator(device=device),
        "embedding-net": lambda device: bl.EmbeddingNet(8, 27, 34,
                                                        device=device),
        "motion-ae": lambda device: bl.MotionAE(device=device),
        "evaluator-27": lambda device: EmbeddingSpaceEvaluator(
            27, device=device).net,
        "evaluator-126": lambda device: EmbeddingSpaceEvaluator(
            126, device=device).net,
        "gan-cli-variant": cli(train_cli, [
            "--synthetic", "8", "--batch_size", "8", "--variant", "base"]),
        "aux-cli-cvae-v1": cli(aux_cli, [
            "--model", "cvae", "--cvae_version", "1", "--synthetic", "8",
            "--batch_size", "8"]),
    }


ZOO = _zoo_factories()


@pytest.mark.parametrize("name", ZOO)
def test_model_zoo_defaults_to_cuda(name):
    """The zoo's constructors and the lifted --variant / --cvae_version
    paths: without a card, not asking for the CPU raises; asked for it, a
    module is built there (a CLI is only checked to refuse)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    build = ZOO[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(None)
    if "cli" in name:
        return
    built = build("cpu")
    modules = [s.module for s in built] if isinstance(built, tuple) else [
        getattr(built, "module", built)]
    for m in modules:
        assert all(p.device.type == "cpu" for p in m.parameters()), name


def test_package_data_holds_every_kernel_source():
    """An installed port carries every source it builds at run time (the
    CUDA kernels and the C++ batch gather)."""
    import fnmatch
    import tomllib

    conf = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["emotiongestures_torch"]
    sources = [p.relative_to(PORT).as_posix()
               for p in (PORT / "csrc").iterdir()]
    assert sources
    for src in sources:
        assert any(fnmatch.fnmatch(src, g) for g in globs), src


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


def test_render_flag_raises_clearly(monkeypatch):
    """--render without matplotlib (the card's machine has none) stops
    before the demo builds anything, naming matplotlib."""
    from emotiongestures_torch.cli import demo

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = demo.build_parser().parse_args(["--render", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="render.*matplotlib"):
        demo.main(args)


@pytest.mark.cuda
def test_dropout_masks_across_ranks_on_card():
    """Two gloo ranks on the card draw the dropout masks of the global batch
    and keep their rows: together the one-process masks, and different
    from each other (a mask shared across ranks would pass loss checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks draw their masks there")
    import torch_port_parallel_common as P

    from emotiongestures_torch.parallel import mesh

    ref = P.masks_case("cuda")
    m0, m1 = (r for r in mesh.launch(P.masks_case, 2, "cuda", device="cuda",
                                     backend="gloo", timeout=P.TIMEOUT))
    half = P.B // 2
    assert np.array_equal(np.concatenate([m0[1], m1[1]]), ref[1])
    assert not np.array_equal(m0[1], m1[1])
    assert np.array_equal(m0[2], np.concatenate([ref[2][:half],
                                                 ref[2][P.B:P.B + half]]))
