"""The port's `convert_data` CLI against the JAX package's, on the CPU: the
four subcommands on the same inputs give the same bytes (the stores'
data.bin and index.npy, the `wordvec` .npy), and `cli()` exits 0 with a
warning when nothing was converted."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch_port_migration_common as C

from emotiongestures_torch.cli import convert_data as PCLI
from emotiongestures_torch.data.arrow014 import serialize
from emotiongestures_torch.data.vocab import Vocab
from emotiongestures_tpu.cli import convert_data as JCLI

REPO = Path(__file__).resolve().parent.parent


def _run(cli, argv):
    return cli.main(cli.build_parser().parse_args(argv))


def _both(argv_of):
    """Both CLIs' main on argv_of("port") and argv_of("jax"): their
    counts."""
    return _run(PCLI, argv_of("port")), _run(JCLI, argv_of("jax"))


def _same_store(a, b):
    for f in ("data.bin", "index.npy"):
        assert (Path(a) / f).read_bytes() == (Path(b) / f).read_bytes(), f


@pytest.mark.parametrize("kind", ["beat", "ted", "committed", "clips"])
def test_cache_and_clips_subcommands_match_jax(tmp_path, kind):
    if kind == "committed":
        src = C.FIXTURES / "beat_cache_lmdb"
    else:
        src = C.write_cache_lmdb(tmp_path / "lmdb", serialize, kind, n=4)
    command = "clips" if kind == "clips" else "cache"
    counts = _both(lambda name: [
        command, "--lmdb", str(src), "--out", str(tmp_path / name)])
    want = {"clips": 6, "committed": 2}.get(kind, 4)
    assert counts == (want, want)
    _same_store(tmp_path / "port", tmp_path / "jax")


def test_synthetic_subcommand_matches_jax(tmp_path):
    counts = _both(lambda name: [
        "synthetic", "--out", str(tmp_path / name), "--n", "6", "--seed",
        "3", "--class_overlap", "0.25"])
    assert counts == (6, 6)
    _same_store(tmp_path / "port", tmp_path / "jax")


def test_wordvec_subcommand_matches_jax(tmp_path):
    """A vocabulary pickle written by the port, a seeded 300-d text .vec
    (a fasttext header line, words in and out of the vocabulary); each CLI
    reads its own copy, since the loader caches beside it."""
    vocab = Vocab("words")
    for k in range(30):
        vocab.index_word(f"word{k}")
    vocab.save(tmp_path / "vocab.pkl")
    r = np.random.RandomState(4)
    lines = ["40 300"] + [
        f"word{k} " + " ".join(f"{x:.6f}" for x in r.randn(300))
        for k in range(0, 40, 2)]
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "vectors.vec").write_text("\n".join(lines) + "\n")
    counts = _both(lambda name: [
        "wordvec", "--vocab", str(tmp_path / "vocab.pkl"), "--vectors",
        str(tmp_path / name / "vectors.vec"), "--out",
        str(tmp_path / name / "wv.npy")])
    assert counts == (vocab.n_words, vocab.n_words)
    got = tmp_path / "port" / "wv.npy"
    assert got.read_bytes() == (tmp_path / "jax" / "wv.npy").read_bytes()
    weights = np.load(got)
    assert weights.shape == (vocab.n_words, 300)
    np.testing.assert_array_equal(
        weights[vocab.word2index["word4"]],
        np.array(lines[3].split()[1:], np.float32))


def test_cli_exits_zero_and_warns_on_an_empty_source(tmp_path):
    """`python -m ...convert_data cache` on an LMDB with no entries: exit 0,
    an empty store, the warning on stderr; JAX's main counts 0 too."""
    src = C.write_lmdb(tmp_path / "empty", {})
    out = subprocess.run(
        [sys.executable, "-m", "emotiongestures_torch.cli.convert_data",
         "cache", "--lmdb", str(src), "--out", str(tmp_path / "port")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "warning: 0 records converted" in out.stderr
    assert "converted 0 records" in out.stdout
    assert _run(JCLI, ["cache", "--lmdb", str(src), "--out",
                       str(tmp_path / "jax")]) == 0
    _same_store(tmp_path / "port", tmp_path / "jax")


def test_parsers_take_the_same_flags():
    """Flag for flag: every subcommand's options and defaults."""
    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {name: sorted((a.dest, a.default, a.required)
                             for a in p._actions if a.dest != "help")
                for name, p in sub.choices.items()}

    assert flags(PCLI.build_parser()) == flags(JCLI.build_parser())
