"""One-shot data migration CLI: reference LMDB caches -> GestureStore, the
port of emotiongestures_tpu/cli/convert_data.py, flag for flag.

The reference stores its datasets as pyarrow-0.14-serialized LMDBs
(`data_loader/lmdb_loader_BEAT_full.py:171-180`,
`data_loader/data_preprocessor.py:44-75`); modern pyarrow removed
`deserialize`, so the port reads them with its own LMDB and pyarrow-0.14
readers (data/lmdb_reader.py, data/arrow014.py) and writes its mmap'd record
store (data/store.py). Neither `lmdb` nor `pyarrow` need be installed, and
the stores are byte for byte those of the JAX package's converter. A
reference user migrates once with:

  # windowed train/val/test caches (BEAT or TED layouts, auto-detected)
  python -m emotiongestures_torch.cli.convert_data cache \\
      --lmdb ./data/beat_trainable_dataset/train/beat_cache \\
      --out  ./data/egtp/train_cache

  # RAW clip LMDBs (one video per record), for re-running preprocessing
  python -m emotiongestures_torch.cli.convert_data clips \\
      --lmdb ./data/raw_clips --out ./data/egtp_clips

  # fasttext/GloVe word vectors -> a vocab-aligned .npy, which
  # models.generator.set_pretrained_embedding installs
  python -m emotiongestures_torch.cli.convert_data wordvec \\
      --vocab ./data/vocab_cache.pkl --vectors ./crawl-300d-2M.vec \\
      --out ./data/word_vectors.npy

The command runs on the host only; it takes no device.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    cache = sub.add_parser(
        "cache", help="windowed sample cache LMDB -> GestureStore")
    cache.add_argument("--lmdb", required=True,
                       help="reference LMDB directory (pyarrow 0.14)")
    cache.add_argument("--out", required=True,
                       help="output GestureStore directory")

    clips = sub.add_parser(
        "clips", help="raw clip LMDB (one video/record) -> GestureStore")
    clips.add_argument("--lmdb", required=True)
    clips.add_argument("--out", required=True)

    syn = sub.add_parser(
        "synthetic",
        help="materialise the synthetic set into a BEAT-shaped "
             "GestureStore (rehearsal data for store-fed training)")
    syn.add_argument("--out", required=True,
                     help="output GestureStore directory (pass the "
                          "trainer `--train_data_path <out minus "
                          "_cache>` or point at it with "
                          "use_cache_suffix semantics)")
    syn.add_argument("--n", type=int, default=1024)
    syn.add_argument("--seed", type=int, default=0)
    syn.add_argument("--class_overlap", type=float, default=0.0,
                     help="postural class-overlap knob "
                          "(data/synthetic.py)")

    wv = sub.add_parser(
        "wordvec",
        help="fasttext .vec / GloVe .txt -> vocab-aligned .npy")
    wv.add_argument("--vocab", required=True,
                    help="pickled Vocab (data/vocab.py Vocab.save)")
    wv.add_argument("--vectors", required=True,
                    help="text-format word vectors (fasttext/GloVe)")
    wv.add_argument("--out", required=True, help="output .npy path")
    wv.add_argument("--dim", type=int, default=300)
    return parser


def main(args=None) -> int:
    """Run one subcommand; returns the number of records (or, for
    `wordvec`, of vocabulary rows) written."""
    if args is None:
        args = build_parser().parse_args()
    if args.command in ("cache", "clips"):
        from ..data.store import (
            GestureStore,
            convert_clip_lmdb,
            convert_lmdb_cache,
        )

        convert = convert_lmdb_cache if args.command == "cache" \
            else convert_clip_lmdb
        convert(args.lmdb, args.out)
        store = GestureStore(args.out)
        n = len(store)
        store.close()
        what = "records" if args.command == "cache" else "clip records"
        print(f"converted {n} {what} -> {args.out}")
        return n
    if args.command == "synthetic":
        from ..data.synthetic import materialize_store

        n = materialize_store(args.out, args.n, seed=args.seed,
                              log_every=max(args.n // 10, 1),
                              class_overlap=args.class_overlap)
        print(f"materialized {n} synthetic records -> {args.out}")
        return n
    if args.command == "wordvec":
        import numpy as np

        from ..data.vocab import Vocab

        vocab = Vocab.load(args.vocab)
        vocab.load_glove_vectors(args.vectors, embedding_dim=args.dim)
        np.save(args.out, vocab.word_embedding_weights)
        print(f"exported ({vocab.n_words}, {args.dim}) matrix -> "
              f"{args.out}")
        return vocab.n_words
    raise SystemExit(f"unknown command {args.command}")  # pragma: no cover


def cli() -> None:
    """Command-line entry point: errors raise; a successful conversion
    exits 0 even for an empty source, with a warning on stderr (0 records
    usually means a wrong --lmdb path). main's return value, the record
    count, is not an exit status."""
    if main() == 0:
        print("warning: 0 records converted — check the source path",
              file=sys.stderr)


if __name__ == "__main__":
    cli()
