"""Vocabulary (model/vocab.py:8-130), the port of
emotiongestures_tpu/data/vocab.py: word <-> index with the reference's
special tokens, count-based trimming, and an embedding-weight slot filled
from an offline fasttext export (SURVEY.md §2.6) or a GloVe text file.

Pickles. Both packages cache a vocabulary as a pickle (`vocab_all.pkl`
beside the test set, `<data_dir>_speaker_model.pkl`), and a cache written
by either serves both:
- `Vocab.save` writes the class path of the JAX package's
  `emotiongestures_tpu.data.vocab.Vocab`, which that package's
  `Vocab.load` resolves, through the pure-Python pickler (the C pickler
  imports every global it writes, and this package must not import the JAX
  package);
- `Vocab.load` reads with a restricted unpickler that maps that class path,
  and this module's own, to this `Vocab` without importing anything, takes
  numpy's array reconstruction, and refuses every other global. A plain
  `pickle.load` would import the JAX package, and runs whatever code a
  crafted file names.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np

# the class path a vocabulary pickle names, in both directions
PICKLED_MODULE = "emotiongestures_tpu.data.vocab"
_VOCAB_PATHS = {(PICKLED_MODULE, "Vocab"), (__name__, "Vocab")}
# numpy's array reconstruction, under numpy 1's and numpy 2's module names
_NUMPY_GLOBALS = {
    (mod, name)
    for base in ("numpy.core", "numpy._core")
    for mod, name in ((f"{base}.multiarray", "_reconstruct"),
                      (f"{base}.numeric", "_frombuffer"))
} | {("numpy", "ndarray"), ("numpy", "dtype")}


class Vocab:
    PAD_token = 0
    SOS_token = 1
    EOS_token = 2
    UNK_token = 3

    def __init__(self, name: str, insert_default_tokens: bool = True):
        self.name = name
        self.trimmed = False
        self.word_embedding_weights = None
        self._init_dict(insert_default_tokens)

    def _init_dict(self, insert_default_tokens: bool = True):
        self.word2index = {}
        self.word2count = {}
        if insert_default_tokens:
            self.index2word = {
                self.PAD_token: "<PAD>",
                self.SOS_token: "<SOS>",
                self.EOS_token: "<EOS>",
                self.UNK_token: "<UNK>",
            }
        else:
            self.index2word = {self.UNK_token: "<UNK>"}
        self.n_words = len(self.index2word)

    def index_word(self, word: str):
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.word2count[word] = 1
            self.index2word[self.n_words] = word
            self.n_words += 1
        else:
            self.word2count[word] += 1

    def add_vocab_from_words(self, words):
        for w in words:
            self.index_word(w)

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, self.UNK_token)

    def trim(self, min_count: int):
        """Remove words below a count threshold (model/vocab.py:44-62)."""
        if self.trimmed:
            return
        self.trimmed = True
        keep = [w for w, c in self.word2count.items() if c >= min_count]
        old_count = dict(self.word2count)
        self._init_dict()
        for word in keep:
            self.index_word(word)
            self.word2count[word] = old_count[word]

    def load_word_vectors(self, npy_path, embedding_dim: int = 300):
        """Load an offline-exported embedding matrix. Two formats:
        * .npz with `words` (str array) + `vectors` (n, dim): rows are
          matched to this vocab by word, N(0, 0.4^2) for missing words
          (the fasttext-random convention of model/vocab.py:70-84);
        * .npy of shape (n_words, dim) already aligned to this vocab."""
        path = Path(npy_path)
        rng = np.random.RandomState(0)
        weights = rng.normal(0.0, 0.4, (self.n_words, embedding_dim)).astype(
            np.float32
        )
        if path.suffix == ".npz":
            data = np.load(path, allow_pickle=True)
            table = {
                str(w): v for w, v in zip(data["words"], data["vectors"])
            }
            for word, idx in self.word2index.items():
                if word in table:
                    weights[idx] = table[word]
        else:
            aligned = np.load(path)
            n = min(len(aligned), self.n_words)
            weights[:n] = aligned[:n]
        self.word_embedding_weights = weights
        return weights

    def load_glove_vectors(self, pretrained_path, embedding_dim: int = 300,
                           use_cache: bool = True):
        """GloVe/word2vec TEXT-format loader (model/vocab.py:86-130):
        rows initialised N(0, 1/sqrt(dim)) for special/OOV words, then
        updated from `word v1 ... vd` lines for words in this vocab.
        Results are pickle-cached at `<path>_cache.pkl` with a shape check
        (the reference's behavior; the cache is a pickled numpy array, read
        back through the restricted unpickler). Deviation kept from the JAX
        package: the random init is seeded (RandomState(0))."""
        cache_path = os.path.splitext(str(pretrained_path))[0] + "_cache.pkl"
        weights = None
        if use_cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                weights = _RestrictedUnpickler(f).load()
            if getattr(weights, "shape", None) != (self.n_words,
                                                   embedding_dim):
                weights = None  # reference: "reinitializing..."
        if weights is None:
            init_sd = 1 / np.sqrt(embedding_dim)
            weights = np.random.RandomState(0).normal(
                0, scale=init_sd, size=(self.n_words, embedding_dim)
            ).astype(np.float32)
            with open(pretrained_path, encoding="utf-8") as f:
                for line_raw in f:
                    line = line_raw.split()
                    # the reference wraps extraction AND assignment in one
                    # try/except ValueError (so dim-mismatch rows are
                    # skipped too, model/vocab.py:110-124)
                    try:
                        word = line[0]
                        vector = np.array(line[1:], dtype=np.float32)
                        idx = self.word2index.get(word, None)
                        if idx is not None:
                            weights[idx] = vector
                    except (ValueError, IndexError):
                        continue
            if use_cache:
                with open(cache_path, "wb") as f:
                    pickle.dump(weights, f)
        self.word_embedding_weights = weights
        return weights

    def save(self, path):
        """Pickle as the JAX package would (protocol 4), under the JAX
        package's class path."""
        with open(path, "wb") as f:
            _VocabPickler(f, protocol=4).dump(self)

    @staticmethod
    def load(path) -> "Vocab":
        with open(path, "rb") as f:
            return _RestrictedUnpickler(f).load()


class _VocabPickler(pickle._Pickler):
    """The pure-Python pickler, writing this module's `Vocab` under the JAX
    package's class path without importing it."""

    def save_global(self, obj, name=None):
        if obj is not Vocab:
            return super().save_global(obj, name)
        self.save(PICKLED_MODULE)
        self.save("Vocab")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _VOCAB_PATHS:
            return Vocab
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refused global {module}.{name} in a vocabulary pickle: only "
            "the Vocab class and numpy arrays are read")


def build_vocab(name, datasets, cache_path=None, word_vec_path=None,
                embedding_dim: int = 300) -> Vocab:
    """Build (or load cached) vocab by scanning datasets' word sequences
    (utils/vocab_utils.py:12-58)."""
    if cache_path and Path(cache_path).exists():
        return Vocab.load(cache_path)
    vocab = Vocab(name)
    for ds in datasets:
        for i in range(len(ds)):
            sample = ds[i]
            words = sample.get("word_seq", []) if isinstance(sample, dict) \
                else []
            for w in words:
                vocab.index_word(w[0] if isinstance(w, (list, tuple)) else w)
    if word_vec_path:
        vocab.load_word_vectors(word_vec_path, embedding_dim)
    if cache_path:
        vocab.save(cache_path)
    return vocab
