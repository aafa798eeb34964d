"""Shared parts of tests/test_torch_port_parallel*.py: the steps that run
in one process and, through `parallel.launch`, in two gloo ranks on the CPU,
the planted faults, and the parity criteria of tests/test_parallel.py.

Every case function runs unchanged in both layouts: outside a group it is
one process on the whole batch, inside one each rank takes its rows
(`process_batch_slice`). It returns numpy only, so its result pickles back
from a rank. This module imports no JAX: the ranks import it.
"""
import concurrent.futures
import contextlib

import numpy as np
import torch

from emotiongestures_torch.cli import (
    test_emotion_gesture_diversity_iterative as eval_cli,
)
from emotiongestures_torch.core import layers
from emotiongestures_torch.data.synthetic import SyntheticGestureDataset
from emotiongestures_torch.models import generator
from emotiongestures_torch.parallel import distributed, mesh
from emotiongestures_torch.train import classifier, cvae, fgd, gan, skeleton

B = 16  # the global batch; 8 rows per rank
SMALL_GAN = dict(n_words=64, d_model=64, d_inner=128, n_layers=1, n_head=4,
                 d_k=16, d_v=16)
GAN_KEYS = ("g_loss", "d_loss", "g_rec", "g_emo", "g_con", "g_adv")
# a child of `launch` gets this many torch threads: the suite's workers
# share the cores
THREADS = 1
TIMEOUT = 600


def local(batch: dict) -> dict:
    """This rank's rows of a numpy batch, as CPU tensors (text int64)."""
    n = len(next(iter(batch.values())))
    rows = distributed.process_batch_slice(n) if mesh.active() else \
        slice(0, n)
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[rows].astype(np.int64) if k == "text" else v[rows]))
        for k, v in batch.items()}


def gan_batch(n=B):
    ds = SyntheticGestureDataset(n_samples=n, seed=3)
    return next(ds.batches(n, shuffle=False, fields=(
        "spectrogram", "text", "pose_seq", "eid_label")))


def numpy_state(module) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def no_dropout(*modules):
    for m in modules:
        for d in m.modules():
            if isinstance(d, layers.Dropout):
                d.p = 0.0


# ---------------------------------------------------------------------------
# planted faults: what a naive port of data parallelism would do
# ---------------------------------------------------------------------------

def _local_moments(x32, dims):
    return x32.mean(dims), (x32 * x32).mean(dims)


def _local_coupling(mem, pe):
    return mem.T @ pe


def _shared_mask(shape, generator=None, device=None, blocks=1):
    return torch.rand(shape, generator=generator, device=device)


FAULTS = {
    # BatchNorm on each rank's own statistics
    "bn": (layers, "batch_moments", _local_moments),
    # TMMemory coupling each rank's rows only
    "tm": (generator, "batch_coupling", _local_coupling),
    # every rank draws the same mask for its own rows
    "mask": (mesh, "global_rand", _shared_mask),
}


@contextlib.contextmanager
def planted(fault):
    if fault is None:
        yield
        return
    module, name, fn = FAULTS[fault]
    before = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, before)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def gan_case(cfg=None, steps=2, dropout=True, fault=None):
    cfg = gan.GANConfig(**{**SMALL_GAN, **(cfg or {})})
    with planted(fault):
        gs, ds = gan.create_states(cfg, 0, device="cpu")
        if not dropout:
            no_dropout(gs.module, ds.module)
        distributed.broadcast_module(gs.module)
        distributed.broadcast_module(ds.module)
        batch = local(gan_batch())
        metrics = []
        for i in range(steps):
            gs, ds, m = gan.train_step(gs, ds, batch, 1 + i, cfg)
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "gen": numpy_state(gs.module),
            "disc": numpy_state(ds.module), "lr": cfg.lr}


def _poses(seed=0, n=B):
    return (0.5 * np.random.RandomState(seed).randn(n, 60, 282)).astype(
        np.float32)


def _labels(n=B):
    return np.eye(8, dtype=np.float32)[np.arange(n) % 8]


def fgd_case(steps=2, dropout=True):
    state = fgd.create_state(0, device="cpu")
    if not dropout:
        no_dropout(state.module)
    distributed.broadcast_module(state.module)
    poses = local({"p": _poses()})["p"]
    metrics = []
    for i in range(steps):
        state, m = fgd.train_step(state, poses, 1 + i)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "model": numpy_state(state.module),
            "lr": 3e-4}


def skeleton_case(steps=2):
    state = skeleton.create_state(0, d_model=64, d_inner=128, device="cpu")
    distributed.broadcast_module(state.module)
    b = local({"p": _poses(1), "y": _labels()})
    metrics = []
    for i in range(steps):
        state, m = skeleton.train_step(state, b["p"], b["y"], 1 + i)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "model": numpy_state(state.module),
            "lr": 3e-4}


def cvae_case(steps=2):
    state = cvae.create_state(0, feat_dim=64, device="cpu")
    distributed.broadcast_module(state.module)
    r = np.random.RandomState(2)
    b = local({"f": r.randn(B, 60, 64).astype(np.float32), "y": _labels()})
    metrics = []
    for i in range(steps):
        state, m = cvae.train_step(state, b["f"], b["y"], 1 + i)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "model": numpy_state(state.module),
            "lr": 2e-4}


def classifier_case(steps=2):
    state = classifier.create_state(0, spec_shape=(32, 30), device="cpu")
    distributed.broadcast_module(state.module)
    r = np.random.RandomState(4)
    b = local({"s": r.randn(B, 32, 30).astype(np.float32), "y": _labels()})
    alpha = torch.ones(8)
    metrics = []
    for _ in range(steps):
        state, m = classifier.train_step(state, b["s"], b["y"], alpha)
        metrics.append({k: float(v) for k, v in m.items()})
    acc, preds, _ = classifier.eval_step(state, b["s"], b["y"])
    return {"metrics": metrics, "model": numpy_state(state.module),
            "lr": 3e-4, "eval_acc": float(acc), "preds": preds.numpy()}


EVAL_FLAGS = ["--device", "cpu", "--d_model", "64", "--latent_dim", "128",
              "--gen_layers", "1"]


def eval_case(fault=None):
    """eval_batch on the global batch with injected noise and with noise
    drawn from a generator: each rank's outputs (its rows)."""
    args = eval_cli.build_parser().parse_args(EVAL_FLAGS)
    with planted(fault):
        nets = eval_cli.build_models(args, eval_cli.N_WORDS_SYNTHETIC,
                                     torch.device("cpu"))
        b = local(gan_batch())
        noise = local({"z": np.random.RandomState(7).randn(B, 32).astype(
            np.float32)})["z"]
        inputs = (b["spectrogram"], b["text"], b["pose_seq"], b["eid_label"])
        injected = eval_cli.eval_batch(nets, *inputs, noise=noise)
        drawn = eval_cli.eval_batch(
            nets, *inputs, generator=torch.Generator().manual_seed(5))
    names = ("pred", "logits", "pred_feat", "target_feat")
    return {f"{tag}_{n}": t.numpy() for tag, out in
            (("injected", injected), ("drawn", drawn))
            for n, t in zip(names, out[:4])}


def tmmemory_case(fault=None):
    """TMMemory alone in train mode (pose 282, chunk 10, dropout on with
    the global batch's masks) on a global batch of unit-scale seeded seed
    and extrapolated poses: this rank's rows of its output. Here TMMemory's
    scores are far from zero, so coupling each rank's rows only (fault
    "tm") moves the output by ~2.7 of a largest |output| of ~7.5: ~3000
    times the eval tolerance (atol 2e-5, rtol 2e-4), read in one process
    on the CPU."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        module = generator.TMMemory(10, 282).train()
    distributed.broadcast_module(module)
    r = np.random.RandomState(8)
    b = local({"initial": r.randn(B, 10, 282).astype(np.float32),
               "pred": r.randn(B, 50, 282).astype(np.float32)})
    with planted(fault), layers.dropout_generator(
            module, torch.Generator().manual_seed(6)):
        out = module(b["initial"], b["pred"])
    return {"out": out.detach().numpy()}


def collectives_case():
    """The differentiable collectives on rank-dependent inputs: values and
    gradients of sum(w * all_reduce_sum(x)) and sum(w * all_gather(x)),
    with w a fixed weight over the global rows, and all_reduce_mean of a
    mixed-dtype list."""
    r = mesh.rank()
    x = torch.arange(6.0).reshape(3, 2) + 10 * r
    w = torch.arange(6.0 * mesh.world()).reshape(-1, 2)
    a = x.clone().requires_grad_()
    s = mesh.all_reduce_sum(a)
    (ga,) = torch.autograd.grad((w[:3] * s).sum(), a)
    b = x.clone().requires_grad_()
    g = mesh.all_gather(b)
    (gb,) = torch.autograd.grad((w * g).sum(), b)
    means = mesh.all_reduce_mean([x, torch.full((2,), float(r),
                                                dtype=torch.bfloat16),
                                  torch.tensor([r], dtype=torch.float64)])
    return {"sum": s.detach().numpy(), "sum_grad": ga.numpy(),
            "gather": g.detach().numpy(), "gather_grad": gb.numpy(),
            "means": [m.float().numpy() for m in means],
            "dtypes": [str(m.dtype) for m in means]}


def masks_case(device="cpu"):
    """Masks of a train-mode Dropout(0.5) on ones on `device`: this rank's
    rows of a batch of B, and of two such batches concatenated
    (blocks=2)."""
    drop = layers.Dropout(0.5).train()
    out = {}
    for blocks in (1, 2):
        x = torch.ones(blocks * B // mesh.world(), 3, 4, device=device)
        gen = torch.Generator(device=device).manual_seed(9)
        with layers.dropout_generator(drop, gen, blocks=blocks):
            out[blocks] = (drop(x) != 0).cpu().numpy()
    return out


CASES = {"gan": gan_case, "collectives": collectives_case,
         "masks": masks_case, "fgd": fgd_case, "skeleton": skeleton_case,
         "cvae": cvae_case, "classifier": classifier_case, "eval": eval_case,
         "tmmemory": tmmemory_case}


def run_cases(cases):
    """[(name, case, kwargs)] in order, on this rank: {name: result}."""
    return {name: CASES[case](**kw) for name, case, kw in cases}


def two_ranks(cases):
    """`cases` in two gloo ranks on the CPU: [rank 0's, rank 1's]."""
    return mesh.launch(run_cases, 2, cases, device="cpu", threads=THREADS,
                       timeout=TIMEOUT)


def one_process(cases):
    """`cases` in this process, on the whole batch."""
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return run_cases(cases)
    finally:
        torch.set_num_threads(before)


def alongside(background, foreground):
    """`background()` in a thread (a `launch` of ranks, which waits on its
    processes) while `foreground()` runs here: (background's result,
    foreground's). An error in either raises here."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(background)
        front = foreground()
        return pending.result(), front


def one_and_two(one_cases, two_cases):
    """(one_process(one_cases), two_ranks(two_cases)), the ranks running
    while this process computes its reference."""
    got, ref = alongside(lambda: two_ranks(two_cases),
                         lambda: one_process(one_cases))
    return ref, got


class TinySpectrograms:
    """An in-memory stand-in for the synthetic set in the classifier's
    tests: `shape` spectrograms ((32, 32): EmotionNet's fc0 is then
    4096 x 4096), one-hot labels cycling through the 8 classes."""

    def __init__(self, n_samples, seed=0, shape=(32, 32), **_):
        r = np.random.RandomState(seed)
        self.items = [{"spectrogram": r.randn(*shape).astype(np.float32),
                       "eid_label": np.eye(8, dtype=np.float32)[i % 8]}
                      for i in range(n_samples)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class KfoldSpectrograms(TinySpectrograms):
    """TinySpectrograms at 16 x 16 for the data-parallel K-fold run:
    EmotionNet's fc0 is then 1024 x 4096, and a step and a checkpoint
    about half those at 32 x 32."""

    def __init__(self, n_samples, seed=0, **_):
        super().__init__(n_samples, seed, shape=(16, 16))


def kfold_rank(argv):
    """The K-fold CLI's main on KfoldSpectrograms in this process (a rank of
    a group its caller started): each record's fold, test accuracy,
    confusion matrix and step."""
    from emotiongestures_torch.cli import train_audio_classifier_K_fold as kf

    kf.SyntheticGestureDataset = KfoldSpectrograms
    return [{"fold": r["fold"], "test_acc": r["test_acc"],
             "confusion": r["confusion"], "step": r["state"].step}
            for r in kf.main(kf.build_parser().parse_args(argv))]


# ---------------------------------------------------------------------------
# the criteria of tests/test_parallel.py
# ---------------------------------------------------------------------------

def parity_failures(ref, got, keys, state_names, steps=2):
    """What breaks tests/test_parallel.py's criteria between a one-process
    result and a rank's: step-0 metrics within rtol 2e-4 (atol 1e-5),
    step-1 within 5e-3; after the steps every state entry within 5e-3, with
    at most 0.1% of elements beyond steps * 2 * lr (Adam's early update is
    about lr * sign(g), and reassociation may flip the sign of a tiny
    gradient). An empty list is parity."""
    bad = []
    for step, rtol in ((0, 2e-4), (1, 5e-3))[:steps]:
        for k in keys:
            a, b = ref["metrics"][step][k], got["metrics"][step][k]
            if not abs(a - b) <= 1e-5 + rtol * abs(a):
                bad.append(f"step {step} {k}: {a} vs {b}")
    quantum = steps * 2 * ref["lr"]
    for name in state_names:
        n_out = n_tot = 0
        for key, want in ref[name].items():
            diff = np.abs(got[name][key].astype(np.float64) - want)
            if diff.size and diff.max() >= 5e-3:
                bad.append(f"{name} {key}: max diff {diff.max():.3g}")
            n_out += int((diff > quantum).sum())
            n_tot += diff.size
        if n_out > max(1, n_tot // 1000):
            bad.append(f"{name}: {n_out} of {n_tot} elements beyond "
                       f"{quantum:.3g}")
    return bad


def assert_replicas(results, name, state_names):
    """Every rank ends with the same states, bit for bit: the gradients are
    one all-reduce's result on every rank."""
    for s in state_names:
        for key, want in results[0][name][s].items():
            for r, res in enumerate(results[1:], 1):
                assert np.array_equal(res[name][s][key], want), \
                    (name, s, key, r)
