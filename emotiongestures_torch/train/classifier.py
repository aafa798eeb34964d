"""Audio emotion classifier training (port of
emotiongestures_tpu/train/classifier.py; reference
train_audio_classifier_K_fold.py).

The reference's per-batch loop (train_...py:155-175) is `train_step`; its
K-fold loop (train_...py:109-204) is `train_k_fold`. Loss = focal(per-class
alpha, gamma 2) * 100; Adam(lr 3e-4, betas (0.5, 0.999), coupled wd 1e-5).

Mixed precision (`compute_dtype="bfloat16"`), as in train/gan.py: the fp32
parameters are the master copy and Adam's state stays fp32; forward and
backward run on a bf16 copy (`core.precision.compute_params`), the focal
loss in fp32, the BatchNorm statistics in fp32 into fp32 running buffers.

The train state is updated in place: the state handed to `train_k_fold` as
`resume_from` is the object that goes on training.

Data parallelism (parallel/mesh.py, the JAX `mesh`): every rank walks the
same folds and the same seeded permutations and takes its rows of each
batch; the focal loss is a mean over the global batch, the accuracies are
global means and the confusion matrix a sum over the ranks.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..core import losses, schedules
from ..core.device import resolve_device
from ..core.precision import compute_params
from ..data.constants import EMOTION_LABELS
from ..data.pipeline import Prefetcher, batch_rows, place_batches
from ..models.emotion_net import EmotionNet
from ..parallel import distributed, mesh
from ..utils.profiling import StepTimer, guard_finite
from .state import TrainState, eval_mode

# the compute dtype of compute_dtype; None is no cast (fp32 as built)
_COMPUTE = {"float32": None, "bfloat16": torch.bfloat16}


def create_state(seed: int = 0, lr: float = 3e-4, beta1: float = 0.5,
                 beta2: float = 0.999, weight_decay: float = 1e-5,
                 spec_shape=(128, 124), device=None) -> TrainState:
    """EmotionNet for (H, W) = `spec_shape` spectrograms (fc0's fan-in
    follows it), weights drawn from torch's generator seeded with `seed`."""
    torch.manual_seed(seed)
    model = EmotionNet(spec_shape=tuple(spec_shape), device=device)
    opt = schedules.adam(model.parameters(), lr=lr, b1=beta1, b2=beta2,
                         weight_decay=weight_decay)
    return TrainState(model, opt)


def train_step(state: TrainState, spec: torch.Tensor,
               labels_onehot: torch.Tensor, alpha: torch.Tensor,
               gamma: float = 2.0, compute_dtype: str = "float32"):
    """One update, in place. `labels_onehot` (B, 8) is argmax'd as
    train_...py:168 does; `alpha` is the per-class focal weight of this
    epoch (train_...py:147-151). Returns the state and 0-d tensors
    {"loss", "acc"} (accuracy in %)."""
    cdtype = _COMPUTE[compute_dtype]
    labels = labels_onehot.argmax(dim=1)
    model = state.module.train()
    params, targets = compute_params(model, cdtype, "master")
    x = spec if cdtype is None else spec.to(cdtype)
    out = functional_call(model, params, (x,)).float()
    loss = losses.focal_loss(out, labels, alpha=alpha, gamma=gamma) * 100.0
    state.apply_gradients(torch.autograd.grad(loss, targets,
                                              allow_unused=True))
    acc = 100.0 * (out.detach().argmax(dim=1) == labels).float().mean()
    return state, mesh.mean_metrics({"loss": loss.detach(), "acc": acc})


def eval_step(state: TrainState, spec: torch.Tensor,
              labels_onehot: torch.Tensor, compute_dtype: str = "float32"):
    """Eval-mode accuracy (%, 0-d tensor), predictions and labels."""
    cdtype = _COMPUTE[compute_dtype]
    labels = labels_onehot.argmax(dim=1)
    with eval_mode(state.module) as model:
        params, _ = compute_params(model, cdtype, "none")
        x = spec if cdtype is None else spec.to(cdtype)
        preds = functional_call(model, params, (x,)).argmax(dim=1)
    acc = 100.0 * (preds == labels).float().mean()
    return mesh.mean_metrics({"acc": acc})["acc"], preds, labels


def confusion_matrix(preds, labels, n_classes: int = 8) -> np.ndarray:
    """(train_...py:56-60): rows are predictions, columns are truth."""
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(preds), np.asarray(labels)), 1)
    return cm


def vis_confusion_matrix(conf_matrix: np.ndarray, save_path: str,
                         labels=None) -> str:
    """Confusion-matrix figure (train_...py:62-87): rows are predictions,
    columns are truth, counts annotated. Needs matplotlib, imported here."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or EMOTION_LABELS
    n = len(labels)
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.imshow(conf_matrix, cmap=plt.cm.Blues)
    thresh = conf_matrix.max() / 2 if conf_matrix.max() else 0.5
    for x in range(n):
        for y in range(n):
            info = int(conf_matrix[y, x])
            ax.text(x, y, info, va="center", ha="center",
                    color="white" if info > thresh else "black")
    ax.set_yticks(range(n))
    ax.set_yticklabels(labels)
    ax.set_xticks(range(n))
    ax.set_xticklabels(labels, rotation=30)
    fig.tight_layout()
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def class_alpha(labels_onehot: np.ndarray, n_classes: int = 8) -> np.ndarray:
    """Per-class re-weighting (train_...py:147-151): alpha_c = sum(count) /
    (n_classes * count_c), an absent class's count clamped to 1 (the
    reference divides by 0)."""
    raw = labels_onehot.reshape(-1, n_classes).sum(0)
    counts = np.maximum(raw, 1.0)
    return (raw.sum() / (n_classes * counts)).astype(np.float32)


def k_fold_indices(n: int, n_splits: int = 10, seed: int = 0):
    """KFold(10, shuffle=True) as the JAX package draws it
    (train_...py:301): RandomState(seed).permutation, array_split; yields
    (train, val) index arrays per fold."""
    order = np.random.RandomState(seed).permutation(n)
    folds = np.array_split(order, n_splits)
    for i in range(n_splits):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(n_splits) if j != i])
        yield train, val


def _index_batches(dataset, indices, batch_size: int, rows=None):
    """{"spectrogram", "eid_label"} batches over `indices`, the last partial
    batch dropped; `rows` takes that slice of each batch."""
    for i in range(0, len(indices) - batch_size + 1, batch_size):
        window = indices[i : i + batch_size]
        if rows is not None:
            window = window[rows]
        samples = [dataset[int(j)] for j in window]
        yield {
            "spectrogram": np.stack([s["spectrogram"] for s in samples]),
            "eid_label": np.stack([s["eid_label"] for s in samples]),
        }


def _batch_stream(dataset, indices, batch_size: int, device, prefetch: int):
    """A context manager over the batches on `device`: prefetched by a host
    thread (the torch DataLoader workers + pin_memory role,
    train_...py:121-124), or synchronous with prefetch 0."""
    raw = _index_batches(dataset, indices, batch_size,
                         batch_rows(batch_size))
    if prefetch <= 0:
        return contextlib.nullcontext(place_batches(raw, device))
    return Prefetcher(raw, device, buffer_size=prefetch)


def train_k_fold(
    dataset,
    test_dataset,
    batch_size: int = 128,
    n_splits: int = 10,
    epochs: int = 1,
    lr: float = 3e-4,
    eval_every: int = 100,
    seed: int = 0,
    max_folds: Optional[int] = None,
    checkpoint_fn=None,
    compute_dtype: str = "float32",
    prefetch: int = 2,
    should_stop=None,
    resume_from=None,
    device=None,
):
    """The K-fold loop of train_...py:109-204 on `device` (the card unless
    the CPU is asked for). Returns one record per finished fold: fold,
    test_acc, confusion, state and step_ms (each step's time: CUDA events
    on the card, the host clock on the CPU).

    `resume_from`: (state, fold) from a checkpoint. Folds before `fold` are
    skipped (the stopped run logged them), and `fold` continues from
    state.step: the loop replays the same seeded epoch permutations and
    skips the batches already consumed, so the fold sees the data order of
    an uninterrupted run. The state is trained in place.

    `should_stop`: a zero-argument callable polled at step boundaries
    (GracefulShutdown.requested); when it turns true the current fold
    checkpoints and the loop returns the folds finished so far.
    `checkpoint_fn(state, fold, epoch, global_iter)` runs then and every
    `eval_every` steps."""
    log = logging.getLogger("emotiongestures_torch.classifier")
    device = resolve_device(device)
    should_stop = should_stop or (lambda: False)
    results = []
    start_fold, resume_state = 0, None
    if resume_from is not None:
        resume_state, start_fold = resume_from
    for fold, (train_idx, val_idx) in enumerate(
            k_fold_indices(len(dataset), n_splits, seed)):
        if max_folds is not None and fold >= max_folds:
            break
        if fold < start_fold:
            continue
        if should_stop():
            break
        steps_per_epoch = max(len(train_idx) // batch_size, 1)
        if resume_state is not None and fold == start_fold:
            state, resume_state = resume_state, None
            global_iter = state.step
            start_epoch = global_iter // steps_per_epoch
            skip_batches = global_iter - start_epoch * steps_per_epoch
            log.info("resuming fold %d at iter %d (epoch %d, skipping %d "
                     "consumed batches)", fold + 1, global_iter, start_epoch,
                     skip_batches)
        else:
            spec_shape = dataset[int(train_idx[0])]["spectrogram"].shape
            state = create_state(seed + fold, lr=lr, spec_shape=spec_shape,
                                 device=device)
            if mesh.active():  # rank 0's weights on every rank
                distributed.broadcast_module(state.module)
            global_iter = start_epoch = skip_batches = 0
        timer = StepTimer(device)
        for epoch in range(start_epoch, epochs):
            if should_stop():
                break
            # the epoch's class re-weighting over this fold's train split
            alpha = torch.as_tensor(class_alpha(np.stack(
                [dataset[int(i)]["eid_label"] for i in train_idx])),
                device=device)
            order = np.random.RandomState(seed + epoch).permutation(
                train_idx)
            if skip_batches:
                # replay the permutation past the consumed prefix
                order = order[skip_batches * batch_size:]
                skip_batches = 0
            with _batch_stream(dataset, order, batch_size, device,
                               prefetch) as batches:
                for batch in batches:
                    if should_stop():
                        log.warning("shutdown requested - checkpointing "
                                    "fold %d at iter %d and stopping",
                                    fold + 1, global_iter)
                        if checkpoint_fn is not None:
                            checkpoint_fn(state, fold, epoch, global_iter)
                        break
                    with timer:
                        state, metrics = train_step(
                            state, batch["spectrogram"], batch["eid_label"],
                            alpha, compute_dtype=compute_dtype)
                    global_iter += 1
                    if global_iter % eval_every == 0:
                        guard_finite(metrics, "train metrics")
                        val_acc = evaluate(state, dataset, val_idx,
                                           batch_size, compute_dtype,
                                           device, prefetch)
                        log.info("Fold %d, Epoch %d, iter %d, loss %.4f, "
                                 "Val Accuracy: %.2f%%", fold + 1, epoch,
                                 global_iter, float(metrics["loss"]),
                                 val_acc)
                        if checkpoint_fn is not None:
                            checkpoint_fn(state, fold, epoch, global_iter)
        if should_stop():  # no test pass: the fold checkpointed
            break
        test_acc, cm = test_model(state, test_dataset, batch_size,
                                  compute_dtype, device, prefetch)
        log.info("Fold %d Test Accuracy: %.2f%%", fold + 1, test_acc)
        results.append({"fold": fold, "test_acc": test_acc,
                        "confusion": cm, "state": state,
                        "step_ms": timer.times_ms()})
    return results


def evaluate(state: TrainState, dataset, indices, batch_size: int,
             compute_dtype: str = "float32", device=None,
             prefetch: int = 2) -> float:
    """Mean eval accuracy (%) over the full batches of `indices`."""
    device = resolve_device(device)
    accs = []
    with _batch_stream(dataset, indices, batch_size, device,
                       prefetch) as batches:
        for batch in batches:
            acc, _, _ = eval_step(state, batch["spectrogram"],
                                  batch["eid_label"], compute_dtype)
            accs.append(float(acc))
    return float(np.mean(accs)) if accs else 0.0


def test_model(state: TrainState, dataset, batch_size: int,
               compute_dtype: str = "float32", device=None,
               prefetch: int = 2):
    """Test pass with confusion matrix (train_...py:206-255): (mean accuracy
    in %, (8, 8) counts)."""
    device = resolve_device(device)
    accs = []
    cm = np.zeros((8, 8), dtype=np.int64)
    with _batch_stream(dataset, np.arange(len(dataset)), batch_size, device,
                       prefetch) as batches:
        for batch in batches:
            acc, preds, lab = eval_step(state, batch["spectrogram"],
                                        batch["eid_label"], compute_dtype)
            accs.append(float(acc))
            cm += confusion_matrix(preds.cpu().numpy(), lab.cpu().numpy())
    cm = mesh.all_reduce_sum(torch.from_numpy(cm)).numpy()
    return (float(np.mean(accs)) if accs else 0.0), cm
