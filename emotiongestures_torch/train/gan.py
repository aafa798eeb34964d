"""GAN training for the gesture generator (port of
emotiongestures_tpu/train/gan.py, the reconstruction of the reference's
unreleased train.py: its module docstring states the loss composition and
the reconstruction decisions, which hold here unchanged).

  G: w_rec * L1(pred, target) + w_adv * BCE(D(offsets(pred)), 1)
     + w_emo * CE(emotion_logits, y) + w_con * contrastive
  D: BCE(D(offsets(real)), 1) + BCE(D(offsets(fake)), 0)

Randomness comes from explicit torch.Generators: a step's integer key
(`step_key(seed, global step)`, the JAX CLI's fold_in) splits into four
generators, for G's forward, the fake batch of the D update and the real
and fake discriminator passes, which draw independently.

Mixed precision (`compute_dtype="bfloat16"`): the fp32 parameters are the
master copy and Adam's state stays fp32; both networks run forward and
backward on a bf16 copy (`core.precision.compute_params`), loss arithmetic
is fp32, BatchNorm statistics are fp32 and its running buffers stay fp32.

The JAX `train_steps` is a lax.scan over K steps in one dispatch; here it is
a plain loop over the same K sequential steps.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import functional_call

from ..core import losses, schedules
from ..core.layers import dropout_generator, frozen_stats
from ..core.precision import compute_params
from ..models.discriminator import MotionDiscriminator, calc_motion
from ..models.generator import GestureTransformer
from ..parallel import mesh
from .state import TrainState, eval_mode

# the compute dtype of cfg.compute_dtype; None is no cast: the modules'
# own dtype, fp32 as built
_COMPUTE = {"float32": None, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class GANConfig:
    n_words: int = 64
    frames: int = 60
    pose_dim: int = 282
    prior_frames: int = 10
    d_model: int = 512
    d_inner: int = 2048
    n_layers: int = 3
    n_head: int = 8
    d_k: int = 64
    d_v: int = 64
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    weight_decay: float = 0.0
    loss_regression_weight: float = 100.0
    loss_gan_weight: float = 1.0
    loss_emotion_weight: float = 1.0
    loss_contrastive_weight: float = 0.1
    variant: str = "memory"
    # "paired_label" (emotion InfoNCE over same-label clips) or "emo_sem"
    # (the reference's SoftmaxContrastiveLoss between emotion and semantic
    # features)
    contrastive_mode: str = "paired_label"
    # "d_first": D updates on a no-grad train-mode fake, then G's
    # adversarial term sees the updated D. "g_first": one G forward serves
    # both updates; G's adversarial term sees the pre-update D and D trains
    # on the detached prediction
    update_order: str = "d_first"
    # > 0 puts the reference's staged LR ladder on the optimizer's updates
    steps_per_epoch: int = 0
    # "float32" (parity) or "bfloat16" (fp32 master, bf16 forward/backward)
    compute_dtype: str = "float32"
    # checkpoint each SE block of the audio encoder (recompute in backward)
    remat_audio: bool = False
    # the discriminator's real and fake passes as one 2B batch (it has no
    # BatchNorm, so only the dropout draws differ from two passes)
    d_concat_batch: bool = False
    # "bfloat16": gradients with respect to the bf16 copy, upcast only at
    # Adam; requires compute_dtype="bfloat16"
    grad_dtype: str = "float32"


def step_key(seed: int, step: int) -> int:
    """The integer key of global step `step` of a run seeded `seed`: the
    same (seed, step) gives the same key, so a resumed run draws what an
    uninterrupted one would."""
    return _seed_words([seed, step], 1)[0]


def split_key(key: int, n: int) -> list:
    """`n` independent integer keys from one."""
    return _seed_words([key], n)


def _seed_words(entropy, n: int) -> list:
    words = np.random.SeedSequence(entropy).generate_state(n, np.uint64)
    return [int(w >> np.uint64(1)) for w in words]  # non-negative int64


def build_models(cfg: GANConfig, device=None):
    """The generator of `cfg.variant` and the motion discriminator, on
    `device` (the card unless the CPU is asked for)."""
    gen = GestureTransformer(
        n_words=cfg.n_words, frames=cfg.frames, pose_dim=cfg.pose_dim,
        prior_frames=cfg.prior_frames, d_model=cfg.d_model,
        d_inner=cfg.d_inner, n_layers=cfg.n_layers, n_head=cfg.n_head,
        d_k=cfg.d_k, d_v=cfg.d_v, remat_audio=cfg.remat_audio,
        variant=cfg.variant, device=device)
    disc = MotionDiscriminator(frames=cfg.frames - 1, pose_dim=cfg.pose_dim,
                               d_model=cfg.pose_dim, device=device)
    return gen, disc


def create_states(cfg: GANConfig, seed: int = 0, device=None):
    """Train states of both networks, weights drawn from torch's generator
    seeded with `seed`; Adam with the staged ladder when
    `cfg.steps_per_epoch > 0`."""
    torch.manual_seed(seed)
    gen, disc = build_models(cfg, device)
    schedule = (schedules.staged_step_lr(cfg.lr, cfg.steps_per_epoch)
                if cfg.steps_per_epoch > 0 else None)

    def state(module):
        opt = schedules.adam(module.parameters(), lr=cfg.lr, b1=cfg.beta1,
                             b2=cfg.beta2, weight_decay=cfg.weight_decay)
        return TrainState(module, opt, lr_schedule=schedule)

    return state(gen), state(disc)


def _grads(loss, targets):
    return torch.autograd.grad(loss, targets, allow_unused=True)


def train_step(gen_state: TrainState, disc_state: TrainState, batch: dict,
               rng: int, cfg: GANConfig, use_disc: bool = True):
    """One generator and one discriminator update, in place. `batch` holds
    spectrogram (B, 128, T), text (B, F) int, pose_seq (B, F, D) and
    eid_label (B, 8); `rng` is the step's integer key. `use_disc=False` is
    the warm-up: no D update and no adversarial term. Returns the states
    and 0-d metric tensors (g_loss, d_loss, g_rec, g_emo, g_con, g_adv)."""
    cdtype = _COMPUTE[cfg.compute_dtype]
    if cfg.grad_dtype == "bfloat16" and cdtype != torch.bfloat16:
        raise ValueError("grad_dtype='bfloat16' requires "
                         "compute_dtype='bfloat16'")
    if cfg.update_order not in ("d_first", "g_first"):
        raise ValueError(f"unknown update_order {cfg.update_order!r}")
    grad_mode = "compute" if cfg.grad_dtype == "bfloat16" else "master"
    gen, disc = gen_state.module.train(), disc_state.module.train()
    target = batch["pose_seq"]
    device = target.device
    labels = batch["eid_label"].argmax(dim=1)
    g_rng, d_gen_rng, d_rng_real, d_rng_fake = (
        torch.Generator(device=device).manual_seed(k)
        for k in split_key(rng, 4))

    def cast(t):
        return t if cdtype is None else t.to(cdtype)

    g_inputs = (cast(batch["spectrogram"]), batch["text"],
                cast(target[:, : cfg.prior_frames]))
    zero = torch.zeros((), device=device)

    def d_update(fake):
        """One D step on `fake` (detached, compute dtype)."""
        params, targets = compute_params(disc, cdtype, grad_mode)
        real_motion = calc_motion(cast(target))
        if cfg.d_concat_batch:
            # the 2B rows are two batches: under data parallelism each
            # block's mask is this rank's rows of that block's global draw
            with dropout_generator(disc, d_rng_real, blocks=2):
                logits = functional_call(disc, params, (torch.cat(
                    [real_motion, calc_motion(fake)]),))
            real_logits, fake_logits = logits.chunk(2)
        else:
            with dropout_generator(disc, d_rng_real):
                real_logits = functional_call(disc, params, (real_motion,))
            with dropout_generator(disc, d_rng_fake):
                fake_logits = functional_call(disc, params,
                                              (calc_motion(fake),))
        loss = losses.gan_d_loss(real_logits.float(), fake_logits.float())
        disc_state.apply_gradients(_grads(loss, targets))
        return loss.detach()

    def g_update():
        """One G step against D as it stands; returns the metrics and the
        detached prediction."""
        params, targets = compute_params(gen, cdtype, grad_mode)
        with dropout_generator(gen, g_rng):
            pred, emo_feat, sem_feat, emo_logits, _ = functional_call(
                gen, params, g_inputs)
        rec = losses.l1_loss(pred.float(), target) * \
            cfg.loss_regression_weight
        emo = losses.cross_entropy(emo_logits.float(), labels).mean() * \
            cfg.loss_emotion_weight
        if cfg.contrastive_mode == "paired_label":
            con = losses.emotion_infonce(emo_feat.float().mean(1), labels)
        else:
            con = losses.softmax_contrastive_loss(emo_feat.float().mean(1),
                                                  sem_feat.float().mean(1))
        con = con * cfg.loss_contrastive_weight
        adv = zero
        if use_disc:
            # D in eval mode, on detached weights: G's backward leaves no
            # gradient on D
            dparams, _ = compute_params(disc, cdtype, "none")
            disc.eval()
            try:
                fake_logits = functional_call(disc, dparams,
                                              (calc_motion(pred),))
            finally:
                disc.train()
            adv = losses.gan_g_loss(fake_logits.float()) * cfg.loss_gan_weight
        total = rec + emo + con + adv
        gen_state.apply_gradients(_grads(total, targets))
        metrics = {"g_loss": total, "g_rec": rec, "g_emo": emo, "g_con": con,
                   "g_adv": adv}
        return {k: v.detach() for k, v in metrics.items()}, pred.detach()

    if cfg.update_order == "d_first":
        d_loss = zero
        if use_disc:
            # the fake batch: G in train mode, its BatchNorm writes
            # discarded (train/gan.py:32-35)
            params, _ = compute_params(gen, cdtype, "none")
            with torch.no_grad(), frozen_stats(gen), \
                    dropout_generator(gen, d_gen_rng):
                fake = functional_call(gen, params, g_inputs)[0]
            d_loss = d_update(fake)
        metrics, _ = g_update()
    else:
        metrics, fake = g_update()
        d_loss = d_update(fake) if use_disc else zero
    metrics["d_loss"] = d_loss
    return gen_state, disc_state, mesh.mean_metrics(metrics)


def train_steps(gen_state: TrainState, disc_state: TrainState,
                batches: dict, rng: int, cfg: GANConfig,
                use_disc: bool = True):
    """K sequential train steps over (K, B, ...) batches, the step keys
    split from `rng`; metrics stacked to (K,) per key."""
    k = next(iter(batches.values())).shape[0]
    per_step = []
    for i, key in enumerate(split_key(rng, k)):
        batch = {name: v[i] for name, v in batches.items()}
        gen_state, disc_state, m = train_step(gen_state, disc_state, batch,
                                              key, cfg, use_disc)
        per_step.append(m)
    return gen_state, disc_state, {
        name: torch.stack([m[name] for m in per_step]) for name in per_step[0]}


def eval_step(gen_state: TrainState, batch: dict, cfg: GANConfig):
    """The generator in eval mode on `batch`: its poses and the mean
    per-frame l2 distance to the target."""
    target = batch["pose_seq"]
    with eval_mode(gen_state.module) as gen:
        pred = gen(batch["spectrogram"], batch["text"],
                   target[:, : cfg.prior_frames])[0]
    l2 = torch.linalg.vector_norm(target - pred, dim=-1).mean()
    return {"pred": pred, "l2": l2}
