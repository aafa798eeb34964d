"""Shared parts of tests/test_torch_port_tp*.py: the cases that run in the
ranks of a data x model grid (`parallel.launch` with
`distributed.set_grid`) and in one process, and the planted faults.

A case takes whole weights (numpy state_dicts, made once by the test, from
JAX variables through utils/weights.py or from a seeded module), cuts
them for its model index (`parallel.tensor`), takes its data index's rows
of the inputs and returns numpy only, whole tensors where the grid holds
shards (gathered over the model group), so its result pickles back from a
rank. This module imports no JAX: the ranks import it.
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F
import torch_port_parallel_common as P

from emotiongestures_torch.models.cvae import EmotionCVAEv3
from emotiongestures_torch.models.fgd_ae import FGDAutoEncoder
from emotiongestures_torch.models.generator import GestureTransformer
from emotiongestures_torch.models.skeleton_classifier import (
    SkeletonTransformer,
)
from emotiongestures_torch.nn import transformer
from emotiongestures_torch.parallel import distributed, mesh, tensor
from emotiongestures_torch.train import gan

# tests/test_parallel.py:254-281
FORWARD_GEN = dict(n_words=30, d_model=128, d_inner=256, n_layers=2,
                   variant="base")
FORWARD_B = 4
# tests/test_parallel.py:406-459
EVAL_GEN = dict(n_words=16, frames=60, d_model=64, d_inner=128, n_layers=1,
                n_head=4, d_k=16, d_v=16)
EVAL_SKELETON = dict(d_model=128, d_inner=128, n_layers=1)
EVAL_B = 16
FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)
EVAL_TOL = dict(atol=2e-5, rtol=2e-4)
# tests/test_parallel.py:339-393, with the synthetic set's 64 words (JAX
# clips the word ids that its 16-word embedding lacks; torch refuses them)
TP_GAN = dict(n_words=64, d_model=64, d_inner=128, n_layers=1, n_head=4,
              d_k=16, d_v=16)


def forward_inputs(n=FORWARD_B):
    r = np.random.RandomState(0)
    return {"spec": r.randn(n, 128, 124).astype(np.float32),
            "text": r.randint(0, 30, (n, 60)),
            "prior": r.randn(n, 10, 282).astype(np.float32)}


def eval_inputs(n=EVAL_B):
    r = np.random.RandomState(1)
    return {"spec": r.randn(n, 128, 124).astype(np.float32),
            "text": r.randint(0, 16, (n, 60)),
            "target": r.randn(n, 60, 282).astype(np.float32),
            "y": np.eye(8, dtype=np.float32)[np.arange(n) % 8],
            "z": r.randn(n, 32).astype(np.float32)}


def loaded(module, state):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()}, strict=True)
    return module.eval()


def shard(module):
    return tensor.shard_module(module, distributed.model_index(),
                               distributed.model_count())


# ---------------------------------------------------------------------------
# planted faults: what a naive port of tensor parallelism would do
# ---------------------------------------------------------------------------

def _bias_on_every_rank(self, x):
    """w_2's bias added to each model rank's partial, before the sum."""
    residual = x
    h = torch.relu(self.w_1(mesh.model_copy(x)))
    y = mesh.model_sum(F.linear(h, self.w_2.weight, self.w_2.bias))
    return self.layer_norm(self.dropout(y) + residual)


@contextlib.contextmanager
def planted(fault, modules=()):
    """"bias": w_2's bias on every model rank; "heads": the attention
    dropout's mask drawn for the local heads only (`modules`' attention
    blocks, after they are cut)."""
    before = transformer.PositionwiseFeedForward.forward
    if fault == "bias":
        transformer.PositionwiseFeedForward.forward = _bias_on_every_rank
    if fault == "heads":
        for m in modules:
            for d in m.modules():
                if isinstance(d, transformer.MultiHeadAttention):
                    d.attn_dropout.heads = None
    try:
        yield
    finally:
        transformer.PositionwiseFeedForward.forward = before


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def forward_case(gen_state, fault=None):
    """(a) the generator's eval forward (test_parallel.py:254-281's
    widths): this rank's rows of the poses."""
    gen = shard(loaded(GestureTransformer(**FORWARD_GEN, device="cpu"),
                       gen_state))
    b = P.local(forward_inputs())
    with torch.no_grad(), planted(fault):
        out = gen(b["spec"], b["text"], b["prior"])[0]
    return {"pred": out.numpy()}


def eval_case(states, fused=True):
    """(b) the eval pipeline of test_parallel.py:406-459 with the CVAE's
    noise injected: this rank's rows of the poses, FGD features and
    skeleton logits, and the sublayers that ran the partial form."""
    gen = shard(loaded(GestureTransformer(**EVAL_GEN, device="cpu",
                                          fused_attention=fused),
                       states["gen"]))
    skeleton = shard(loaded(SkeletonTransformer(**EVAL_SKELETON,
                                                device="cpu"),
                            states["skeleton"]))
    fgd = loaded(FGDAutoEncoder(device="cpu"), states["fgd"])
    vae = loaded(EmotionCVAEv3(feat_dim=EVAL_GEN["d_model"], device="cpu"),
                 states["vae"])
    b = P.local(eval_inputs())
    calls = []
    real = transformer.fused_attention_partial
    transformer.fused_attention_partial = \
        lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with torch.no_grad():
            sampled = vae.sample(b["y"], noise=b["z"])
            pred = gen(b["spec"], b["text"], b["target"][:, :10],
                       sampled)[0]
            _, feat = fgd(pred)
            logits, _ = skeleton(pred)
    finally:
        transformer.fused_attention_partial = real
    return {"pred": pred.numpy(), "feat": feat.numpy(),
            "logits": logits.numpy(), "partial_calls": len(calls)}


def gan_case(cfg=None, steps=1, fault=None):
    """(c) d_first GAN steps with dropout on (test_parallel.py:339-393's
    widths and one step), the states cut after the broadcast: losses, and
    the whole
    states gathered in the one-process layout with Adam's moments (by
    parameter name)."""
    cfg = gan.GANConfig(**{**TP_GAN, **(cfg or {})})
    gs, ds = gan.create_states(cfg, 0, device="cpu")
    distributed.broadcast_module(gs.module)
    distributed.broadcast_module(ds.module)
    for s in (gs, ds):
        tensor.shard_train_state(s, distributed.model_index(),
                                 distributed.model_count())
    batch = P.local(P.gan_batch())
    metrics = []
    with planted(fault, (gs.module, ds.module)):
        for i in range(steps):
            gs, ds, m = gan.train_step(gs, ds, batch, 1 + i, cfg)
            metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "lr": cfg.lr}
    for name, s in (("gen", gs), ("disc", ds)):
        tree = tensor.whole_tree(s)
        out[name] = {k: v.numpy().copy() for k, v in tree["model"].items()}
        names = [n for n, _ in s.module.named_parameters()]
        out[name + "_adam"] = {
            f"{names[i]}.{k}": v.numpy().copy()
            for i, st in tree["optimizer"]["state"].items()
            for k, v in st.items() if v.ndim}
    return out


CLIP_NORM = 1.0


def clip_grads():
    """Whole 'gradients' of the eval generator's parameters: a fixed
    function of its seeded weights, by name."""
    torch.manual_seed(2)
    gen = GestureTransformer(**EVAL_GEN, device="cpu")
    return gen, {n: torch.sin(3 * p.detach())
                 for n, p in gen.named_parameters()}


def clip_case():
    """train.state.clip_by_global_norm on this model index's cut of
    `clip_grads` (their global norm is well above CLIP_NORM): the clipped
    gradients by name, and this rank's model index."""
    from emotiongestures_torch.train.state import clip_by_global_norm

    gen, full = clip_grads()
    cut = tensor.shard_state(full, distributed.model_index(),
                             distributed.model_count())
    shard(gen)
    names = [n for n, _ in gen.named_parameters()]
    clipped = clip_by_global_norm([cut[n] for n in names], CLIP_NORM,
                                  tensor.sharded_flags(gen))
    return {"grads": {n: g.numpy() for n, g in zip(names, clipped)},
            "model_index": distributed.model_index()}


CASES = {"forward": forward_case, "eval": eval_case, "gan": gan_case,
         "clip": clip_case}


def run_grid(n_model, cases):
    """[(name, case, kwargs)] on this rank of an n_model grid."""
    distributed.set_grid(n_model)
    return {name: CASES[case](**kw) for name, case, kw in cases}


def grid(n_ranks, n_model, cases):
    """`cases` on n_ranks gloo ranks on the CPU as an (n_ranks / n_model)
    x n_model grid: each rank's results, in rank order."""
    return mesh.launch(run_grid, n_ranks, n_model, cases, device="cpu",
                       threads=P.THREADS, timeout=P.TIMEOUT)


def stacked(results, name, key, n_model):
    """A case output's rows stacked over the data axis (model index 0's
    ranks), in data-index order."""
    return np.concatenate([r[name][key] for r in results[::n_model]])
