"""Tensor parallelism: which weights a model group splits, and how (port of
emotiongestures_tpu/parallel/mesh.py:114-158 and :190-213, `shard_state_tp`,
`_TP_RULES` and `tp_param_shardings`).

The JAX package shards the transformer FFN and MHA kernels over its mesh's
`model` axis in Megatron's layout and replicates everything else; Adam's
moments mirror the parameters' paths and sit beside each shard. The port
names the same weights by their `state_dict` names, in torch.nn.Linear's
(out, in) layout, so a JAX kernel's column split is a row split here:

    JAX path                      torch name                      dim
    *pos_ffn/w_1/kernel           *.pos_ffn.w_1.weight            0 (rows)
    *pos_ffn/w_1/bias             *.pos_ffn.w_1.bias              0
    *pos_ffn/w_2/kernel           *.pos_ffn.w_2.weight            1 (columns)
    *w_[qkv]s/kernel              *.w_qs/w_ks/w_vs.weight         0 (rows)
    *(slf|enc)_attn/fc/kernel     *.slf_attn/enc_attn.fc.weight   1 (columns)

w_2's bias stays whole (it is added once, after the model group's sum). A
tensor of n_model shards is cut into equal contiguous slices, slice i on
model index i. The JAX package applies the rules to every network it
shards (the generator, the discriminator, the skeleton classifier); the
CVAE and the FGD autoencoder match no rule.

A model is built whole (from its seed, a checkpoint or a JAX transfer
through utils/weights.py), then cut with `shard_module` or, with its Adam
state, `shard_train_state`. Checkpoints are written whole: `whole_tree`
gathers the shards of every model rank (a collective of the model group),
so a checkpoint reads back into any layout, one process or a grid, and
into the JAX package (orbax) tables' one-process names.
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist

from . import distributed

RULES = [
    (re.compile(r"(^|.*\.)pos_ffn\.w_1\.weight$"), 0),
    (re.compile(r"(^|.*\.)pos_ffn\.w_1\.bias$"), 0),
    (re.compile(r"(^|.*\.)pos_ffn\.w_2\.weight$"), 1),
    (re.compile(r"(^|.*\.)w_[qkv]s\.weight$"), 0),
    (re.compile(r"(^|.*\.)(slf|enc)_attn\.fc\.weight$"), 1),
]

_GRID = "_tensor_parallel"  # attribute of a sharded module: (index, n)


def shard_dim(name: str):
    """The dimension the rules split the state_dict entry `name` along, or
    None (replicated)."""
    for pattern, dim in RULES:
        if pattern.match(name):
            return dim
    return None


def _slice(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"a dimension of {t.shape[dim]} does not split "
                         f"into {n} equal shards")
    k = t.shape[dim] // n
    return t.narrow(dim, index * k, k).clone(
        memory_format=torch.contiguous_format)


def shard_state(full: dict, model_index: int, n_model: int) -> dict:
    """This model index's shards of a whole state_dict: the entries the
    rules name cut into n_model slices along their dimension, the others
    as they are."""
    return {k: v if shard_dim(k) is None else
            _slice(v, shard_dim(k), model_index, n_model)
            for k, v in full.items()}


def gather_state(shards: list) -> dict:
    """The whole state_dict from every model index's shards, in model-index
    order: `shard_state`'s inverse."""
    return {k: v if shard_dim(k) is None else
            torch.cat([s[k] for s in shards], dim=shard_dim(k))
            for k, v in shards[0].items()}


def _param_dims(module) -> list:
    """shard_dim of each parameter, in `module.parameters()` order (the
    order of an optimizer's state indices)."""
    return [shard_dim(n) for n, _ in module.named_parameters()]


def shard_optimizer_state(osd: dict, dims: list, model_index: int,
                          n_model: int) -> dict:
    """An optimizer state_dict's per-parameter tensors of parameter shape
    (Adam's exp_avg and exp_avg_sq) cut as their parameters are; `dims`
    follows the state's parameter indices."""
    return {**osd, "state": {
        i: {k: _slice(v, dims[i], model_index, n_model)
            if dims[i] is not None and torch.is_tensor(v) and v.ndim
            else v for k, v in st.items()}
        for i, st in osd["state"].items()}}


def gather_optimizer_state(osds: list, dims: list) -> dict:
    """`shard_optimizer_state`'s inverse, from every model index's state in
    model-index order."""
    first = osds[0]
    return {**first, "state": {
        i: {k: torch.cat([o["state"][i][k] for o in osds], dim=dims[i])
            if dims[i] is not None and torch.is_tensor(v) and v.ndim
            else v for k, v in st.items()}
        for i, st in first["state"].items()}}


def grid_of(module):
    """(model_index, n_model) of a module cut by `shard_module`, else
    None."""
    return getattr(module, _GRID, None)


def shard_module(module, model_index: int, n_model: int):
    """Cut `module`'s parameters in place to this model index's shards and
    set its attention and feed-forward blocks to compute on them (their
    `n_model` and `model_index`, the attention dropout's heads). Returns
    `module`; n_model 1 leaves it whole."""
    from ..nn.transformer import MultiHeadAttention, PositionwiseFeedForward

    if n_model <= 1:
        return module
    if grid_of(module) is not None:
        raise RuntimeError("shard_module: the module is sharded already")
    for m in module.modules():
        if isinstance(m, MultiHeadAttention) and m.n_head % n_model:
            raise ValueError(f"--model_parallel {n_model} does not divide "
                             f"the {m.n_head} attention heads")
    with torch.no_grad():
        for name, p in module.named_parameters():
            dim = shard_dim(name)
            if dim is not None:
                p.data = _slice(p.data, dim, model_index, n_model)
    for m in module.modules():
        if isinstance(m, (MultiHeadAttention, PositionwiseFeedForward)):
            m.n_model, m.model_index = n_model, model_index
        if isinstance(m, MultiHeadAttention):
            m.attn_dropout.heads = (model_index, n_model)
    setattr(module, _GRID, (model_index, n_model))
    return module


def shard_train_state(state, model_index: int, n_model: int):
    """`shard_module` on a train state's module, and its optimizer's
    per-parameter moments cut beside each shard (`shard_state_tp`)."""
    if n_model <= 1:
        return state
    osd = shard_optimizer_state(state.optimizer.state_dict(),
                                _param_dims(state.module), model_index,
                                n_model)
    shard_module(state.module, model_index, n_model)
    state.optimizer.load_state_dict(osd)
    return state


def sharded_flags(module) -> list:
    """True for each parameter (in `parameters()` order) that the model
    group splits, when the module is sharded; all False otherwise."""
    dims = _param_dims(module)
    if grid_of(module) is None:
        return [False] * len(dims)
    return [d is not None for d in dims]


def _gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from the model group's slices along `dim` (each
    rank's slice placed in zeros, summed: exact, and any backend takes
    it)."""
    index, n = distributed.model_index(), distributed.model_count()
    shape = list(t.shape)
    k = shape[dim]
    shape[dim] = k * n
    out = t.new_zeros(shape)
    out.narrow(dim, index * k, k).copy_(t)
    if dist.get_backend() == "nccl" and out.device.type != "cuda":
        out = out.cuda()
    dist.all_reduce(out, group=distributed.model_group())
    return out.to(t.device)


def whole_tree(state) -> dict:
    """{"step", "model", "optimizer"} of a train state in the one-process
    layout: a sharded state's shards gathered over the model group (every
    rank of the group calls it), another state's own dicts."""
    model = state.module.state_dict()
    optim = state.optimizer.state_dict()
    if grid_of(state.module) is not None:
        model = {k: v if shard_dim(k) is None else
                 _gather_model(v, shard_dim(k)) for k, v in model.items()}
        dims = _param_dims(state.module)
        optim = {**optim, "state": {
            i: {k: _gather_model(v, dims[i])
                if dims[i] is not None and torch.is_tensor(v) and v.ndim
                else v for k, v in st.items()}
            for i, st in optim["state"].items()}}
    return {"step": int(state.step), "model": model, "optimizer": optim}
