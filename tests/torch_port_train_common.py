"""Shared parts of tests/test_torch_port_train*.py: the JAX train states
built from the port's seeded modules, the JAX step without dropout, and the
comparisons of two states.

The weights go torch -> JAX through the JAX package's own tables
(utils/torch_port.py, and for MotionDiscriminator the mapping of
tests/test_torch_parity.py), inverted here. Every entry of the port's
state_dict must be in a table, so the transfer also checks the structure.
JAX train states are built from those weights, not from `gan.create_states`:
an eager flax init of the generator takes tens of seconds on the CPU.
"""
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotiongestures_tpu.core import schedules as jschedules
from emotiongestures_tpu.train import gan as jgan
from emotiongestures_tpu.train.state import create_train_state
from emotiongestures_tpu.utils.torch_port import (
    _enc_layers,
    _seq_linears,
    flax_table_to_torch_state,
    generator_mapping,
)
from emotiongestures_torch.core.layers import Dropout
from emotiongestures_torch.train import gan as tgan

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread while a test module that imports this runs: the
    suite's workers share the cores, and torch's default of a thread per
    core in each of them oversubscribes the machine many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FROM_TORCH = {
    "raw": lambda t: t,
    "dense": lambda t: t.T,
    "conv2d": lambda t: np.transpose(t, (2, 3, 1, 0)),
    "conv1d": lambda t: np.transpose(t, (2, 1, 0)),
    "dense1x1": lambda t: t[:, :, 0].T,
    "g": lambda t: t.reshape(-1),
    "convT1d": lambda t: np.transpose(t, (2, 0, 1))[::-1],
}

# a small generator: one transformer layer, d_model 64 (the audio
# encoder's SE-ResNet keeps its full 3-4-6 stages)
SMALL = dict(n_words=64, d_model=64, d_inner=128, n_layers=1)
BATCH = 4


def make_batch(seed=0, b=BATCH):
    """Numpy batch; labels 0, 0, 1, 2, ...: one pair of positives for the
    InfoNCE term, the other clips without a partner."""
    r = np.random.RandomState(seed)
    labels = np.array([0, 0] + list(range(1, b - 1))) % 8
    return {
        "spectrogram": r.randn(b, 128, 124).astype(np.float32),
        "text": r.randint(0, 64, (b, 60)).astype(np.int32),
        "pose_seq": (0.5 * r.randn(b, 60, 282)).astype(np.float32),
        "eid_label": np.eye(8, dtype=np.float32)[labels],
    }


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "text" else v)
            for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def generator_table(gen):
    """The JAX package's generator table; the stub tells it which TCN
    blocks have a downsample, as the port's module does."""
    blocks = {f"block{i}": ({"downsample": {}} if blk.downsample is not None
                            else {})
              for i, blk in enumerate(gen.text_encoder.tcn.network)}
    stub = {"params": {"text_encoder": {"tcn": blocks}}}
    return generator_mapping(stub, n_layers=len(gen.encoder.layer_stack),
                             tcn_layers=len(blocks))


def motion_discriminator_table(n_layers=2):
    """tests/test_torch_parity.py's mapping of the reference's
    Motion_Discriminator."""
    t = []
    _enc_layers(t, "encoder", ("encoder",), n_layers, "slf_attn")
    _seq_linears(t, "fc1", (), ("fc1",), (0,))
    _seq_linears(t, "fc2", (), ("fc2_0", "fc2_1", "fc2_2", "fc2_3",
                                "fc2_4", "fc2_out"), (0, 2, 4, 6, 8, 10))
    return t


def jax_variables(module, table):
    """The flax variables tree holding copies of `module`'s weights. Copies:
    JAX on the CPU may alias a numpy buffer, and a view of the module's
    tensors would then change under a JAX step still in flight when the
    port's optimizer updates them in place."""
    sd = {k: v.detach().cpu().numpy().copy()
          for k, v in module.state_dict().items()}
    assert {k for k, _, _ in table} == set(sd), "table and module differ"
    tree = {}
    for key, path, kind in table:
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = jnp.asarray(np.ascontiguousarray(
            FROM_TORCH[kind](sd[key])))
    return tree


def no_dropout(*modules):
    for m in modules:
        for d in m.modules():
            if isinstance(d, Dropout):
                d.p = 0.0


def patch_flax_dropout(monkeypatch):
    """Dropout off on the JAX side; BatchNorm keeps its batch statistics."""
    monkeypatch.setattr(
        flax.linen.Dropout, "__call__",
        lambda self, inputs, deterministic=None, rng=None: inputs)


def states(cfg, seed=0, float64=False):
    """Port states on the CPU (dropout off) and the JAX states holding the
    same weights, with the same optimizer. `float64`: both sides in double
    (call under `jax.enable_x64(True)`)."""
    gs, ds = tgan.create_states(cfg, seed, device="cpu")
    if float64:
        gs.module.double()
        ds.module.double()
    no_dropout(gs.module, ds.module)
    jcfg = jgan.GANConfig(**dataclasses.asdict(cfg))
    jgen, jdisc = jgan.build_models(jcfg)

    def tx():
        kw = dict(b1=cfg.beta1, b2=cfg.beta2, weight_decay=cfg.weight_decay)
        if cfg.steps_per_epoch > 0:
            return jschedules.adam_staged(cfg.lr, cfg.steps_per_epoch, **kw)
        return jschedules.adam(lr=cfg.lr, **kw)

    jg = create_train_state(jgen, jax_variables(gs.module, generator_table(
        gs.module)), tx())
    jd = create_train_state(jdisc, jax_variables(
        ds.module, motion_discriminator_table()), tx())
    return (gs, ds), (jg, jd), jcfg


def jax_step(jcfg, use_disc=True):
    """gan.train_step's body under a fresh jit: a trace made while flax's
    Dropout is patched, never a cached one made without the patch."""
    body = jgan.train_step.__wrapped__
    return jax.jit(lambda g, d, b, k: body(g, d, b, k, jcfg, use_disc))


def snapshot(state):
    """Copies of a port state's parameters, Adam moments, buffers and
    counts, by state_dict name."""
    named = dict(state.module.named_parameters())
    opt = state.optimizer.state
    return {
        "params": {n: p.detach().clone() for n, p in named.items()},
        "mu": {n: opt[p]["exp_avg"].clone() for n, p in named.items()
               if p in opt},
        "nu": {n: opt[p]["exp_avg_sq"].clone() for n, p in named.items()
               if p in opt},
        "buffers": {n: b.clone() for n, b in state.module.named_buffers()},
        "step": state.step,
        "adam_count": {int(opt[p]["step"]) for p in named.values()
                       if p in opt},
    }


def load_jax_state(tstate, jstate, table):
    """Put a JAX state's parameters, running statistics and Adam moments
    into a port state."""
    sd = tstate.module.state_dict()
    ref = reference(jstate, table, "buffers")
    tstate.module.load_state_dict(
        {k: torch.as_tensor(ref[k], dtype=v.dtype) for k, v in sd.items()},
        strict=True)
    mu, nu = reference(jstate, table, "mu"), reference(jstate, table, "nu")
    for name, p in tstate.module.named_parameters():
        st = tstate.optimizer.state[p]
        st["exp_avg"].copy_(torch.as_tensor(mu[name]))
        st["exp_avg_sq"].copy_(torch.as_tensor(nu[name]))


def run_both(cfg, monkeypatch, steps=2, use_disc=True, float64=False,
             seed=0, sync=False):
    """`steps` train steps of the port and of JAX from the same weights
    and batches, dropout off on both sides. One record per step: the
    metrics, a snapshot of each port state and the JAX states. `sync`:
    each step after the first starts the port from JAX's state, so it
    holds that update alone."""
    patch_flax_dropout(monkeypatch)
    with jax.enable_x64(float64):
        (gs, ds), (jg, jd), jcfg = states(cfg, seed, float64)
        step = jax_step(jcfg, use_disc)
        gen_table = generator_table(gs.module)
        disc_table = motion_discriminator_table()
        records = []
        for i in range(steps):
            if sync and i:
                load_jax_state(gs, jg, gen_table)
                if use_disc:
                    load_jax_state(ds, jd, disc_table)
            b = make_batch(seed + i)
            if float64:
                b = {k: (v.astype(np.float64) if v.dtype == np.float32
                         else v) for k, v in b.items()}
            jg, jd, jm = step(jg, jd, jax_batch(b), jax.random.PRNGKey(i))
            jm = {k: float(v) for k, v in jm.items()}
            gs, ds, tm = tgan.train_step(gs, ds, torch_batch(b), i, cfg,
                                         use_disc)
            records.append({
                "tm": {k: float(v) for k, v in tm.items()}, "jm": jm,
                "g": snapshot(gs), "d": snapshot(ds), "jg": jg, "jd": jd})
    return records, gen_table


def adam_state(opt_state):
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s
    raise AssertionError("no ScaleByAdamState")


def reference(jstate, table, what):
    """A JAX state's params / mu / nu / batch_stats in the port's
    state_dict names."""
    tree = jstate.params
    if what in ("mu", "nu"):
        tree = getattr(adam_state(jstate.opt_state), what)
    ref = flax_table_to_torch_state(
        {"params": tree, "batch_stats": jstate.batch_stats}, table)
    return {k: np.asarray(v, np.float64) for k, v in ref.items()}


def assert_close(snap, jstate, table, what, tol):
    """Each tensor of snap[what] against JAX: |got - want| <= atol +
    rtol * |want| with (rtol, atol) = tol(name); a callable atol takes
    max|want|."""
    ref = reference(jstate, table, what)
    assert snap[what], what
    for name, got in snap[what].items():
        want = ref[name]
        rtol, atol = tol(name)
        if callable(atol):
            atol = atol(float(np.abs(want).max()))
        np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol,
                                   atol=atol, err_msg=f"{what} {name}")


def assert_metrics(tm, jm, rtol):
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-12,
                                   err_msg=k)


def assert_counts(snap, jstate, n):
    assert snap["step"] == int(jstate.step) == n
    assert snap["adam_count"] == {n}
    assert int(np.asarray(adam_state(jstate.opt_state).count)) == n


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
