"""The port's audio emotion classifier (emotiongestures_torch/models/
emotion_net.py, nn/resnet_se.py's SEBottleneck, train/classifier.py) against
the JAX package on the CPU, at spectrogram (32, 32), where fc0 is
4096 x 4096 (the full (128, 124) model's fc0 is 65,536 x 4096 and runs only
on the card).

Weights go torch -> JAX through the JAX package's tables; the JAX train
state comes from its own `create_state` with flax's `init` patched to
return them.

Tolerances:
  * forwards rtol 1e-5, atol 1e-5 (fp32, other summation orders), running
    statistics rtol 1e-4, atol 1e-6;
  * one fp32 step: loss rtol 1e-4; parameters atol 2.02 * lr (Adam's first
    update is about lr * sign(g)); Adam moments loosely, rtol 1e-3 and
    atol 0.15 of the tensor's largest entry. fp32 gradients through the
    train-mode BatchNorms can be off from float64 by a few % of a tensor's
    scale, depending on the batch, in either package (the BatchNorm
    backward cancels most of each channel's gradient). On this batch the
    port's and op-by-op JAX's read within 1.3e-5 of each tensor's scale
    from float64, and JAX's jitted step (XLA's fused CPU program) up to
    2.3% of fc0's;
  * one float64 step (JAX under enable_x64, the port in double; both still
    compute the focal loss in fp32): every moment rtol 1e-4, atol 1e-4 of
    its tensor's largest entry.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_train_common as C
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_tpu.models.emotion_net import DisNet as JaxDisNet
from emotiongestures_tpu.models.emotion_net import EmotionNet as JaxNet
from emotiongestures_tpu.nn.resnet_se import ResNetSE as JaxResNetSE
from emotiongestures_tpu.nn.resnet_se import SEBottleneck as JaxBottleneck
from emotiongestures_tpu.train import classifier as jclassifier
from emotiongestures_tpu.utils import torch_port as tp
from emotiongestures_torch.models.emotion_net import (
    DisNet,
    EmotionNet,
    flat_features,
)
from emotiongestures_torch.nn.resnet_se import ResNetSE, SEBottleneck
from emotiongestures_torch.train import classifier
from emotiongestures_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

SPEC = (32, 32)
B = 4


def spec_batch(seed=0, b=B):
    r = np.random.RandomState(seed)
    return (r.randn(b, *SPEC).astype(np.float32),
            np.eye(8, dtype=np.float32)[r.randint(0, 8, b)])


def emotion_net(seed=0):
    torch.manual_seed(seed)
    net = EmotionNet(spec_shape=SPEC, device="cpu")
    return net, C.jax_variables(net, tp.emotion_net_mapping())


def test_flat_features_follow_the_stride_2_stages():
    assert flat_features((128, 124)) == 16 * 16 * 256 == 65536
    assert flat_features(SPEC) == 4 * 4 * 256
    assert flat_features((33, 20)) == 256 * 5 * 3


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_emotion_net_forward(train):
    """Eval mode on the running statistics; train mode on the batch's, with
    the running statistics it writes."""
    net, variables = emotion_net()
    x, _ = spec_batch()
    model = JaxNet()
    if train:
        want, mutated = model.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        net.train()
    else:
        want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if train:
        ref = tp.flax_table_to_torch_state(
            {"params": variables["params"], **mutated},
            tp.emotion_net_mapping())
        for name, buf in net.named_buffers():
            np.testing.assert_allclose(buf.numpy(), np.asarray(ref[name]),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def bottleneck_table(layers):
    """SEBottleneck stages: the JAX package has no table for them."""
    t = []
    tp._conv(t, "conv1", ("conv1",))
    tp._bn(t, "bn1", ("bn1",))
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            jb = (f"layer{stage + 1}_block{b}",)
            pre = f"layer{stage + 1}.{b}"
            for i in (1, 2, 3):
                tp._conv(t, f"{pre}.conv{i}", jb + (f"conv{i}",), bias=False)
                tp._bn(t, f"{pre}.bn{i}", jb + (f"bn{i}",))
            tp._linear(t, f"{pre}.se.fc.0", jb + ("se", "fc1"))
            tp._linear(t, f"{pre}.se.fc.2", jb + ("se", "fc2"))
            if b == 0:  # every stage's first block widens by 4
                tp._conv(t, f"{pre}.downsample.0", jb + ("downsample_conv",),
                         bias=False)
                tp._bn(t, f"{pre}.downsample.1", jb + ("downsample_bn",))
    return t


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_se_bottleneck_stages(train):
    layers, filters = (2, 1), (8, 16)
    torch.manual_seed(1)
    net = ResNetSE(layers, filters, block=SEBottleneck).train(train)
    assert isinstance(net.layer2[0], SEBottleneck)
    variables = C.jax_variables(net, bottleneck_table(layers))
    x = np.random.RandomState(2).randn(3, 1, 12, 10).astype(np.float32)
    model = JaxResNetSE(layers=layers, num_filters=filters,
                        block=JaxBottleneck)
    want, _ = model.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                          train=train, mutable=["batch_stats"])
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (3, 64, 6, 5)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)


def test_remat_bottleneck_gives_the_same_gradients():
    layers, filters = (1, 1), (4, 8)
    torch.manual_seed(3)
    plain = ResNetSE(layers, filters, block=SEBottleneck).train()
    remat = ResNetSE(layers, filters, block=SEBottleneck,
                     remat_blocks=True).train()
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 1, 8, 8)
    grads = []
    for net in (plain, remat):
        net(x).square().sum().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for (n, a), b in zip(plain.named_buffers(), remat.buffers()):
        assert torch.equal(a, b), n


def test_disnet_forward():
    torch.manual_seed(4)
    net = DisNet(device="cpu")
    variables = C.jax_variables(net, tp.disnet_mapping())
    x = np.random.RandomState(5).randn(6, 128).astype(np.float32)
    want = JaxDisNet().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def step_both(monkeypatch, float64=False):
    """One classifier step of each package from the same weights, batch and
    alpha; the port's state and JAX's."""
    with jax.enable_x64(float64):
        ts = classifier.create_state(0, spec_shape=SPEC, device="cpu")
        if float64:
            ts.module.double()
        table = tp.emotion_net_mapping()
        variables = C.jax_variables(ts.module, table)
        monkeypatch.setattr(JaxNet, "init", lambda self, *a, **k: variables)
        js = jclassifier.create_state(jax.random.PRNGKey(0))
        x, y = spec_batch(6)
        if float64:
            x = x.astype(np.float64)
        alpha = classifier.class_alpha(y)
        js, jm = jclassifier.train_step(js, jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(alpha))
        jm = {k: float(v) for k, v in jm.items()}
        ts, tm = classifier.train_step(ts, torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       torch.from_numpy(alpha))
    return ts, js, table, {k: float(v) for k, v in tm.items()}, jm


def test_one_step_fp32(monkeypatch):
    ts, js, table, tm, jm = step_both(monkeypatch)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    assert tm["acc"] == jm["acc"]
    snap = C.snapshot(ts)
    C.assert_close(snap, js, table, "params",
                   lambda name: (0.0, 2.02 * 3e-4))

    for what in ("mu", "nu"):
        C.assert_close(snap, js, table, what,
                       lambda name: (1e-3, lambda scale: 0.15 * scale))
    C.assert_close(snap, js, table, "buffers", lambda name: (1e-4, 1e-6))
    C.assert_counts(snap, js, 1)


def test_one_step_float64_gradients(monkeypatch):
    ts, js, table, tm, jm = step_both(monkeypatch, float64=True)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    snap = C.snapshot(ts)

    def tol(what):
        def by_name(name):
            return 1e-4, lambda scale: 1e-4 * scale
        return by_name

    for what in ("mu", "nu"):
        C.assert_close(snap, js, table, what, tol(what))
    C.assert_close(snap, js, table, "buffers", lambda name: (1e-4, 1e-6))


def test_bf16_step_runs_on_fp32_masters():
    ts = classifier.create_state(0, spec_shape=SPEC, device="cpu")
    x, y = spec_batch(7)
    before = ts.module.emotion_eocder_fc[0].weight.detach().clone()
    ts, m = classifier.train_step(ts, torch.from_numpy(x),
                                  torch.from_numpy(y),
                                  torch.ones(8), compute_dtype="bfloat16")
    assert np.isfinite(float(m["loss"]))
    for t in list(ts.module.parameters()) + list(ts.module.buffers()):
        assert t.dtype == torch.float32
    assert not torch.equal(before, ts.module.emotion_eocder_fc[0].weight)
    acc, preds, labels = classifier.eval_step(
        ts, torch.from_numpy(x), torch.from_numpy(y), "bfloat16")
    assert preds.shape == labels.shape == (B,) and 0 <= float(acc) <= 100


def test_class_alpha_folds_and_confusion_match_jax():
    r = np.random.RandomState(0)
    labels = np.eye(8, dtype=np.float32)[r.choice([0, 1, 1, 3, 5, 7], 50)]
    np.testing.assert_array_equal(classifier.class_alpha(labels),
                                  jclassifier.class_alpha(labels))
    assert classifier.class_alpha(labels)[2] == 50 / 8  # absent: count 1
    for n, splits, seed in ((40, 4, 0), (103, 10, 3)):
        for (a, b), (c, d) in zip(
                classifier.k_fold_indices(n, splits, seed),
                jclassifier.k_fold_indices(n, splits, seed)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    preds, truth = r.randint(0, 8, 64), r.randint(0, 8, 64)
    cm = classifier.confusion_matrix(preds, truth)
    np.testing.assert_array_equal(cm, jclassifier.confusion_matrix(preds,
                                                                   truth))
    assert cm[preds[0], truth[0]] >= 1 and cm.sum() == 64


@pytest.fixture
def ckpt_dir(tmp_path):
    path = tmp_path / "ckpt"
    yield path
    shutil.rmtree(path, ignore_errors=True)  # ~380 MB per checkpoint


def test_kfold_resume_continues_fold(ckpt_dir):
    """The contract of tests/test_cli_mains.py::test_kfold_resume_continues_
    fold: stop fold 0 through should_stop after 8 polls, resume from the
    checkpoint, and the resumed run finishes folds 0 and 1, fold 0 at
    4 epochs x (30 // 8) = 12 steps. The port trains the state in place, so
    the checkpoint's step is read before the resumed run."""
    full, test = C.TinySpectrograms(40, 0), C.TinySpectrograms(8, 1)
    saved = {}

    def checkpoint_fn(state, fold, epoch, it):
        save_checkpoint(state, ckpt_dir, max_to_keep=1)
        saved.update(fold=fold, iter=it)

    calls = {"n": 0}

    def stopper():
        calls["n"] += 1
        return calls["n"] > 8

    kw = dict(batch_size=8, n_splits=4, epochs=4, eval_every=2, seed=0,
              max_folds=2, checkpoint_fn=checkpoint_fn, device="cpu")
    assert classifier.train_k_fold(full, test, should_stop=stopper,
                                   **kw) == []
    assert saved and saved["fold"] == 0
    template = classifier.create_state(0, spec_shape=SPEC, device="cpu")
    state, ok = load_checkpoint(template, ckpt_dir)
    checkpoint_step = state.step
    assert ok and 2 <= checkpoint_step < 12
    assert checkpoint_step == saved["iter"]

    results = classifier.train_k_fold(full, test,
                                      resume_from=(state, saved["fold"]),
                                      **kw)
    assert [r["fold"] for r in results] == [0, 1]
    assert results[0]["state"] is state and state.step == 12
    assert len(results[0]["step_ms"]) == 12 - checkpoint_step
    assert results[1]["state"].step == 12
    for r in results:
        assert 0.0 <= r["test_acc"] <= 100.0
        assert r["confusion"].sum() == 8
