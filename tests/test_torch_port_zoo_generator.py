"""The generator's prior-encoder variants against the JAX package at fp32 on
the CPU: `base` (PriorConvEncoder), `spatial_memory` (SPMemoryV2, no
TMMemory) and `padding_initial` (SPMemoryV2 + TMMemory), and the unused
AudioConvEncoder; one GAN train step of `base` and of `padding_initial`
against the JAX step; the GAN trainer's --variant through its `main`.

The JAX package has no weight table for PriorConvEncoder, SPMemoryV2 or
AudioConvEncoder, so this file writes the JAX-side entries itself, from the
JAX modules' parameter names, and holds the port's tables to them and to
the JAX parameter trees (every leaf mapped once). Weights go torch -> JAX
(tests/torch_port_train_common.py::jax_variables), with the BatchNorm
statistics and affine parameters moved off their init values first.

Tolerance: rtol 2e-4, atol 2e-5 of the largest entry of each output (the
parity default of test_torch_port_modules.py); running statistics rtol
1e-4, atol 1e-6. The GAN step keeps test_torch_port_train_dfirst.py's
tolerances and their reasons.
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_train_common as C
from torch_port_train_common import one_torch_thread  # noqa: F401
from torch_port_zoo_common import assert_tree_matches, perturb_bn, rel_close

from emotiongestures_tpu.models.generator import (
    AudioConvEncoder as JaxAudioConv,
    GestureTransformer as JaxGen,
)
from emotiongestures_tpu.utils.torch_port import (
    _bn,
    _conv,
    _linear,
    flax_table_to_torch_state,
)
from emotiongestures_torch.cli import train_emotion_gesture as gan_cli
from emotiongestures_torch.models import generator as G
from emotiongestures_torch.train import gan as tgan
from emotiongestures_torch.utils import weights as W
from emotiongestures_torch.utils.checkpoint import latest_step

VARIANTS = ("base", "spatial_memory", "padding_initial")
SMALL = dict(n_words=16, d_model=64, d_inner=128, n_layers=1, n_head=2,
             d_k=32, d_v=32)
SPEC_LEN = 16
B = 3


MEMORY_TABLE = C.generator_table  # the JAX package's table, "memory"


def jax_prior_table(gen, variant):
    """The JAX-side prior_seq_encoder entries of `variant`, written here
    from the JAX modules' names (generator.py:140-170, 206-233, 299-345)."""
    pe, P = ("prior_seq_encoder",), "prior_seq_encoder"
    t = []
    if variant == "base":
        for i in (1, 2):
            _conv(t, f"{P}.conv{i}", pe + (f"conv{i}",), kind="conv1d")
            _bn(t, f"{P}.bn{i}", pe + (f"bn{i}",))
        _linear(t, f"{P}.fc1", pe + ("fc1",))
        _linear(t, f"{P}.fc2", pe + ("fc2",))
        return t
    memory = [e for e in MEMORY_TABLE(gen) if e[0].startswith(P + ".")]
    t += [e for e in memory if ".pred_conv." in e[0]]
    for i in (1, 2):
        _conv(t, f"{P}.spatial_memory.conv{i}",
              pe + ("spatial_memory", f"conv{i}"), kind="conv1d")
        _bn(t, f"{P}.spatial_memory.bn{i}", pe + ("spatial_memory",
                                                 f"bn{i}"))
    if variant == "padding_initial":
        t += [e for e in memory if ".temporal_memory." in e[0]]
    t += [e for e in memory if ".post_header." in e[0]]
    return t


def jax_generator_table(gen, variant):
    """The JAX package's generator table with the variant's prior
    encoder entries in place of the memory variant's."""
    rest = [e for e in MEMORY_TABLE(gen)
            if not e[0].startswith("prior_seq_encoder.")]
    return rest + jax_prior_table(gen, variant)


def inputs(seed=0, b=B):
    r = np.random.RandomState(seed)
    return (r.randn(b, 128, SPEC_LEN).astype(np.float32),
            r.randint(0, 16, (b, 60)),
            (0.5 * r.randn(b, 10, 282)).astype(np.float32))


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    """(variant, port generator, JAX generator, JAX variables with the
    port's weights, the JAX-side table)."""
    variant = request.param
    torch.manual_seed(0)
    gen = perturb_bn(G.GestureTransformer(**SMALL, spec_len=SPEC_LEN,
                                          variant=variant, device="cpu"))
    jgen = JaxGen(**SMALL, variant=variant)
    table = jax_generator_table(gen, variant)
    variables = C.jax_variables(gen, table)
    spec, text, prior = inputs()
    shapes = jax.eval_shape(lambda: jgen.init(
        jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(text),
        jnp.asarray(prior)))
    assert_tree_matches(variables, dict(shapes))
    return variant, gen, jgen, variables, table


def test_variant_tables_agree_with_the_jax_side(pair):
    """The port's generator_table for the variant gives the JAX-side
    table's keys and arrays."""
    variant, gen, _, variables, table = pair
    ours = W.generator_state_from_jax(
        {"params": {**variables["params"]}, "batch_stats":
         variables["batch_stats"]}, n_layers=1, variant=variant)
    theirs = flax_table_to_torch_state(variables, table)
    assert set(ours) == set(theirs) == set(gen.state_dict())
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))


def _blend_v2(self, initial, pred):
    """A planted fault: SPMemoryV2 returning the blend that the reference
    writes into a discarded clone."""
    h = initial[:, self.prior_frames - self.chunk:]
    mem = self.bn2(torch.relu(self.conv2(self.bn1(torch.relu(
        self.conv1(h))))))[:, 0]
    head = pred[:, : self.chunk]
    gate = torch.sigmoid(torch.einsum("bd,bcd->bc", mem, head))[..., None]
    blended = gate * head + (1.0 - gate) * mem[:, None]
    return torch.cat([blended, pred[:, self.chunk:]], dim=1)


def test_variant_forward_matches_jax(pair, monkeypatch):
    """Eval mode, and train mode with dropout off on both sides (both JAX
    modes in one jit): the five outputs, and in train mode the running
    statistics written (SPMemoryV2's two BatchNorms included). Then a
    planted fault, SPMemoryV2 returning its blend, must fail the eval pose
    check."""
    variant, gen, jgen, variables, table = pair
    spec, text, prior = inputs(1)
    targs = (torch.from_numpy(spec), torch.from_numpy(text),
             torch.from_numpy(prior))
    C.patch_flax_dropout(monkeypatch)
    # a fresh jit: traced under this test's patches
    want_eval, (want_train, mutated) = jax.jit(lambda v, *a: (
        jgen.apply(v, *a),
        jgen.apply(v, *a, train=True, mutable=["batch_stats"])))(
        variables, jnp.asarray(spec), jnp.asarray(text), jnp.asarray(prior))
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    with torch.no_grad():
        got_eval = gen(*targs)
        C.no_dropout(gen)
        gen.train()
        try:
            got_train = gen(*targs)
            after = {k: v.clone() for k, v in gen.state_dict().items()}
        finally:
            gen.load_state_dict(before)
            gen.eval()
    for mode, got, want in (("eval", got_eval, want_eval),
                            ("train", got_train, want_train)):
        for i, (g, w) in enumerate(zip(got, want)):
            rel_close(g.numpy(), w, msg=f"{variant} {mode} output {i}")
    stats = flax_table_to_torch_state(
        {"params": variables["params"],
         "batch_stats": mutated["batch_stats"]}, table)
    moved = 0
    for name, buf in gen.named_buffers():
        np.testing.assert_allclose(after[name].numpy(), stats[name],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        moved += not torch.equal(after[name], before[name])
    assert moved == len(list(gen.buffers()))
    if variant == "base":
        return
    sp = "prior_seq_encoder.spatial_memory.bn2.running_mean"
    assert not torch.equal(after[sp], before[sp])
    monkeypatch.setattr(G.SPMemoryV2, "forward", _blend_v2)
    with torch.no_grad():
        bad = gen(*targs)[0]
    with pytest.raises(AssertionError):
        rel_close(bad.numpy(), want_eval[0])


def test_audio_conv_encoder_matches_jax(monkeypatch):
    """AudioConvEncoder (unused by every variant) in eval and train mode;
    its table (the port's names) against the JAX module's tree."""
    torch.manual_seed(1)
    enc = perturb_bn(G.AudioConvEncoder(60, 32, 128, SPEC_LEN), 1).eval()
    jenc = JaxAudioConv(frames=60, d_model=32)
    t = []
    for i in (1, 2):
        _conv(t, f"conv{i}", (f"conv{i}",))
        _bn(t, f"bn{i}", (f"bn{i}",))
    _linear(t, "fc1", ("fc1",))
    _linear(t, "fc2", ("fc2",))
    assert [k for k, _, _ in W.audio_conv_encoder_table()] == \
        [k for k, _, _ in t]
    assert W.audio_conv_encoder_table() == t
    variables = C.jax_variables(enc, t)
    spec = np.random.RandomState(2).randn(2, 128, SPEC_LEN).astype(
        np.float32)
    assert_tree_matches(variables, dict(jax.eval_shape(
        lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(spec)))))
    with torch.no_grad():
        got = enc(torch.from_numpy(spec))
    rel_close(got.numpy(), jenc.apply(variables, jnp.asarray(spec)))
    C.patch_flax_dropout(monkeypatch)
    C.no_dropout(enc)
    enc.train()
    with torch.no_grad():
        got = enc(torch.from_numpy(spec))
    want, mutated = jenc.apply(variables, jnp.asarray(spec), train=True,
                               mutable=["batch_stats"])
    rel_close(got.numpy(), want)
    stats = flax_table_to_torch_state(
        {"params": variables["params"], "batch_stats":
         mutated["batch_stats"]}, t)
    for name, buf in enc.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="variant"):
        G.GestureTransformer(n_words=8, variant="spatial", device="cpu")


# --- one GAN train step of `base` and of `padding_initial` against JAX ----


@pytest.mark.parametrize("variant", ["base", "padding_initial"])
def test_gan_step_matches_jax(variant):
    """One train step from the same weights and batch, dropout off, in the
    discriminator warm-up (`use_disc=False`: G's update alone, where the
    variants differ; the d_first discriminator path is the same for every
    variant and tests/test_torch_port_train_dfirst.py holds it, and
    chip_smoke.py phase 12b runs it for both variants card vs CPU).
    Losses rtol 1e-4; Adam moments and parameters under
    test_torch_port_train_dfirst.py's tolerances (the audio encoder's
    ill-conditioned fp32 gradients at 0.15 of the largest entry); running
    statistics rtol 1e-4, atol 1e-6. SPMemoryV2's parameters get no
    gradient in either package (a zero update), its BatchNorms write their
    running statistics."""
    cfg = tgan.GANConfig(**C.SMALL, variant=variant)
    make_batch = C.make_batch

    def short_batch(seed=0, b=C.BATCH):
        batch = make_batch(seed, b)
        batch["spectrogram"] = batch["spectrogram"][..., :SPEC_LEN].copy()
        return batch

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "generator_table",
                   lambda gen: jax_generator_table(gen, variant))
        # spectrograms of SPEC_LEN frames: the SE-ResNet's run time is the
        # step's, its graph (the compile) the same
        mp.setattr(C, "make_batch", short_batch)
        mp.setattr(tgan, "GestureTransformer", functools.partial(
            G.GestureTransformer, spec_len=SPEC_LEN))
        (records, table) = C.run_both(cfg, mp, steps=1, use_disc=False)
    r = records[0]
    C.assert_metrics(r["tm"], r["jm"], rtol=1e-4)

    def moment_tol(name):
        if name == "audio_encoder.final_conv1.bias":
            return 0.0, 1e-6
        if name.startswith("audio_encoder.feat_extractor."):
            return 1e-4, lambda s: 0.15 * s
        return 1e-4, lambda s: 1e-4 * s

    C.assert_close(r["g"], r["jg"], table, "mu", moment_tol)
    C.assert_close(r["g"], r["jg"], table, "params",
                   lambda name: (0.0, 2.02 * cfg.lr))
    C.assert_close(r["g"], r["jg"], table, "buffers",
                   lambda name: (1e-4, 1e-6))
    C.assert_counts(r["g"], r["jg"], 1)
    if variant == "padding_initial":
        sp = "prior_seq_encoder.spatial_memory.conv1.weight"
        assert float(r["g"]["mu"][sp].abs().max()) == 0.0


# --- the trainer CLI's --variant -------------------------------------------

CLI = ["--device", "cpu", "--synthetic", "2", "--batch_size", "2",
       "--n_frames", "20", "--pose_dim", "12", "--d_model", "16",
       "--latent_dim", "32", "--gen_layers", "1", "--save_every", "1000",
       "--total_epoch", "1"]


def _cli(run_dir, *extra):
    return gan_cli.main(gan_cli.build_parser().parse_args(
        CLI + ["--model_save_path", str(run_dir), *extra]))


@pytest.mark.parametrize("variant", ["base", "padding_initial"])
def test_gan_cli_trains_each_variant(variant, tmp_path):
    """--variant through main: one step, finite losses; `base` then resumes
    with the same --variant to step 2, and a checkpoint of another variant
    fails its strict load. (`spatial_memory` builds as `padding_initial`
    less TMMemory; chip_smoke.py phase 12b trains all three.)"""
    run_dir = tmp_path / "run"
    try:
        gen, _, summary = _cli(run_dir, "--variant", variant)
        assert gen.module.variant == variant
        assert gen.step == summary["steps"] == 1
        assert all(np.isfinite(v) for v in summary["metrics"].values())
        assert latest_step(run_dir / "generator") == 1
        if variant == "base":
            gen, _, _ = _cli(run_dir, "--variant", variant, "--resume")
            assert gen.step == 2
            with pytest.raises(RuntimeError, match="state_dict"):
                _cli(run_dir, "--variant", "padding_initial", "--resume")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
