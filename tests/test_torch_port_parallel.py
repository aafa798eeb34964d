"""The port's data parallelism on the CPU: two gloo ranks
(`parallel.launch`, spawned processes) against one process on the whole
batch, with tests/test_parallel.py's criteria, at small widths (d_model 64,
one layer, global batch 16).

  * the GAN step (d_first with paired_label, g_first with emo_sem,
    d_concat_batch; dropout on), the FGD, skeleton, CVAE v3 and classifier
    steps, and the eval pipeline (`eval_batch` with injected and with drawn
    CVAE noise): the ranks reproduce one process and stay replicas;
  * train-mode TMMemory alone (pose 282), its output against one process;
  * planted faults, each of which the parity check must fail: BatchNorm on
    per-rank statistics, a dropout mask shared across ranks (both caught
    by the GAN step's check) and TMMemory coupling per rank (caught by the
    eval pipeline's and by train-mode TMMemory's; the train step's check at
    d_model 64 does not see it, since TMMemory's scores start near zero);
  * the 2-rank GAN step against the JAX package's single-device step on
    the same weights and batch, dropout off on both sides: JAX's data
    parallelism equals its single device (tests/test_parallel.py), so the
    ranks are held to JAX through it;
  * the collectives, the masks, and `dp_setup` / `resolve_num_devices`
    against tests/test_parallel.py:317-337.

The heavier runs are shared by several tests and made once per pytest run:
under pytest-xdist by whichever worker comes first, the others read its
pickled verdicts (a lock file in the run's temp root). Each computes its
one-process reference while its two ranks run.
"""
import fcntl
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import torch_port_parallel_common as P
import torch_port_train_common as T
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_torch.cli import presets
from emotiongestures_torch.cli import train_emotion_gesture as train_cli
from emotiongestures_torch.parallel import mesh
from emotiongestures_torch.train import gan as tgan

GAN_STATES = ("gen", "disc")


def shared(tmp_path_factory, name, compute):
    """`compute()` once per pytest run across xdist workers."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"torch_port_parallel_{name}.pkl"
    with open(root / f"torch_port_parallel_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(compute()))
        return pickle.loads(path.read_bytes())


def verdicts(ref, got, pairs):
    """{name: (parity failures, ranks equal)} for (name, ref name, keys,
    state names) in `pairs`."""
    out = {}
    for name, ref_name, keys, states in pairs:
        fails = P.parity_failures(ref[ref_name], got[0][name], keys, states)
        try:
            P.assert_replicas(got, name, states)
            same = True
        except AssertionError:
            same = False
        out[name] = (fails, same)
    return out


@pytest.fixture(scope="module")
def gan_dfirst(tmp_path_factory):
    """d_first, paired_label, dropout on: one process, two ranks, and two
    ranks with a fault planted."""
    def compute():
        ref, got = P.one_and_two([("d_first", "gan", {})],
                                 [("d_first", "gan", {}),
                                  ("bn", "gan", {"fault": "bn"}),
                                  ("mask", "gan", {"fault": "mask"})])
        return verdicts(ref, got, [
            (n, "d_first", P.GAN_KEYS, GAN_STATES)
            for n in ("d_first", "bn", "mask")])
    return shared(tmp_path_factory, "gan_dfirst", compute)


VARIANTS = {"g_first-emo_sem": {"update_order": "g_first",
                                "contrastive_mode": "emo_sem"},
            "d_concat_batch": {"d_concat_batch": True}}


@pytest.fixture(scope="module")
def gan_variants(tmp_path_factory):
    def compute():
        cases = [(n, "gan", {"cfg": c}) for n, c in VARIANTS.items()]
        ref, got = P.one_and_two(cases, cases)
        return verdicts(ref, got, [(n, n, P.GAN_KEYS, GAN_STATES)
                                   for n in VARIANTS])
    return shared(tmp_path_factory, "gan_variants", compute)


BF16_GRADS = {"compute_dtype": "bfloat16", "grad_dtype": "bfloat16",
              "d_concat_batch": True, "update_order": "g_first"}


@pytest.fixture(scope="module")
def gan_bf16_grads(tmp_path_factory):
    """One step with bf16 compute and bf16 gradients (reduced in fp32 after
    the upcast), d_concat_batch, g_first: losses and the generator's
    parameters of one process and of rank 0."""
    def compute():
        cases = [("bf16", "gan", {"cfg": BF16_GRADS, "steps": 1})]
        ref, got = P.one_and_two(cases, cases)
        ref = ref["bf16"]
        gen = max(float(np.abs(got[0]["bf16"]["gen"][k].astype(np.float64)
                               - v).max()) for k, v in ref["gen"].items()
                  if not k.endswith(("running_mean", "running_var")))
        return ref["metrics"][0], got[0]["bf16"]["metrics"][0], gen
    return shared(tmp_path_factory, "gan_bf16_grads", compute)


SMALL = {"fgd": ("loss",), "skeleton": ("loss", "acc"),
         "cvae": ("loss", "recon", "kl"), "classifier": ("loss", "acc")}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small trainers, the eval pipeline and train-mode TMMemory (each
    also with TMMemory per rank), the collectives and the masks."""
    def compute():
        cases = [(n, n, {}) for n in SMALL] + [("eval", "eval", {}),
                                               ("tmmemory", "tmmemory", {})]
        ref, got = P.one_and_two(cases + [("masks", "masks", {})], cases + [
            ("eval_tm", "eval", {"fault": "tm"}),
            ("tmmemory_tm", "tmmemory", {"fault": "tm"}),
            ("collectives", "collectives", {}), ("masks", "masks", {})])
        out = verdicts(ref, got, [(n, n, keys, ("model",))
                                  for n, keys in SMALL.items()])
        for name, ref_name in (("eval", "eval"), ("eval_tm", "eval"),
                               ("tmmemory", "tmmemory"),
                               ("tmmemory_tm", "tmmemory")):
            out[name] = {k: (np.concatenate([g[name][k] for g in got]), v)
                         for k, v in ref[ref_name].items()}
        out["classifier_eval"] = (
            ref["classifier"]["eval_acc"],
            [g["classifier"]["eval_acc"] for g in got],
            ref["classifier"]["preds"],
            np.concatenate([g["classifier"]["preds"] for g in got]))
        out["collectives"] = [g["collectives"] for g in got]
        out["masks"] = (ref["masks"], [g["masks"] for g in got])
        return out
    return shared(tmp_path_factory, "small", compute)


def test_gan_step_two_ranks_match_one_process(gan_dfirst):
    fails, same = gan_dfirst["d_first"]
    assert fails == []
    assert same, "the ranks' states differ"


@pytest.mark.parametrize("name", list(VARIANTS))
def test_gan_variants_two_ranks_match_one_process(gan_variants, name):
    fails, same = gan_variants[name]
    assert fails == []
    assert same, "the ranks' states differ"


def test_gan_bf16_grads_two_ranks_match_one_process(gan_bf16_grads):
    """tests/test_parallel.py:462-503's criteria: losses within rtol 2e-2
    (atol 1e-4), the generator's parameters within 5e-4."""
    ref, got, gen_err = gan_bf16_grads
    for k in P.GAN_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-2, atol=1e-4,
                                   err_msg=k)
    assert gen_err < 5e-4, gen_err


@pytest.mark.parametrize("name", list(SMALL))
def test_small_trainers_two_ranks_match_one_process(small, name):
    fails, same = small[name]
    assert fails == []
    assert same, "the ranks' states differ"


def test_classifier_eval_is_global(small):
    """eval_step's accuracy is the global batch's on every rank; the
    ranks' predictions are the one-process predictions' rows."""
    acc, rank_accs, preds, rank_preds = small["classifier_eval"]
    assert rank_accs == [acc, acc]
    assert np.array_equal(preds, rank_preds)


EVAL_TOL = dict(atol=2e-5, rtol=2e-4)  # tests/test_parallel.py:186-187


def test_eval_pipeline_two_ranks_match_one_process(small):
    """eval_batch's poses, skeleton logits and FGD features, the ranks'
    rows stacked, against one process: injected noise and noise drawn for
    the global batch from a generator."""
    for key, (got, want) in small["eval"].items():
        np.testing.assert_allclose(got, want, err_msg=key, **EVAL_TOL)


@pytest.mark.parametrize("fault", ["bn", "mask"])
def test_planted_faults_fail_the_gan_parity_check(gan_dfirst, fault):
    fails, _ = gan_dfirst[fault]
    assert fails, f"{fault}: the parity check passed"


def test_planted_tmmemory_fault_fails_the_eval_parity_check(small):
    with pytest.raises(AssertionError):
        for key, (got, want) in small["eval_tm"].items():
            np.testing.assert_allclose(got, want, err_msg=key, **EVAL_TOL)


def test_tmmemory_train_two_ranks_match_one_process(small):
    """TMMemory in train mode, directly: the ranks' rows of its output
    against one process on the global batch (the GAN step's check cannot
    resolve its coupling at d_model 64)."""
    got, want = small["tmmemory"]["out"]
    assert got.shape == (P.B, 50, 282)
    np.testing.assert_allclose(got, want, **EVAL_TOL)


def test_planted_tmmemory_fault_fails_the_train_check(small):
    """Coupling each rank's rows only: the check above must fail."""
    got, want = small["tmmemory_tm"]["out"]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **EVAL_TOL)


def test_dropout_masks_are_the_global_draw(small):
    """Each rank's masks are its rows of the one-process draw (blocks 2:
    its rows of each of the two batches), so no two ranks share one."""
    ref, (m0, m1) = small["masks"]
    half = P.B // 2
    assert np.array_equal(np.concatenate([m0[1], m1[1]]), ref[1])
    assert not np.array_equal(m0[1], m1[1])
    want = [ref[2][:half], ref[2][P.B:P.B + half]], \
        [ref[2][half:P.B], ref[2][P.B + half:]]
    for got, parts in zip((m0[2], m1[2]), want):
        assert np.array_equal(got, np.concatenate(parts))


def test_collectives_and_their_gradients(small):
    """all_reduce_sum: the sum on every rank, backward the sum of the ranks'
    upstream gradients; all_gather: rank order, backward this rank's rows
    of the summed gradient; all_reduce_mean keeps each dtype."""
    xs = [np.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)]
    w = np.arange(12.0).reshape(6, 2)
    for r, res in enumerate(small["collectives"]):
        np.testing.assert_array_equal(res["sum"], xs[0] + xs[1])
        np.testing.assert_array_equal(res["sum_grad"], 2 * w[:3])
        np.testing.assert_array_equal(res["gather"], np.concatenate(xs))
        np.testing.assert_array_equal(res["gather_grad"],
                                      2 * w[3 * r:3 * r + 3])
        np.testing.assert_array_equal(res["means"][0], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(res["means"][1], [0.5, 0.5])
        np.testing.assert_array_equal(res["means"][2], [0.5])
        assert res["dtypes"] == ["torch.float32", "torch.bfloat16",
                                 "torch.float64"]


def test_gan_step_two_ranks_match_jax(monkeypatch):
    """One d_first step of two ranks (dropout off) against the JAX
    package's single-device step from the same weights on the same global
    batch: losses rtol 1e-4, parameters atol 2.02 * lr, running statistics
    rtol 1e-4 atol 1e-6 (test_torch_port_train_dfirst.py's)."""
    cfg = tgan.GANConfig(**P.SMALL_GAN)
    T.patch_flax_dropout(monkeypatch)

    def jax_side():  # while the ranks run
        (gs, _), (jg, jd), jcfg = T.states(cfg)
        jg, jd, jm = T.jax_step(jcfg)(jg, jd, T.jax_batch(P.gan_batch()),
                                      jax.random.PRNGKey(0))
        return gs, jg, jd, jm

    got, (gs, jg, jd, jm) = P.alongside(
        lambda: P.two_ranks([("jax", "gan", {"steps": 1,
                                             "dropout": False})]),
        jax_side)
    res = got[0]["jax"]
    T.assert_metrics(res["metrics"][0], {k: float(v) for k, v in jm.items()},
                     rtol=1e-4)
    names = dict(gs.module.named_parameters())
    for net, jstate, table in (
            ("gen", jg, T.generator_table(gs.module)),
            ("disc", jd, T.motion_discriminator_table())):
        sd = {k: torch.from_numpy(v) for k, v in res[net].items()}
        params = {k: v for k, v in sd.items()
                  if net == "disc" or k in names}
        buffers = {k: v for k, v in sd.items() if k.endswith(
            ("running_mean", "running_var"))}
        T.assert_close({"params": params}, jstate, table, "params",
                       lambda n: (0.0, 2.02 * cfg.lr))
        if buffers:
            T.assert_close({"buffers": buffers}, jstate, table, "buffers",
                           lambda n: (1e-4, 1e-6))
    P.assert_replicas(got, "jax", GAN_STATES)


def test_dp_setup_semantics_on_cards(monkeypatch):
    """tests/test_parallel.py:317-337 with 8 cards visible: auto mode
    degrades to the largest count that divides the batch; an explicit count
    that cannot shard it, or that exceeds the cards, is a SystemExit."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert mesh.dp_setup(1, 7) is None
    assert mesh.dp_setup(0, 16) == 8
    assert mesh.dp_setup(0, 12) == 6
    assert mesh.dp_setup(0, 7) == 7
    assert mesh.dp_setup(0, 1) is None
    assert mesh.dp_setup(4, 16) == 4
    with pytest.raises(SystemExit, match="divisible"):
        mesh.dp_setup(8, 12)
    with pytest.raises(SystemExit, match="visible"):
        mesh.dp_setup(16, 16)
    assert mesh.resolve_num_devices(0) == 8


def test_num_devices_on_the_cpu():
    """On the CPU 0 is one process; ranks start only for a count."""
    assert mesh.resolve_num_devices(0, "cpu") == 1
    assert mesh.dp_setup(0, 16, "cpu") is None
    assert mesh.dp_setup(2, 16, "cpu") == 2
    with pytest.raises(SystemExit, match="visible"):
        mesh.resolve_num_devices(100000, "cpu")


@pytest.mark.parametrize("flags,error,match", [
    (["--model_parallel", "2", "--coordinator_address", "localhost:1",
      "--num_processes", "6", "--process_id", "0"], SystemExit,
     "data axis"),
    (["--coordinator_address", "localhost:1", "--num_processes", "2"],
     SystemExit, "together"),
    (["--coordinator_address", "localhost:1", "--num_processes", "2",
      "--process_id", "0", "--num_devices", "4"], SystemExit, "disagrees"),
], ids=["model-parallel", "partial-multihost", "devices-vs-processes"])
def test_plan_refuses_before_joining(flags, error, match):
    args = train_cli.build_parser().parse_args(["--device", "cpu", *flags])
    with pytest.raises(error, match=match):
        mesh.plan(args, 8, "cpu")


@pytest.mark.parametrize("source", ["synthetic", "store"])
def test_batches_take_a_process_rows(tmp_path, source):
    """`rows` (what `pipeline.batch_rows` gives a rank) takes that slice of
    every global batch in the seeded order, for the synthetic set and for
    a GestureStore (through the C++ gather)."""
    from emotiongestures_torch.data.dataset import SpeechMotionDataset
    from emotiongestures_torch.data.synthetic import (
        SyntheticGestureDataset,
        materialize_store,
    )

    if source == "synthetic":
        ds = SyntheticGestureDataset(n_samples=16, seed=1)
    else:
        materialize_store(tmp_path / "s_cache", 16, seed=1)
        ds = SpeechMotionDataset(tmp_path / "s")
    fields = ("pose_seq", "eid_label")
    full = list(ds.batches(8, seed=5, fields=fields))
    halves = [list(ds.batches(8, seed=5, fields=fields, rows=r))
              for r in (slice(0, 4), slice(4, 8))]
    assert len(full) == 2
    for i, batch in enumerate(full):
        for k in fields:
            np.testing.assert_array_equal(
                np.concatenate([halves[0][i][k], halves[1][i][k]]),
                batch[k], err_msg=k)


def test_preset_expands_once():
    """main() after cli(), and every rank of a launch, expand the preset
    again without argv: an explicit flag at its parser default must stay."""
    parser = train_cli.build_parser()
    argv = ["--preset", "fast", "--compute_dtype", "float32"]
    args = presets.apply_preset(parser.parse_args(argv), parser,
                                presets.GAN_TRAIN_FAST, argv=argv)
    args = presets.apply_preset(args, parser, presets.GAN_TRAIN_FAST)
    assert (args.compute_dtype, args.update_order) == ("float32", "g_first")
