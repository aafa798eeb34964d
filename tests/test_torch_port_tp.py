"""The port's tensor parallelism on the CPU: a 2 x 2 grid (4 gloo ranks:
(a), (c), the clip and (f)) and a 1 x 2 grid (2 ranks: (b), (c), the
clip) of `parallel.launch`, held to the JAX package and to one process at
tests/test_parallel.py's widths and tolerances.

  (a) the generator's eval forward (test_parallel.py:254-281: d_model 128,
      two layers, variant "base", batch 4) against JAX's `gen.apply` on
      the same weights (seeded in torch, carried to JAX through
      utils/weights.py's tables), rtol 1e-4, atol 1e-5;
  (b) the eval pipeline (test_parallel.py:406-459: the CVAE's sample, the
      generator with fused attention, the FGD autoencoder's features, the
      skeleton classifier's logits; batch 16) against JAX with the same
      injected CVAE noise, atol 2e-5, rtol 2e-4, through the plain
      partial-heads form and `residual_layer_norm_plain`;
  (c) a d_first GAN step with dropout on (test_parallel.py:339-393:
      d_model 64, one layer, 4 heads, batch 16) against the port's one
      process, with test_parallel.py's criteria, the split parameters'
      Adam moments gathered into the one-process layout beside them;
  (f) planted faults that those checks must fail: w_2's bias added on
      every model rank (the forward), the attention dropout's mask not
      sliced by heads (the GAN step).

The runs are shared by the tests and made once per pytest run (across
xdist workers, `test_torch_port_parallel.py::shared`'s lock file); the
JAX references and the one-process run are computed while the ranks run.
The shard rules (d), `shard_state` / `gather_state` (e) and the refusals
are in tests/test_torch_port_tp_rules.py; the CLIs in
tests/test_torch_port_tp_cli.py.
"""
import fcntl
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_parallel_common as P
import torch_port_tp_common as TP
import torch_port_train_common as T

from emotiongestures_torch.models.cvae import EmotionCVAEv3 as TCVAE
from emotiongestures_torch.models.fgd_ae import FGDAutoEncoder as TFGD
from emotiongestures_torch.models.generator import GestureTransformer as TGen
from emotiongestures_torch.models.skeleton_classifier import (
    SkeletonTransformer as TSkeleton,
)
from emotiongestures_torch.parallel import tensor
from emotiongestures_torch.utils import weights as W

GAN_STATES = ("gen", "disc", "gen_adam", "disc_adam")


def shared(tmp_path_factory, name, compute):
    """`compute()` once per pytest run across xdist workers."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"torch_port_tp_{name}.pkl"
    with open(root / f"torch_port_tp_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(compute()))
        return pickle.loads(path.read_bytes())


def jax_variables(module, table):
    """The JAX variables holding a seeded port module's weights (through
    utils/weights.py's table) and its numpy state_dict."""
    return T.jax_variables(module, table), P.numpy_state(module)


def generator_table(gen, n_layers, variant="memory"):
    blocks = {f"block{i}": ({"downsample": {}} if b.downsample is not None
                            else {})
              for i, b in enumerate(gen.text_encoder.tcn.network)}
    stub = {"params": {"text_encoder": {"tcn": blocks}}}
    return W.generator_table(stub, n_layers, len(blocks), variant)


def jax_forward():
    """(the weights as the port's state_dict, a callable of JAX's
    reference poses)."""
    from emotiongestures_tpu.models import GestureTransformer

    torch.manual_seed(0)
    port = TGen(**TP.FORWARD_GEN, device="cpu")
    v, state = jax_variables(port, generator_table(
        port, TP.FORWARD_GEN["n_layers"], "base"))
    gen = GestureTransformer(**TP.FORWARD_GEN)
    x = {k: jnp.asarray(a) for k, a in TP.forward_inputs().items()}
    return state, lambda: np.asarray(jax.jit(gen.apply)(
        v, x["spec"], x["text"], x["prior"])[0])


def jax_eval():
    """The four nets' port state_dicts (seeded in torch) and a callable of
    JAX's eval pipeline (test_parallel.py:406-459) on the same weights,
    with the CVAE noise injected."""
    from emotiongestures_tpu.models import (
        EmotionCVAEv3,
        FGDAutoEncoder,
        GestureTransformer,
        SkeletonTransformer,
    )

    torch.manual_seed(1)
    port = {"gen": TGen(**TP.EVAL_GEN, device="cpu"),
            "skeleton": TSkeleton(**TP.EVAL_SKELETON, device="cpu"),
            "fgd": TFGD(device="cpu"),
            "vae": TCVAE(feat_dim=TP.EVAL_GEN["d_model"], device="cpu")}
    tables = {"gen": generator_table(port["gen"], 1),
              "skeleton": W.skeleton_classifier_table(
                  TP.EVAL_SKELETON["n_layers"]),
              "fgd": W.fgd_ae_table(), "vae": W.cvae_v3_table()}
    pairs = {k: jax_variables(m, tables[k]) for k, m in port.items()}
    states = {k: st for k, (_, st) in pairs.items()}
    gv, sv, fv, vv = (pairs[k][0] for k in ("gen", "skeleton", "fgd",
                                            "vae"))
    gen = GestureTransformer(**TP.EVAL_GEN)
    vae = EmotionCVAEv3(feat_dim=TP.EVAL_GEN["d_model"])
    fgd = FGDAutoEncoder()
    skl = SkeletonTransformer(**TP.EVAL_SKELETON)
    x = {k: jnp.asarray(a) for k, a in TP.eval_inputs().items()}

    @jax.jit
    def pipeline(gv, sv, fv, vv, x):
        n = x["y"].shape[0]
        post_y = vae.apply(vv, x["y"],
                           method=lambda m, y: m.y_embed(y, train=False))
        sampled = vae.apply(vv, x["z"], post_y, n, False,
                            method=EmotionCVAEv3._fuse_decode)
        pred = gen.apply(gv, x["spec"], x["text"], x["target"][:, :10],
                         sampled, train=False)[0].astype(jnp.float32)
        _, feat = fgd.apply(fv, pred, train=False)
        logits, _ = skl.apply(sv, pred, train=False)
        return {"pred": pred, "feat": feat, "logits": logits}

    return states, lambda: {k: np.asarray(a) for k, a in
                            pipeline(gv, sv, fv, vv, x).items()}


def split_adam(res):
    """The gathered Adam moments of the parameters the grid splits (the
    transformer's; the audio encoder's fp32 gradients, and so its moments,
    are ill-conditioned in both layouts: test_torch_port_train_*.py)."""
    for net in ("gen", "disc"):
        res[net + "_adam"] = {
            k: v for k, v in res[net + "_adam"].items()
            if tensor.shard_dim(k.rsplit(".", 1)[0]) is not None}
        assert res[net + "_adam"], net
    return res


def clip_errors(got):
    """Each rank's clipped gradients against its cut of one process's
    clip of the whole gradients: the largest difference."""
    from emotiongestures_torch.train.state import clip_by_global_norm

    _, full = TP.clip_grads()
    names = list(full)
    ref = dict(zip(names, clip_by_global_norm([full[n] for n in names],
                                              TP.CLIP_NORM)))
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in full.values()])))
    worst = 0.0
    for g in got:
        want = tensor.shard_state(ref, g["clip"]["model_index"], 2)
        worst = max(worst, max(float(np.abs(g["clip"]["grads"][n]
                                            - want[n].numpy()).max())
                               for n in names))
    return {"max_abs_err": worst, "norm": norm}


def run_grid(n_ranks):
    """The cases on an (n_ranks / 2) x 2 grid, JAX's reference and the
    one-process GAN step computed meanwhile: {case: verdict inputs}. The
    2 x 2 grid runs the generator's forward and the planted faults, the
    1 x 2 grid the eval pipeline; both the GAN step and the clip."""
    cases = [("gan", "gan", {}), ("clip", "clip", {})]
    if n_ranks == 4:
        state, jax_ref = jax_forward()
        cases += [("forward", "forward", {"gen_state": state}),
                  ("forward_bias", "forward", {"gen_state": state,
                                               "fault": "bias"}),
                  ("gan_heads", "gan", {"fault": "heads"})]
    else:
        states, jax_ref = jax_eval()
        cases += [("eval", "eval", {"states": states})]

    def references():
        before = torch.get_num_threads()
        torch.set_num_threads(P.THREADS)
        try:
            return {"jax": jax_ref(), "gan": split_adam(TP.gan_case())}
        finally:
            torch.set_num_threads(before)

    got, ref = P.alongside(lambda: TP.grid(n_ranks, 2, cases), references)
    ref[cases[2][0]] = ref.pop("jax")
    out = {"ref": ref, "n_ranks": n_ranks}
    out["clip"] = clip_errors(got)
    for name, _, _ in cases[:1] + cases[2:]:
        kind = name.split("_")[0]
        if kind == "gan":
            ranks = [split_adam(g[name]) for g in got]
            out[name] = {
                "fails": P.parity_failures(ref["gan"], ranks[0], P.GAN_KEYS,
                                           GAN_STATES, steps=1),
                "ranks_equal": all(
                    np.array_equal(r[s][k], ranks[0][s][k])
                    for r in ranks[1:] for s in GAN_STATES
                    for k in ranks[0][s])}
        else:
            keys = ("pred",) if kind == "forward" else \
                ("pred", "feat", "logits")
            out[name] = {
                k: TP.stacked(got, name, k, 2) for k in keys}
            out[name]["model_ranks_equal"] = all(
                np.array_equal(got[i][name][k], got[i + 1][name][k])
                for i in range(0, n_ranks, 2) for k in keys)
            if kind == "eval":
                out[name]["partial_calls"] = [g[name]["partial_calls"]
                                              for g in got]
    return out


@pytest.fixture(scope="module")
def grid22(tmp_path_factory):
    return shared(tmp_path_factory, "grid22", lambda: run_grid(4))


@pytest.fixture(scope="module")
def grid12(tmp_path_factory):
    return shared(tmp_path_factory, "grid12", lambda: run_grid(2))


GRIDS = ["grid22", "grid12"]


def test_generator_forward_on_a_grid_matches_jax(grid22):
    """(a): the 2 x 2 grid's rows stacked over the data axis against JAX's
    one-device forward (test_parallel.py:276-277's tolerance); the model
    ranks of a data group hold the same rows."""
    res = grid22
    np.testing.assert_allclose(res["forward"]["pred"], res["ref"]["forward"],
                               **TP.FORWARD_TOL)
    assert res["forward"]["model_ranks_equal"]


def test_eval_pipeline_on_a_grid_matches_jax(grid12):
    """(b): the 1 x 2 grid's poses, FGD features and skeleton logits
    against JAX (test_parallel.py:457-459's tolerance); the generator's
    two fused sublayers ran the partial-heads form on both ranks."""
    res = grid12
    for k in ("pred", "feat", "logits"):
        np.testing.assert_allclose(res["eval"][k], res["ref"]["eval"][k],
                                   err_msg=k, **TP.EVAL_TOL)
    assert res["eval"]["model_ranks_equal"]
    assert res["eval"]["partial_calls"] == [2] * res["n_ranks"]


@pytest.mark.parametrize("grid", GRIDS)
def test_gan_steps_on_a_grid_match_one_process(grid, request):
    """(c): one step, dropout on: losses, parameters, BatchNorm statistics
    and Adam's moments (gathered) within test_parallel.py:376-393's
    criteria; every rank gathers the same states."""
    res = request.getfixturevalue(grid)["gan"]
    assert res["fails"] == []
    assert res["ranks_equal"]


@pytest.mark.parametrize("grid", GRIDS)
def test_global_norm_clip_on_a_grid_matches_one_process(grid, request):
    """train.state.clip_by_global_norm: a split gradient's squares summed
    over the model group once, a replicated one's counted once, so each
    rank's clipped shards are its cut of one process's clip."""
    res = request.getfixturevalue(grid)["clip"]
    assert res["norm"] > 10 * TP.CLIP_NORM
    assert res["max_abs_err"] < 1e-7


def test_planted_bias_fault_fails_the_forward_check(grid22):
    """(f): w_2's bias added by both model ranks."""
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(grid22["forward_bias"]["pred"],
                                   grid22["ref"]["forward"],
                                   **TP.FORWARD_TOL)


def test_planted_head_mask_fault_fails_the_gan_check(grid22):
    """(f): each model rank's attention-dropout mask drawn for its own
    heads, not sliced from the draw for all heads."""
    assert grid22["gan_heads"]["fails"]
