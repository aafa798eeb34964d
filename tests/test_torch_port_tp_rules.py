"""The port's tensor-parallel shard rules and the partial-heads form, in
one process on the CPU:

  (d) `parallel.tensor.RULES` split exactly the weights that the JAX
      package's `tp_param_shardings` shards on a GestureTransformer, a
      SkeletonTransformer and the motion discriminator, along the
      counterpart axis (a JAX kernel's column is a torch weight's row);
  (e) `shard_state` / `gather_state` and the optimizer's moments round
      trip bit for bit, and `shard_train_state` cuts a module and its Adam
      state as `shard_state` cuts their state_dicts;
  the partial-heads form: its plain version, summed over the heads'
      shards and closed by `residual_layer_norm_plain`, against the JAX
      package's Pallas kernel (interpret mode) and the whole-heads plain
      version; CPU routing; the wrapper's refusals;
  `tp_setup` against tests/test_parallel.py:396-403.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_train_common as T

from emotiongestures_torch.models.discriminator import MotionDiscriminator
from emotiongestures_torch.models.generator import GestureTransformer
from emotiongestures_torch.models.skeleton_classifier import (
    SkeletonTransformer,
)
from emotiongestures_torch.ops import fused_attention as FA
from emotiongestures_torch.parallel import mesh, tensor
from emotiongestures_torch.utils import weights as W

SMALL_GEN = dict(n_words=16, d_model=64, d_inner=128, n_layers=2, n_head=4,
                 d_k=16, d_v=16)


def _generator_table(gen, n_layers):
    blocks = {f"block{i}": ({"downsample": {}} if b.downsample is not None
                            else {})
              for i, b in enumerate(gen.text_encoder.tcn.network)}
    stub = {"params": {"text_encoder": {"tcn": blocks}}}
    return W.generator_table(stub, n_layers, len(blocks))


def _nets():
    torch.manual_seed(0)
    gen = GestureTransformer(**SMALL_GEN, device="cpu")
    skl = SkeletonTransformer(d_model=64, d_inner=128, n_layers=2,
                              device="cpu")
    disc = MotionDiscriminator(device="cpu")
    return {"generator": (gen, _generator_table(gen, 2)),
            "skeleton": (skl, W.skeleton_classifier_table(2)),
            "discriminator": (disc, W.motion_discriminator_table())}


@pytest.mark.parametrize("net", ["generator", "skeleton", "discriminator"])
def test_shard_rules_match_jax(net):
    """(d): for every weight of the net, JAX's spec on a (1, 2) mesh and
    the port's rule agree: replicated on both sides, or split along the
    counterpart axis (a transposed dense kernel's axis j is the torch
    weight's axis 1 - j; a bias's axis 0 is its axis 0)."""
    from emotiongestures_tpu.parallel.mesh import (make_mesh,
                                                   tp_param_shardings)

    module, table = _nets()[net]
    variables = T.jax_variables(module, table)
    specs = tp_param_shardings(variables["params"],
                               make_mesh(n_data=1, n_model=2))
    n_split = 0
    for key, path, kind in table:
        if path[0] != "params":
            assert tensor.shard_dim(key) is None, key
            continue
        spec = specs
        for name in path[1:]:
            spec = spec[name]
        spec = tuple(spec.spec)
        if "model" not in spec:
            assert tensor.shard_dim(key) is None, (key, spec)
            continue
        n_split += 1
        axis = spec.index("model")
        want = axis if len(spec) == 1 or kind == "raw" else 1 - axis
        assert kind in ("dense", "raw"), (key, kind)
        assert tensor.shard_dim(key) == want, (key, spec, kind)
    # per attention block w_qs, w_ks, w_vs, fc; per FFN w_1 (and bias),
    # w_2
    blocks = sum(1 for k, _, _ in table if k.endswith("w_qs.weight"))
    assert n_split == blocks * 7, (n_split, blocks)


def _adam_state(module):
    """An Adam over `module` after one step on fixed gradients."""
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    for p in module.parameters():
        p.grad = torch.sin(p.detach() * 7)
    opt.step()
    return opt


@pytest.mark.parametrize("n_model", [2, 4])
def test_shard_and_gather_round_trip_bit_for_bit(n_model):
    """(e): a whole state_dict and its Adam state cut into n_model shards
    and gathered back equal the originals bit for bit; each shard holds
    1/n_model of a split weight; shard_train_state cuts the live module
    and optimizer as shard_state / shard_optimizer_state cut their
    state_dicts."""
    from emotiongestures_torch.train.state import TrainState

    torch.manual_seed(1)
    gen = GestureTransformer(**SMALL_GEN, device="cpu")
    opt = _adam_state(gen)
    full = {k: v.clone() for k, v in gen.state_dict().items()}
    osd = opt.state_dict()
    dims = [tensor.shard_dim(n) for n, _ in gen.named_parameters()]
    shards = [tensor.shard_state(full, i, n_model) for i in range(n_model)]
    for k, v in full.items():
        d = tensor.shard_dim(k)
        for s in shards:
            want = list(v.shape)
            if d is not None:
                want[d] //= n_model
            assert list(s[k].shape) == want, k
    back = tensor.gather_state(shards)
    assert set(back) == set(full)
    assert all(torch.equal(back[k], full[k]) for k in full)
    oshards = [tensor.shard_optimizer_state(osd, dims, i, n_model)
               for i in range(n_model)]
    oback = tensor.gather_optimizer_state(oshards, dims)
    for i, st in osd["state"].items():
        for k, v in st.items():
            assert torch.equal(oback["state"][i][k], v), (i, k)
    state = TrainState(gen, opt)
    tensor.shard_train_state(state, 1, n_model)
    assert tensor.grid_of(gen) == (1, n_model)
    assert all(torch.equal(v, shards[1][k])
               for k, v in gen.state_dict().items())
    live = opt.state_dict()["state"]
    for i, st in oshards[1]["state"].items():
        for k, v in st.items():
            assert torch.equal(live[i][k], v), (i, k)


def test_shard_module_refuses_what_does_not_divide():
    gen = GestureTransformer(**SMALL_GEN, device="cpu")
    with pytest.raises(ValueError, match="attention heads"):
        tensor.shard_module(gen, 0, 3)
    tensor.shard_module(gen, 0, 2)
    with pytest.raises(RuntimeError, match="sharded already"):
        tensor.shard_module(gen, 0, 2)


def _sublayer(seed, B=3, Lq=7, Lk=5, D=128, H=8, dk=16):
    r = np.random.RandomState(seed)
    a = lambda *s, scale=1.0: (scale * r.randn(*s)).astype(np.float32)
    return (a(B, Lq, D), a(B, Lk, D), a(H * dk, D, scale=D ** -0.5),
            a(H * dk, D, scale=D ** -0.5), a(H * dk, D, scale=D ** -0.5),
            a(D, H * dk, scale=D ** -0.5), 1 + a(D, scale=0.1),
            a(D, scale=0.1))


def _partials(args, n, H, dk):
    q, kv, wq, wk, wv, wo = (torch.from_numpy(x) for x in args[:6])
    k = H * dk // n
    return [FA.fused_attention_partial(
        q, kv, wq[i * k:(i + 1) * k], wk[i * k:(i + 1) * k],
        wv[i * k:(i + 1) * k], wo[:, i * k:(i + 1) * k].contiguous(),
        n_head_local=H // n, d_k=dk) for i in range(n)]


@pytest.mark.parametrize("n_model", [2, 4, 8])
def test_partial_heads_form_matches_the_pallas_kernel(n_model):
    """The partial-heads form's plain version, n_model partials summed
    and closed by residual_layer_norm, against the JAX package's Pallas
    kernel (interpret mode) on the whole heads, at its tests' tolerance
    (rtol 2e-4, atol 2e-5), cross-attention with Lq != Lk."""
    from emotiongestures_tpu.ops.pallas_attention import fused_attention

    H, dk = 8, 16
    args = _sublayer(n_model, H=H, dk=dk)
    q, kv, wq, wk, wv, wo, s, b = args
    want = fused_attention(jnp.asarray(q), jnp.asarray(kv),
                           jnp.asarray(wq.T), jnp.asarray(wk.T),
                           jnp.asarray(wv.T), jnp.asarray(wo.T),
                           jnp.asarray(s), jnp.asarray(b), n_head=H,
                           d_k=dk, interpret=True)
    before = (FA.partial_launches, FA.residual_launches)
    got = FA.residual_layer_norm(sum(_partials(args, n_model, H, dk)),
                                 torch.from_numpy(q), torch.from_numpy(s),
                                 torch.from_numpy(b))
    assert (FA.partial_launches, FA.residual_launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    whole = FA.fused_attention_plain(*(torch.from_numpy(x) for x in args),
                                     n_head=H, d_k=dk)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_partial_form_refusals():
    """A tensor with no kernel raises; on the card the wrapper refuses a
    local H * d_k that is not a multiple of 32 (the kernel's k-step),
    which _check reads before any launch."""
    args = [torch.from_numpy(x) for x in _sublayer(0)]
    q, kv, wq, wk, wv, wo, s, b = args
    meta = [t.to("meta") for t in (q, kv, wq, wk, wv, wo)]
    with pytest.raises(RuntimeError, match="no kernel"):
        FA.fused_attention_partial(*meta, n_head_local=8, d_k=16)
    with pytest.raises(RuntimeError, match="no kernel"):
        FA.residual_layer_norm(q.to("meta"), q.to("meta"), s.to("meta"),
                               b.to("meta"))
    # 8 heads of d_k 16 over 8 ranks: one head, H_local * d_k = 16
    with pytest.raises(ValueError, match="32"):
        FA._check(q, kv, (wq[:16], wk[:16], wv[:16],
                          wo[:, :16].contiguous()), 1, 16)
    assert FA._check(q, kv, (wq[:32], wk[:32], wv[:32],
                             wo[:, :32].contiguous()), 2, 16) == (3, 7, 5,
                                                                  128)


def test_tp_setup_semantics(monkeypatch):
    """tests/test_parallel.py:396-403 with 8 cards visible; on the CPU,
    0 devices is one process, which --model_parallel 2 cannot divide."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert mesh.tp_setup(8, 4, 16) == (2, 4)
    assert mesh.tp_setup(8, 2, 16) == (4, 2)
    assert mesh.tp_setup(1, 1, 16) is None
    assert mesh.tp_setup(2, 2, 7) == (1, 2)  # one data index: any batch
    with pytest.raises(SystemExit, match="must divide the 8-device"):
        mesh.tp_setup(8, 3, 16)
    with pytest.raises(SystemExit, match="data axis"):
        mesh.tp_setup(8, 2, 18)
    with pytest.raises(SystemExit, match="must divide the 1-device"):
        mesh.tp_setup(0, 2, 8, "cpu")
