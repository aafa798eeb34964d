"""The port's modules against their JAX counterparts, at fp32 on the CPU.

Weights go across through emotiongestures_torch/utils/weights.py and load
with strict=True, so the port's module structure is checked too. BatchNorm
statistics and affine params are perturbed away from their init so that
the eval-mode normalisation is exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotiongestures_tpu.models.cvae import EmotionCVAEv3 as JaxCVAE
from emotiongestures_tpu.models.generator import GestureTransformer as JaxGen
from emotiongestures_tpu.nn.resnet_se import ResNetSE as JaxResNetSE
from emotiongestures_tpu.nn.tcn import TemporalConvNet as JaxTCN
from emotiongestures_tpu.nn.transformer import (
    TransformerDecoder as JaxDecoder,
    TransformerEncoder as JaxEncoder,
)
from emotiongestures_tpu.utils.torch_port import (
    flax_cvae_v3_to_torch_state,
    flax_fgd_ae_to_torch_state,
    flax_generator_to_torch_state,
    flax_skeleton_classifier_to_torch_state,
)
from emotiongestures_torch.models.cvae import EmotionCVAEv3
from emotiongestures_torch.nn.resnet_se import ResNetSE
from emotiongestures_torch.nn.tcn import TemporalConvNet
from emotiongestures_torch.nn.transformer import (
    TransformerDecoder,
    TransformerEncoder,
)
from emotiongestures_torch.utils import weights as W

TOL = dict(rtol=2e-4, atol=2e-5)


def perturb(variables, seed=0):
    """Copy of a JAX variables tree as numpy, with BatchNorm/LayerNorm
    scale, bias and running statistics moved off their init values."""
    r = np.random.RandomState(seed)

    def walk(tree, path=()):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.array(tree, np.float32)
        name = path[-1]
        if name == "scale":
            a = a * (1 + 0.2 * r.randn(*a.shape)).astype(np.float32)
        elif name == "mean":
            a = a + 0.2 * r.randn(*a.shape).astype(np.float32)
        elif name == "var":
            a = a * r.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif name == "bias" and "BatchNorm_0" in path:
            a = a + 0.1 * r.randn(*a.shape).astype(np.float32)
        return a

    return walk(dict(variables))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _load(module, table, variables):
    module.load_state_dict(W.state_from_table(variables, table), strict=True)
    return module.eval()


@pytest.mark.parametrize("fused", [False, True], ids=["einsum", "fused"])
def test_transformer_encoder_decoder_match_jax(fused):
    D, H, dk, inner, n_layers = 64, 2, 32, 128, 2
    r = np.random.RandomState(0)
    src = r.randn(2, 60, D).astype(np.float32)
    trg = r.randn(2, 60, D).astype(np.float32)
    kw = dict(n_layers=n_layers, n_head=H, d_k=dk, d_v=dk, d_model=D,
              d_inner=inner, fused=fused)
    jenc, jdec = JaxEncoder(n_position=60, **kw), JaxDecoder(**kw)
    ev = perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(src)), 1)
    enc_out_j = jenc.apply(_to_jax(ev), jnp.asarray(src))
    dv = perturb(jdec.init(jax.random.PRNGKey(1), jnp.asarray(trg),
                           enc_out_j), 2)
    dec_out_j = jdec.apply(_to_jax(dv), jnp.asarray(trg), enc_out_j)

    enc = TransformerEncoder(n_layers, H, dk, dk, D, inner, n_position=60,
                             fused=fused)
    dec = TransformerDecoder(n_layers, H, dk, dk, D, inner, fused=fused)
    t = []
    W.transformer_layers(t, "", (), n_layers, "slf_attn")
    _load(enc, t, ev)
    t = []
    W.transformer_layers(t, "", (), n_layers, "enc_attn")
    _load(dec, t, dv)
    with torch.no_grad():
        enc_out = enc(torch.from_numpy(src))
        dec_out = dec(torch.from_numpy(trg), enc_out)
    np.testing.assert_allclose(enc_out.numpy(), np.asarray(enc_out_j), **TOL)
    np.testing.assert_allclose(dec_out.numpy(), np.asarray(dec_out_j), **TOL)


def test_resnet_se_matches_jax():
    x = np.random.RandomState(0).randn(2, 32, 20).astype(np.float32)
    jnet = JaxResNetSE(layers=[3, 4, 6], num_filters=[32, 64, 128])
    v = perturb(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)[..., None]))
    ref = np.asarray(jnet.apply(_to_jax(v), jnp.asarray(x)[..., None]))
    t = []
    W.resnet_se(t, "", ())
    net = _load(ResNetSE(), t, v)
    with torch.no_grad():
        got = net(torch.from_numpy(x)[:, None]).permute(0, 2, 3, 1).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=2e-4,
                               atol=2e-5)


def test_tcn_matches_jax():
    """Two levels, 8 -> 16 channels: level 0 carries the 1x1 downsample
    (the dense1x1 layout), both the causal dilated weight-norm convs."""
    x = np.random.RandomState(0).randn(2, 60, 8).astype(np.float32)
    jnet = JaxTCN(num_channels=[16, 16], kernel_size=2)
    v = perturb(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jnet.apply(_to_jax(v), jnp.asarray(x)))
    t = []
    W.tcn(t, "", (), v["params"], 2)
    assert any(k.endswith("downsample.weight") for k, _, _ in t)
    net = _load(TemporalConvNet(8, [16, 16], 2), t, v)
    with torch.no_grad():
        got = net(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.fixture(scope="module")
def cvae_pair():
    jv = JaxCVAE(feat_dim=64)
    v = perturb(jv.init({"params": jax.random.PRNGKey(0),
                         "sample": jax.random.PRNGKey(1)},
                        jnp.zeros((1, 60, 64)), jnp.zeros((1, 8))))
    vae = EmotionCVAEv3(feat_dim=64, device="cpu")
    vae.load_state_dict(W.cvae_v3_state_from_jax(v), strict=True)
    return jv, v, vae


def test_cvae_sample_matches_jax_with_injected_z(cvae_pair):
    jv, v, vae = cvae_pair
    r = np.random.RandomState(0)
    y = np.eye(8, dtype=np.float32)[[1, 5, 7]]
    z = r.randn(3, 32).astype(np.float32)
    jvars = _to_jax(v)
    post_y = jv.apply(jvars, jnp.asarray(y),
                      method=lambda m, y: m.y_embed(y, train=False))
    ref = jv.apply(jvars, jnp.asarray(z), post_y, 3, False,
                   method=JaxCVAE._fuse_decode)
    with torch.no_grad():
        got = vae.sample(torch.from_numpy(y), noise=torch.from_numpy(z))
    assert got.shape == (3, 60, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cvae_posterior_stats_match_jax(cvae_pair):
    """The conv encoder and mu/logvar heads (z is random, so only the
    deterministic outputs are compared)."""
    jv, v, vae = cvae_pair
    r = np.random.RandomState(1)
    x = r.randn(2, 60, 64).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[[0, 3]]
    _, mu_j, logvar_j = jv.apply(_to_jax(v), jnp.asarray(x), jnp.asarray(y),
                                 rngs={"sample": jax.random.PRNGKey(3)})
    with torch.no_grad():
        _, mu, logvar = vae(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), **TOL)


def test_weight_tables_agree_with_jax_package():
    """The port's copy of the weight tables gives the same keys and arrays
    as emotiongestures_tpu/utils/torch_port.py (generator, CVAE, FGD
    autoencoder, skeleton classifier, EmotionNet, DisNet)."""
    gen = JaxGen(n_words=16, d_model=64, d_inner=128, n_layers=2, n_head=2,
                 d_k=32, d_v=32)
    gv = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 124)),
                  jnp.zeros((1, 60), jnp.int32), jnp.zeros((1, 10, 282)))
    ours = W.generator_state_from_jax(gv, n_layers=2)
    theirs = flax_generator_to_torch_state(gv, n_layers=2)
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))

    cv = JaxCVAE().init({"params": jax.random.PRNGKey(1),
                         "sample": jax.random.PRNGKey(2)},
                        jnp.zeros((1, 60, 512)), jnp.zeros((1, 8)))
    ours = W.cvae_v3_state_from_jax(cv)
    theirs = flax_cvae_v3_to_torch_state(cv)
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))

    from emotiongestures_tpu.models.fgd_ae import FGDAutoEncoder as JaxFGD
    from emotiongestures_tpu.models.skeleton_classifier import (
        SkeletonTransformer as JaxSkeleton,
    )

    pose = jnp.zeros((1, 60, 282))
    fv = JaxFGD().init(jax.random.PRNGKey(3), pose)
    sv = JaxSkeleton(d_model=64, d_inner=128, n_layers=2, n_head=2, d_k=32,
                     d_v=32).init(jax.random.PRNGKey(4), pose)
    from emotiongestures_tpu.models.emotion_net import DisNet as JaxDisNet
    from emotiongestures_tpu.models.emotion_net import EmotionNet as JaxNet
    from emotiongestures_tpu.utils import torch_port as tp

    # the tables do not depend on the spectrogram's size: (32, 32) keeps
    # fc0 at 4096 x 4096
    ev = JaxNet().init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32)))
    dv = JaxDisNet().init(jax.random.PRNGKey(6), jnp.zeros((1, 128)))
    assert W.emotion_net_table() == tp.emotion_net_mapping()
    assert W.disnet_table() == tp.disnet_mapping()
    pairs = [(W.fgd_ae_state_from_jax(fv), flax_fgd_ae_to_torch_state(fv)),
             (W.skeleton_classifier_state_from_jax(sv, n_layers=2),
              flax_skeleton_classifier_to_torch_state(sv, n_layers=2)),
             (W.emotion_net_state_from_jax(ev),
              tp.flax_emotion_net_to_torch_state(ev)),
             (W.disnet_state_from_jax(dv),
              tp.flax_table_to_torch_state(dv, tp.disnet_mapping()))]
    for ours, theirs in pairs:
        assert list(ours) == list(theirs)
        for k in theirs:
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(theirs[k]))


def test_xavier_reinit_all():
    """The reference constructor's loop (the JAX package's
    xavier_reinit_all): every ndim > 1 parameter redrawn within the
    xavier-uniform bound; 1-D parameters and weight-norm gains untouched;
    the word embedding spared on request."""
    from emotiongestures_torch.core.init import xavier_reinit_all_
    from emotiongestures_torch.models.generator import TextEncoderTCN

    enc = TextEncoderTCN(n_words=16, embed_size=8, hidden_size=8, frames=6)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    xavier_reinit_all_(enc, torch.Generator().manual_seed(0),
                       keep_embedding=True)
    for name, p in enc.named_parameters():
        changed = not torch.equal(p, before[name])
        redraw = p.ndim > 1 and not name.endswith("weight_g") \
            and "embedding" not in name
        assert changed == redraw, name
        if redraw:
            fan_out, fan_in = p.shape[0], p[0].numel()
            fan_out *= p[0, 0].numel()
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            assert p.abs().max() <= bound, name
