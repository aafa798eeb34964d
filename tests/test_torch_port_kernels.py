"""The port's two kernel modules against the JAX package.

On the CPU each wrapper takes its plain PyTorch version, which is held here
against the Pallas kernels (interpret mode, as tests/test_pallas_*.py run
them), the JAX einsum/XLA paths and the golden audio fixtures. The tests
marked `cuda` hold the CUDA kernels against those plain versions; they need
the card and skip without it. JAX is imported inside the tests that use
it, so that the card's machine, which has no JAX, can run the `cuda` tests:

    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest \
        -o addopts="" -q
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from emotiongestures_torch.ops import fused_attention as FA
from emotiongestures_torch.ops import fused_mel as FM
from emotiongestures_torch.ops import mel as TM

GOLDEN = np.load(Path(__file__).parent / "fixtures" / "audio_golden.npz")

# (kind, Lq, Lk, d_model, n_head, d_k)
ATTN_CASES = [
    ("self", 60, 60, 128, 4, 32),
    ("cross", 60, 60, 128, 4, 32),
    ("self", 17, 17, 128, 4, 32),
    ("cross", 60, 37, 128, 4, 32),
    ("cross", 60, 60, 512, 8, 64),
]


def _attn_inputs(seed, Lq, Lk, D, H, dk, wdtype):
    """Inputs as numpy: activations fp32, weights rounded to `wdtype` (the
    bf16 serving recipe reads bf16 weights with fp32 activations)."""
    import jax.numpy as jnp

    r = np.random.RandomState(seed)
    q = r.randn(2, Lq, D).astype(np.float32)
    kv = r.randn(2, Lk, D).astype(np.float32)
    w = [(r.randn(D, H * dk) / np.sqrt(D)).astype(np.float32)
         for _ in range(3)]
    w.append((r.randn(H * dk, D) / np.sqrt(H * dk)).astype(np.float32))
    s = (1 + 0.1 * r.randn(D)).astype(np.float32)
    b = (0.1 * r.randn(D)).astype(np.float32)
    params = [jnp.asarray(x, wdtype) for x in (*w, s, b)]
    return q, kv, params


def _torch_weights(params):
    """JAX (in, out) kernels -> torch (out, in), same dtype."""
    import jax.numpy as jnp

    out = []
    for i, p in enumerate(params):
        t = torch.from_numpy(np.array(p, np.float32))
        t = t.T.contiguous() if i < 4 else t
        out.append(t.to(torch.bfloat16 if p.dtype == jnp.bfloat16
                        else torch.float32))
    return out


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"],
                         ids=["fp32", "bf16w"])
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-d{c[3]}" for c in ATTN_CASES])
def test_plain_attention_matches_jax(case, wdtype):
    import jax.numpy as jnp

    from emotiongestures_tpu.nn.transformer import MultiHeadAttention as JaxMHA
    from emotiongestures_tpu.ops.pallas_attention import (
        fused_attention as jax_fused,
    )

    kind, Lq, Lk, D, H, dk = case
    q, kv, params = _attn_inputs(0, Lq, Lk, D, H, dk, wdtype)
    if kind == "self":
        kv = q
    ref_kernel = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(kv),
                                      *params, n_head=H, d_k=dk,
                                      interpret=True))
    mha = JaxMHA(n_head=H, d_model=D, d_k=dk, d_v=dk)
    names = ("w_qs", "w_ks", "w_vs", "fc")
    variables = {"params": {n: {"kernel": p} for n, p in zip(names, params)}}
    variables["params"]["layer_norm"] = {"scale": params[4],
                                         "bias": params[5]}
    ref_einsum, _ = mha.apply(variables, jnp.asarray(q), jnp.asarray(kv),
                              jnp.asarray(kv))

    got = FA.fused_attention_plain(torch.from_numpy(q), torch.from_numpy(kv),
                                   *_torch_weights(params), n_head=H, d_k=dk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref_kernel, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_einsum),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n", [16000, 64000])
def test_plain_mel_matches_pallas(n):
    from emotiongestures_tpu.ops.pallas_mel import melspectrogram_pallas

    y = np.random.RandomState(1).randn(n).astype(np.float32)
    ref = np.asarray(melspectrogram_pallas(y, interpret=True))
    got = FM.melspectrogram(y, use_kernel=True, device="cpu").numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-3)


def test_plain_mel_batched_matches_pallas():
    from emotiongestures_tpu.ops.pallas_mel import (
        batched_melspectrogram_pallas,
    )

    y = np.random.RandomState(2).randn(3, 32000).astype(np.float32)
    ref = np.asarray(batched_melspectrogram_pallas(y, interpret=True))
    got = FM.batched_melspectrogram(y, device="cpu").numpy()
    assert got.shape == ref.shape == (3, 128, 63)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["noise", "clicks", "chirp"])
def test_plain_mel_matches_golden(name):
    """Against the fp64 torch.stft golden fixture, with the tolerance
    tests/test_golden_audio.py gives the JAX matmul-DFT mel."""
    wave = GOLDEN[f"wave_{name}"]
    got = FM.melspectrogram(wave, device="cpu").numpy()
    ref = GOLDEN[f"mel1024_{name}"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-3)


def test_log_mel_pipeline_matches_golden_db():
    """power_to_db(ref=max) and the float16 cast: within 0.1 dB of the fp64
    golden, as the JAX pipeline is held."""
    got = FM.extract_melspectrogram(GOLDEN["wave_chirp"], device="cpu")
    assert got.dtype == torch.float16
    ref = GOLDEN["mel1024db_chirp"]
    assert got.shape == ref.shape
    assert np.abs(got.double().numpy() - ref).max() < 0.1


def test_batched_log_mel_matches_jax():
    """Per-clip ref-max, as the JAX vmapped frontend computes it."""
    import jax.numpy as jnp

    from emotiongestures_tpu.ops import mel as JM

    r = np.random.RandomState(3)
    y = (r.randn(2, 32000) * np.array([[1.0], [0.01]])).astype(np.float32)
    ref = np.asarray(JM.batched_log_melspectrogram(jnp.asarray(y)))
    got = FM.batched_log_melspectrogram(y, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_spectrogram_length():
    from emotiongestures_tpu.ops import mel as JM

    assert TM.calc_spectrogram_length_from_motion_length(60, 15) == \
        JM.calc_spectrogram_length_from_motion_length(60, 15) == 124


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


# (Lq, Lk, d_model, n_head, d_k, query dtype): the flagship widths, and the
# other widths and lengths the wrapper takes
CARD_ATTN_CASES = [
    (60, 60, 512, 8, 64, torch.float32),
    (60, 23, 512, 8, 64, torch.float32),
    (60, 60, 512, 8, 64, torch.bfloat16),
    (17, 60, 128, 4, 32, torch.float32),
    (60, 41, 256, 2, 64, torch.bfloat16),
    (33, 33, 384, 12, 32, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_ATTN_CASES)
def test_attention_kernel_matches_plain_on_card(wdtype, case):
    _need_card()
    Lq, Lk, D, H, dk, qdtype = case
    g = torch.Generator().manual_seed(0)
    B = 64
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, D, generator=g).to(dev, qdtype)
    kv = torch.randn(B, Lk, D, generator=g).to(dev)
    ws = [(torch.randn(H * dk, D, generator=g) / D ** 0.5).to(dev, wdtype)
          for _ in range(3)]
    ws.append((torch.randn(D, H * dk, generator=g) / (H * dk) ** 0.5)
              .to(dev, wdtype))
    s = (1 + 0.1 * torch.randn(D, generator=g)).to(dev, wdtype)
    b = (0.1 * torch.randn(D, generator=g)).to(dev, wdtype)
    before = FA.launches
    got = FA.fused_attention(q, kv, *ws, s, b, n_head=H, d_k=dk)
    ref = FA.fused_attention_plain(q, kv, *ws, s, b, n_head=H, d_k=dk)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_attention_wrapper_rejects_bf16_keys_on_card():
    """The kernel is built for fp32 keys/values, the only type the serving
    path gives it; bf16 keys raise instead of launching."""
    _need_card()
    dev = torch.device("cuda")
    q = torch.randn(2, 8, 128, device=dev)
    ws = [torch.randn(128, 128, device=dev) for _ in range(4)]
    s, b = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    before = FA.launches
    with pytest.raises(ValueError, match="kv_in must be float32"):
        FA.fused_attention(q, q.to(torch.bfloat16), *ws, s, b, n_head=4,
                           d_k=32)
    assert FA.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("clips,n", [(16, 64000), (7, 25000)])
def test_mel_kernel_matches_plain_on_card(clips, n):
    _need_card()
    g = torch.Generator().manual_seed(0)
    waves = torch.randn(clips, n, generator=g).cuda()
    padded = TM.pad_center(waves)
    nf = TM.n_frames_of(padded.shape[-1])
    before = FM.launches
    got = FM.mel_power(padded, nf)
    ref = FM.mel_power_plain(padded, nf)
    torch.cuda.synchronize()
    assert FM.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=1e-3)


def _se_operands(nb, g):
    """Stacked operands of `nb` random SEBasicBlock(128, 128) with
    BatchNorm affines and statistics off their init."""
    from emotiongestures_torch.nn.resnet_se import SEBasicBlock
    from emotiongestures_torch.ops import fused_se_stage as FS

    torch.manual_seed(0)
    blocks = [SEBasicBlock(128, 128).eval() for _ in range(nb)]
    with torch.no_grad():
        for blk in blocks:
            for bn in (blk.bn1, blk.bn2):
                bn.running_mean.normal_(0.0, 0.2, generator=g)
                bn.running_var.uniform_(0.5, 1.5, generator=g)
                bn.weight.normal_(1.0, 0.2, generator=g)
    return FS.stage_params_from_module(blocks)


# (B, H, W, blocks): the JAX test's shape, the serving tail's spatial shape
# (32 x 31 = 992 pixels: a ragged last tile of 96), one block
CARD_SE_CASES = [(4, 8, 9, 2), (2, 32, 31, 5), (3, 5, 7, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_SE_CASES)
def test_se_stage_kernel_matches_plain_on_card(dtype, case):
    """fp32 at the tolerance of tests/test_pallas_se.py; bf16 at 8 bf16
    steps of max |ref| (sums in another order can flip a rounding to bf16
    that the next blocks carry on)."""
    from emotiongestures_torch.core.device import fp32_exact_on_cuda
    from emotiongestures_torch.ops import fused_se_stage as FS

    _need_card()
    fp32_exact_on_cuda()
    B, H, W, nb = case
    g = torch.Generator().manual_seed(1)
    ops = [t.cuda() for t in _se_operands(nb, g)]
    x = torch.relu(torch.randn(B, H, W, 128, generator=g)).cuda().to(dtype)
    before = FS.launches
    got = FS.fused_se_stage(x, *ops)
    ref = FS.fused_se_stage_plain(x, *ops)
    torch.cuda.synchronize()
    assert FS.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    else:
        limit = 8 * 2.0 ** -8 * ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= limit


@pytest.mark.cuda
def test_se_stage_wrapper_rejects_what_the_kernel_does_not_take():
    from emotiongestures_torch.ops import fused_se_stage as FS

    _need_card()
    g = torch.Generator().manual_seed(2)
    ops = [t.cuda() for t in _se_operands(1, g)]
    x = torch.randn(2, 4, 5, 128, generator=g).cuda()
    before = FS.launches
    with pytest.raises(ValueError, match="contiguous"):
        FS.fused_se_stage(x.permute(0, 2, 1, 3), *ops)
    with pytest.raises(ValueError, match="dtype"):
        FS.fused_se_stage(x.half(), *ops)
    assert FS.launches == before
