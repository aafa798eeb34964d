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

from emotiongestures_torch.ops import cuda_lib
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


def test_edited_source_applies_each_edit_once():
    """The breakdown tools' variants: an edit must find its text once."""
    text = cuda_lib.edited_source("attention", [("kBK = 32;", "kBK = 16;")])
    assert "kBK = 16;" in text and "kBK = 32;" not in text
    with pytest.raises(RuntimeError, match="no longer holds"):
        cuda_lib.edited_source("attention", [("no such text", "")])
    with pytest.raises(RuntimeError, match="no longer holds"):
        cuda_lib.edited_source("attention", [("mma_tf32(", "")])  # many


def test_using_routes_load_and_restores():
    variant, inner = object(), object()
    before = dict(cuda_lib._loaded)
    with cuda_lib.using("mel", variant):
        assert cuda_lib.load("mel") is variant
        with cuda_lib.using("mel", inner):
            assert cuda_lib.load("mel") is inner
        assert cuda_lib.load("mel") is variant
    assert cuda_lib._loaded == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


# (Lq, Lk, d_model, n_head, d_k, query dtype, B): the flagship widths, and
# the other widths and lengths the wrapper takes; then the edges of the
# kernel's tiles (128 rows x 128 columns for Q/K/V, 64 rows for the output
# projection): B*L of 60 and 180 rows (one partial row tile; a ragged last
# one), Lq = 1 and Lk = 1, d_model 128 with H*d_k = 128 (one column tile),
# and H*d_k = 96 (a partial column tile)
CARD_ATTN_CASES = [
    (60, 60, 512, 8, 64, torch.float32, 64),
    (60, 23, 512, 8, 64, torch.float32, 64),
    (60, 60, 512, 8, 64, torch.bfloat16, 64),
    (17, 60, 128, 4, 32, torch.float32, 64),
    (60, 41, 256, 2, 64, torch.bfloat16, 64),
    (33, 33, 384, 12, 32, torch.float32, 64),
    (60, 60, 512, 8, 64, torch.float32, 1),
    (60, 60, 512, 8, 64, torch.float32, 3),
    (60, 60, 512, 8, 64, torch.bfloat16, 3),
    (1, 60, 512, 8, 64, torch.float32, 3),
    (60, 1, 512, 8, 64, torch.float32, 3),
    (1, 1, 512, 8, 64, torch.bfloat16, 5),
    (60, 60, 128, 2, 64, torch.float32, 3),
    (20, 37, 128, 3, 32, torch.float32, 7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_ATTN_CASES)
def test_attention_kernel_matches_plain_on_card(wdtype, case):
    _need_card()
    Lq, Lk, D, H, dk, qdtype, B = case
    g = torch.Generator().manual_seed(0)
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


# (clips, samples, hop): the serving clip length; frame counts that leave a
# ragged last tile of the kernel's 8 frames (49; 45); one clip shorter than
# a tile (6 frames); one clip of exactly 8 and of exactly 16 frames; the
# shortest and the longest hop the kernel takes beside 512; more clips than
# the 65535 of a grid's y dimension
CARD_MEL_CASES = [(16, 64000, 512), (7, 25000, 512), (5, 22528, 512),
                  (1, 3000, 512), (1, 3584, 512), (1, 7680, 512),
                  (3, 4000, 4), (3, 16000, 1024), (2, 9000, 256),
                  (65537, 600, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("clips,n,hop", CARD_MEL_CASES)
def test_mel_kernel_matches_plain_on_card(clips, n, hop):
    _need_card()
    g = torch.Generator().manual_seed(0)
    waves = torch.randn(clips, n, generator=g).cuda()
    padded = TM.pad_center(waves)
    nf = TM.n_frames_of(padded.shape[-1], hop=hop)
    before = FM.launches
    got = FM.mel_power(padded, nf, hop=hop)
    ref = FM.mel_power_plain(padded, nf, hop=hop)
    torch.cuda.synchronize()
    assert FM.launches == before + 1
    assert got.shape == (clips, nf, 128)
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=1e-3)


@pytest.mark.cuda
def test_mel_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    padded = TM.pad_center(torch.randn(2, 8000, device="cuda"))
    before = FM.launches
    for hop, match in ((1025, "hop"), (510, "hop"), (0, "hop")):
        with pytest.raises(ValueError, match=match):
            FM.mel_power(padded, 2, hop=hop)
    with pytest.raises(ValueError, match="do not fit"):
        FM.mel_power(padded, 40)
    assert FM.launches == before


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
# (32 x 31 = 992 pixels: a ragged last tile of 96), one block; the edge of
# the bf16 kernel's cluster layout (32 x 32: 8 CTAs of 4 rows, full 128-row
# GEMM tiles); clusters whose last CTA holds rows past H (30 x 31: 8 CTAs,
# the last with 2 of its 4 rows; 3 x 64: 2 CTAs of 2 rows, the last with 1)
# and a cluster of 3 CTAs (12 x 31), where a weight tile's 8 multicast
# slices split unevenly over the CTAs
CARD_SE_CASES = [(4, 8, 9, 2), (2, 32, 31, 5), (3, 5, 7, 1), (2, 32, 32, 1),
                 (2, 30, 31, 2), (2, 12, 31, 2), (2, 3, 64, 1)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(33, 32), (2, 128)])
def test_se_stage_wrapper_refuses_bf16_shapes_outside_the_cluster(hw):
    """bf16 shapes the cluster kernel does not take (more than 8 CTAs; tiles
    beyond shared memory) raise, with no launch and no fallback."""
    from emotiongestures_torch.ops import fused_se_stage as FS

    _need_card()
    g = torch.Generator().manual_seed(3)
    ops = [t.cuda() for t in _se_operands(1, g)]
    x = torch.randn(1, *hw, 128, generator=g).cuda().bfloat16()
    before = FS.launches
    with pytest.raises(ValueError, match="bf16 kernel"):
        FS.fused_se_stage(x, *ops)
    assert FS.launches == before


@pytest.mark.cuda
def test_se_stage_bf16_entry_checks_the_layout():
    """The C entry takes the wrapper's layout (R, n, smem) and refuses,
    before any launch, one that does not cover H, overfills the 128 GEMM
    rows or gives less shared memory than the kernel carves."""
    import ctypes

    from emotiongestures_torch.ops import cuda_lib
    from emotiongestures_torch.ops import fused_se_stage as FS

    _need_card()
    lib = cuda_lib.load("se_stage")
    H, W, hidden = 32, 31, 16
    R, n = FS.cluster_layout(H, W, hidden)
    smem = FS.cluster_smem(R, W, hidden)
    null = [ctypes.c_void_p(0)] * 11
    invalid = 1  # cudaErrorInvalidValue
    for bad in ((R, n - 1, smem), (R + 1, n, smem), (R, n, smem - 1),
                (R, 9, smem)):
        assert lib.eg_se_stage_bf16(*null, 1, H, W, bad[0], bad[1], 1, hidden,
                                    bad[2], None) == invalid, bad
    assert FS.active_clusters(H, W, hidden) >= 1
