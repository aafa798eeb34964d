"""The host tables of the CUDA mel kernel (`csrc/mel.cu`) and its routing.

The kernel computes the power mel with a real FFT (a 512-point complex FFT
in three radix-8 Stockham passes, then a split step) and a banded
filterbank. It runs only on the card (`tests/test_torch_port_kernels.py`
holds it against its plain version there); these tests need no card. They
hold the tables the host builds for it to the filterbank and twiddles they
stand for, and check that a CPU tensor takes the plain version.
"""
import numpy as np
import pytest
import torch

from emotiongestures_torch.ops import fused_mel as FM
from emotiongestures_torch.ops import mel as TM


def _fb_t():
    return TM.mel_filterbank().T.astype(np.float32)


def _densify(bands, band_w, n_bins=513):
    dense = np.zeros((n_bins, len(bands)), np.float32)
    for m, (start, length, offset, _) in enumerate(bands):
        dense[start:start + length, m] = band_w[offset:offset + length]
    return dense


def test_banded_filterbank_densifies_to_the_filterbank():
    bands, band_w = TM.banded_filterbank(_fb_t())
    assert bands.shape == (128, 4) and bands.dtype == np.int32
    assert band_w.shape == (1009,) and band_w.dtype == np.float32
    assert (bands[:, 1] >= 2).all() and (bands[:, 1] <= 24).all()
    # packed in mel order, back to back
    assert (bands[:, 2] == np.concatenate([[0], np.cumsum(bands[:-1, 1])])
            ).all()
    assert bands[-1, 2] + bands[-1, 1] == 1009
    np.testing.assert_array_equal(_densify(bands, band_w), _fb_t())


def test_banded_product_matches_the_dense_product():
    bands, band_w = TM.banded_filterbank(_fb_t())
    power = np.random.RandomState(0).rand(7, 513).astype(np.float32) * 100
    banded = np.stack([power[:, s:s + n] @ band_w[o:o + n]
                       for s, n, o, _ in bands], axis=1)
    np.testing.assert_allclose(banded, power @ _fb_t(), rtol=1e-6, atol=0)


def test_banded_filterbank_refuses_a_split_filter():
    fb = _fb_t().copy()
    start, length = TM.banded_filterbank(fb)[0][40, :2]
    fb[start + length // 2, 40] = 0.0  # a hole inside mel 40's band
    with pytest.raises(ValueError, match="filter 40"):
        TM.banded_filterbank(fb)


def test_fft_twiddles_match_exp():
    tw = TM.fft_twiddles(1024)
    # the split step takes the bins in pairs (k, 512 - k), k < 256
    assert tw.shape == (256, 2) and tw.dtype == np.float32
    ref = np.exp(-2j * np.pi * np.arange(256) / 1024)
    assert np.abs(tw[:, 0] - ref.real).max() <= 1e-7
    assert np.abs(tw[:, 1] - ref.imag).max() <= 1e-7


def test_stockham_twiddles_match_exp():
    """Pass Ns (8, 64), lane j, r = 1..7: W_{8 Ns}^{(j % Ns) r}."""
    ptw = TM.stockham_twiddles()
    assert ptw.shape == (2, 7, 64, 2) and ptw.dtype == np.float32
    j, r = np.arange(64)[None, :], np.arange(1, 8)[:, None]
    for p, ns in enumerate((8, 64)):
        ref = np.exp(-2j * np.pi * (j % ns) * r / (8 * ns))
        assert np.abs(ptw[p, ..., 0] - ref.real).max() <= 1e-7
        assert np.abs(ptw[p, ..., 1] - ref.imag).max() <= 1e-7


def test_kernel_operands():
    ops = FM._operands(torch.device("cpu"))
    bands, band_w = TM.banded_filterbank(_fb_t())
    assert torch.equal(ops["bands"], torch.from_numpy(bands))
    assert torch.equal(ops["band_w"], torch.from_numpy(band_w))
    assert torch.equal(ops["tw"], torch.from_numpy(TM.fft_twiddles()))
    assert torch.equal(ops["ptw"], torch.from_numpy(TM.stockham_twiddles()))
    assert ops["bands"].dtype == torch.int32 and ops["bands"].is_contiguous()
    # the dense DFT operands stay for the plain version only
    assert ops["cos"].shape == ops["sin"].shape == (1024, 513)
    assert ops["fb"].shape == (513, 128)


@pytest.mark.parametrize("hop", [512, 256])
def test_mel_power_on_cpu_takes_the_plain_version(hop):
    waves = torch.from_numpy(
        np.random.RandomState(2).randn(3, 5000).astype(np.float32))
    padded = TM.pad_center(waves)
    nf = TM.n_frames_of(padded.shape[-1], hop=hop)
    before = FM.launches
    got = FM.mel_power(padded, nf, hop=hop)
    assert FM.launches == before
    assert torch.equal(got, FM.mel_power_plain(padded, nf, hop=hop))
    assert got.shape == (3, nf, 128)


def test_mel_power_has_no_kernel_for_other_devices():
    padded = torch.zeros(2, 4096, device="meta")
    before = FM.launches
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        FM.mel_power(padded, 5)
    assert FM.launches == before
