"""The demo's --render path on the CPU: utils/render.py and
utils/tts_helper.py against the JAX package's, and the demo end to end at a
small width on weights from orbax checkpoints the JAX package wrote.

  * `create_video_and_save` of both packages writes the same bytes (the
    pillow gif where ffmpeg is absent, or ffmpeg's mp4; the wav) for the
    same poses;
  * without matplotlib the port refuses --render before it builds a model,
    with a message naming matplotlib;
  * TTSHelper: the same cache key as the JAX package's, a cached wav
    returned without the client, and the ImportError without it;
  * the demo's `main` with --render, the generator and CVAE at d_model 64
    loaded from `save_checkpoint` directories of the JAX package: poses
    within the demo's tolerance of test_torch_port_slice.py (rtol 2e-3,
    atol 5e-4) of the JAX modules' on the demo's own spectrogram and
    injected noise, and a video written (the renderer is
    given the first 4 of the 60 frames: it takes ~0.2 s a frame here).
"""
import functools
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_train_common as C
from test_torch_port_orbax_load import _trained
from torch_port_train_common import one_torch_thread  # noqa: F401
from torch_port_zoo_common import perturb_bn

from emotiongestures_tpu.models.cvae import EmotionCVAEv3 as JCVAE
from emotiongestures_tpu.models.generator import GestureTransformer as JGen
from emotiongestures_tpu.utils import render as jrender
from emotiongestures_tpu.utils import torch_port as tp
from emotiongestures_tpu.utils import tts_helper as jtts
from emotiongestures_tpu.utils.checkpoint import save_checkpoint as jax_save
from emotiongestures_torch.cli import demo
from emotiongestures_torch.models.cvae import EmotionCVAEv3
from emotiongestures_torch.models.generator import GestureTransformer
from emotiongestures_torch.ops.fused_mel import extract_melspectrogram
from emotiongestures_torch.utils import render, tts_helper

pytest.importorskip("matplotlib")

SMALL = dict(n_words=16, d_model=64, d_inner=128, n_layers=1, n_head=2,
             d_k=32, d_v=32)


def _poses(n=4, seed=0):
    return 0.1 * np.random.default_rng(seed).standard_normal(
        (n, 27)).astype(np.float32)


def test_render_writes_the_jax_packages_bytes(tmp_path):
    poses, target = _poses(4), _poses(3, 1)
    audio = 0.1 * np.sin(np.arange(16000, dtype=np.float32) / 7.0)
    outs = []
    for name, mod in (("port", render), ("jax", jrender)):
        merged, out_poses, target_poses = mod.create_video_and_save(
            tmp_path / name, 3, "cmp", 7, target, poses, np.zeros(27),
            "a title", audio=audio, aux_str="aux", delete_audio_file=False)
        outs.append((merged, out_poses, target_poses))
    (p_video, p_out, p_target), (j_video, j_out, j_target) = outs
    assert p_video.replace("port", "jax") == j_video
    with open(p_video, "rb") as a, open(j_video, "rb") as b:
        assert a.read() == b.read()
    wavs = [tmp_path / n / "cmp_003_7.wav" for n in ("port", "jax")]
    if shutil.which("ffmpeg") is None:  # the wav stays beside a gif
        assert wavs[0].read_bytes() == wavs[1].read_bytes()
    np.testing.assert_array_equal(p_out, j_out)
    np.testing.assert_array_equal(p_target, j_target)


def test_render_refuses_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        render.require_matplotlib()
    built = []
    monkeypatch.setattr(demo, "GestureTransformer",
                        lambda *a, **k: built.append(1))
    args = demo.build_parser().parse_args(["--render", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="matplotlib"):
        demo.main(args)
    assert not built


def test_tts_cache_key_and_import_error(tmp_path):
    ours = tts_helper.TTSHelper(cache_path=tmp_path / "p")
    theirs = jtts.TTSHelper(cache_path=tmp_path / "j")
    for text in ("hello there", "Ünïcode ✓", ""):
        assert ours._cache_file(text).name == theirs._cache_file(text).name
    cached = ours._cache_file("cached text")
    cached.write_bytes(b"RIFF")
    assert ours.synthesis("cached text") == str(cached)
    if ours._tts is None:
        with pytest.raises(ImportError, match="texttospeech"):
            ours.synthesis("not cached")
    ours.clean_cache()
    assert not list((tmp_path / "p").glob("*.wav"))


def test_demo_render_on_jax_orbax_weights(tmp_path, monkeypatch):
    torch.manual_seed(3)
    gen = perturb_bn(GestureTransformer(**SMALL, device="cpu"), 3)
    vae = perturb_bn(EmotionCVAEv3(feat_dim=64, device="cpu"), 4)
    jgen, jvae = JGen(**SMALL), JCVAE(feat_dim=64)
    gtable, vtable = C.generator_table(gen), tp.cvae_v3_mapping()
    gstate = _trained(jgen, C.jax_variables(gen, gtable), 0)
    vstate = _trained(jvae, C.jax_variables(vae, vtable), 1)
    jax_save(gstate, tmp_path / "gan" / "generator")
    jax_save(vstate, tmp_path / "cvae")

    monkeypatch.setattr(demo, "GestureTransformer", functools.partial(
        GestureTransformer, **{k: v for k, v in SMALL.items()
                               if k != "n_words"}))
    monkeypatch.setattr(demo, "EmotionCVAEv3",
                        functools.partial(EmotionCVAEv3, feat_dim=64))
    real = render.create_video_and_save
    monkeypatch.setattr(render, "create_video_and_save",
                        lambda save, ep, pre, it, tgt, out, *a, **k: real(
                            save, ep, pre, it, tgt, out[:4], *a, **k))
    noise = np.random.default_rng(5).standard_normal((2, 32)).astype(
        np.float32)
    args = demo.build_parser().parse_args([
        "--render", "--device", "cpu", "--num_samples", "2", "--n_words",
        "16", "--emotion", "anger", "--out", str(tmp_path / "out"),
        "--checkpoints_folder_path", str(tmp_path / "gan" / "generator"),
        "--cvae_checkpoint", str(tmp_path / "cvae")])
    summary = demo.main(args, noise=noise)
    assert summary["video"].endswith((".gif", ".mp4"))
    assert (tmp_path / "out").joinpath(summary["video"].split("/")[-1]) \
        .stat().st_size > 0
    poses = np.load(summary["out"])["poses"]

    wave = demo.load_wave(args)
    spec = extract_melspectrogram(wave, use_kernel=False, device="cpu")
    spec = np.asarray(spec.float()[None, :, :124])
    y = np.eye(8, dtype=np.float32)[[demo.EMOTION_LABELS.index("anger")]]
    gv = {"params": gstate.params, "batch_stats": gstate.batch_stats}
    vv = {"params": vstate.params, "batch_stats": vstate.batch_stats}

    @jax.jit
    def jax_poses(z):
        sampled = jvae.apply(vv, z, jnp.asarray(y), method=lambda m, z, y:
                             m._fuse_decode(z, m.y_embed(y, train=False),
                                            1, False))
        return jgen.apply(gv, jnp.asarray(spec), jnp.zeros((1, 60),
                                                           jnp.int32),
                          jnp.zeros((1, 10, 282)), sampled)[0][0]

    for i in range(2):  # the demo's tolerance, test_torch_port_slice.py
        np.testing.assert_allclose(
            poses[i], jax_poses(jnp.asarray(noise[i:i + 1])), rtol=2e-3,
            atol=5e-4, err_msg=f"sample {i}")
