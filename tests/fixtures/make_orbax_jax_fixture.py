"""Write tests/fixtures/orbax_jax/: small checkpoints that the JAX package's
own `save_checkpoint` writes (orbax + tensorstore: OCDBT, zarr v2, zstd
level 1 with its compressed blocks), and JAX's outputs beside them, for the
port's reader on the CPU (tests/test_torch_port_orbax.py) and on the card
(chip_smoke.py phase 13b), where neither JAX nor tensorstore is installed.

    JAX_PLATFORMS=cpu python tests/fixtures/make_orbax_jax_fixture.py

  cvae/checkpoint_iteration2  EmotionCVAEv3(feat_dim=32): a TrainState
      with optax adam(1e-3) after two updates on seeded gradients (step 2,
      Adam's moments set), params and batch_stats
  fgd/checkpoint_iteration2   FGDAutoEncoder(pose_dim=27, latent_dim=32),
      the same two updates
  outputs.npz  inputs and JAX's outputs, eval mode, fp32: `cvae_prior`,
      the prior's decode of `cvae_z` as its noise for the one-hot
      `cvae_y`; `cvae_mu`, `cvae_logvar`, the encoder's moments of
      `cvae_x`; `fgd_recon`, `fgd_feat` of `fgd_x`

Needs JAX (this script only). The directories are rewritten each run; the
bytes differ run to run (orbax writes random file names and times) while
the arrays do not.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "orbax_jax"
sys.path.insert(0, str(HERE.parent.parent))


def _updated_state(model, variables, seed: int):
    """The TrainState after two Adam updates on seeded gradients."""
    import jax
    import jax.numpy as jnp

    from emotiongestures_tpu.core.schedules import adam
    from emotiongestures_tpu.train.state import create_train_state

    state = create_train_state(model, variables, adam(1e-3))
    rng = np.random.default_rng(seed)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.1,
                                  p.dtype), state.params)
        state = state.apply_gradients(grads)
    return state


def main() -> Path:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from emotiongestures_tpu.models import EmotionCVAEv3, FGDAutoEncoder
    from emotiongestures_tpu.utils.checkpoint import save_checkpoint

    shutil.rmtree(OUT, ignore_errors=True)
    rng = np.random.default_rng(0)
    out = {}

    vae = EmotionCVAEv3(feat_dim=32)
    x = rng.standard_normal((2, 60, 32)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[[1, 6]]
    v = vae.init({"params": jax.random.PRNGKey(0),
                  "sample": jax.random.PRNGKey(1)}, jnp.asarray(x),
                 jnp.asarray(y))
    # running statistics away from their init, so that they are checked
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape), s.dtype),
        v["batch_stats"])}
    state = _updated_state(vae, v, 1)
    save_checkpoint(state, OUT / "cvae")
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    z = rng.standard_normal((2, 32)).astype(np.float32)

    def decode(m, z, y):
        return m._fuse_decode(z, m.y_embed(y, train=False), z.shape[0],
                              False)

    out.update(cvae_x=x, cvae_y=y, cvae_z=z)
    out["cvae_prior"] = np.asarray(vae.apply(variables, z, y, method=decode))
    _, mu, logvar = vae.apply(variables, x, y,
                              rngs={"sample": jax.random.PRNGKey(3)})
    out["cvae_mu"], out["cvae_logvar"] = np.asarray(mu), np.asarray(logvar)

    fgd = FGDAutoEncoder(pose_dim=27, latent_dim=32)
    px = rng.standard_normal((2, 60, 27)).astype(np.float32)
    fv = fgd.init(jax.random.PRNGKey(2), jnp.asarray(px))
    state = _updated_state(fgd, fv, 2)
    save_checkpoint(state, OUT / "fgd")
    recon, feat = fgd.apply({"params": state.params}, jnp.asarray(px))
    out.update(fgd_x=px, fgd_recon=np.asarray(recon),
               fgd_feat=np.asarray(feat))
    np.savez_compressed(OUT / "outputs.npz", **out)
    for lock in OUT.rglob(".egtp_writer.lock"):
        lock.unlink()
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT} ({size} bytes)")
    return OUT


if __name__ == "__main__":
    main()
