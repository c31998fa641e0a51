"""The two-level VQ-VAE (models/vqvae.py `VQVAE`) against the JAX
package's on the same seeded weights: both levels' code ids, the decode
from both levels (the top level through `upsample_t`, a SAME-padded
ConvTranspose, at an odd and an even top grid), `decode_code`, and one
train-mode forward with both codebooks' EMA updates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.models.vqvae import VQVAE as JaxVQVAE
from pixelsynth_tpu_torch.models.vqvae import VQVAE
from pixelsynth_tpu_torch.weights import from_jax_module
from test_torch_models import _fill
from torch_threads import _few_torch_threads  # noqa: F401

ARGS = dict(in_channel=3, channel=16, n_res_block=2, n_res_channel=8, embed_dim=8,
            n_embed=32, decay=0.99)


def _model(variables):
    m = VQVAE(**ARGS).eval()
    m.load_state_dict(from_jax_module(VQVAE(**ARGS), variables))
    return m


@pytest.fixture(scope="module", params=[24, 32], ids=["top3x3", "top4x4"])
def nets(request):
    """Image side 24 (top grid 3x3, odd) or 32 (4x4, even); each codebook
    is drawn from its level's own latents plus noise, so that many codes
    are in use."""
    H = request.param
    rng = np.random.default_rng(H)
    img = rng.uniform(-1, 1, (2, H, H, 3)).astype(np.float32)
    jm = JaxVQVAE(**ARGS)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": k}, jnp.asarray(img), train=False))
    variables = _fill(shapes, rng)
    m = _model(variables)

    def codebook(latents):
        flat = latents.reshape(-1, latents.shape[-1]).numpy()
        rows = flat[rng.integers(0, len(flat), ARGS["n_embed"])]
        rows = rows + rng.normal(0, 0.05 * flat.std(), rows.shape)
        return jnp.asarray(rows.T.astype(np.float32))

    with torch.no_grad():
        x = torch.as_tensor(img).permute(0, 3, 1, 2)
        enc_b = m.enc_b(x)
        qt = m.quantize_conv_t(m.enc_t(enc_b)).permute(0, 2, 3, 1)
        ema = variables["ema"]
        ema["quantize_t"]["embed"] = ema["quantize_t"]["embed_avg"] = codebook(qt)
        m = _model(variables)
        quant_t = m.quantize_t.embed_code(m.quantize_t(qt))
        qb = m._qb_input(quant_t, enc_b)
        ema["quantize_b"]["embed"] = ema["quantize_b"]["embed_avg"] = codebook(qb)
    return jm, variables, img


def test_ids_and_decode_match_jax(nets):
    """Both ids exactly (nearest codes in fp32 on both sides), the latent
    loss, the decode from the quantizations and decode_code to 1e-5 + 1e-4
    relative."""
    jm, v, img = nets
    qt, qb, diff, id_t, id_b = jm.apply(v, jnp.asarray(img), train=False,
                                        method=jm.encode)
    m = _model(v)
    with torch.no_grad():
        got_t, got_b = m.encode(torch.as_tensor(img))
        full = m.encode_full(torch.as_tensor(img))
    H = img.shape[1]
    assert got_t.shape == (2, H // 8, H // 8) and got_b.shape == (2, H // 4, H // 4)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(id_t))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(id_b))
    assert len(np.unique(np.asarray(id_b))) > 8
    np.testing.assert_allclose(float(full[2]), float(diff), rtol=1e-4)
    want = jm.apply(v, qt, qb, method=jm.decode)
    with torch.no_grad():
        got = m.decode(torch.as_tensor(np.array(qt)), torch.as_tensor(np.array(qb)))
        got_code = m.decode_code(got_t, got_b)
    assert got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    want_code = jm.apply(v, id_t, id_b, method=jm.decode_code)
    np.testing.assert_allclose(got_code.numpy(), np.asarray(want_code), atol=1e-5, rtol=1e-4)


def test_train_forward_and_ema_match_jax(nets):
    """One train-mode forward: the reconstruction and the latent loss, and
    both codebooks' EMA buffers after the update, to 1e-5 + 1e-4
    relative."""
    jm, v, img = nets
    (recon, diff), upd = jm.apply(v, jnp.asarray(img), train=True, mutable=["ema"])
    m = _model(v).train()
    with torch.no_grad():
        got, got_diff = m(torch.as_tensor(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(recon), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(got_diff), float(diff), rtol=1e-4)
    for q in ("quantize_t", "quantize_b"):
        for leaf in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(getattr(getattr(m, q), leaf).numpy(),
                                       np.asarray(upd["ema"][q][leaf]),
                                       atol=1e-5, rtol=1e-4)
        assert not np.allclose(np.asarray(upd["ema"][q]["cluster_size"]),
                               np.asarray(v["ema"][q]["cluster_size"]))
