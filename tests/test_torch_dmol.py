"""The discretized mixture-of-logistics losses and samplers
(models/dmol.py) against the JAX package's on the same logits: the
3-channel, 1-channel and 4- / 6-channel losses and their gradients, and
both samplers with JAX's own draws (the mixture index and the uniforms
under its key) injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.models import dmol as jdmol
from pixelsynth_tpu_torch.models import dmol
from torch_threads import _few_torch_threads  # noqa: F401

B, H, W, K = 2, 6, 5, 4


def _data(C, per_mix, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    x[0, 0, 0] = -1.0          # the edge bins, both ends
    x[0, 0, 1] = 1.0
    logits = (rng.normal(size=(B, H, W, per_mix * K)) * scale).astype(np.float32)
    return x, logits


def _loss_and_grad(fn_t, fn_j, x, logits):
    lt = torch.tensor(logits, requires_grad=True)
    got = fn_t(torch.as_tensor(x), lt)
    got.backward()
    want, g = jax.value_and_grad(lambda l: fn_j(jnp.asarray(x), l))(jnp.asarray(logits))
    return float(got.detach()), float(want), lt.grad.numpy(), np.asarray(g)


@pytest.mark.parametrize("case", ["3", "1d", "4", "6"])
def test_losses_and_gradients_match_jax(case):
    """The summed NLL to 1e-5 relative and its gradient to 1e-4 of its
    scale (fp32; torch's and XLA's sigmoid and softplus differ by ulps,
    and the gradient of log(cdf_delta) divides by cdf_delta, ~1e-5 near
    the small-bin branch); logits at two scales, the larger sending some
    bins to that branch."""
    C, per_mix, t_fn, j_fn = {
        "3": (3, 10, dmol.discretized_mix_logistic_loss, jdmol.discretized_mix_logistic_loss),
        "1d": (1, 3, dmol.discretized_mix_logistic_loss_1d,
               jdmol.discretized_mix_logistic_loss_1d),
        "4": (4, 13, dmol.discretized_mix_logistic_loss_nd,
              jdmol.discretized_mix_logistic_loss_nd),
        "6": (6, 31, dmol.discretized_mix_logistic_loss_nd,
              jdmol.discretized_mix_logistic_loss_nd),
    }[case]
    for scale in (0.5, 4.0):
        x, logits = _data(C, per_mix, seed=int(scale), scale=scale)
        got, want, g, wg = _loss_and_grad(t_fn, j_fn, x, logits)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(g, wg, rtol=0, atol=1e-4 * np.abs(wg).max())


def test_unreduced_losses_match_jax():
    x, logits = _data(3, 10, seed=5)
    got = dmol.discretized_mix_logistic_loss(torch.as_tensor(x), torch.as_tensor(logits),
                                             reduce_sum=False)
    want = jdmol.discretized_mix_logistic_loss(jnp.asarray(x), jnp.asarray(logits),
                                               reduce_sum=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    x, logits = _data(6, 31, seed=6)
    got = dmol.discretized_mix_logistic_loss_nd(torch.as_tensor(x), torch.as_tensor(logits),
                                                reduce_sum=False)
    want = jdmol.discretized_mix_logistic_loss_nd(jnp.asarray(x), jnp.asarray(logits),
                                                  reduce_sum=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _jax_draws(key, logit_probs, temperature, shape):
    """dmol.py's own draws under `key`: the categorical mixture index and
    the uniforms in [1e-5, 1 - 1e-5)."""
    k1, k2 = jax.random.split(key)
    mix = jax.random.categorical(k1, jnp.asarray(logit_probs) / temperature, axis=-1)
    u = jax.random.uniform(k2, shape, minval=1e-5, maxval=1 - 1e-5)
    return np.array(mix), np.array(u)


@pytest.mark.parametrize("n_channels", [3, 4, 6])
@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_samplers_match_jax_with_its_draws(n_channels, temperature):
    """Both samplers with JAX's draws injected: the samples to 1e-6, in
    [-1, 1]; and drawn from a torch.Generator, samples of the same shape
    in [-1, 1]."""
    per_mix = {3: 10, 4: 13, 6: 31}[n_channels]
    _, logits = _data(n_channels, per_mix, seed=7)
    key = jax.random.PRNGKey(11)
    mix, u = _jax_draws(key, logits[..., :K], temperature, (B, H, W, n_channels))
    lt = torch.as_tensor(logits)
    if n_channels == 3:
        want = jdmol.sample_from_discretized_mix_logistic(key, jnp.asarray(logits),
                                                          temperature)
        got = dmol.sample_from_discretized_mix_logistic(lt, temperature, mix=mix, u=u)
        drawn = dmol.sample_from_discretized_mix_logistic(
            lt, temperature, torch.Generator().manual_seed(0))
    else:
        want = jdmol.sample_from_discretized_mix_logistic_nd(key, jnp.asarray(logits),
                                                             n_channels, temperature)
        got = dmol.sample_from_discretized_mix_logistic_nd(lt, n_channels, temperature,
                                                           mix=mix, u=u)
        drawn = dmol.sample_from_discretized_mix_logistic_nd(
            lt, n_channels, temperature, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got.abs().max()) <= 1.0
    assert drawn.shape == (B, H, W, n_channels) and float(drawn.abs().max()) <= 1.0


def test_categorical_draw_follows_the_probabilities():
    """The port's own mixture draw (Gumbel-max) picks each component about
    as often as its probability (40000 cells, 3 sigma)."""
    probs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    logits = np.zeros((1, 200, 200, 10 * K), np.float32)
    logits[..., :K] = np.log(probs)
    mix, _ = dmol._draws(torch.Generator().manual_seed(1), torch.as_tensor(logits[..., :K]),
                         1.0, (1, 200, 200, 3), None, None)
    freq = np.bincount(mix.numpy().reshape(-1), minlength=K) / mix.numel()
    sigma = np.sqrt(probs * (1 - probs) / mix.numel())
    assert np.all(np.abs(freq - probs) < 3 * sigma + 1e-4), freq
