"""The same NoiseBN draws in both packages, keyed by where each draws.

A JAX NoiseBN draws `jax.random.normal(self.make_rng("noise"), (B, 20))`
(pixelsynth_tpu/models/layers.py:216): the key depends on the rngs the
caller passed and on the layer.  The port's NoiseBN draws from a
torch.Generator, whose state before the draw plays the key's part.  In
`NoiseBank.patch()` each package's draw takes a row of the bank: a key
seen for the first time takes the next row, a key seen again the row it
took before.  So where the JAX package hands several calls the same key
(forward_angle's views), the port has to restart its generator at the
same state to draw the same rows, and a port that did not would draw new
rows and run the bank out."""

from contextlib import ExitStack, contextmanager
from unittest import mock

import jax
import numpy as np
import torch

from pixelsynth_tpu.models import layers as jax_layers
from pixelsynth_tpu_torch.models import layers as port_layers

NOISE_SZ = 20


class NoiseBank:
    def __init__(self, n_rows: int, batch: int, seed: int = 0):
        self.rows = np.random.default_rng(seed).normal(
            size=(n_rows, batch, NOISE_SZ)).astype(np.float32)
        self.jax_keys, self.port_keys = {}, {}

    def _row(self, table, key):
        if key not in table:
            table[key] = len(table)
        return self.rows[table[key]]

    @contextmanager
    def patch(self):
        bank = self

        class _Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            @staticmethod
            def normal(key, shape, dtype=None):
                row = bank._row(bank.jax_keys, np.asarray(key).tobytes())
                assert tuple(shape) == row.shape, (shape, row.shape)
                return row if dtype is None else row.astype(dtype)

        class _Jax:
            random = _Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        forward = port_layers.NoiseBN.forward

        def port_forward(layer, x, *, noise_scale=1.0, gen=None, noise=None):
            if noise is None and noise_scale != 0.0:
                key = gen.get_state().numpy().tobytes()
                torch.randn((x.shape[0], NOISE_SZ), generator=gen, device=x.device)
                noise = torch.as_tensor(bank._row(bank.port_keys, key)) * noise_scale
            return forward(layer, x, noise_scale=noise_scale, gen=gen, noise=noise)

        with ExitStack() as stack:
            stack.enter_context(mock.patch.object(jax_layers, "jax", _Jax()))
            stack.enter_context(mock.patch.object(port_layers.NoiseBN, "forward",
                                                  port_forward))
            yield self
