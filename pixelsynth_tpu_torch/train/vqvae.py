"""The stage-1 VQ-VAE training step (port of pixelsynth_tpu/train/vqvae.py).

MSE reconstruction + 0.25 x the latent commitment loss, Adam(3e-4)
(train_vqvae.py:27-41).  The train forward updates both codebooks' EMA
buffers in place (models/vqvae.py `Quantize`), from the parameters before
the step, as the JAX step merges its `ema` updates.  The codebooks start
from the data (`init_codebook_from_batch`): the reference's N(0, 1)
codebook collapses to one live code at this scale.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from pixelsynth_tpu_torch.models.vqvae import Quantize, VQVAETop
from pixelsynth_tpu_torch.parallel.mesh import mean_over_ranks
from pixelsynth_tpu_torch.train.dpr import Adam, _grads

LATENT_LOSS_WEIGHT = 0.25  # train_vqvae.py:30


class VQTrainState:
    """The model (its parameters and `ema` buffers), Adam and the step
    count."""

    def __init__(self, model: VQVAETop, opt: Adam):
        self.model, self.opt, self.step = model, opt, 0

    def state_dict(self) -> Dict:
        return {"variables": self.model.state_dict(), "opt": self.opt.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: Dict):
        self.model.load_state_dict(sd["variables"])
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])


def create_vqvae_state(model: VQVAETop, gen: torch.Generator, *, lr: float = 3e-4,
                       init_batch=None, draws: Optional[Dict] = None) -> VQTrainState:
    """Initialise `model` from `gen` (a CPU generator) and, given
    init_batch (B, W, W, 3) images, its codebooks from the data; make its
    parameters trainable."""
    with torch.no_grad():
        model.reset(gen)
    model.requires_grad_(True)
    if init_batch is not None:
        init_codebook_from_batch(model, init_batch, gen, draws=draws)
    return VQTrainState(model, Adam(model.parameters(), lr, (0.9, 0.999)))


def _sample_codes(q: Quantize, lat: torch.Tensor, gen: torch.Generator,
                  draws: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    flat = lat.reshape(-1, lat.shape[-1])
    n = q.n_embed
    if draws is None:
        idx = torch.randint(flat.shape[0], (n,), generator=gen)
        noise = torch.randn((n, flat.shape[1]), generator=gen)
    else:
        idx, noise = (torch.tensor(d) for d in draws)
    centers = flat[idx.to(flat.device).long()]
    std = torch.clamp(flat.std(unbiased=False), min=1e-4)
    centers = centers + 0.01 * std * noise.to(centers)
    q.embed.copy_(centers.T)
    q.embed_avg.copy_(centers.T)   # its own storage, equal to embed
    q.cluster_size.fill_(1.0)


@torch.no_grad()
def init_codebook_from_batch(model: VQVAETop, img, gen: torch.Generator, *,
                             draws: Optional[Dict] = None):
    """Each codebook's codes sampled from the batch's pre-quantize latents,
    plus 0.01 x their std of normal jitter to separate duplicates
    (vqvae.py:49-97): the top codebook first, then the bottom one from qb
    recomputed through it.  cluster_size ones.  The draws (n_embed ids,
    then (n_embed, dim) normals, for "quantize_t" then "quantize_b") come
    from `gen`, or from `draws` {name: (ids, normals)}."""
    e = model.quantize_t.embed
    img = torch.as_tensor(img, dtype=e.dtype, device=e.device)
    draws = draws or {}
    qt, _ = model.pre_quantize(img)
    _sample_codes(model.quantize_t, qt, gen, draws.get("quantize_t"))
    _, qb = model.pre_quantize(img)
    _sample_codes(model.quantize_b, qb, gen, draws.get("quantize_b"))


def make_vqvae_train_step(model: VQVAETop, state: VQTrainState) -> Callable:
    """(img (B, W, W, 3) tensor on the model's device) -> metrics {loss,
    mse, latent} (tensors)."""
    params = list(model.parameters())

    def step(img: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.train()
        recon, diff = model(img)
        mse = ((recon - img) ** 2).mean()
        loss = mse + LATENT_LOSS_WEIGHT * diff
        state.opt.update(_grads(loss, params))
        state.step += 1
        return mean_over_ranks({"loss": loss.detach(), "mse": mse.detach(),
                                "latent": diff.detach()})

    return step
