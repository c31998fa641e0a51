"""The stage-3 locally-masked PixelCNN training step (port of
pixelsynth_tpu/train/lmconv.py).

512-way cross-entropy over the code grid with per-image mask triples;
the gradients clipped to a global norm of 4e6, then Adam with the
per-step exponential decay (StepLR gamma 0.999995, train_lmconv.py:458);
an optional parameter EMA (models/lmconv/utils.py:635-653) taken after
the update.  bpd = CE / ln 2 per position.

The step runs whatever `LMPixelCNN` it is given, as the JAX step does:
built with backend "pallas", every masked conv goes through K3's
differentiable entry (ops/masked_conv_kernel.py), the masks laid out for
the kernel once a step; with "xla", the plain masked conv.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN
from pixelsynth_tpu_torch.ops.masked_conv_kernel import prepare_mask
from pixelsynth_tpu_torch.parallel.mesh import mean_over_ranks
from pixelsynth_tpu_torch.pipeline import softmax_xent
from pixelsynth_tpu_torch.train.dpr import Adam, _grads
from pixelsynth_tpu_torch.train.schedulers import step_schedule


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the 2-norm of every leaf together."""
    return torch.sqrt(sum((g * g).sum() for g in grads))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: each leaf x max_norm / norm where the
    global norm reaches max_norm."""
    norm = global_norm(grads)
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


class LMTrainState:
    """The model, the clipped Adam, the EMA parameters and their decay (or
    None and None) and the step count."""

    def __init__(self, model: LMPixelCNN, opt: Adam, clip: float,
                 ema_decay: Optional[float]):
        self.model, self.opt, self.clip = model, opt, clip
        self.ema_decay = ema_decay or None
        self.ema_params: Optional[List[torch.Tensor]] = None
        if self.ema_decay is not None:
            self.ema_params = [p.detach().clone() for p in model.parameters()]
        self.step = 0

    def ema_state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        """The model's state dict with the EMA parameters in place of the
        parameters (None without an EMA)."""
        if self.ema_params is None:
            return None
        sd = dict(self.model.state_dict())
        for (name, _), e in zip(self.model.named_parameters(), self.ema_params):
            sd[name] = e.clone()
        return sd

    def state_dict(self) -> Dict:
        return {"variables": self.model.state_dict(), "opt": self.opt.state_dict(),
                "ema_params": self.ema_params, "step": self.step}

    def load_state_dict(self, sd: Dict):
        self.model.load_state_dict(sd["variables"])
        self.opt.load_state_dict(sd["opt"])
        if sd["ema_params"] is not None:
            dev = next(self.model.parameters()).device
            self.ema_params = [e.to(dev) for e in sd["ema_params"]]
        self.step = int(sd["step"])


def create_lmconv_state(model: LMPixelCNN, gen: Optional[torch.Generator], *,
                        lr: float = 2e-4, lr_decay: float = 0.999995,
                        clip: float = 4e6, ema_decay: Optional[float] = None
                        ) -> LMTrainState:
    """Initialise `model` from `gen` (a CPU generator; None keeps the
    parameters it has), make its parameters trainable, and build
    clip_by_global_norm(clip) then Adam(exponential_decay(lr, 1, lr_decay)),
    with an EMA copy of the parameters when ema_decay is set."""
    if gen is not None:
        with torch.no_grad():
            model.reset(gen)
    model.requires_grad_(True)
    params = list(model.parameters())
    opt = Adam(params, step_schedule(lr, lr_decay), (0.9, 0.999))
    return LMTrainState(model, opt, clip, ema_decay)


def lmconv_loss(model: LMPixelCNN, codes: torch.Tensor, masks: torch.Tensor, *,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean CE of the one-hot codes (B, H, W) under masks (B, 3, k^2, HW)
    [init, undilated, dilated], in the model's current mode."""
    oh = F.one_hot(codes.long(), model.num_classes).to(torch.float32)
    triple = [masks[:, 0], masks[:, 1], masks[:, 2]]
    if masks.is_cuda and model.LMConv_0.backend == "pallas":
        triple = [prepare_mask(m) for m in triple]
    return softmax_xent(model(oh, *triple, gen=gen), codes)


def make_lmconv_train_step(model: LMPixelCNN, state: LMTrainState) -> Callable:
    """(codes (B, H, W) int, masks (B, 3, k^2, HW), gen) -> metrics {ce,
    bpd, grad_norm} (tensors; grad_norm before clipping), the EMA updated
    with `state.ema_decay`.  gen: the torch.Generator of the dropout
    draws, on the device."""
    params = list(model.parameters())

    def step(codes, masks, gen: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        loss = lmconv_loss(model, codes, masks, gen=gen)
        grads = _grads(loss, params)
        gnorm = global_norm(grads)
        state.opt.update(clip_by_global_norm(grads, state.clip))
        d = state.ema_decay
        if d is not None:
            with torch.no_grad():
                for e, p in zip(state.ema_params, params):
                    e.copy_(e * d + p * (1 - d))
        state.step += 1
        ce = loss.detach()
        return mean_over_ranks({"ce": ce, "bpd": ce / math.log(2.0),
                                "grad_norm": gnorm.detach()})

    return step
