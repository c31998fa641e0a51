"""The stage-2 (depth + projection + refinement + AR head) training step
(port of pixelsynth_tpu/train/dpr.py).

One step, in the JAX step's order (:122-185): the generator update
(synthesis + perceptual + AR cross-entropy + GAN hinge + feature matching,
D scored in eval mode with its stored spectral vectors), then the
discriminator update on the detached prediction, then one train-mode
forward of D on fake || real that only advances D's spectral vectors.
Adam with betas (beta1, beta2) = (0, 0.9) by default, lr/2 for G and lr*2
for D (config.py:181-187), with the `niter` linear decay (:75-86) and
`num_accumulations` gradient averaging (optax.MultiSteps, :91-93).

torch.optim.Adam places eps as optax.adam does: lr * m_hat /
(sqrt(v_hat) + eps), eps = 1e-8 outside the square root.  G's batch and
spectral statistics are updated in place by its train forward (the JAX
step merges the same updates after its optimizer step).  The VQ-VAE and
the VGG19 stay frozen.

Inside an active mesh (parallel/mesh.py: one process a device, the batch
sharded over them) G's and D's gradients are each averaged over the ranks
after their backward, the BatchNorm moments and the NoiseBN draws are the
global batch's, and the metrics are their means over the ranks: N ranks
on a batch split N ways take the step one process takes on the whole
batch.  Its `psnr_std` metric is the mean of the ranks' values.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from pixelsynth_tpu_torch.models.losses import (
    discriminator_scores, hinge_d_loss, hinge_g_loss,
)
from pixelsynth_tpu_torch.parallel.mesh import all_reduce_mean, mean_over_ranks
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.train.schedulers import Schedule, niter_schedule

TRAINABLE = ("unet", "projector", "pixelcnn")
FROZEN = ("vqvae", "vgg")


class Adam:
    """optax.adam(lr, b1, b2) [inside optax.MultiSteps(k)] over a list of
    parameters, on torch.optim.Adam.  `update(grads)` takes one gradient
    per parameter; every k-th call applies Adam to their running mean (the
    MultiSteps mean, acc + (g - acc) / (n + 1)); the others leave the
    parameters as they are.  lr is a constant or, as optax takes it, a
    schedule of the applied updates' count from 0 (train/schedulers.py)."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 lr: Union[float, Schedule], betas, *, k: int = 1):
        self.params = list(params)
        self.schedule = lr if callable(lr) else (lambda count: lr)
        self.opt = torch.optim.Adam(self.params, lr=self.lr_at(0), betas=tuple(betas),
                                    eps=1e-8)
        self.k = k
        self.count = 0       # applied updates
        self.mini = 0        # gradients accumulated since the last one
        self.acc: Optional[List[torch.Tensor]] = None

    def lr_at(self, count: int) -> float:
        return float(self.schedule(count))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]):
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            self.acc = [a + (g - a) / (self.mini + 1) for a, g in zip(self.acc, grads)]
            self.mini += 1
            if self.mini < self.k:
                return
            grads, self.acc, self.mini = self.acc, None, 0
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> Dict:
        return {"opt": self.opt.state_dict(), "count": self.count,
                "mini": self.mini, "acc": self.acc}

    def load_state_dict(self, sd: Dict):
        self.opt.load_state_dict(sd["opt"])
        self.count, self.mini = int(sd["count"]), int(sd["mini"])
        self.acc = None if sd["acc"] is None else [
            a.to(p.device) for a, p in zip(sd["acc"], self.params)]


class DPRTrainState:
    """The trainer's state: the networks (in `ps`), G's and D's optimizers,
    and the step count."""

    def __init__(self, ps: PixelSynth, tx_g: Adam, tx_d: Adam):
        self.ps, self.tx_g, self.tx_d = ps, tx_g, tx_d
        self.step = 0

    def state_dict(self) -> Dict:
        ps = self.ps
        return {
            "gen_vars": {k: getattr(ps, k).state_dict() for k in TRAINABLE},
            "disc_vars": ps.disc.state_dict(),
            "frozen_vars": {k: getattr(ps, k).state_dict() for k in FROZEN},
            "opt_g": self.tx_g.state_dict(),
            "opt_d": self.tx_d.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, sd: Dict):
        ps = self.ps
        for k in TRAINABLE:
            getattr(ps, k).load_state_dict(sd["gen_vars"][k])
        ps.disc.load_state_dict(sd["disc_vars"])
        for k in FROZEN:
            getattr(ps, k).load_state_dict(sd["frozen_vars"][k])
        self.tx_g.load_state_dict(sd["opt_g"])
        self.tx_d.load_state_dict(sd["opt_d"])
        self.step = int(sd["step"])


def gen_params(ps: PixelSynth) -> List[torch.nn.Parameter]:
    return [p for k in TRAINABLE for p in getattr(ps, k).parameters()]


def create_dpr_state(ps: PixelSynth, *, steps_per_epoch: int = 500) -> DPRTrainState:
    """G's and D's optimizers over the trainable trees of a
    `PixelSynth(cfg, trainable=True)` (dpr.py:67-108)."""
    if not ps.trainable:
        raise ValueError("create_dpr_state needs PixelSynth(cfg, trainable=True)")
    tc = ps.cfg.train

    def lr(peak):
        if tc.niter is None:
            return peak
        return niter_schedule(peak, tc.niter * steps_per_epoch,
                              tc.niter_decay * steps_per_epoch)

    betas = (tc.beta1, tc.beta2)
    tx_g = Adam(gen_params(ps), lr(tc.lr_g), betas, k=tc.num_accumulations)
    tx_d = Adam(ps.disc.parameters(), lr(tc.lr_d), betas, k=tc.num_accumulations)
    return DPRTrainState(ps, tx_g, tx_d)


def _grads(loss, params):
    """d loss / d params, zeros where a parameter does not reach the loss
    (as jax.grad gives); inside an active mesh, their mean over the ranks
    (each rank's loss is the mean over its shard of the batch, so this is
    the gradient of the global batch's loss)."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return all_reduce_mean([torch.zeros_like(p) if g is None else g
                            for g, p in zip(gs, params)])


def make_dpr_train_step(ps: PixelSynth, state: DPRTrainState, *,
                        train_ar: bool = True, noise_scale: float = 1.0) -> Callable:
    """The G+D step: (batch, gen) -> metrics (tensors).  batch: numpy or
    tensor arrays (pipeline.train_forward); gen: the torch.Generator of the
    NoiseBN draws, on the device.  noise_scale=0.0 runs the deterministic
    forward (gain 1, bias 0)."""
    cfg = ps.cfg
    g_params = gen_params(ps)
    d_params = list(ps.disc.parameters())

    def step(batch: Dict, gen: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        batch = ps.batch_to_device(batch)
        # ---- generator step (D in eval: its stored u/v) ----
        ps.disc.eval()
        total, losses, outputs, _ = ps.train_forward(
            batch, gen=gen, train_ar=train_ar, noise_scale=noise_scale)
        pred, gt = outputs["PredImg"], outputs["OutputImg"]
        pf, pr = discriminator_scores(ps.disc, pred, gt)
        g_losses = hinge_g_loss(pf, pr, lambda_feat=cfg.loss.lambda_feat,
                                feat_match=not cfg.loss.no_ganFeat_loss)
        g_total = total + g_losses["Total Loss"]
        losses.update({k: v for k, v in g_losses.items() if k != "Total Loss"})
        state.tx_g.update(_grads(g_total, g_params))

        # ---- discriminator step on the detached prediction ----
        pred = pred.detach()
        pf, pr = discriminator_scores(ps.disc, pred, gt)
        d_losses = hinge_d_loss(pf, pr)
        state.tx_d.update(_grads(d_losses["Total Loss"], d_params))

        # advance D's spectral power iterations once a step, with its new
        # parameters
        with torch.no_grad():
            ps.disc.train()
            ps.disc(torch.cat([pred, gt], 0))
            ps.disc.eval()

        metrics = {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
                   for k, v in losses.items()}
        metrics.update({k: v.detach() for k, v in d_losses.items() if k != "Total Loss"})
        metrics["G_total"] = g_total.detach()
        metrics["D_total"] = d_losses["Total Loss"].detach()
        state.step += 1
        return mean_over_ranks(metrics)

    return step


def make_dpr_eval_step(ps: PixelSynth, *, train_ar: bool = True,
                       noise_scale: float = 1.0) -> Callable:
    """The validation forward (dpr.py:195-213): the same losses (PSNR
    included, which picks the best checkpoint), no parameter or statistics
    updates.  noise_scale=0.0 evaluates deterministically."""

    @torch.no_grad()
    def step(batch: Dict, gen: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        _, losses, _, _ = ps.train_forward(ps.batch_to_device(batch), gen=gen,
                                           train_ar=train_ar, train=False,
                                           noise_scale=noise_scale)
        return mean_over_ranks(losses)

    return step
