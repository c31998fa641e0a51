"""The stage-2 evidence protocol (pixelsynth_tpu_torch/tools/
training_evidence.py `evidence_dpr`: W=64, batch 8, 48 fixed synthetic
pairs) on the port, with the parts that a run of the JAX package would
differ in swapped one at a time.  The port only; every swap is made here,
by replacing functions for this process, and none is a switch of the
package.

  --init own|jax   the port's own `reset` from --seed, or the JAX
                   package's init_variables carried in through
                   weights.from_jax_params(..., trainable=True) from the
                   npz that `jax_run.py --export-init` writes;
  --noise own|bank the port's own NoiseBN draws in the train step, or
                   step t's rows of numpy default_rng([777, t]) in draw
                   order (jax_run.py --noise bank reads the same); the
                   evals draw from the run's generator either way;
  --bank PATH      with --noise bank: the rows of an .npy of shape (steps,
                   n layers, B, 20), e.g. the JAX package's own draws that
                   `jax_run.py --dump-draws` writes;
  --truncated      the port's own init with Flax's lecun_normal (a normal
                   truncated to +-2 and rescaled to std 1/sqrt(fan_in))
                   in every Conv, ConvTranspose, Dense and NoiseBN kernel;
  --bf16-mm        both operands of every convolution, linear layer,
                   matmul and einsum rounded to bf16, the sums in f32 (a
                   TPU's default precision for f32 operands);
  --plain-k2       K2's launcher rebound to its plain version (on the card);
  --float64        every tree but the PixelCNN (whose plain masked conv
                   computes in float32) and the batches in float64;
  --metrics-only   one line of the step's metrics a step, no evals;
  --device, --threads  the device (cuda or cpu) and the CPU's threads.
TF32 is off.  Each --log-every steps: psnr (with noise) and psnr_det
(zero noise), in both conventions, as the tool writes them.

  python3 scripts/dpr_bisect/port_run.py --init jax --noise bank \\
      --jax-init build/dpr_bisect/jax_init_s0.npz --out build/dpr_bisect/x
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch  # noqa: E402
from pixelsynth_tpu_torch.models import layers as L  # noqa: E402
from pixelsynth_tpu_torch.pipeline import PixelSynth  # noqa: E402
from pixelsynth_tpu_torch.tools.training_evidence import evidence_cfg  # noqa: E402
from pixelsynth_tpu_torch.train.dpr import (  # noqa: E402
    create_dpr_state, make_dpr_eval_step, make_dpr_train_step,
)
from pixelsynth_tpu_torch.weights import from_jax_params, unflatten_tree  # noqa: E402

BANK_SEED = 777
NOISE_SZ = 20


def lecun_truncated(shape, gen):
    """Flax's truncated normal of std 1 (before the 1/sqrt(fan_in))."""
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                       generator=gen) / 0.87962566103423978


def use_truncated_init():
    tn = lecun_truncated

    def conv_reset(self, gen):
        cout = self.weight.shape[0]
        w = tn(self.weight.shape, gen) / np.sqrt(self.weight[0].numel())
        if self.sn_state:
            u = L.converged_u(self._mat(w), gen)
            self.u.copy_(u)
            self.v.copy_(L.l2norm(self._mat(w) @ u))
        elif self.spectral:
            w = w / L.spectral_sigma(w.reshape(cout, -1).T, gen)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def convt_reset(self, gen):
        cin, cout, k, _ = self.weight.shape
        self.weight.copy_(tn(self.weight.shape, gen) / np.sqrt(k * k * cin))
        self.bias.zero_()

    def dense_reset(self, gen):
        self.weight.copy_(tn(self.weight.shape, gen) / np.sqrt(self.weight.shape[1]))
        self.bias.zero_()

    def noisebn_reset(self, gen):
        for p, kind in ((self.wg, "gain"), (self.wb, "bias")):
            w = tn(p.shape, gen) / np.sqrt(self.noise_sz)
            if self.sn_state:
                u = L.converged_u(w, gen)
                getattr(self, f"u_{kind}").copy_(u)
                getattr(self, f"v_{kind}").copy_(L.l2norm(w @ u))
            elif self.spectral:
                w = w / L.spectral_sigma(w, gen)
            p.copy_(w)

    for cls, fn in ((L.Conv, conv_reset), (L.ConvTranspose, convt_reset),
                    (L.Dense, dense_reset), (L.NoiseBN, noisebn_reset)):
        cls.reset = torch.no_grad()(fn)


def use_bf16_operands():
    def rb(t):
        return (t.to(torch.bfloat16).to(t.dtype)
                if torch.is_tensor(t) and t.is_floating_point() else t)

    def wrap(fn):
        def g(x, w, *args, **kw):
            return fn(rb(x), rb(w), *args, **kw)
        return g

    F.conv2d = wrap(F.conv2d)
    F.conv_transpose2d = wrap(F.conv_transpose2d)
    F.linear = wrap(F.linear)
    torch.matmul = wrap(torch.matmul)
    einsum = torch.einsum
    torch.einsum = lambda eq, *ops: einsum(eq, *[rb(o) for o in ops])
    mm = torch.Tensor.__matmul__
    torch.Tensor.__matmul__ = lambda x, y: mm(rb(x), rb(y))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", default="own", choices=["own", "jax"])
    ap.add_argument("--noise", default="own", choices=["own", "bank"])
    ap.add_argument("--jax-init", default="build/dpr_bisect/jax_init_s0.npz")
    ap.add_argument("--bank")
    ap.add_argument("--truncated", action="store_true")
    ap.add_argument("--bf16-mm", action="store_true")
    ap.add_argument("--metrics-only", action="store_true")
    ap.add_argument("--plain-k2", action="store_true")
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3200)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    if a.threads:
        torch.set_num_threads(a.threads)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.truncated:
        use_truncated_init()
    if a.bf16_mm:
        use_bf16_operands()
    if a.plain_k2:
        from pixelsynth_tpu_torch.ops import splat
        splat.blend_slots_kernel = splat.blend_slots_plain
    cfg = evidence_cfg(64)
    B = cfg.train.batch_size
    sd = None
    if a.init == "jax":
        with np.load(a.jax_init) as z:
            sd = from_jax_params(unflatten_tree(dict(z)), cfg, trainable=True)
    ps = PixelSynth(cfg, device=a.device, seed=a.seed, trainable=True, state_dicts=sd)
    dtype = torch.float64 if a.float64 else torch.float32
    if a.float64:
        for tree in ps.trees:
            if tree != "pixelcnn":
                getattr(ps, tree).double()
    state = create_dpr_state(ps)
    step_fn = make_dpr_train_step(ps, state)
    eval_fn = make_dpr_eval_step(ps)
    eval_det = make_dpr_eval_step(ps, noise_scale=0.0)
    rng = np.random.default_rng(a.seed)
    fixed = [{k: torch.as_tensor(v, dtype=dtype, device=ps.device)
              for k, v in synthetic_pair_batch(rng, B, cfg.model.W).items()}
             for _ in range(48 // B)]
    gen = torch.Generator(ps.device).manual_seed(a.seed + 1)

    rows = []
    forward = L.NoiseBN.forward

    def bank_forward(self, x, *, noise_scale=1.0, gen=None, noise=None):
        if noise is None and noise_scale != 0.0 and rows:
            noise = rows.pop(0).to(x) * noise_scale
        return forward(self, x, noise_scale=noise_scale, gen=gen, noise=noise)

    if a.noise == "bank":
        L.NoiseBN.forward = bank_forward
    bank_file = np.load(a.bank, mmap_mode="r") if a.bank else None
    n_layers = sum(isinstance(m, L.NoiseBN) for m in ps.projector.modules())

    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "dpr.jsonl"), "w") as f:
        t0 = time.time()
        best = -float("inf")
        for it in range(a.steps):
            if a.noise == "bank":
                bank = (np.array(bank_file[it]) if bank_file is not None else
                        np.random.default_rng([BANK_SEED, it]).standard_normal(
                            (n_layers, B, NOISE_SZ), dtype=np.float32))
                rows.extend(torch.from_numpy(r).to(ps.device) for r in bank)
            m = step_fn(fixed[it % len(fixed)], gen)
            assert not rows, len(rows)
            if a.metrics_only:
                f.write(json.dumps({"step": it, **{k: float(v) for k, v in m.items()}}) + "\n")
                f.flush()
                continue
            if it % a.log_every == 0 or it == a.steps - 1:
                ev = [eval_fn(b, gen) for b in fixed]
                ed = [eval_det(b, gen) for b in fixed]

                def mean(es, k):
                    return float(np.mean([float(e[k]) for e in es]))

                rec = {"step": it, "psnr": mean(ev, "psnr"), "psnr_std": mean(ev, "psnr_std"),
                       "psnr_det": mean(ed, "psnr"), "psnr_std_det": mean(ed, "psnr_std"),
                       "total_loss": float(m["Total Loss"]), "l1": float(m.get("L1", 0.0)),
                       "D_total": float(m["D_total"]), "G_total": float(m["G_total"]),
                       "secs": time.time() - t0}
                best = max(best, rec["psnr_det"])
                f.write(json.dumps(rec) + "\n")
                f.flush()
    print(f"{a.out}: init={a.init} noise={a.noise} seed={a.seed} best det {best:.2f} "
          f"({a.steps} steps, {time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
