"""Which backward differs between the card and the CPU?  Float64 gradients
of the operations on the stage-2 generator's path, each computed on the
card and on the CPU from the same inputs and upstream gradient, and their
largest difference over the CPU's largest value (float64 rounding is
~1e-15); then, at the JAX package's init, the gradient of each term of G's
loss with respect to the decoder's output, and the decoder's parameter
gradients for one upstream gradient.  One JSON object.

  python3 scripts/dpr_bisect/op_grads.py \\
      --init build/dpr_bisect/jax_init_s0_nopcnn.npz --out build/dpr_bisect/ops.json
"""

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from pixelsynth_tpu_torch import pipeline as P  # noqa: E402
from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch  # noqa: E402
from pixelsynth_tpu_torch.models import discriminators, layers  # noqa: E402
from pixelsynth_tpu_torch.models.losses import (  # noqa: E402
    discriminator_scores, hinge_g_loss, perceptual_loss,
)
from pixelsynth_tpu_torch.tools.training_evidence import evidence_cfg  # noqa: E402
from pixelsynth_tpu_torch.weights import from_jax_params, unflatten_tree  # noqa: E402


def rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    m = float(b.abs().max())
    return float((a - b).abs().max()) / m if m else float((a - b).abs().max())


def op_cases(gen):
    """(name, function of one input, input shape) for the path's operations."""
    w3 = torch.randn(16, 16, 3, 3, generator=gen, dtype=torch.float64)
    w4 = torch.randn(16, 16, 4, 4, generator=gen, dtype=torch.float64)
    w_rgb = torch.randn(64, 3, 4, 4, generator=gen, dtype=torch.float64)
    b_rgb = torch.randn(64, generator=gen, dtype=torch.float64)
    return [
        ("conv3x3", lambda x: F.conv2d(x, w3.to(x), None, 1, 1), (8, 16, 32, 32)),
        ("conv4x4_s2_p2", lambda x: F.conv2d(x, w4.to(x), None, 2, 2), (8, 16, 32, 32)),
        ("upsample2x", layers.upsample2x, (8, 16, 16, 16)),
        ("port_avg_pool_3_2_1_incl", lambda x: layers.avg_pool(x, 3, 2, 1), (8, 16, 32, 32)),
        ("F.avg_pool2d_3_2_1_excl",
         lambda x: F.avg_pool2d(x, 3, 2, 1, count_include_pad=False), (8, 16, 32, 32)),
        ("max_pool_2", lambda x: F.max_pool2d(F.relu(x), 2, 2), (8, 16, 32, 32)),
        ("leaky_relu", lambda x: F.leaky_relu(x, 0.2), (8, 16, 32, 32)),
        ("instance_norm", discriminators._instance_norm, (8, 16, 32, 32)),
        ("batch_moments", lambda x: torch.stack(layers.batch_moments(x)), (8, 16, 32, 32)),
        ("tanh", torch.tanh, (8, 16, 32, 32)),
        ("conv4x4_s2_p2_rgb", lambda x: F.conv2d(x, w_rgb.to(x), b_rgb.to(x), 2, 2),
         (16, 3, 64, 64)),
        ("F.avg_pool2d_excl_rgb",
         lambda x: F.avg_pool2d(x, 3, 2, 1, count_include_pad=False), (16, 3, 64, 64)),
        ("F.avg_pool2d_3_2_1_incl", lambda x: F.avg_pool2d(x, 3, 2, 1), (8, 16, 32, 32)),
        ("port_avg_pool_excl_rgb",
         lambda x: layers.avg_pool(x, 3, 2, 1, count_include_pad=False), (16, 3, 64, 64)),
        ("abs", torch.abs, (8, 16, 32, 32)),
    ]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for n, v in tree.items() for k in _leaves(v, f"{prefix}{n}/")]
    return [prefix[:-1]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", default="build/dpr_bisect/jax_init_s0_nopcnn.npz")
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices", default="cuda,cpu")
    a = ap.parse_args(argv)
    card, host = a.devices.split(",")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"ops": {}}
    gen = torch.Generator().manual_seed(0)
    for name, fn, shape in op_cases(gen):
        x = torch.randn(shape, generator=gen, dtype=torch.float64)
        y0 = fn(x)
        g = torch.randn(y0.shape, generator=gen, dtype=torch.float64)
        # contiguous NCHW, and an NHWC tensor seen through permute (channels
        # last strides), as the models' NHWC boundary hands it on
        for layout in ("nchw", "nhwc"):
            res = {}
            for dev in (card, host):
                if layout == "nchw":
                    xd = x.to(dev).requires_grad_(True)
                    y = fn(xd)
                else:
                    xd = x.permute(0, 2, 3, 1).contiguous().to(dev).requires_grad_(True)
                    y = fn(xd.permute(0, 3, 1, 2))
                gx, = torch.autograd.grad(y, xd, g.to(dev))
                res[dev] = (y, gx if layout == "nchw" else gx.permute(0, 3, 1, 2))
            out["ops"][f"{name}/{layout}"] = {"forward": rel(res[card][0], res[host][0]),
                                              "backward": rel(res[card][1], res[host][1])}

    cfg = evidence_cfg(64)
    with np.load(a.init) as z:
        variables = unflatten_tree(dict(z))
    batch = synthetic_pair_batch(np.random.default_rng(0), cfg.train.batch_size, cfg.model.W)
    n_layers = sum(k.endswith("gain_kernel") for k in _leaves(variables["projector"]["params"]))
    bank = np.random.default_rng(5).standard_normal(
        (n_layers, cfg.train.batch_size, 20))
    rows = []
    forward = layers.NoiseBN.forward

    def bank_forward(self, x, *, noise_scale=1.0, gen=None, noise=None):
        if noise is None and noise_scale != 0.0:
            noise = rows.pop(0).to(x)
        return forward(self, x, noise_scale=noise_scale, gen=gen, noise=noise)

    layers.NoiseBN.forward = bank_forward
    sides = {}
    for dev in (card, host):
        rows.extend(torch.from_numpy(r) for r in bank)
        ps = P.PixelSynth(cfg, device=dev, seed=0, trainable=True,
                          state_dicts=from_jax_params(variables, cfg, trainable=True))
        for tree in ps.trees:
            if tree != "pixelcnn":
                getattr(ps, tree).double()
        b = {k: torch.as_tensor(v, dtype=torch.float64, device=dev) for k, v in batch.items()}
        ps.disc.eval()
        _, _, outputs, _ = ps.train_forward(b)
        assert not rows
        pred, gt = outputs["PredImg"], outputs["OutputImg"]
        terms = {}
        x = pred.detach().requires_grad_(True)
        terms["l1"] = (x - gt).abs().mean()
        terms["perceptual"] = perceptual_loss(ps.vgg, x, gt)
        pf, pr = discriminator_scores(ps.disc, x, gt)
        g_losses = hinge_g_loss(pf, pr, lambda_feat=cfg.loss.lambda_feat)
        terms["gan"] = g_losses["GAN"]
        terms["gan_feat"] = g_losses["GAN_Feat"]
        both = torch.cat([x, gt], 0).permute(0, 3, 1, 2)
        h = both
        for i, d in enumerate(ps.disc.discs):
            feats = d(h)
            for j, f in enumerate(feats):
                terms[f"disc{i}_layer{j}"] = (f[:x.shape[0]] * torch.linspace(
                    -1, 1, f[:x.shape[0]].numel(), dtype=f.dtype, device=f.device
                ).reshape(f[:x.shape[0]].shape)).sum()
            if i != len(ps.disc.discs) - 1:
                h = F.avg_pool2d(h, 3, 2, 1, count_include_pad=False)
        grads = {k: torch.autograd.grad(v, x, retain_graph=True)[0] for k, v in terms.items()}
        up = torch.randn(pred.shape, generator=torch.Generator().manual_seed(1),
                         dtype=torch.float64).to(dev)
        names = [n for n, _ in ps.projector.named_parameters()]
        pg = torch.autograd.grad(pred, [p for _, p in ps.projector.named_parameters()], up)
        sides[dev] = dict(pred=pred, grads=grads, pgrads=dict(zip(names, pg)))
    out["pred"] = rel(sides[card]["pred"], sides[host]["pred"])
    out["loss_grads_wrt_pred"] = {k: rel(sides[card]["grads"][k], sides[host]["grads"][k])
                                  for k in sides[host]["grads"]}
    out["decoder_param_grads"] = {k: rel(sides[card]["pgrads"][k], sides[host]["pgrads"][k])
                                  for k in sides[host]["pgrads"]}
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
