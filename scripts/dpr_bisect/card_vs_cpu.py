"""The port's stage-2 step on the card against the same step on the CPU:
two trainers from one state (the JAX package's init, `jax_run.py
--export-init`), the same batches and NoiseBN rows (a bank, `jax_run.py
--dump-draws`), stepped side by side.  After every step: each tree's
gradients, parameters and statistics and the step's metrics, card against
CPU (largest difference over the leaf's largest value); at every step the
intermediate tensors of G's forward (depth, the splat's image and
background, the masks, the decoder's output).  In float64 (K2's plain
version on the card, as on the CPU) the two devices compute the same
formulas, so any leaf far above float64 rounding names an operation whose
CUDA result differs from its CPU one.  One JSON line a step.

  python3 scripts/dpr_bisect/card_vs_cpu.py --float64 --steps 30 \\
      --init build/dpr_bisect/jax_init_s0_nopcnn.npz \\
      --bank build/dpr_bisect/jax_draws_s0.npy --out build/dpr_bisect/cvc.jsonl
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from pixelsynth_tpu_torch import pipeline as P  # noqa: E402
from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch  # noqa: E402
from pixelsynth_tpu_torch.models import layers as L  # noqa: E402
from pixelsynth_tpu_torch.ops import splat  # noqa: E402
from pixelsynth_tpu_torch.tools.training_evidence import evidence_cfg  # noqa: E402
from pixelsynth_tpu_torch.train.dpr import TRAINABLE, create_dpr_state, make_dpr_train_step  # noqa: E402
from pixelsynth_tpu_torch.weights import from_jax_params, unflatten_tree  # noqa: E402

TREES = TRAINABLE + ("disc",)


def rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    if a.dtype == torch.bool or b.dtype == torch.bool:
        return float((a != b).sum())
    m = float(b.abs().max()) if b.numel() else 0.0
    e = float((a - b).abs().max()) if b.numel() else 0.0
    return e / m if m else e


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", default="build/dpr_bisect/jax_init_s0_nopcnn.npz")
    ap.add_argument("--bank", default="build/dpr_bisect/jax_draws_s0.npy")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--kernel-k2", action="store_true",
                    help="K2's kernel on the card (default: its plain version)")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--leaves", type=int, default=0,
                    help="write every leaf's gradient and parameter difference "
                         "for this many first steps")
    ap.add_argument("--devices", default="cuda,cpu",
                    help="the two sides (cpu,cpu rehearses the script)")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not a.kernel_k2:
        splat.blend_slots_kernel = splat.blend_slots_plain
    cfg = evidence_cfg(64)
    B = cfg.train.batch_size
    with np.load(a.init) as z:
        variables = unflatten_tree(dict(z))
    dtype = torch.float64 if a.float64 else torch.float32
    sides = {}
    for side, dev in zip(("card", "cpu"), a.devices.split(",")):
        ps = P.PixelSynth(cfg, device=dev, seed=0, trainable=True,
                          state_dicts=from_jax_params(variables, cfg, trainable=True))
        if a.float64:
            for tree in ps.trees:
                if tree != "pixelcnn":
                    getattr(ps, tree).double()
        state = create_dpr_state(ps)
        seen = {}
        for name, tx in (("g", state.tx_g), ("d", state.tx_d)):
            def spy(grads, _name=name, _update=tx.update, _seen=seen):
                _seen[_name] = [g.detach().clone() for g in grads]
                return _update(grads)
            tx.update = spy
        rng = np.random.default_rng(0)
        fixed = [{k: torch.as_tensor(v, dtype=dtype, device=dev)
                  for k, v in synthetic_pair_batch(rng, B, cfg.model.W).items()}
                 for _ in range(48 // B)]
        sides[side] = dict(ps=ps, state=state, step=make_dpr_train_step(ps, state),
                          seen=seen, fixed=fixed, gen=torch.Generator(dev).manual_seed(1))

    bank = np.load(a.bank, mmap_mode="r")
    rows = {"card": [], "cpu": []}
    seen_fwd = {}
    now = {"side": None}
    forward = L.NoiseBN.forward

    def bank_forward(self, x, *, noise_scale=1.0, gen=None, noise=None):
        if noise is None and noise_scale != 0.0:
            noise = rows[now["side"]].pop(0).to(x)
        return forward(self, x, noise_scale=noise_scale, gen=gen, noise=noise)

    L.NoiseBN.forward = bank_forward

    def record(name, t):
        seen_fwd[now["side"]][name] = t.detach().clone()

    splat_fn = P.splat

    def splat_rec(*args, **kw):
        img, bg = splat_fn(*args, **kw)
        record("gen_fs", img)
        record("bg", bg)
        return img, bg

    P.splat = splat_rec
    masks_fn = P.PixelSynth.masks_for_background

    def masks_rec(self, bg_mask, **kw):
        out = masks_fn(self, bg_mask, **kw)
        record("masks", out[1])
        return out

    P.PixelSynth.masks_for_background = masks_rec
    depth_fn = P.PixelSynth.regress_depth

    def depth_rec(self, img, **kw):
        out = depth_fn(self, img, **kw)
        record("depth", out[0] if isinstance(out, tuple) else out)
        return out

    P.PixelSynth.regress_depth = depth_rec
    decode_fn = P.PixelSynth.decode_image

    def decode_rec(self, combined, bg_mask, **kw):
        out = decode_fn(self, combined, bg_mask, **kw)
        record("combined", combined)
        record("pred", out[0] if isinstance(out, tuple) else out)
        return out

    P.PixelSynth.decode_image = decode_rec

    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    t0 = time.time()
    with open(a.out, "w") as f:
        for t in range(a.steps):
            metrics, params = {}, {}
            for side, s in sides.items():
                now["side"] = side
                rows[side].extend(torch.from_numpy(np.array(r)).to(s["ps"].device)
                                  for r in bank[t])
                seen_fwd[side] = {}
                metrics[side] = {k: float(v) for k, v in
                                 s["step"](s["fixed"][t % len(s["fixed"])], s["gen"]).items()}
                assert not rows[side]
                params[side] = {tr: dict(getattr(s["ps"], tr).named_parameters())
                                for tr in TREES}
            rec = {"step": t, "secs": time.time() - t0,
                   "metrics": {k: abs(metrics["card"][k] - metrics["cpu"][k])
                               / max(abs(metrics["cpu"][k]), 1e-30) for k in metrics["cpu"]},
                   "forward": {k: rel(seen_fwd["card"][k], seen_fwd["cpu"][k])
                               for k in seen_fwd["cpu"]}}
            for tr in TREES:
                names = list(params["cpu"][tr])
                gs = {}
                for side in sides:
                    g = sides[side]["seen"]["d" if tr == "disc" else "g"]
                    if tr != "disc":
                        off = sum(len(list(getattr(sides[side]["ps"], x).parameters()))
                                  for x in TRAINABLE[:TRAINABLE.index(tr)])
                        g = g[off:off + len(names)]
                    gs[side] = dict(zip(names, g))
                worst = lambda d1, d2: max(((rel(d1[k], d2[k]), k) for k in d2), default=(0.0, ""))
                stats = {side: dict(getattr(s["ps"], tr).named_buffers())
                         for side, s in sides.items()}
                rec[tr] = {"grads": worst(gs["card"], gs["cpu"]),
                           "params": worst(params["card"][tr], params["cpu"][tr]),
                           "stats": worst(stats["card"], stats["cpu"])}
                if t < a.leaves:
                    nu = {}
                    for side, s in sides.items():
                        opt = (s["state"].tx_d if tr == "disc" else s["state"].tx_g).opt
                        nu[side] = {k: opt.state[p]["exp_avg_sq"]
                                    for k, p in params[side][tr].items()}
                    rec[tr]["leaves"] = {k: [rel(gs["card"][k], gs["cpu"][k]),
                                             rel(params["card"][tr][k], params["cpu"][tr][k]),
                                             rel(nu["card"][k], nu["cpu"][k])]
                                         for k in names}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
