"""The stage-2 evidence protocol (pixelsynth_tpu/tools/training_evidence.py
`evidence_dpr`: W=64, batch 8, 48 fixed synthetic pairs, seed 0) on the JAX
package, with the NoiseBN draws of each train step optionally read from a
bank that scripts/dpr_bisect/port_run.py reads too.  JAX only.

  --noise own    the package's own key-split draws (as its tool);
  --noise bank   step t's draws are numpy default_rng([777, t]) rows of
                 shape (n NoiseBN layers, B, 20), taken in draw order;
                 the evals keep the package's own draws;
  --metrics-only one line of the step's metrics a step, no evals;
  --bank PATH    with --noise bank: the rows of an .npy of shape (steps,
                 n layers, B, 20) instead of the numpy bank;
  --export-init PATH  write init_variables(PRNGKey(seed)) as a flat npz
                 ("tree/collection/.../leaf" keys) for port_run.py and exit;
  --dump-draws PATH   write the draws the package's own run (--noise own)
                 takes in each train step, as such an .npy, and exit.  The
                 draws depend on the key chain alone (the tool's: one split a
                 step, one more at each logged step), so the decoder is
                 applied to zeros at 16x16 with each step's noise key.

  JAX_PLATFORMS=cpu python scripts/dpr_bisect/jax_run.py --noise bank \\
      --steps 3200 --out build/dpr_bisect/jax_bank
"""

import argparse
import json
import os
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from pixelsynth_tpu.data.synthetic import synthetic_pair_batch  # noqa: E402
from pixelsynth_tpu.models import layers as jax_layers  # noqa: E402
from pixelsynth_tpu.pipeline import PixelSynth  # noqa: E402
from pixelsynth_tpu.tools.training_evidence import _cfg  # noqa: E402
from pixelsynth_tpu.train import dpr as jdpr  # noqa: E402

BANK_SEED = 777
NOISE_SZ = 20
_BANK = {"rows": None, "i": 0}


class _Random:
    """jax.random whose `normal` reads the bank while one is set, and
    records what it draws while a capture list is set (only NoiseBN calls
    it inside a step)."""

    def __getattr__(self, name):
        return getattr(jax.random, name)

    @staticmethod
    def normal(key, shape, dtype=None):
        if _BANK["rows"] is None:
            out = jax.random.normal(key, shape, *(() if dtype is None else (dtype,)))
            if _BANK.get("capture") is not None:
                _BANK["capture"].append(out)
            return out
        row = _BANK["rows"][_BANK["i"]]
        _BANK["i"] += 1
        assert tuple(shape) == row.shape, (shape, row.shape)
        return row if dtype is None else row.astype(dtype)


class _Jax:
    random = _Random()

    def __getattr__(self, name):
        return getattr(jax, name)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def bank_rows(step, n_layers, batch):
    return np.random.default_rng([BANK_SEED, step]).standard_normal(
        (n_layers, batch, NOISE_SZ), dtype=np.float32)


def dump_draws(ps, variables, a, n_layers):
    """The NoiseBN draws of each train step of the package's own run."""
    jax_layers.jax = _Jax()
    B = ps.cfg.train.batch_size
    cin = variables["projector"]["params"]["ResNetBlock_0"]["SNConv_0"]["kernel"].shape[2]
    x = jnp.zeros((B, 16, 16, cin - 1))      # the decoder appends the mask
    bg = jnp.zeros((B, 16, 16), bool)

    @jax.jit
    def draws(rng):
        _BANK["capture"] = []
        ps.decode_image(variables["projector"], x, bg, train=True, rngs={"noise": rng})
        out, _BANK["capture"] = jnp.stack(_BANK["capture"]), None
        return out

    key = jax.random.PRNGKey(a.seed + 1)
    out = np.zeros((a.steps, n_layers, B, NOISE_SZ), np.float32)
    for it in range(a.steps):
        rng_noise, key = jax.random.split(key)     # dpr.py's step
        out[it] = np.asarray(draws(rng_noise))
        if it % a.log_every == 0 or it == a.steps - 1:
            key, _ = jax.random.split(key)          # the tool's eval key
    np.save(a.dump_draws, out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--noise", default="own", choices=["own", "bank"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3200)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--metrics-only", action="store_true")
    ap.add_argument("--export-init")
    ap.add_argument("--dump-draws")
    ap.add_argument("--bank")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    cfg = _cfg(64)
    B = cfg.train.batch_size
    ps = PixelSynth(cfg)
    variables = ps.init_variables(jax.random.PRNGKey(a.seed))
    if a.export_init:
        np.savez(a.export_init, **flat(variables))
        return
    n_layers = sum(k.endswith("gain_kernel") for k in flat(variables["projector"]["params"]))
    if a.dump_draws:
        dump_draws(ps, variables, a, n_layers)
        return
    bank_file = np.load(a.bank, mmap_mode="r") if a.bank else None
    state, tx_g, tx_d = jdpr.create_dpr_state(ps, variables)
    with mock.patch.object(jdpr.jax, "jit", lambda f, **kw: f):
        raw = jdpr.make_dpr_train_step(ps, tx_g, tx_d)

    def banked(state, batch, key, bank):
        _BANK["rows"], _BANK["i"] = bank, 0
        out = raw(state, batch, key)
        assert _BANK["i"] == n_layers, _BANK["i"]
        _BANK["rows"] = None
        return out

    if a.noise == "bank":
        jax_layers.jax = _Jax()
        step_fn = jax.jit(banked)
    else:
        step_fn = jax.jit(raw)
    eval_fn = jdpr.make_dpr_eval_step(ps)
    eval_det = jdpr.make_dpr_eval_step(ps, noise_scale=0.0)
    rng = np.random.default_rng(a.seed)
    fixed = [{k: jnp.asarray(v) for k, v in synthetic_pair_batch(rng, B, cfg.model.W).items()}
             for _ in range(48 // B)]
    key = jax.random.PRNGKey(a.seed + 1)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "dpr.jsonl"), "w") as f:
        t0 = time.time()
        for it in range(a.steps):
            batch = fixed[it % len(fixed)]
            if a.noise == "bank":
                rows = bank_file[it] if bank_file is not None else bank_rows(it, n_layers, B)
                state, m, key = step_fn(state, batch, key, jnp.asarray(np.asarray(rows)))
            else:
                state, m, key = step_fn(state, batch, key)
            if a.metrics_only:
                f.write(json.dumps({"step": it, **{k: float(v) for k, v in m.items()}}) + "\n")
                f.flush()
            if it % a.log_every == 0 or it == a.steps - 1:
                key, sub = jax.random.split(key)    # the tool's key chain
                if a.metrics_only:
                    continue
                ev = [eval_fn(state, b, sub) for b in fixed]
                ed = [eval_det(state, b, sub) for b in fixed]

                def mean(es, k):
                    return float(np.mean([float(e[k]) for e in es]))

                f.write(json.dumps({
                    "step": it, "psnr": mean(ev, "psnr"), "psnr_std": mean(ev, "psnr_std"),
                    "psnr_det": mean(ed, "psnr"), "psnr_std_det": mean(ed, "psnr_std"),
                    "total_loss": float(m["Total Loss"]), "l1": float(m.get("L1", 0.0)),
                    "secs": time.time() - t0}) + "\n")
                f.flush()


if __name__ == "__main__":
    main()
