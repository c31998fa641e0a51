"""Where does the port's stage-2 step part from the JAX package's?  Each
step of the evidence protocol (W=64, batch 8, 48 fixed pairs, seed 0; the
JAX package's init and its own NoiseBN draws, float32 on the CPU) is taken
by both packages from the same state, so that their trajectories cannot
part.  Three commands, run from the root of the repository:

  reference  the JAX package's own run: writes its whole state before
             every step t (parameters, Adam's mu / nu / count, the batch
             and spectral statistics) to DIR/state_<t>.npz;
  compare    for every t, loads state t into the port and into a second
             JAX process, takes one step with each, and counts per leaf
             the elements whose update differs from the reference's (state
             t+1 - state t) by more than lr/2 (lr of the leaf's optimizer).
             With --consume it deletes state t when done (the reference
             waits while more than 6 states are pending);
  swap       one trajectory from the init in which tree TREE (unet,
             projector, pixelcnn, disc: its parameters, Adam moments and
             statistics) takes the port's step and every other tree the
             JAX package's, both from the same state; with --tree none, the
             JAX package's run alone.  Writes the total loss of a
             deterministic (noise 0) JAX eval forward over the 48 pairs at
             step 0 and after the last step.

The JAX processes' thread counts are set by their CPU affinity (XLA sizes
its pool by it):

  JAX_PLATFORMS=cpu taskset -c 0-6 python scripts/dpr_bisect/step_compare.py \\
      reference --steps 113 --dir build/dpr_bisect/states
  JAX_PLATFORMS=cpu taskset -c 5-7 python scripts/dpr_bisect/step_compare.py \\
      compare --steps 112 --dir build/dpr_bisect/states --consume \\
      --out build/dpr_bisect/compare.jsonl

The init and the draws are those of `jax_run.py --export-init` and
`--dump-draws` (runs.sh prepare).
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

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)
import jax_run  # noqa: E402
from pixelsynth_tpu.data.synthetic import synthetic_pair_batch  # noqa: E402
from pixelsynth_tpu.models import layers as jax_layers  # noqa: E402
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth  # noqa: E402
from pixelsynth_tpu.tools.training_evidence import _cfg  # noqa: E402
from pixelsynth_tpu.train import dpr as jdpr  # noqa: E402

G_TREES = ("unet", "projector", "pixelcnn")
TREES = G_TREES + ("disc",)
FIELDS = ("gen_vars", "disc_vars", "opt_g", "opt_d", "step")


class Jax:
    """The JAX package's step with the NoiseBN rows of a bank (jax_run.py's
    mock), from any state given."""

    def __init__(self, init_path, draws_path):
        self.cfg = _cfg(64)
        self.ps = JaxPixelSynth(self.cfg)
        with np.load(init_path) as z:
            from pixelsynth_tpu_torch.weights import unflatten_tree
            self.variables = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(dict(z)))
        self.state, tx_g, tx_d = jdpr.create_dpr_state(self.ps, self.variables)
        self.defs = {f: jax.tree_util.tree_flatten(getattr(self.state, f))[1] for f in FIELDS}
        with mock.patch.object(jdpr.jax, "jit", lambda f, **kw: f):
            raw = jdpr.make_dpr_train_step(self.ps, tx_g, tx_d)

        def banked(state, batch, key, bank):
            jax_run._BANK["rows"], jax_run._BANK["i"] = bank, 0
            out = raw(state, batch, key)
            jax_run._BANK["rows"] = None
            return out

        jax_layers.jax = jax_run._Jax()
        self.step_fn = jax.jit(banked)
        self.eval_det = jdpr.make_dpr_eval_step(self.ps, noise_scale=0.0)
        self.draws = np.load(draws_path, mmap_mode="r")
        rng = np.random.default_rng(0)
        B = self.cfg.train.batch_size
        self.fixed = [{k: jnp.asarray(v) for k, v in
                       synthetic_pair_batch(rng, B, self.cfg.model.W).items()}
                      for _ in range(48 // B)]
        self.lr = {"g": self.cfg.train.lr_g, "d": self.cfg.train.lr_d}

    def step(self, state, t):
        new, metrics, _ = self.step_fn(state, self.fixed[t % len(self.fixed)],
                                       jax.random.PRNGKey(0),
                                       jnp.asarray(np.asarray(self.draws[t])))
        return new, metrics

    def eval_loss(self, state):
        return float(np.mean([float(self.eval_det(state, b, jax.random.PRNGKey(0))["Total Loss"])
                              for b in self.fixed]))

    def save(self, state, path):
        arrays = {}
        for f in FIELDS:
            for i, leaf in enumerate(jax.tree_util.tree_leaves(getattr(state, f))):
                arrays[f"{f}/{i}"] = np.asarray(leaf)
        np.savez(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)

    def load(self, path):
        with np.load(path) as z:
            parts = {}
            for f in FIELDS:
                n = self.defs[f].num_leaves
                parts[f] = jax.tree_util.tree_unflatten(
                    self.defs[f], [jnp.asarray(z[f"{f}/{i}"]) for i in range(n)])
        return jdpr.DPRTrainState(frozen_vars=self.state.frozen_vars, **parts)


def adam_of(opt):
    """The ScaleByAdamState inside optax.adam's chain state."""
    return opt[0]


class Port:
    """The port's trainer on the CPU, loadable from and readable as a JAX
    state; its NoiseBN draws are the bank's rows."""

    def __init__(self, jx: Jax, threads: int):
        import torch

        from pixelsynth_tpu_torch.config import Config
        from pixelsynth_tpu_torch.models import layers as L
        from pixelsynth_tpu_torch.pipeline import PixelSynth, build_modules, build_pixelcnn
        from pixelsynth_tpu_torch.train.dpr import create_dpr_state, make_dpr_train_step
        from pixelsynth_tpu_torch.weights import from_jax_params

        torch.set_num_threads(threads)
        self.torch, self.jx = torch, jx
        self.cfg = Config.from_json(jx.cfg.to_json())
        self.ps = PixelSynth(self.cfg, device="cpu", trainable=True,
                             state_dicts=from_jax_params(jx.variables, self.cfg, trainable=True))
        self.state = create_dpr_state(self.ps)
        self.step_fn = make_dpr_train_step(self.ps, self.state)
        self.rows = []
        forward = L.NoiseBN.forward
        rows = self.rows

        def bank_forward(m, x, *, noise_scale=1.0, gen=None, noise=None):
            if noise is None and noise_scale != 0.0:
                noise = rows.pop(0).to(x)
            return forward(m, x, noise_scale=noise_scale, gen=gen, noise=noise)

        L.NoiseBN.forward = bank_forward
        mods = build_modules(self.cfg, trainable=True)
        self.scratch = {t: (build_pixelcnn(self.cfg, trainable=True) if t == "pixelcnn"
                            else mods[t]) for t in TREES}
        self.batches = [{k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}
                        for b in jx.fixed]

    def _layout(self, tree, variables, params):
        """A JAX params tree (params, or Adam's moments of them) in the
        port's {name: tensor} layout."""
        from pixelsynth_tpu_torch.weights import merge_collections

        m = self.scratch[tree]
        with self.torch.no_grad():
            m.load_flax(merge_collections({**variables, "params": params}))
        return {n: p.detach().clone() for n, p in m.named_parameters()}

    def _to_jax(self, tree, named):
        """{name: tensor} of a tree's parameters -> its JAX params tree."""
        from pixelsynth_tpu_torch.weights import split_collections

        m = self.scratch[tree]
        with self.torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(named[n])
        return jax.tree_util.tree_map(jnp.asarray, split_collections(m.to_flax())["params"])

    def load(self, js):
        """The whole JAX state js (parameters, statistics, Adam's state)."""
        from pixelsynth_tpu_torch.weights import merge_collections

        torch, ps = self.torch, self.ps
        with torch.no_grad():
            for t in G_TREES:
                getattr(ps, t).load_flax(merge_collections(js.gen_vars[t]))
            ps.disc.load_flax(merge_collections(js.disc_vars))
        for tx, opt, trees in ((self.state.tx_g, js.opt_g, G_TREES),
                               (self.state.tx_d, js.opt_d, ("disc",))):
            adam = adam_of(opt)
            count = int(adam.count)
            tx.count = count
            tx.opt.state.clear()
            if count == 0:
                continue
            for t in trees:
                var = js.disc_vars if t == "disc" else js.gen_vars[t]
                mu = adam.mu if t == "disc" else adam.mu[t]
                nu = adam.nu if t == "disc" else adam.nu[t]
                mu, nu = self._layout(t, var, mu), self._layout(t, var, nu)
                for n, p in getattr(ps, t).named_parameters():
                    tx.opt.state[p] = {"step": torch.tensor(float(count)),
                                       "exp_avg": mu[n].clone(), "exp_avg_sq": nu[n].clone()}

    def params(self, tree):
        return {n: p.detach().clone() for n, p in getattr(self.ps, tree).named_parameters()}

    def step(self, t):
        self.rows.extend(self.torch.as_tensor(np.array(r)) for r in self.jx.draws[t])
        m = self.step_fn(self.batches[t % len(self.batches)], self.torch.Generator())
        assert not self.rows
        return m

    def tree_state(self, tree):
        """The JAX layout of one tree after a step: (vars with params and
        statistics, Adam's mu, Adam's nu)."""
        from pixelsynth_tpu_torch.weights import split_collections

        mod = getattr(self.ps, tree)
        var = jax.tree_util.tree_map(jnp.asarray, split_collections(mod.to_flax()))
        tx = self.state.tx_d if tree == "disc" else self.state.tx_g
        mu = self._to_jax(tree, {n: tx.opt.state[p]["exp_avg"] for n, p in mod.named_parameters()})
        nu = self._to_jax(tree, {n: tx.opt.state[p]["exp_avg_sq"]
                                 for n, p in mod.named_parameters()})
        return var, mu, nu


def _params(js, tree):
    return js.disc_vars["params"] if tree == "disc" else js.gen_vars[tree]["params"]


def _vars(js, tree):
    return js.disc_vars if tree == "disc" else js.gen_vars[tree]


def _sub(a, b):
    return jax.tree_util.tree_map(lambda x, y: np.asarray(x) - np.asarray(y), a, b)


def counts(port, js, ref, other, lr):
    """{tree: [n elements whose update differs by more than lr/2, n
    elements]} of `other` ({tree: JAX update tree, or the port's {name:
    tensor}}) against `ref` ({tree: JAX update tree})."""
    out = {}
    for t in TREES:
        want = port._layout(t, _vars(js, t), ref[t])
        got = other[t]
        if not all(hasattr(v, "numpy") for v in jax.tree_util.tree_leaves(got)):
            got = port._layout(t, _vars(js, t), got)
        half = lr["d" if t == "disc" else "g"] / 2
        n = sum(int((np.abs(got[k].numpy() - want[k].numpy()) > half).sum()) for k in want)
        out[t] = [n, sum(int(v.numel()) for v in want.values())]
    return out


def cmd_reference(a):
    jx = Jax(a.init, a.draws)
    os.makedirs(a.dir, exist_ok=True)
    st = jx.state
    for t in range(a.steps + 1):
        while len([f for f in os.listdir(a.dir) if f.startswith("state_")]) > 6:
            time.sleep(2)
        jx.save(st, os.path.join(a.dir, f"state_{t}.npz"))
        if t < a.steps:
            st, m = jx.step(st, t)
            print(t, float(m["L1"]), flush=True)


def _wait(path):
    while not os.path.exists(path):
        time.sleep(1)
    return path


def cmd_compare(a):
    jx = Jax(a.init, a.draws)
    port = Port(jx, a.threads)
    with open(a.out, "a") as f:
        for t in range(a.start, a.steps):
            s0 = jx.load(_wait(os.path.join(a.dir, f"state_{t}.npz")))
            s1 = jx.load(_wait(os.path.join(a.dir, f"state_{t + 1}.npz")))
            ref = {tr: _sub(_params(s1, tr), _params(s0, tr)) for tr in TREES}
            j2, jm = jx.step(s0, t)
            other = {tr: _sub(_params(j2, tr), _params(s0, tr)) for tr in TREES}
            port.load(s0)
            before = {tr: port.params(tr) for tr in TREES}
            pm = port.step(t)
            pupd = {tr: {k: v - before[tr][k] for k, v in port.params(tr).items()}
                    for tr in TREES}
            rec = {"step": t, "jax_vs_jax": counts(port, s0, ref, other, jx.lr),
                   "port_vs_jax": counts(port, s0, ref, pupd, jx.lr),
                   "L1": {"jax": float(jm["L1"]), "port": float(pm["L1"])},
                   "G_total": {"jax": float(jm["G_total"]), "port": float(pm["G_total"])}}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec), flush=True)
            if a.consume:
                os.remove(os.path.join(a.dir, f"state_{t}.npz"))


def cmd_swap(a):
    jx = Jax(a.init, a.draws)
    port = Port(jx, a.threads) if a.tree != "none" else None
    st = jx.state
    first = jx.eval_loss(st)
    t0 = time.time()
    for t in range(a.steps):
        new, m = jx.step(st, t)
        if port is not None:
            port.load(st)
            port.step(t)
            var, mu, nu = port.tree_state(a.tree)
            if a.tree == "disc":
                opt = adam_of(new.opt_d)._replace(mu=mu, nu=nu)
                new = jdpr.DPRTrainState(
                    gen_vars=new.gen_vars, disc_vars={**new.disc_vars, **var},
                    frozen_vars=new.frozen_vars, opt_g=new.opt_g,
                    opt_d=(opt,) + tuple(new.opt_d[1:]), step=new.step)
            else:
                ad = adam_of(new.opt_g)
                opt = ad._replace(mu={**ad.mu, a.tree: mu}, nu={**ad.nu, a.tree: nu})
                new = jdpr.DPRTrainState(
                    gen_vars={**new.gen_vars, a.tree: {**new.gen_vars[a.tree], **var}},
                    disc_vars=new.disc_vars, frozen_vars=new.frozen_vars,
                    opt_g=(opt,) + tuple(new.opt_g[1:]), opt_d=new.opt_d, step=new.step)
        st = new
        if t % 10 == 0:
            print(a.tree, t, float(m["L1"]), f"{time.time() - t0:.0f}s", flush=True)
    last = jx.eval_loss(st)
    rec = {"tree": a.tree, "steps": a.steps, "eval_total_loss_first": first,
           "eval_total_loss_last": last, "fall": first - last}
    with open(a.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["reference", "compare", "swap"])
    ap.add_argument("--init", default="build/dpr_bisect/jax_init_s0.npz")
    ap.add_argument("--draws", default="build/dpr_bisect/jax_draws_s0.npy")
    ap.add_argument("--dir", default="build/dpr_bisect/states")
    ap.add_argument("--steps", type=int, default=112)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--tree", default="none", choices=("none",) + TREES)
    ap.add_argument("--consume", action="store_true")
    ap.add_argument("--out", default="build/dpr_bisect/compare.jsonl")
    a = ap.parse_args(argv)
    {"reference": cmd_reference, "compare": cmd_compare, "swap": cmd_swap}[a.command](a)


if __name__ == "__main__":
    main()
