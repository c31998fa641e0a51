"""Each trainer's step on two devices side by side, in float64, leaf by
leaf: the check that the card computes the gradients the CPU computes.

For each of the four networks the relay chain trains (stage 1
`train/vqvae.py`, stage 2 `train/dpr.py` G+D, stage 3 `train/lmconv.py`,
the scene classifier `tools/train_scene_classifier.py`) one float64 state
is made from a seed, copied to both devices, and stepped `steps` times on
the same batches, with the same NoiseBN rows (a CPU generator: NoiseBN
draws on its generator's device, then moves the rows).  After every step
each gradient the optimizer was given, each parameter, Adam's two moments
and step, and each buffer (batch statistics, spectral vectors, the
codebooks' EMA, stage 3's EMA parameters) on the first device is held
against the second's; then the first takes the second's state, so that
the next step starts both from one carried state (`compare_trainer`
says why).

The bound is `BOUND` of each leaf's largest value.  A parameter whose
gradient's largest value is below `ROUNDING` of its tree's largest
gradient has a gradient that is zero in exact arithmetic, float64
rounding alone (the bias of a conv that a BatchNorm follows): its
gradient, value, moments and EMA are held to the same bound of their
tree's largest value of that kind instead, and the record names it.
Integer and boolean leaves must be equal.

In float64 the kernels take their plain versions on both devices (K2's
plain blend; stage 3 and stage 2's PixelCNN on train_backend "xla"); the
order kernel runs on the card, on integer distances.  Any leaf far above
rounding names an operation whose CUDA result differs from its CPU one:
the fault of CUDA's `avg_pool2d` backward on channels-last strides was
found this way (models/layers.py `avg_pool`).

  from pixelsynth_tpu_torch.train.card_vs_cpu import compare_trainer
  compare_trainer("classifier", ("cuda", "cpu"))   # -> {"ok": ..., ...}
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TRAINERS = ("vqvae", "dpr", "lmconv", "classifier")
BOUND = 1e-9
ROUNDING = 1e-12

Leaves = Dict[str, Dict[str, Dict[str, torch.Tensor]]]   # kind -> tree -> name -> t


@contextlib.contextmanager
def plain_k2():
    """K2's launcher rebound to its plain version inside the block (the
    kernel blends float32 and bfloat16 features only)."""
    from pixelsynth_tpu_torch.ops import splat

    saved = splat.blend_slots_kernel
    splat.blend_slots_kernel = splat.blend_slots_plain
    try:
        yield
    finally:
        splat.blend_slots_kernel = saved


def _adam_leaves(opt: torch.optim.Optimizer, named: Dict[str, torch.Tensor]) -> Dict:
    out: Dict[str, Dict[str, torch.Tensor]] = {"exp_avg": {}, "exp_avg_sq": {},
                                               "adam_step": {}}
    for name, p in named.items():
        st = opt.state.get(p, {})
        for k, kind in (("exp_avg", "exp_avg"), ("exp_avg_sq", "exp_avg_sq"),
                        ("step", "adam_step")):
            if k in st:
                out[kind][name] = torch.as_tensor(st[k])
    return out


def _spy(adam, seen: Dict, key: str):
    """Record the gradients handed to a train/dpr.py `Adam`."""
    update = adam.update

    def spy(grads):
        seen[key] = [g.detach().clone() for g in grads]
        return update(grads)

    adam.update = spy


class _Side:
    """One device's trainer: `step(t)` takes step t and returns its
    metrics, `leaves()` the state after it."""

    def __init__(self, step: Callable[[int], Dict], leaves: Callable[[], Leaves]):
        self.step, self.leaves = step, leaves


# ---------------------------------------------------------------------------
# the four trainers at small widths: each (seed, width) -> make(device),
# which copies one seeded float64 state to that device
# ---------------------------------------------------------------------------


def _vqvae_side(seed: int, width: int) -> Callable[..., _Side]:
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.pipeline import build_vqvae
    from pixelsynth_tpu_torch.train.dpr import Adam
    from pixelsynth_tpu_torch.train.vqvae import (
        VQTrainState, create_vqvae_state, make_vqvae_train_step,
    )

    cfg = Config()
    v = cfg.model.vqvae
    v.channel, v.n_res_channel, v.n_embed = 16, 8, 64
    rng = np.random.default_rng(seed)
    imgs = [rng.uniform(-1, 1, (2, width, width, 3)) for _ in range(4)]
    ref = build_vqvae(cfg).double()
    create_vqvae_state(ref, torch.Generator().manual_seed(seed), init_batch=imgs[0])

    def make(dev):
        model = copy.deepcopy(ref).to(dev)
        state = VQTrainState(model, Adam(model.parameters(), 3e-4, (0.9, 0.999)))
        seen: Dict = {}
        _spy(state.opt, seen, "g")
        step = make_vqvae_train_step(model, state)
        named = dict(model.named_parameters())

        def leaves():
            return {"grads": {"vqvae": dict(zip(named, seen.get("g", [])))},
                    "params": {"vqvae": named},
                    "stats": {"vqvae": dict(model.named_buffers())},
                    **{k: {"vqvae": v} for k, v in _adam_leaves(state.opt.opt,
                                                                 named).items()}}

        return _Side(lambda t: step(torch.as_tensor(imgs[t % len(imgs)], device=dev)),
                     leaves)

    return make


def _dpr_cfg(width: int):
    from pixelsynth_tpu_torch.config import Config

    cfg = Config()
    cfg.dataset = "synthetic"
    cfg.model.W = width
    cfg.model.unet_num_filters = 4
    cfg.model.ngf = 8
    cfg.model.ndf = 8
    cfg.model.vqvae.channel = 16
    cfg.model.vqvae.n_res_channel = 8
    cfg.model.lmconv.nr_filters = 16
    cfg.model.lmconv.obs = (3, width // 8, width // 8)
    cfg.model.splat.max_points_per_tile = 1024
    cfg.model.splat.tile_group = 4
    cfg.model.train_depth = True          # the relay's stage 2 (run_relay.py)
    cfg.train.batch_size = 2
    return cfg


def _dpr_side(seed: int, width: int) -> Callable[..., _Side]:
    from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.train.dpr import (
        TRAINABLE, create_dpr_state, make_dpr_train_step,
    )

    cfg = _dpr_cfg(width)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(3):
        b = synthetic_pair_batch(rng, cfg.train.batch_size, width)
        b["depth_img"] = rng.uniform(1.0, 4.0, (cfg.train.batch_size, width, width))
        batches.append({k: torch.as_tensor(np.asarray(x, np.float64)) for k, x in b.items()})
    trees = TRAINABLE + ("disc",)

    def make(dev):
        ps = PixelSynth(cfg, device=dev, seed=seed, trainable=True)
        for tree in ps.trees:
            getattr(ps, tree).double()
        state = create_dpr_state(ps)
        seen: Dict = {}
        _spy(state.tx_g, seen, "g")
        _spy(state.tx_d, seen, "d")
        step = make_dpr_train_step(ps, state)
        gen = torch.Generator().manual_seed(seed + 1)    # the NoiseBN rows, on the CPU

        def leaves():
            out: Leaves = {"grads": {}, "params": {}, "stats": {}}
            off = 0
            for tree in trees:
                named = dict(getattr(ps, tree).named_parameters())
                if tree == "disc":
                    g = seen.get("d", [])
                else:
                    g = seen.get("g", [])[off:off + len(named)]
                    off += len(named)
                out["grads"][tree] = dict(zip(named, g))
                out["params"][tree] = named
                out["stats"][tree] = dict(getattr(ps, tree).named_buffers())
                opt = (state.tx_d if tree == "disc" else state.tx_g).opt
                for k, v in _adam_leaves(opt, named).items():
                    out.setdefault(k, {})[tree] = v
            return out

        def run(t):
            with plain_k2():
                return step({k: v.to(dev) for k, v in batches[t % len(batches)].items()},
                            gen)

        return _Side(run, leaves)

    return make


def _lmconv_side(seed: int, width: int) -> Callable[..., _Side]:
    from pixelsynth_tpu_torch.ops.orders import (
        augment_orders, masks_for_orders_batch, s_curve_order,
    )
    from pixelsynth_tpu_torch.pipeline import build_pixelcnn
    from pixelsynth_tpu_torch.train.lmconv import create_lmconv_state, make_lmconv_train_step

    cfg = _dpr_cfg(width)
    l = cfg.model.lmconv
    rows, cols = l.obs[1], l.obs[2]
    rng = np.random.default_rng(seed)
    orders = augment_orders(s_curve_order(rows, cols), rows, cols)
    batches = []
    for _ in range(3):
        pick = rng.choice(len(orders), 2, replace=False)
        a, b, d = masks_for_orders_batch([orders[i] for i in pick], rows, cols,
                                         l.kernel_size, l.max_dilation)
        batches.append((torch.as_tensor(rng.integers(0, l.num_classes, (2, rows, cols))),
                        torch.as_tensor(np.stack([a, b, d], 1))))
    ref = build_pixelcnn(cfg, trainable=True)
    with torch.no_grad():
        ref.reset(torch.Generator().manual_seed(seed))
    ref.double()

    def make(dev):
        model = copy.deepcopy(ref).to(dev)
        # a clip that binds, so that its branch is the one compared
        state = create_lmconv_state(model, None, clip=0.05, ema_decay=0.9995)
        seen: Dict = {}
        _spy(state.opt, seen, "g")
        step = make_lmconv_train_step(model, state)
        named = dict(model.named_parameters())

        def leaves():
            return {"grads": {"pixelcnn": dict(zip(named, seen.get("g", [])))},
                    "params": {"pixelcnn": named},
                    "ema": {"pixelcnn": dict(zip(named, state.ema_params))},
                    "stats": {"pixelcnn": dict(model.named_buffers())},
                    **{k: {"pixelcnn": v} for k, v in _adam_leaves(state.opt.opt,
                                                                   named).items()}}

        def run(t):
            codes, masks = batches[t % len(batches)]
            return step(codes.to(dev), masks.to(dev))

        return _Side(run, leaves)

    return make


def _classifier_side(seed: int, width: int) -> Callable[..., _Side]:
    from pixelsynth_tpu_torch.models.classifier import ResNet18
    from pixelsynth_tpu_torch.tools.train_scene_classifier import make_optimizer, train_step

    n_cls = 8
    rng = np.random.default_rng(seed)
    batches = [(torch.as_tensor(rng.uniform(-1, 1, (4, width, width, 3))),
                torch.as_tensor(rng.integers(0, n_cls, 4))) for _ in range(3)]
    ref = ResNet18(num_classes=n_cls)
    with torch.no_grad():
        ref.reset(torch.Generator().manual_seed(seed))
    ref.double()

    def make(dev):
        model = copy.deepcopy(ref).to(dev)
        opt = make_optimizer(model)
        named = dict(model.named_parameters())

        def leaves():
            return {"grads": {"classifier": {k: p.grad for k, p in named.items()}},
                    "params": {"classifier": named},
                    "stats": {"classifier": dict(model.named_buffers())},
                    **{k: {"classifier": v} for k, v in _adam_leaves(opt, named).items()}}

        def run(t):
            imgs, labels = batches[t % len(batches)]
            ce, acc = train_step(model, opt, imgs.to(dev), labels.to(dev))
            return {"ce": ce, "accuracy": acc}

        return _Side(run, leaves)

    return make


SIDES = {"vqvae": _vqvae_side, "dpr": _dpr_side, "lmconv": _lmconv_side,
         "classifier": _classifier_side}
WIDTHS = {"vqvae": 32, "dpr": 32, "lmconv": 32, "classifier": 64}


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def _leaf_diff(a: torch.Tensor, b: torch.Tensor) -> Tuple[float, float]:
    """(largest difference, largest value of the two) of one leaf, or
    (mismatches, 0.0) for an integer or boolean one."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape:
        return float("inf"), 0.0
    if not (a.is_floating_point() and b.is_floating_point()):
        return float((a != b).sum()), 0.0
    if not a.numel():
        return 0.0, 0.0
    a, b = a.double(), b.double()
    return _abs_max(a - b), max(_abs_max(a), _abs_max(b))


def _abs_max(x: torch.Tensor) -> float:
    lo, hi = torch.aminmax(x)
    return max(-float(lo), float(hi), 0.0) + 0.0   # no -0.0


def _rounding_leaves(want: Leaves) -> Dict[str, set]:
    """{tree: names} of the parameters whose gradient is float64 rounding
    alone: largest value below `ROUNDING` of the tree's largest gradient."""
    out = {}
    for tree, grads in want.get("grads", {}).items():
        tops = {k: _abs_max(g.detach().cpu().double()) if g.numel() else 0.0
                for k, g in grads.items()}
        top = max(tops.values(), default=0.0)
        out[tree] = {k for k, m in tops.items() if m < ROUNDING * top}
    return out


def compare_leaves(got: Leaves, want: Leaves) -> Dict:
    """Every leaf of `got` against `want` -> {kind: {tree: [worst relative
    difference, its leaf]}}, the leaves held as rounding alone
    ({kind: {tree: [names]}}) and whether every leaf keeps the bound."""
    worst: Dict = {}
    rounding: Dict = {}
    ok = True
    alone = _rounding_leaves(want)
    for kind, trees in want.items():
        for tree, leaves in trees.items():
            other = got.get(kind, {}).get(tree, {})
            if set(other) != set(leaves):
                ok = False
                worst.setdefault(kind, {})[tree] = [float("inf"), "leaf sets differ"]
                continue
            diffs = {k: _leaf_diff(other[k], leaves[k]) for k in leaves}
            top = max((m for _, m in diffs.values()), default=0.0)
            w = [0.0, ""]
            for k, (err, m) in diffs.items():
                exact = not leaves[k].is_floating_point()
                if exact:
                    rel = err
                elif k in alone.get(tree, ()):
                    rounding.setdefault(kind, {}).setdefault(tree, []).append(k)
                    rel = err / top if top else err
                else:
                    rel = err / m if m else err
                if (exact and rel != 0) or (not exact and not rel <= BOUND):
                    ok = False
                if rel > w[0] or not w[1]:
                    w = [rel, k]
            worst.setdefault(kind, {})[tree] = w
    return {"worst": worst, "rounding": rounding, "ok": ok}


@torch.no_grad()
def _take_state(dst: _Side, src: _Side):
    """Every carried leaf of `src` (parameters, buffers, Adam's moments and
    step, EMA parameters) copied into `dst`'s, in place."""
    theirs = src.leaves()
    for kind, trees in dst.leaves().items():
        if kind == "grads":
            continue
        for tree, leaves in trees.items():
            for k, t in leaves.items():
                t.copy_(theirs[kind][tree][k])


def compare_sides(sides: Sequence[_Side], steps: int, resync: bool = True) -> Dict:
    """`steps` steps of two trainers side by side, sides[0]'s state held to
    sides[1]'s after each -> {"steps": [per-step compare_leaves records
    with the metrics' relative differences], "worst": the worst leaf of
    each kind and tree over every step, "ok"}.  With `resync` sides[0]
    takes sides[1]'s state before each next step (`compare_trainer`)."""
    records = []
    worst: Dict = {}
    ok = True
    for t in range(steps):
        metrics = [{k: float(v) for k, v in s.step(t).items()} for s in sides]
        rec = compare_leaves(sides[0].leaves(), sides[1].leaves())
        rec["step"] = t
        rec["metrics"] = {k: abs(metrics[0][k] - w) / max(abs(w), 1e-300)
                          for k, w in metrics[1].items()}
        ok = ok and rec["ok"]
        for kind, trees in rec["worst"].items():
            for tree, w in trees.items():
                cur = worst.setdefault(kind, {}).get(tree)
                if cur is None or w[0] > cur[0]:
                    worst[kind][tree] = w + [t]
        records.append(rec)
        if resync and t + 1 < steps:
            _take_state(sides[0], sides[1])
    return {"steps": records, "worst": worst, "ok": ok}


def compare_trainer(name: str, devices: Sequence = ("cuda", "cpu"), *, steps: int = 3,
                    width: Optional[int] = None, resync: bool = True) -> Dict:
    """`steps` carried float64 steps of trainer `name` on devices[0] beside
    devices[1], from one state made from seed 0 (`compare_sides`' record
    with the trainer, the devices and the bounds).

    With `resync` each step starts both devices from devices[1]'s carried
    state (its state after the step before is copied into devices[0]'s), so
    that each step is held to one step's rounding; without it each device
    carries its own state, and Adam's division by |g| + eps, which turns a
    rounding difference in a gradient near eps into lr / (4 eps) times it
    in the update, compounds from step to step."""
    make = SIDES[name](0, width or WIDTHS[name])
    got = compare_sides([make(dev) for dev in devices], steps, resync)
    return {"trainer": name, "devices": [str(d) for d in devices], "resync": resync,
            "bound": BOUND, "rounding": ROUNDING, **got}
