"""The relay walk of the port against the JAX package's, in what a test can
hold at tiny size: both packages read the relay artifact's config alike;
both speculative samplers at the walk's settings (spec 12, T = 0.7) draw
each cell of each candidate from softmax(logits / T), independently
across the population's rows, and hit the joint of a Markov chain whose
drafts are rejected; and the committed records of
scripts/walk_parity/ (evidence/torch/walk_parity/) meet the decision rule
they state, name the argmax walk's first departure, and name the view
and the draw that carry a port artifact's low walk seeds.  Only the
config's JSON is read from the artifact."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.sampling import ar_sample_speculative as jax_speculative
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.sampling import ar_sample_speculative
from torch_threads import _few_torch_threads  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARTIFACT = os.path.join(REPO, "evidence", "relay", "stitched.npz")
RECORDS = os.path.join(REPO, "evidence", "torch", "walk_parity")

SPEC, T = 12, 0.7
ROWS, HW, C = 2048, 16, 5       # population rows, cells (4 x 4), classes
P_MIN = 1e-4                    # a fixed seed: no flake, a fault far below


def test_both_packages_read_the_artifacts_config_alike():
    with np.load(ARTIFACT) as z:
        text = bytes(z["__config__"]).decode()
    jcfg, cfg = JaxConfig.from_json(text), Config.from_json(text)
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    jcfg.refresh_splat_perf_knobs()
    cfg.refresh_splat_perf_knobs()
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    s = cfg.sample
    assert (s.num_samples, s.temperature, s.noise_mode, s.carry, s.speculative,
            s.num_split) == (8, 0.7, "fixed", "composite", 12, 8)


def _raster(rows):
    yy, xx = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    order = np.stack([yy.ravel(), xx.ravel()], -1)
    return np.broadcast_to(order, (rows, HW, 2)).copy()


def _logits(rng, shape):
    """Logits whose softmax at T puts at least 0.1 on every class (so every
    bin of the chi^2 tables below expects >= 10 counts): T * log(p) with
    p = 0.1 + 0.5 * Dirichlet(1)."""
    p = 0.1 + 0.5 * rng.dirichlet(np.ones(C), size=shape)
    return (T * np.log(p)).astype(np.float32)


def _fixed_table(seed=3):
    return _logits(np.random.default_rng(seed), HW)


def _chain_tables(seed=5):
    """Cell 0 from l0; cell k > 0 from M[k, code of cell k-1] (raster order =
    generation order), so a draft drawn from a stale context is rejected
    where its predecessor changed."""
    rng = np.random.default_rng(seed)
    return _logits(rng, ()), _logits(rng, (HW, C))


def _port_draws(at_fn, seed):
    fn = lambda cur, filled: (_ for _ in ()).throw(AssertionError("no full grid"))  # noqa
    fn.at = at_fn
    out = ar_sample_speculative(
        fn, torch.zeros((ROWS, 4, 4), dtype=torch.long), torch.as_tensor(_raster(ROWS)),
        torch.ones((ROWS, 4, 4)), torch.Generator().manual_seed(seed), num_classes=C,
        temperature=T, spec=SPEC)
    return out.reshape(ROWS, HW).numpy()


def _jax_draws(at_fn, seed):
    def fn(cur, filled):
        raise AssertionError("no full grid")

    fn.at = at_fn
    run = jax.jit(lambda key: jax_speculative(
        fn, jnp.zeros((ROWS, 4, 4), jnp.int32), jnp.asarray(_raster(ROWS)),
        jnp.ones((ROWS, 4, 4)), key, num_classes=C, temperature=T, spec=SPEC))
    return np.asarray(run(jax.random.PRNGKey(seed))).reshape(ROWS, HW)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _gof(counts, probs):
    """Pearson chi^2 of counts against probs over independent cells ->
    p-value (the statistics and degrees of freedom summed)."""
    chi, dof = 0.0, 0
    for n, p in zip(counts, probs):
        want = p * n.sum()
        chi += float(((n - want) ** 2 / want).sum())
        dof += len(p) - 1
    return stats.chi2.sf(chi, dof)


def _independence(a, b):
    """chi^2 test of independence of two paired code arrays -> p-value."""
    table = np.zeros((C, C))
    np.add.at(table, (a, b), 1)
    table = table[table.sum(1) > 0][:, table.sum(0) > 0]
    return stats.chi2_contingency(table, correction=False)[1]


def _counts(draws):
    return [np.bincount(draws[:, k], minlength=C) for k in range(HW)]


@pytest.mark.parametrize("side", ["port", "jax"])
def test_speculative_draws_each_cell_from_softmax_independently_across_rows(side):
    """Context-free logits: every cell of every row is one draw from
    softmax(L[cell] / T), and rows do not share draws (the population's
    candidates are independent: row r against row r + 1, and the first
    half of the rows against the second)."""
    L = _fixed_table()
    if side == "port":
        t = torch.as_tensor(L)
        draws = _port_draws(lambda cur, filled, pos: t[pos], seed=11)
    else:
        t = jnp.asarray(L)
        draws = _jax_draws(lambda cur, filled, pos: t[pos], seed=11)
    assert _gof(_counts(draws), _softmax(L / T)) > P_MIN
    for k in (0, 7, 15):
        assert _independence(draws[:-1:2, k], draws[1::2, k]) > P_MIN, k
        assert _independence(draws[:ROWS // 2, k], draws[ROWS // 2:, k]) > P_MIN, k
    # and the cells of one row are independent of each other
    assert _independence(draws[:, 0], draws[:, 13]) > P_MIN


@pytest.mark.parametrize("side", ["port", "jax"])
def test_speculative_hits_a_markov_chains_joint(side):
    """Logits that depend on the previous cell's code (drafts go stale and
    are rejected): each cell's marginal is the chain's, and each pair
    (cell k-1, cell k) follows p(k-1) * softmax(M[k, x] / T)."""
    l0, M = _chain_tables()
    if side == "port":
        tl0, tM = torch.as_tensor(l0), torch.as_tensor(M)

        def at(cur, filled, pos):
            c, f = cur.reshape(ROWS, HW), filled.reshape(ROWS, HW)
            prev = torch.clamp(pos - 1, min=0)
            pc, pf = torch.gather(c, 1, prev), torch.gather(f, 1, prev)
            rows = tM[pos, pc]
            return torch.where(((pos > 0) & (pf > 0))[..., None], rows, tl0)

        draws = _port_draws(at, seed=12)
    else:
        tl0, tM = jnp.asarray(l0), jnp.asarray(M)

        def at(cur, filled, pos):
            c, f = cur.reshape(ROWS, HW), filled.reshape(ROWS, HW)
            prev = jnp.maximum(pos - 1, 0)
            pc = jnp.take_along_axis(c, prev, 1)
            pf = jnp.take_along_axis(f, prev, 1)
            rows = tM[pos, pc]
            return jnp.where(((pos > 0) & (pf > 0))[..., None], rows, tl0)

        draws = _jax_draws(at, seed=12)
    marg = [_softmax(l0 / T)]
    cond = [None] + [_softmax(M[k] / T) for k in range(1, HW)]
    for k in range(1, HW):
        marg.append(marg[-1] @ cond[k])
    assert _gof(_counts(draws), marg) > P_MIN
    pairs, probs = [], []
    for k in range(1, HW):
        n = np.zeros((C, C))
        np.add.at(n, (draws[:, k - 1], draws[:, k]), 1)
        pairs.append(n.ravel())
        probs.append((marg[k - 1][:, None] * cond[k]).ravel())
    assert _gof(pairs, probs) > P_MIN


def _record(name):
    path = os.path.join(RECORDS, name)
    if not os.path.exists(path):
        pytest.fail(f"{path} missing")
    with open(path) as f:
        return json.load(f)


def _summary(rows, k):
    v = np.array([r[k] for r in rows], np.float64)
    return v.mean(), v.std(ddof=1), len(v)


@pytest.mark.parametrize("jax_name,port_name,decision_in", [
    ("jax_cpu_spread.json", "port_card_spread.json", "port"),
    ("jax_cpu_noise_zero.json", "factor_noise_zero.json", "jax"),
])
def test_walk_parity_records_meet_their_decision_rule(jax_name, port_name, decision_in):
    """JAX's 8 seeds on the CPU and the port's on the card, on the same
    artifact and settings (the artifact's own; and with zero decoder
    noise): each record's summary is its rows', and for scene_gt_psnr and
    adjacency the means differ by no more than
    2 * sqrt(sd_jax^2 / 8 + sd_port^2 / 8), the rule the records state."""
    jax_rec, port_rec = _record(jax_name), _record(port_name)
    det = _record("deterministic.json")
    assert jax_rec["sha256"] == port_rec["sha256"] == det["sha256"]
    assert jax_rec["settings"] == port_rec["settings"]
    assert port_rec["card"].startswith("NVIDIA H100") and port_rec["tf32"] is False
    assert [r["seed"] for r in jax_rec["rows"]] == list(range(8))
    assert [r["seed"] for r in port_rec["rows"]] == list(range(8))
    for r in jax_rec["rows"] + port_rec["rows"]:
        assert len(r["views"]) == 40 and len(r["steps"]) == 82
    decision = (port_rec if decision_in == "port" else jax_rec)["decision"]
    for k in ("gt", "adjacent"):
        mj, sj, nj = _summary(jax_rec["rows"], k)
        mp, sp, n_p = _summary(port_rec["rows"], k)
        assert abs(jax_rec["summary"][k]["mean"] - mj) < 1e-9
        assert abs(port_rec["summary"][k]["mean"] - mp) < 1e-9
        band = 2.0 * math.sqrt(sj ** 2 / nj + sp ** 2 / n_p)
        assert abs(decision[k]["band"] - band) < 1e-9
        assert abs(decision[k]["port_minus_jax"] - (mp - mj)) < 1e-9
        assert not decision[k]["gap_is_real"] and abs(mp - mj) <= band, (k, mp - mj, band)


def test_deterministic_walk_record_names_its_departure():
    """The argmax walk of both packages on the artifact: 82 views each way,
    and the first departure beyond float noise named (or none)."""
    det = _record("deterministic.json")
    assert det["settings"]["views"] == 82 == len(det["forced"]) == len(det["free"])
    assert det["settings"]["temperature"] == 1e-4
    assert det["settings"]["noise_mode"] == "zero" and det["settings"]["num_samples"] == 8
    assert det["input_equal"]
    first = next((r for r in det["forced"] if r["first_stage"] is not None), None)
    want = ("none beyond float noise" if first is None else
            {"view": first["view"], "stage": first["first_stage"]})
    assert det["first_departure"] == want


def test_collapse_record_names_the_first_view_and_the_draw():
    """The low walk seeds of a port-trained artifact (scripts/walk_parity/
    collapse.py): every walk scored as the relay gate scores it, and the
    record's finding -- each low seed's first view in walk order more than
    drop_db below seed 0's, and which draw the noise-swap walks follow --
    recomputed from its own per-view rows."""
    with open(os.path.join(RECORDS, "collapse", "collapse.json")) as f:
        rec = json.load(f)
    assert rec["card"].startswith("NVIDIA H100") and rec["noise_mode"] == "fixed"
    walks, fin = rec["walks"], rec["finding"]
    for name, w in walks.items():
        assert len(w["views"]) == 40 and len(w["view_gt"]) == 48 and len(w["steps"]) == 82
        adj = [v["adjacent"] for v in w["views"] if v["adjacent"] is not None]
        assert abs(w["adjacent"] - np.mean(adj)) < 1e-9
        assert abs(w["gt"] - np.mean([v["gt"] for v in w["views"]])) < 1e-9
        assert os.path.exists(os.path.join(RECORDS, "collapse", f"strip_{name}.png"))
    base = walks[fin["base"]]
    order = [v["view"] for v in base["view_gt"]]
    for name, got in fin["seeds"].items():
        gt = {v["view"]: v["gt"] for v in walks[name]["view_gt"]}
        ref = {v["view"]: v["gt"] for v in base["view_gt"]}
        want = next((v for v in order if gt[v] < ref[v] - fin["drop_db"]), None)
        assert got["first_view_below"] == want, name
    seed_walk = {w["view_seed"]: w for w in walks.values()
                 if w["view_seed"] == w["noise_seed_from"]}
    follows = set()
    for name, got in fin["swaps"].items():
        w = walks[name]
        a = w["adjacent"]
        to_noise = abs(a - seed_walk[w["noise_seed_from"]]["adjacent"])
        to_views = abs(a - seed_walk[w["view_seed"]]["adjacent"])
        assert got["follows"] == ("noise" if to_noise < to_views else "views"), name
        follows.add(got["follows"])
    assert fin["carrier"] == {frozenset({"noise"}): "scene noise",
                              frozenset({"views"}): "view draws"}.get(frozenset(follows),
                                                                      "both")
