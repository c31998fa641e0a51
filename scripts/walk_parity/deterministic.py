"""Where do the port's walk and the JAX package's part, at the relay
artifact's real weights?  Both packages on the CPU walk the held-out demo
world on `evidence/relay/stitched.npz` at the artifact's settings but for
the draws: temperature 1e-4 (an argmax chain: Gumbel noise of 1e-4 moves
no choice whose top-2 gap exceeds ~2e-3), `noise_mode="zero"` (no decoder
draws), S = 8 candidates, speculative 12, the cloud capacity of the demo
(4 x 65536), re-ranking by D score and classifier entropy, 82 views.

Two comparisons, view by view:

  free    each package walks on its own (JAX: rng PRNGKey(0); the port:
          seed 0); per view the max |difference| of the shown views, the
          share of values off by more than 2e-3, the PSNR between them,
          both clouds' valid counts and both chosen candidates.
  forced  at every view of the JAX walk the port takes the same inputs
          (JAX's carried image, cloud, background and cameras) and each of
          its stages is also fed JAX's output of the stage before, so each
          stage is held alone: depth; splat (gen_fs, bg, the new cloud);
          orders and masks; codes; sampled codes (a cell that differs is
          a near-tie when JAX's top-2 logit gap there is within twice the
          two packages' logit difference); the decoded candidates; D
          scores, entropies and the chosen candidate.  The view step taken
          whole on JAX's inputs is compared too.

Writes one JSON line a view to --rows and the record (every view's row,
the first departing view and stage, or "none beyond float noise") to
--out.

  JAX_PLATFORMS=cpu taskset -c 5-7 python scripts/walk_parity/deterministic.py

(~25 min on 3 cores; rows to build/walk_parity/deterministic.jsonl, the
record to evidence/torch/walk_parity/deterministic.json.)

--views N stops after N views (a rehearsal); --rescore recomputes the
first stages of the record at --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import common  # noqa: E402

os.environ.setdefault("PIXELSYNTH_CACHE", os.path.join(common.WORK, "jax_cache"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pixelsynth_tpu import demo as jdemo  # noqa: E402
from pixelsynth_tpu.data.demo_data import demo_cameras as j_demo_cameras  # noqa: E402
from pixelsynth_tpu.data.demo_data import load_demo_image as j_load_demo_image  # noqa: E402
from pixelsynth_tpu.geometry.projection import homogeneous_to_pixels as j_to_pixels  # noqa: E402
from pixelsynth_tpu.geometry.projection import lift_to_cloud as j_lift  # noqa: E402
from pixelsynth_tpu.sampling import ar_sample_speculative as j_sample  # noqa: E402
from pixelsynth_tpu.sampling import classifier_entropy as j_entropy  # noqa: E402
from pixelsynth_tpu.sampling import d_fake_score as j_d_fake  # noqa: E402
from pixelsynth_tpu.sampling import rank_candidates_jax  # noqa: E402
from pixelsynth_tpu.models.classifier import preprocess_for_classifier as j_prep  # noqa: E402
from pixelsynth_tpu.pipeline import CloudState as JaxCloudState  # noqa: E402
from pixelsynth_tpu.scene import SceneGenerator as JaxSceneGenerator  # noqa: E402
from pixelsynth_tpu_torch import demo as pdemo  # noqa: E402
from pixelsynth_tpu_torch.data.demo_data import load_demo_image  # noqa: E402
from pixelsynth_tpu_torch.geometry.projection import (  # noqa: E402
    homogeneous_to_pixels, lift_to_cloud,
)
from pixelsynth_tpu_torch.ops.splat import splat as p_splat  # noqa: E402
from pixelsynth_tpu_torch.models.classifier import (  # noqa: E402
    classifier_entropy, preprocess_for_classifier,
)
from pixelsynth_tpu_torch.pipeline import CloudState  # noqa: E402
from pixelsynth_tpu_torch.sampling import (  # noqa: E402
    ar_sample_speculative, d_fake_score, rank_candidates,
)
from pixelsynth_tpu_torch.scene import SceneGenerator  # noqa: E402

T = 1e-4
VALUE_TOL = 2e-3          # the walk tests' value tolerance
# beyond float noise: the tolerances of tests/test_torch_view_step.py
STAGE_TOL = {"depth": 1e-4, "d_scores": 1e-3, "entropy": 1e-3}


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def t_(x, dtype=None):
    t = torch.as_tensor(np.asarray(x))
    return t.to(dtype) if dtype is not None else t


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(4.0 / mse)  # range [-1, 1]


def diff(a, b) -> dict:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return {"max": float(d.max()) if d.size else 0.0,
            "off": float((d > VALUE_TOL).mean()) if d.size else 0.0}


class JaxStages:
    """The JAX view step (scene.py `_view_step_impl`) split at its stages,
    each jitted, returning what the view step keeps inside."""

    def __init__(self, jgen: JaxSceneGenerator):
        self.g = jgen
        ps, S = jgen.ps, jgen.num_samples
        nc = ps.cfg.model.lmconv.num_classes
        spec = ps.cfg.sample.speculative
        tile = lambda x: jnp.repeat(x, S, axis=0)  # noqa: E731

        def pre(v, img, cams, cloud, last_bg, RTinv_last):
            depth, _ = ps.regress_depth(v["unet"], img)
            fs, _ = ps.features(v, img, noise_scale=0.0)
            gen_fs, bg, new_cloud = ps.splat_cumulative(fs, depth, cams, cloud,
                                                        last_bg, RTinv_last)
            order, masks, bg_ds = ps.masks_for_background(bg)
            codes, _ = ps.vq_encode(v["vqvae"], gen_fs)
            return {"depth": depth, "gen_fs": gen_fs, "bg": bg, "cloud": new_cloud,
                    "order": order, "masks": masks, "bg_ds": bg_ds, "codes": codes}

        def splat(v, img, depth, cams, cloud, last_bg, RTinv_last):
            fs, _ = ps.features(v, img, noise_scale=0.0)
            gen_fs, bg, _ = ps.splat_cumulative(fs, depth, cams, cloud, last_bg,
                                                RTinv_last)
            return {"gen_fs": gen_fs, "bg": bg}

        def splat_points(v, img, depth, cams, cloud, last_bg, RTinv_last):
            """What splat_cumulative hands splat(): the lifted current
            points and the carried cloud in this view's frame."""
            W = ps.W
            fs, _ = ps.features(v, img, noise_scale=0.0)
            cur_cloud = j_lift(depth, cams["K"], cams["Kinv"], cams["Pinv_in"],
                               cams["P_out"], W)
            cur_pts, cur_valid = j_to_pixels(cur_cloud, W)
            if last_bg is not None:
                cur_valid = cur_valid & last_bg.reshape(fs.shape[0], -1)
            st = cloud.transform(cams["K"], cams["P_out"], RTinv_last)
            prior_pts, prior_valid = j_to_pixels(jnp.swapaxes(st.pts, 1, 2), W)
            return (jnp.concatenate([cur_pts, prior_pts], 1),
                    jnp.concatenate([fs.reshape(fs.shape[0], -1, fs.shape[-1]),
                                     st.feats], 1),
                    jnp.concatenate([cur_valid, prior_valid & st.valid], 1))

        def sample(v, codes, order, masks, bg_ds, rng):
            fn = ps.make_sampling_logits_fn(v["pixelcnn"], tile(masks))
            sampled = j_sample(fn, tile(codes), tile(order), tile(bg_ds), rng,
                               num_classes=nc, temperature=T, spec=spec)
            return sampled

        def logits(v, masks, codes):
            fn = ps.make_sampling_logits_fn(v["pixelcnn"], masks)
            return fn(codes, jnp.ones(codes.shape, jnp.float32))

        def post(v, cv, sampled, gen_fs, bg, img):
            decoded = ps.vq_decode(v["vqvae"], sampled)
            n = sampled.shape[0] // gen_fs.shape[0]
            rep = lambda x: jnp.repeat(x, n, axis=0)  # noqa: E731
            combined = ps.combine(rep(gen_fs), decoded, rep(bg))
            gen_imgs, _ = ps.decode_image(v["projector"], combined, rep(bg),
                                          rngs={"noise": jax.random.PRNGKey(0)},
                                          noise_scale=0.0)
            return {"decoded": decoded, "combined": combined, "gen_imgs": gen_imgs}

        def rank(v, cv, gen_imgs, img):
            n = gen_imgs.shape[0] // img.shape[0]
            d = j_d_fake(lambda x, train=False: ps.disc.apply(v["disc"], x, train=False),
                         gen_imgs, jnp.repeat(img, n, axis=0))
            e = j_entropy(jgen.classifier.apply(cv, j_prep(gen_imgs * 0.5 + 0.5)))
            return d, e

        self.pre = jax.jit(pre)
        self.splat = jax.jit(splat)
        self.splat_points = jax.jit(splat_points)
        self.sample = jax.jit(sample)
        self.logits = jax.jit(logits)
        self.post = jax.jit(post)
        self.rank = jax.jit(rank)


def jax_self_noise(stages, jv, img_j, cams, cloud_j, last_bg, RTinv, jr,
                   jitters: int = 4) -> dict:
    """The splat-radius float noise of JAX against itself at this view: its
    splat with its inputs moved by float32 ulps against its splat of the
    unmoved inputs, the largest difference over the moves.  "moves": one
    input scaled by (1 +- 2^-23) -- the carried cloud's points, the last
    view's inverse extrinsics, this view's Pinv_in (the lift of the current
    points) or P_out (both); "jitter": every carried point's coordinate and
    every depth value moved on its own by -1, 0 or +1 ulp (`jitters` draws
    from a fixed seed), the rounding noise of a transform and lift that
    round differently element by element, as the two frameworks' do (see
    "transform_ulps")."""
    def worst(acc, r):
        d = diff(r["gen_fs"], jr["gen_fs"])
        return {"gen_fs": {k: max(acc["gen_fs"][k], d[k]) for k in d},
                "bg_differ": max(acc["bg_differ"],
                                 int((np.asarray(r["bg"]) != np.asarray(jr["bg"])).sum()))}

    zero = {"gen_fs": {"max": 0.0, "off": 0.0}, "bg_differ": 0}
    moves, jitter = zero, zero
    RTinv = np.asarray(RTinv, np.float32)
    for e in (2.0 ** -23, -2.0 ** -23):
        f = np.float32(1.0 + e)
        moved = JaxCloudState(cloud_j.pts * f, cloud_j.feats, cloud_j.valid)
        for c, m, name in ((moved, RTinv, None), (cloud_j, RTinv * f, None),
                           (cloud_j, RTinv, "Pinv_in"), (cloud_j, RTinv, "P_out")):
            cams_m = dict(cams)
            if name is not None:
                cams_m[name] = np.asarray(cams[name], np.float32) * f
            moves = worst(moves, stages.pre(jv, jnp.asarray(img_j), cams_m, c, last_bg,
                                            jnp.asarray(m)))
    pts, depth = np.asarray(cloud_j.pts, np.float32), np.asarray(jr["depth"], np.float32)
    for k in range(jitters):
        rng = np.random.default_rng(k)
        ulp = lambda x: (1.0 + rng.integers(-1, 2, x.shape) * 2.0 ** -23).astype(np.float32)  # noqa: E731
        c = JaxCloudState(jnp.asarray(pts * ulp(pts)), cloud_j.feats, cloud_j.valid)
        jitter = worst(jitter, stages.splat(jv, jnp.asarray(img_j),
                                            jnp.asarray(depth * ulp(depth)), cams, c,
                                            last_bg, jnp.asarray(RTinv)))
    both = {"gen_fs": {k: max(moves["gen_fs"][k], jitter["gen_fs"][k])
                       for k in moves["gen_fs"]},
            "bg_differ": max(moves["bg_differ"], jitter["bg_differ"])}
    return {**both, "moves": moves, "jitter": jitter}


def _points(ps, depth, cams, cloud, last_bg, RTinv, dtype):
    """What the port's splat_cumulative hands splat() (points, validity),
    computed in `dtype` from the same inputs."""
    d = t_(depth, dtype)
    c = {k: t_(v, dtype) for k, v in cams.items()}
    cur_cloud = lift_to_cloud(d, c["K"], c["Kinv"], c["Pinv_in"], c["P_out"], ps.W)
    cur_pts, cur_valid = homogeneous_to_pixels(cur_cloud, ps.W)
    if last_bg is not None:
        cur_valid = cur_valid & t_(last_bg).reshape(1, -1)
    st = CloudState(cloud.pts.to(dtype), cloud.feats, cloud.valid).transform(
        c["K"], c["P_out"], t_(RTinv, dtype))
    prior_pts, prior_valid = homogeneous_to_pixels(st.pts.transpose(1, 2), ps.W)
    return (np_(torch.cat([cur_pts, prior_pts], 1)).astype(np.float64),
            np_(torch.cat([cur_valid, prior_valid & st.valid], 1)))


def same_points(stages, jv, ps, img_j, depth_j, cams, cloud_j, cloud_t, last_bg, RTinv,
                jr) -> dict:
    """Each package's splat on the same points, and each package's points
    against a float64 evaluation of the same formulas.  "port_on_jax_points":
    the port's splat() on the points, features and validity JAX's
    splat_cumulative hands its splat, against JAX's gen_fs; "ulps": the
    largest error of a valid point's coordinate, in float32 ulps of the
    point's largest coordinate, of JAX's points ("jax") and the port's
    ("port") against float64, and between them ("between");
    "points_differ": valid points with any coordinate unequal between the
    packages; "valid_differ": points valid on one side only.  When the
    port's splat agrees on JAX's points, a splat that departs on its own
    points departs by their rounding alone, and the float64 errors say
    whose rounding is the larger."""
    pts, feats, valid = stages.splat_points(jv, jnp.asarray(img_j), depth_j, cams, cloud_j,
                                            last_bg, jnp.asarray(RTinv))
    gen_fs, _ = p_splat(t_(np.asarray(pts)), t_(np.asarray(feats)),
                        t_(np.asarray(valid)), W=ps.W, cfg=ps.cfg.model.splat)
    out = {"port_on_jax_points": diff(np_(gen_fs), jr["gen_fs"])}
    mine, mine_valid = _points(ps, depth_j, cams, cloud_t, last_bg, RTinv, torch.float32)
    ref, _ = _points(ps, depth_j, cams, cloud_t, last_bg, RTinv, torch.float64)
    theirs, theirs_valid = np.asarray(pts, np.float64), np.asarray(valid)
    both = mine_valid & theirs_valid
    scale = np.maximum(np.abs(ref).max(-1, keepdims=True) * 2.0 ** -23, 1e-30)
    ulps = lambda a, b: float((np.abs(a - b) / scale)[both].max()) if both.any() else 0.0  # noqa: E731
    out["ulps"] = {"jax": ulps(theirs, ref), "port": ulps(mine, ref),
                   "between": ulps(mine, theirs)}
    out["points_differ"] = int((np.abs(mine - theirs).max(-1) > 0)[both].sum())
    out["valid_differ"] = int((mine_valid != theirs_valid).sum())
    return out


def transform_ulps(cloud_j, cloud_t, cams, RTinv) -> float:
    """The largest difference between the two packages' carried cloud in
    this view's frame (CloudState.transform), in float32 ulps of the
    point's largest coordinate."""
    want = np.asarray(cloud_j.transform(jnp.asarray(cams["K"]), jnp.asarray(cams["P_out"]),
                                        jnp.asarray(RTinv)).pts, np.float64)
    got = np_(cloud_t.transform(t_(cams["K"]), t_(cams["P_out"]),
                                t_(RTinv, torch.float32)).pts).astype(np.float64)
    valid = np.asarray(cloud_j.valid)
    if not valid.any():
        return 0.0
    scale = np.abs(want).max(-1, keepdims=True) * 2.0 ** -23
    return float((np.abs(got - want) / np.maximum(scale, 1e-30))[valid].max())


def near_tie_check(sj, sp, lj, lp) -> dict:
    """Sampled codes of both packages on the same inputs: cells that
    differ, and of those the ones where JAX's top-2 logit gap exceeds
    twice the largest logit difference between the packages there (a
    difference that float noise cannot explain)."""
    sj, sp = np.asarray(sj), np.asarray(sp)
    differ = np.argwhere(sj != sp)
    lj, lp = np.asarray(lj, np.float64), np.asarray(lp, np.float64)
    unexplained, gaps = [], []
    for b, y, x in differ:
        top = np.sort(lj[b, y, x])[-2:]
        gap = float(top[1] - top[0])
        noise = float(np.abs(lj[b, y, x] - lp[b, y, x]).max())
        gaps.append((gap, noise))
        if gap > 2.0 * noise:
            unexplained.append([int(b), int(y), int(x), gap, noise])
    return {"cells": int(sj.size), "differ": int(len(differ)),
            "unexplained": unexplained,
            "max_gap_of_differing": max((g for g, _ in gaps), default=None),
            "logit_max_diff": float(np.abs(lj - lp).max())}


def forced_view(name, stages, jv, jcv, gen, ps, img_j, cams, cloud_j, last_bg, RTinv,
                rng) -> dict:
    """One view of the JAX walk with the port's stages each on JAX's
    inputs; -> the row, with "first_stage" the first that departs."""
    S = gen.num_samples
    img_t = t_(img_j)
    cams_t = {k: t_(v, torch.float32) for k, v in cams.items()}
    cloud_t = CloudState(t_(cloud_j.pts), t_(cloud_j.feats), t_(cloud_j.valid))
    last_t = None if last_bg is None else t_(last_bg)
    RTinv_t = t_(RTinv, torch.float32)
    jr = stages.pre(jv, jnp.asarray(img_j), cams, cloud_j, last_bg, jnp.asarray(RTinv))
    row = {"view": name}
    with torch.no_grad():
        depth = ps.regress_depth(img_t)
        row["depth"] = diff(np_(depth), jr["depth"])
        gen_fs, bg, new_cloud = ps.splat_cumulative(img_t, t_(jr["depth"]), cams_t,
                                                    cloud_t, last_t, RTinv_t)
        row["gen_fs"] = diff(np_(gen_fs), jr["gen_fs"])
        row["bg_differ"] = int((np_(bg) != np.asarray(jr["bg"])).sum())
        row["transform_ulps"] = transform_ulps(cloud_j, cloud_t, cams, RTinv)
        if row["gen_fs"]["off"] > 0 or row["bg_differ"]:
            row["jax_self"] = jax_self_noise(stages, jv, img_j, cams, cloud_j, last_bg,
                                             RTinv, jr)
            row["same_points"] = same_points(stages, jv, ps, img_j, jr["depth"], cams,
                                             cloud_j, cloud_t, last_bg, RTinv, jr)
        row["cloud_valid"] = [int(np.asarray(jr["cloud"].valid).sum()),
                              int(np_(new_cloud.valid).sum())]
        order, masks, bg_ds = ps.masks_for_background(t_(jr["bg"]))
        row["order_equal"] = bool(np.array_equal(np_(order), np.asarray(jr["order"])))
        row["masks_equal"] = bool(np.array_equal(np_(masks), np.asarray(jr["masks"])))
        row["bg_ds"] = diff(np_(bg_ds), jr["bg_ds"])
        codes = ps.vq_encode(t_(jr["gen_fs"]))
        row["codes_differ"] = int((np_(codes) != np.asarray(jr["codes"])).sum())
        sampling = bool((np.asarray(jr["bg_ds"]) >= 1.0 - 1e-6).any())
        row["sampled"] = sampling
        if sampling:
            sj = stages.sample(jv, jr["codes"], jr["order"], jr["masks"], jr["bg_ds"], rng)
            rep = lambda x: torch.repeat_interleave(t_(x), S, 0)  # noqa: E731
            fn = ps.make_sampling_logits_fn(rep(jr["masks"]))
            sp = ar_sample_speculative(fn, rep(jr["codes"]).long(), rep(jr["order"]),
                                       rep(jr["bg_ds"]),
                                       torch.Generator().manual_seed(0),
                                       num_classes=ps.cfg.model.lmconv.num_classes,
                                       temperature=T, spec=ps.cfg.sample.speculative)
            lj = stages.logits(jv, jnp.repeat(jr["masks"], S, 0), sj)
            lp = fn(t_(np.asarray(sj)).long(), torch.ones(sj.shape))
            row["codes"] = near_tie_check(sj, np_(sp), lj, np_(lp))
            jp = stages.post(jv, jcv, sj, jr["gen_fs"], jr["bg"], jnp.asarray(img_j))
            decoded = ps.vq_decode(t_(np.asarray(sj)).long())
            combined = ps.combine(torch.repeat_interleave(t_(jr["gen_fs"]), S, 0), decoded,
                                  torch.repeat_interleave(t_(jr["bg"]), S, 0))
            gen_imgs = ps.decode_image(combined, torch.repeat_interleave(t_(jr["bg"]), S, 0),
                                       noise_scale=0.0)
        else:
            jp = stages.post(jv, jcv, jr["codes"], jr["gen_fs"], jr["bg"],
                             jnp.asarray(img_j))
            decoded = ps.vq_decode(t_(np.asarray(jr["codes"])).long())
            combined = ps.combine(t_(jr["gen_fs"]), decoded, t_(jr["bg"]))
            gen_imgs = ps.decode_image(combined, t_(jr["bg"]), noise_scale=0.0)
        row["decoded"] = diff(np_(gen_imgs), jp["gen_imgs"])
        if sampling:
            jd, je = stages.rank(jv, jcv, jp["gen_imgs"], jnp.asarray(img_j))
            gi = t_(np.asarray(jp["gen_imgs"]))
            pd = d_fake_score(ps.disc, gi, torch.repeat_interleave(img_t, S, 0))
            pe = classifier_entropy(ps.classifier(preprocess_for_classifier(gi * 0.5 + 0.5)))
            row["d_scores"] = diff(np_(pd), jd)
            row["entropy"] = diff(np_(pe), je)
            row["chosen"] = [int(rank_candidates_jax(jd, je)), int(rank_candidates(pd, pe))]
            # the candidates are equal but for near-ties: a chosen index
            # that differs between equal candidates changes no image
            row["candidates_spread"] = float(np.abs(np.asarray(jp["gen_imgs"]) -
                                                    np.asarray(jp["gen_imgs"])[:1]).max())
    # the port's whole view step on JAX's inputs
    best, _ = gen.generate_view(img_j, cams, cloud_t, last_t, RTinv_t, seed=0)
    return row, np_(best)


def first_stage(row) -> str:
    """The first stage of a forced view that departs beyond float noise, or
    None.  Float noise is what tests/test_torch_view_step.py allows: depth
    within 1e-4; every other array within 2e-3 but at most two values,
    except at the input pose (numerator 0), where points land exactly at
    the splat radius and all but 1% of values within 2e-3 (and 1% of the
    background's pixels) is float noise; at any view, a splat whose share
    of values off is within twice JAX's own under a one-ulp move of one of
    its inputs or a per-element one-ulp jitter of its points and depth
    ("jax_self"), or a splat that agrees on JAX's points while its own
    points part from float64 by at most twice JAX's ("same_points": the
    difference is the points' rounding); sampled codes that differ only
    where JAX's
    top-2 logit gap is within twice the packages' logit difference
    (near-ties)."""
    at_input = row["view"].endswith("_0")
    share = 0.01 if at_input else 2.0 / (128 * 128 * 3)
    own = row.get("jax_self", {"gen_fs": {"off": 0.0}, "bg_differ": 0})
    if row["depth"]["max"] > STAGE_TOL["depth"]:
        return "depth"
    if row["gen_fs"]["off"] > max(share, 2.0 * own["gen_fs"]["off"]):
        sp = row.get("same_points")
        if (sp is None or sp["port_on_jax_points"]["off"] > share or sp["valid_differ"]
                or sp["ulps"]["port"] > 2.0 * max(sp["ulps"]["jax"], 1.0)):
            return "gen_fs"
    if row["bg_differ"] > max(0.01 * 128 * 128 if at_input else 0, 2 * own["bg_differ"]):
        return "bg"
    if not (row["order_equal"] and row["masks_equal"]):
        return "order/masks"
    if row["codes_differ"]:
        return "codes"
    if row["sampled"] and row["codes"]["unexplained"]:
        return "sampled"
    if row["decoded"]["off"] > share:
        return "decoded"
    for k in ("d_scores", "entropy"):
        if k in row and row[k]["max"] > STAGE_TOL[k]:
            return k
    return None


def rescore(path: str) -> dict:
    """Recompute each forced view's first stage and the first departure of
    a written record, in place."""
    with open(path) as f:
        record = json.load(f)
    for row in record["forced"]:
        row["first_stage"] = first_stage(row)
    departing = next((r for r in record["forced"] if r["first_stage"] is not None), None)
    record["first_departure"] = ("none beyond float noise" if departing is None else
                                 {"view": departing["view"],
                                  "stage": departing["first_stage"]})
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


class _Stop(Exception):
    """Raised at the view after the last one asked for (--views)."""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=common.ARTIFACT)
    ap.add_argument("--rows", default=os.path.join(common.WORK, "deterministic.jsonl"),
                    help="JSON lines, one a view")
    ap.add_argument("--out", default=os.path.join(common.RECORDS, "deterministic.json"),
                    help="the record (JSON)")
    ap.add_argument("--views", type=int, default=None)
    ap.add_argument("--rescore", action="store_true",
                    help="only recompute the first stages of the record at --out")
    args = ap.parse_args(argv)
    if args.rescore:
        print(json.dumps(rescore(args.out)["first_departure"]))
        return
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))))
    if os.path.exists(args.rows):
        os.remove(args.rows)

    jps, jv = jdemo.load_model(args.ckpt)
    jcv = jv.pop("classifier")
    cfg = jps.cfg
    ps = pdemo.load_model(args.ckpt, device="cpu")
    world, inp = common.demo_input(os.path.join(common.WORK, "deterministic"), cfg.model.W)
    img_j, ratio = j_load_demo_image(inp, cfg.model.W)
    img_p, ratio_p = load_demo_image(inp, cfg.model.W)
    cams = j_demo_cameras(ratio)
    kw = dict(temperature=T, noise_mode="zero")
    jgen = JaxSceneGenerator(jps, jv, classifier_vars=jcv, **kw)
    gen = SceneGenerator(ps, **kw)
    names = common.walk_names(cfg.sample)[:args.views]
    dirs = list(dict.fromkeys(n.rsplit("_", 1)[0] for n in names))
    stages = JaxStages(jgen)
    record = {"ckpt": os.path.relpath(args.ckpt, common.REPO),
              "sha256": common.file_sha256(args.ckpt),
              "settings": {"temperature": T, "noise_mode": "zero",
                           "num_samples": gen.num_samples, "carry": gen.carry,
                           "speculative": cfg.sample.speculative,
                           "cloud_capacity": gen.cloud_capacity,
                           "compute_dtype": cfg.model.lmconv.compute_dtype,
                           "views": len(names)},
              "input_equal": bool(np.array_equal(np.asarray(img_j), img_p)),
              "tolerances": {"value": VALUE_TOL, **STAGE_TOL}}

    # the JAX walk, with the port's stages forced onto each of its views
    forced, j_best, j_steps = [], {}, []
    inner = jgen.generate_view

    def j_view(img, cams_v, cloud, last_bg, RTinv_last, rng, noise_rng=None):
        if len(j_steps) == len(names):
            raise _Stop
        name = names[len(j_steps)]
        best, out = inner(img, cams_v, cloud, last_bg, RTinv_last, rng, noise_rng=noise_rng)
        t0 = time.perf_counter()
        row, p_best = forced_view(name, stages, jv, jcv, gen, ps, np.asarray(img),
                                  {k: np.asarray(v, np.float32) for k, v in cams_v.items()},
                                  cloud, None if last_bg is None else np.asarray(last_bg),
                                  np.asarray(RTinv_last), rng)
        row["whole_view"] = {**diff(p_best, best), "psnr": psnr(p_best, best)}
        row["first_stage"] = first_stage(row)
        row["seconds"] = time.perf_counter() - t0
        j_steps.append({"chosen": int(rank_candidates_jax(out["d_scores"], out["entropy"])),
                        "cloud_valid": int(np.asarray(out["cloud"].valid).sum())})
        j_best[name] = np.asarray(best)
        forced.append(row)
        common.append_jsonl(args.rows, {"forced": row})
        print(f"[forced] {name}: first stage {row['first_stage']}, view max "
              f"{row['whole_view']['max']:.2e} ({row['seconds']:.1f} s)", flush=True)
        return best, out

    jgen.generate_view = j_view
    try:
        jgen.generate_scene(img_j, cams["K"], cams["Kinv"], cams["P"], cams["Pinv"],
                            directions=dirs, rng=jax.random.PRNGKey(0))
    except _Stop:
        pass

    # the port's own walk
    p_steps, p_best = [], {}
    p_inner = gen.generate_view

    def p_view(*a, **k):
        if len(p_steps) == len(names):
            raise _Stop
        best, out = p_inner(*a, **k)
        name = names[len(p_steps)]
        p_steps.append({"chosen": int(rank_candidates(out["d_scores"], out["entropy"])),
                        "cloud_valid": int(out["cloud"].valid.sum())})
        p_best[name] = np_(best)
        return best, out

    gen.generate_view = p_view
    pdemo_cams = j_demo_cameras(ratio_p)
    try:
        gen.generate_scene(img_p, pdemo_cams["K"], pdemo_cams["Kinv"], pdemo_cams["P"],
                           pdemo_cams["Pinv"], directions=dirs, seed=0)
    except _Stop:
        pass
    free = []
    for i, name in enumerate(names):
        if name not in p_best:
            break
        row = {"view": name, **diff(p_best[name], j_best[name]),
               "psnr": psnr(p_best[name], j_best[name]),
               "cloud_valid": [j_steps[i]["cloud_valid"], p_steps[i]["cloud_valid"]],
               "chosen": [j_steps[i]["chosen"], p_steps[i]["chosen"]]}
        free.append(row)
        common.append_jsonl(args.rows, {"free": row})
    departing = next((r for r in forced if r["first_stage"] is not None), None)
    record["forced"] = forced
    record["free"] = free
    record["first_departure"] = ("none beyond float noise" if departing is None else
                                 {"view": departing["view"],
                                  "stage": departing["first_stage"]})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record["first_departure"]))


if __name__ == "__main__":
    main()
