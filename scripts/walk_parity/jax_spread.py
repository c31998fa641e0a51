"""The JAX package's relay walk at seeds on the CPU, scored by the port's
`scene_walk_metrics`: the reference spread that the port's walk on the
card is held to.

Each seed is what the JAX demo CLI runs for `--mode gen_scene --ckpt-dir
ARTIFACT --seed N` (its load_model, the stitched classifier, the
checkpoint's walk settings, rng = PRNGKey(N)), in one process so that the
view step compiles once.  The input is the relay's held-out demo world
written as a PNG.  Per seed one JSON line: gt PSNR, adjacency, the
numerator means, the 40 scored views, and for each of the 82 views the
candidates' D scores and entropies, the chosen candidate and the cloud's
valid count.  The walks' PNGs go under build/walk_parity/jax/.

  JAX_PLATFORMS=cpu taskset -c 0-4 python scripts/walk_parity/jax_spread.py \\
      --seeds 0-7 --out build/walk_parity/jax_rows.jsonl

About 90 s to compile, then ~7 min a walk on 5 cores.  --temperature,
--noise-mode and --num-samples override the checkpoint's walk settings
(the factor runs).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import common  # noqa: E402

os.environ.setdefault("PIXELSYNTH_CACHE", os.path.join(common.WORK, "jax_cache"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pixelsynth_tpu import demo as jdemo  # noqa: E402
from pixelsynth_tpu.data.demo_data import demo_cameras, load_demo_image  # noqa: E402
from pixelsynth_tpu.sampling import rank_candidates_jax  # noqa: E402
from pixelsynth_tpu.scene import SceneGenerator  # noqa: E402
from pixelsynth_tpu_torch.config import Config  # noqa: E402
from pixelsynth_tpu_torch.eval.relay_report import scene_walk_metrics  # noqa: E402


def recording(gen, names):
    """Wrap gen.generate_view so that each call appends its view's
    candidates to the returned list."""
    steps = []
    inner = gen.generate_view

    def generate_view(*a, **kw):
        best, out = inner(*a, **kw)
        d = np.asarray(out["d_scores"], np.float64)
        e = np.asarray(out["entropy"], np.float64)
        steps.append({"view": names[len(steps)],
                      "chosen": int(rank_candidates_jax(jnp.asarray(d), jnp.asarray(e))),
                      "d_scores": d.tolist(), "entropy": e.tolist(),
                      "cloud_valid": int(np.asarray(out["cloud"].valid).sum())})
        return best, out

    gen.generate_view = generate_view
    return steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--ckpt", default=common.ARTIFACT)
    ap.add_argument("--out", required=True, help="JSON lines, one a seed (appended)")
    ap.add_argument("--work", default=os.path.join(common.WORK, "jax"))
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--noise-mode", default=None, choices=["per_view", "fixed", "zero"])
    ap.add_argument("--num-samples", type=int, default=None)
    args = ap.parse_args(argv)

    ps, variables = jdemo.load_model(args.ckpt)
    classifier_vars = variables.pop("classifier", None)
    cfg = ps.cfg
    pcfg = Config.from_json(cfg.to_json())
    world, inp = common.demo_input(args.work, cfg.model.W)
    img, ratio = load_demo_image(inp, cfg.model.W)
    cams = demo_cameras(ratio)
    gen = SceneGenerator(ps, variables, num_samples=args.num_samples,
                         temperature=args.temperature, classifier_vars=classifier_vars,
                         noise_mode=args.noise_mode)
    names = common.walk_names(cfg.sample)
    print(f"[jax] {len(names)} views, S={gen.num_samples}, T={gen.temperature}, "
          f"noise={gen.noise_mode}, carry={gen.carry}, spec={cfg.sample.speculative}, "
          f"classifier={'yes' if classifier_vars is not None else 'no'}", flush=True)
    base = gen.generate_view
    for seed in common.parse_seeds(args.seeds):
        gen.generate_view = base  # one recording wrapper a walk
        steps = recording(gen, names)
        t0 = time.perf_counter()
        outputs = gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"],
                                     cams["Pinv"], rng=jax.random.PRNGKey(seed))
        secs = time.perf_counter() - t0
        scene_dir = os.path.join(args.work, f"seed{seed}")
        jdemo.save_scene(outputs, cfg, scene_dir)
        m = scene_walk_metrics(pcfg, world, scene_dir, scene_dir, per_view=True)
        row = common.walk_row(seed, m, secs, steps)
        row["settings"] = {"num_samples": gen.num_samples, "temperature": gen.temperature,
                           "noise_mode": gen.noise_mode, "carry": gen.carry,
                           "speculative": cfg.sample.speculative,
                           "cloud_capacity": gen.cloud_capacity}
        common.append_jsonl(args.out, row)
        print(f"[jax] seed {seed}: gt {row['gt']:.4f} adjacent {row['adjacent']:.4f} "
              f"({secs:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
