"""Stitch the trained stages into one scene-generating checkpoint (port of
pixelsynth_tpu/tools/stitch_checkpoint.py).

The reference assembles four separately trained artifacts at every run
(demo.py:198-243): the DPR networks, the VQ-VAE, the PixelCNN prior and
the scene classifier.  `stitch` saves them once, in two forms:

  * a work directory of the port's `run_dpr` layout, `<out>/dpr/<step>/
    state.pt` + `<out>/dpr/config.json`, which the demo's --ckpt-dir loads
    (demo.load_model);
  * one compressed .npz of Flax variable trees (float16 leaves, the JSON
    config as `__config__`, `meta` as `__meta__`) in the layout that
    weights.load_stitched_npz and the JAX package's load_stitched_npz
    both read: the port's state dicts go back through
    weights.to_jax_params.

The stage directories are the port's own (checkpoint.py): `load_dpr_state`
(run_dpr's dpr/), `load_vqvae_variables` (run_vqvae's vqvae/) and
`load_lmconv_variables` (run_lmconv's lmconv/, EMA parameters where kept)
each restore the best step by the stage's own metric, else the latest.

Usage:
  python -m pixelsynth_tpu_torch.tools.stitch_checkpoint \
      --dpr build/relay_chain/dpr_final/dpr --vqvae build/relay_chain/vqvae \
      --lmconv build/relay_chain/lmconv --out build/relay_chain/stitched \
      [--npz build/relay_chain/evidence/stitched.npz] [--classifier NPZ]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.checkpoint import CheckpointManager
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.weights import flatten_tree, to_jax_params


def save_stitched_npz(path: str, variables: Dict, cfg: Config,
                      meta: Optional[Dict] = None) -> None:
    """Flax variable trees (numpy) -> one compressed npz of flat `a/b/c`
    keys, float32 leaves cast to float16, plus `__config__` and, with
    `meta`, `__meta__` (JSON as uint8 bytes)."""
    arrays = {}
    for k, v in flatten_tree(variables).items():
        assert not k.startswith("__"), k
        arrays[k] = v.astype(np.float16) if v.dtype == np.float32 else v
    arrays["__config__"] = np.frombuffer(cfg.to_json().encode(), dtype=np.uint8)
    if meta:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def _best_or_latest(ckpt_dir: str, metric: str, mode: str):
    mgr = CheckpointManager(ckpt_dir, best_metric=metric, best_mode=mode)
    step = mgr.best_step() or mgr.latest_step()
    return mgr, mgr.restore(step)


def load_dpr_state(ckpt_dir: str, cfg: Optional[Config] = None, *,
                   device="cuda"):
    """A run_dpr checkpoint directory (its dpr/) at its best val-PSNR step
    -> (PixelSynth(trainable=True) holding it, DPRTrainState, cfg)."""
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.train.dpr import create_dpr_state

    mgr, sd = _best_or_latest(ckpt_dir, "psnr", "max")
    cfg = mgr.load_config() or cfg
    ps = PixelSynth(cfg, device=device, trainable=True)
    state = create_dpr_state(ps)
    state.load_state_dict(sd)
    return ps, state, cfg


def load_vqvae_variables(ckpt_dir: str, cfg: Config) -> Dict[str, torch.Tensor]:
    """A run_vqvae checkpoint directory (its vqvae/) at its best val-MSE
    step -> the VQ-VAE's state dict (CPU)."""
    del cfg
    _, sd = _best_or_latest(ckpt_dir, "val_mse", "min")
    return sd["variables"]


def load_lmconv_variables(ckpt_dir: str, cfg: Config,
                          prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A run_lmconv checkpoint directory (its lmconv/) at its best val-bpd
    step -> the PixelCNN's state dict (CPU), with the EMA parameters in
    place of the parameters where the run kept them (the reference samples
    with them, train_lmconv.py:606,733)."""
    from pixelsynth_tpu_torch.pipeline import build_pixelcnn

    _, sd = _best_or_latest(ckpt_dir, "val_bpd", "min")
    out = dict(sd["variables"])
    if prefer_ema and sd["ema_params"] is not None:
        names = [n for n, _ in build_pixelcnn(cfg, trainable=True).named_parameters()]
        out.update(zip(names, sd["ema_params"]))
    return out


def stitch(dpr_dir: str, out_dir: str, *, vqvae_dir: Optional[str] = None,
           lmconv_dir: Optional[str] = None, npz_path: Optional[str] = None,
           classifier_npz: Optional[str] = None, meta: Optional[Dict] = None,
           device="cuda") -> Dict[str, Dict]:
    """Assemble the final trees and write both forms.  The DPR checkpoint
    gives unet, projector, disc and its vqvae / pixelcnn; `vqvae_dir` and
    `lmconv_dir` replace those two with the stage-1 / stage-3 artifacts
    (the reference's load order, demo.py:198-243).  `classifier_npz`: a
    scene classifier (tools/train_scene_classifier.py) packed into the npz
    as "classifier", so the artifact ranks candidates by both terms
    (z_buffermodel.py:244-276).  Returns {tree: state dict}."""
    from pixelsynth_tpu_torch.train.dpr import FROZEN, TRAINABLE, create_dpr_state

    ps, state, cfg = load_dpr_state(dpr_dir, device=device)
    trees = {k: getattr(ps, k).state_dict() for k in (*TRAINABLE, "disc", *FROZEN)}
    if vqvae_dir:
        trees["vqvae"] = load_vqvae_variables(vqvae_dir, cfg)
    if lmconv_dir:
        trees["pixelcnn"] = load_lmconv_variables(lmconv_dir, cfg)
    for name, sd in trees.items():
        getattr(ps, name).load_state_dict(sd)

    # the run_dpr layout, with fresh optimizers at the DPR step
    fresh = create_dpr_state(ps)
    fresh.step = state.step
    mgr = CheckpointManager(os.path.join(out_dir, "dpr"))
    mgr.save(int(state.step), fresh.state_dict(), cfg)

    if npz_path:
        cpu = {k: {n: t.detach().cpu() for n, t in getattr(ps, k).state_dict().items()}
               for k in trees if k != "vgg"}
        variables = to_jax_params(cpu, cfg)
        if classifier_npz:
            from pixelsynth_tpu_torch.models.classifier import load_classifier_npz

            variables["classifier"] = load_classifier_npz(classifier_npz)
        save_stitched_npz(npz_path, variables, cfg, meta)
    return trees


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dpr", required=True, help="a run_dpr dpr/ directory")
    ap.add_argument("--vqvae", default=None)
    ap.add_argument("--lmconv", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--npz", default=None)
    ap.add_argument("--classifier", default=None,
                    help="scene_classifier.npz to pack into the stitched npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    stitch(args.dpr, args.out, vqvae_dir=args.vqvae, lmconv_dir=args.lmconv,
           npz_path=args.npz, classifier_npz=args.classifier, device=args.device)
    print(f"stitched checkpoint written to {args.out}")


if __name__ == "__main__":
    main()
