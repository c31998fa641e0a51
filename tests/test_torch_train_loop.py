"""The port's training loop on the CPU: the checkpoint manager's retention
(rolling, best-by-metric, periodic, the latest/ slot), `run_dpr` with
checkpoint and resume (mirroring tests/test_train_loops.py:53-66), and the
dpr stage of the training-evidence tool at a tiny size."""

import json
import os

import numpy as np
import pytest
import torch

from pixelsynth_tpu_torch.checkpoint import (
    CheckpointManager, load_variables, save_variables,
)
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.train.dpr import create_dpr_state
from pixelsynth_tpu_torch.train.loop import make_batch_source, run_dpr

from test_train_loops import tiny_cfg
from torch_train_ref import _few_torch_threads  # noqa: F401


def _cfg():
    return Config.from_json(tiny_cfg().to_json())


def _state(x):
    return {"w": torch.full((3,), float(x)), "step": x}


def test_rolling_retention_keeps_the_newest(tmp_path):
    m = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in range(1, 6):
        m.save(s, _state(s))
    assert m.all_steps() == [4, 5] and m.latest_step() == 5
    assert m.restore()["step"] == 5 and m.restore(4)["step"] == 4
    assert not os.path.isdir(os.path.join(str(tmp_path), "latest"))
    with pytest.raises(FileNotFoundError):
        m.restore(1)


def test_best_and_periodic_retention_with_latest_slot(tmp_path):
    """best_metric keeps the max_to_keep best, keep_period keeps every N-th
    step for good, and latest/ always holds the newest step, which a
    reader (a new manager on the same directory) resumes from."""
    psnr = {1: 5.0, 2: 9.0, 3: 1.0, 4: 7.0, 5: 2.0, 6: 3.0}
    m = CheckpointManager(str(tmp_path), max_to_keep=2, best_metric="psnr",
                          best_mode="max", keep_period=3)
    cfg = _cfg()
    for s, v in psnr.items():
        m.save(s, _state(s), cfg, {"psnr": v})
    assert m.all_steps() == [2, 3, 4, 6]
    assert m.best_step() == 2
    assert m.latest_step() == 6
    m2 = CheckpointManager(str(tmp_path), max_to_keep=2, best_metric="psnr",
                           keep_period=3)
    m2.save(7, _state(7), None, {"psnr": 0.5})
    assert 7 not in m2.all_steps() and m2.latest_step() == 7
    assert m2.restore()["step"] == 7
    assert m2.load_config().to_dict() == cfg.to_dict()
    low = CheckpointManager(str(tmp_path / "low"), max_to_keep=1,
                            best_metric="loss", best_mode="min")
    for s, v in ((1, 3.0), (2, 1.0), (3, 2.0)):
        low.save(s, _state(s), None, {"loss": v})
    assert low.all_steps() == [2] and low.latest_step() == 3


def test_save_and_load_variables(tmp_path):
    sd = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2)}}
    save_variables(str(tmp_path / "v" / "vars.pt"), sd)
    back = load_variables(str(tmp_path / "v" / "vars.pt"))
    assert torch.equal(back["a"], sd["a"]) and torch.equal(back["b"]["c"], sd["b"]["c"])


def test_batch_source_is_synthetic_only():
    cfg = _cfg()
    b = make_batch_source(cfg, "train")()
    v = make_batch_source(cfg, "val")()
    assert b["input_img"].shape == (2, 64, 64, 3)
    assert not np.array_equal(b["input_img"], v["input_img"])
    # every dataset of the JAX package is served (tests/test_torch_datasets.py);
    # an unknown name raises, as the JAX factory's does
    cfg.dataset = "no_such_dataset"
    with pytest.raises(ValueError, match="unknown dataset"):
        make_batch_source(cfg)


def test_run_dpr_checkpoint_and_resume(tmp_path):
    """Two steps and a checkpoint; a second call resumes from it (the state
    it restores is the state that was saved) and runs one more step."""
    cfg = _cfg()
    logs = []
    m1 = run_dpr(cfg, str(tmp_path), epochs=1, iters_per_epoch=2, val_iters=1,
                 log_fn=logs.append, device="cpu")
    assert np.isfinite(m1["Total Loss"]) and np.isfinite(m1["psnr"])
    ckpt = CheckpointManager(os.path.join(str(tmp_path), "dpr"), best_metric="psnr")
    assert ckpt.latest_step() == 1
    assert ckpt.load_config().model.W == cfg.model.W
    saved = ckpt.restore(1)
    assert saved["step"] == 2 and saved["opt_g"]["count"] == 2

    # the restored state loads into a fresh trainer and gives back what was saved
    ps = PixelSynth(cfg, device="cpu", seed=5, trainable=True)
    state = create_dpr_state(ps)
    state.load_state_dict(saved)
    again = state.state_dict()
    for tree in ("gen_vars", "frozen_vars"):
        for name, sd in saved[tree].items():
            for k, v in sd.items():
                assert torch.equal(again[tree][name][k], v), (tree, name, k)
    for k, v in saved["disc_vars"].items():
        assert torch.equal(again["disc_vars"][k], v), k
    for p_saved, p_again in zip(saved["opt_g"]["opt"]["state"].values(),
                                again["opt_g"]["opt"]["state"].values()):
        for k in p_saved:
            assert torch.equal(torch.as_tensor(p_again[k]), torch.as_tensor(p_saved[k]))

    m2 = run_dpr(cfg, str(tmp_path), epochs=2, iters_per_epoch=1, val_iters=1,
                 log_fn=logs.append, device="cpu")
    assert any("resumed from epoch 1" in s for s in logs)
    assert np.isfinite(m2["Total Loss"])
    last = ckpt.restore()
    assert ckpt.latest_step() == 2 and last["step"] == 3 and last["opt_g"]["count"] == 3
    with open(os.path.join(str(tmp_path), "dpr_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2] and rows[0]["rot"] == cfg.train.max_rotation


def test_evidence_tool_dpr_stage(tmp_path):
    """The evidence tool's dpr stage at a tiny size writes its curve and its
    noise diagnosis into the directory it is given."""
    from pixelsynth_tpu_torch.tools.training_evidence import evidence_dpr

    cfg = _cfg()
    out = evidence_dpr(str(tmp_path), steps=2, log_every=1, n_items=2, cfg=cfg,
                       device="cpu", log_fn=lambda s: None)
    with open(tmp_path / "dpr.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [0, 1]
    assert {"psnr", "psnr_std", "psnr_det", "psnr_std_det", "total_loss",
            "l1"} <= set(rows[0])
    diag = json.loads((tmp_path / "dpr_noise_diag.json").read_text())
    assert diag["n_draws"] == 8 and np.isfinite(diag["noise_cost_db"])
    assert out["best_psnr"] == max(r["psnr_det"] for r in rows)


def test_run_vqvae_checkpoint_and_resume(tmp_path):
    """Stage 1 (mirroring tests/test_train_loops.py:30-40): a checkpoint
    with the val MSE that picks the best, the strip PNG; a second call
    restores it (the state saved is the state loaded) and trains on."""
    from pixelsynth_tpu_torch.eval.harness import load_png
    from pixelsynth_tpu_torch.train.loop import run_vqvae

    cfg = _cfg()
    logs = []
    m1 = run_vqvae(cfg, str(tmp_path), epochs=1, iters_per_epoch=2, val_iters=1,
                   log_fn=logs.append, device="cpu")
    assert np.isfinite(m1["mse"]) and np.isfinite(m1["val_mse"])
    ckpt = CheckpointManager(os.path.join(str(tmp_path), "vqvae"), best_metric="val_mse",
                             best_mode="min")
    saved = ckpt.restore(1)
    assert ckpt.best_step() == 1 and saved["step"] == 2 and saved["opt"]["count"] == 2
    v = saved["variables"]
    assert torch.all(v["quantize_t.cluster_size"] > 0)
    assert not torch.equal(v["quantize_t.embed"], v["quantize_t.embed_avg"])
    png = load_png(str(tmp_path / "vqvae_samples" / "epoch_0001.png"))
    assert png.shape == (2 * cfg.model.W, 2 * cfg.model.W, 3)
    m2 = run_vqvae(cfg, str(tmp_path), epochs=2, iters_per_epoch=1, val_iters=1,
                   log_fn=logs.append, device="cpu")
    assert any("resumed from epoch 1" in s for s in logs) and np.isfinite(m2["mse"])
    # the epochs run again from 0 after the restore, as the JAX loop's do
    assert ckpt.latest_step() == 2 and ckpt.restore()["step"] == 4


def test_run_lmconv_checkpoint_resume_and_preview(tmp_path):
    """Stage 3 (mirroring tests/test_train_loops.py:43-50): bpd near
    log2(512) at init, the val bpd on the EMA parameters, a checkpoint
    with the EMA, the preview PNG decoded through a VQ-VAE; a resume."""
    from pixelsynth_tpu_torch.eval.harness import load_png
    from pixelsynth_tpu_torch.train.loop import run_lmconv
    from pixelsynth_tpu_torch.pipeline import build_vqvae

    cfg = _cfg()
    cfg.model.lmconv.ema_decay = 0.9
    vq = build_vqvae(cfg)
    with torch.no_grad():
        vq.reset(torch.Generator().manual_seed(0))
    logs = []
    m = run_lmconv(cfg, str(tmp_path), epochs=1, iters_per_epoch=2, val_iters=1,
                   preview_every=1, vq_model=vq, log_fn=logs.append, device="cpu")
    assert np.isfinite(m["bpd"]) and m["bpd"] < 12 and np.isfinite(m["val_bpd"])
    assert m["grad_norm"] > 0
    ckpt = CheckpointManager(os.path.join(str(tmp_path), "lmconv"), best_metric="val_bpd",
                             best_mode="min")
    saved = ckpt.restore(1)
    assert saved["step"] == 2 and len(saved["ema_params"]) == len(saved["variables"])
    png = load_png(str(tmp_path / "lmconv_samples" / "epoch_0001.png"))
    W = cfg.model.W
    assert png.shape == (W, 4 * W, 3)
    run_lmconv(cfg, str(tmp_path), epochs=1, iters_per_epoch=1, val_iters=1,
               log_fn=logs.append, device="cpu")
    assert any("resumed from epoch 1" in s for s in logs)
    assert ckpt.restore()["step"] == 3


def test_lmconv_sample_preview_keeps_the_first_cells(tmp_path):
    """The preview keeps each order's first `frac` cells, fills the rest,
    and writes a grey-code PNG; with sample_backend "fused" its logits
    come from K1's entry (on the CPU its plain version, counted)."""
    from pixelsynth_tpu_torch.eval.harness import load_png
    from pixelsynth_tpu_torch.ops import lmconv_fused
    from pixelsynth_tpu_torch.ops.orders import augment_orders, s_curve_order
    from pixelsynth_tpu_torch.pipeline import build_pixelcnn, random_pixelcnn_params
    from pixelsynth_tpu_torch.train.loop import lmconv_sample_preview
    from pixelsynth_tpu_torch.weights import unflatten_tree

    cfg = _cfg()
    l = cfg.model.lmconv
    assert l.sample_backend == "fused"
    rows, cols = l.obs[1], l.obs[2]
    model = build_pixelcnn(cfg)
    with torch.no_grad():
        model.load_flax(unflatten_tree(random_pixelcnn_params(
            cfg, torch.Generator().manual_seed(1))))
    codes = np.random.default_rng(2).integers(0, l.num_classes, (3, rows, cols))
    order = np.stack(augment_orders(s_curve_order(rows, cols), rows, cols)[:3])
    lmconv_fused.PLAIN_CALLS.update(dict.fromkeys(lmconv_fused.PLAIN_CALLS, 0))
    out = lmconv_sample_preview(cfg, model.state_dict(), None, codes, order,
                                str(tmp_path / "p.png"), frac=0.5, device="cpu",
                                gen=torch.Generator().manual_seed(3))
    keep = rows * cols // 2
    for i in range(3):
        first = order[i, :keep]
        assert np.array_equal(out[i][first[:, 0], first[:, 1]],
                              codes[i][first[:, 0], first[:, 1]])
    assert not np.array_equal(out, codes) and out.min() >= 0 and out.max() < l.num_classes
    assert lmconv_fused.PLAIN_CALLS["lmconv_up"] == rows * cols - keep
    assert load_png(str(tmp_path / "p.png")).shape == (rows, 3 * cols, 3)


def test_evidence_tool_vqvae_and_lmconv_stages(tmp_path):
    """The evidence tool's stage 1 and stage 3 (on codes from that stage-1
    model) at a tiny size write their curves with the JAX tool's keys."""
    from pixelsynth_tpu_torch.tools.training_evidence import (
        evidence_lmconv, evidence_vqvae, main, structured_images,
    )

    cfg = _cfg()
    img = structured_images(np.random.default_rng(0), 2, 32)
    assert img.shape == (2, 32, 32, 3) and img.min() >= -1 and img.max() <= 1
    vq = evidence_vqvae(str(tmp_path), steps=3, log_every=2, device="cpu", cfg=cfg,
                        log_fn=lambda s: None)
    rows = [json.loads(line) for line in open(tmp_path / "vqvae.jsonl")]
    assert [r["step"] for r in rows] == [0, 2] and {"mse", "latent", "recon_psnr"} <= set(rows[0])
    assert vq["first_mse"] == rows[0]["mse"] and vq["last_mse"] == rows[-1]["mse"]
    lm = evidence_lmconv(str(tmp_path), steps=2, log_every=1, device="cpu", cfg=cfg,
                         vq=vq, log_fn=lambda s: None)
    rows = [json.loads(line) for line in open(tmp_path / "lmconv.jsonl")]
    assert [r["step"] for r in rows] == [0, 1] and {"bpd", "ce"} <= set(rows[0])
    assert lm["first_bpd"] > 5
    with pytest.raises(SystemExit):
        main(["--out", str(tmp_path), "--stage", "nope"])
