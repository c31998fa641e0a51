#!/bin/bash
# Stage 2 on the PyTorch port (twin of scripts/train_dpr_realestate.sh;
# reference scripts/train_dpr_realestate.sh: 250 ep, batch 12, lr 1.5e-4,
# sync spectral-batch norm, curriculum +10deg/50ep)
python - <<'PY'
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.train.loop import run_dpr
cfg = Config(); cfg.dataset = "realestate"
import os; cfg.train_data_path = os.environ.get("REAL_ESTATE_10K", "data/realestate")
cfg.model.norm_G = "sync:spectral_batch"
cfg.train.batch_size = 12; cfg.train.lr = 1.5e-4
run_dpr(cfg, "runs/", epochs=250)
PY
