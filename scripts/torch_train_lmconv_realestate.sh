#!/bin/bash
# Stage 3 on the PyTorch port (twin of scripts/train_lmconv_realestate.sh;
# reference scripts/train_lmconv_realestate.sh: 150 ep, batch 60)
python - <<'PY'
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.train.loop import run_lmconv
cfg = Config(); cfg.train.batch_size = 60
run_lmconv(cfg, "runs/", epochs=150, iters_per_epoch=500,
           codes_path="codes.npy", orders_path="orders.npy")
PY
