#!/bin/bash
# Stage 1 on the PyTorch port (twin of scripts/train_vqvae_realestate.sh;
# reference scripts/train_vqvae_realestate.sh: 150 ep, lr 3e-4)
python - <<'PY'
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.train.loop import run_vqvae
cfg = Config(); cfg.dataset = "custom"; cfg.train_data_path = "extraction/"
cfg.train.batch_size = 64
run_vqvae(cfg, "runs/", epochs=150, iters_per_epoch=500, lr=3e-4)
PY
