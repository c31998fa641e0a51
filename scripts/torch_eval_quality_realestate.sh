#!/bin/bash
# Paired-image quality eval on the PyTorch port (twin of
# scripts/eval_quality_realestate.sh; reference
# scripts/eval_quality_realestate.sh: T=0.5, 1 sample over the fixed 3600
# triples)
python - <<'PY'
import os
from pixelsynth_tpu_torch.data.realestate10k import RealEstate10KFixed
from pixelsynth_tpu_torch.demo import load_model
from pixelsynth_tpu_torch.eval.harness import eval_quality
ps = load_model("runs/")
ds = RealEstate10KFixed(
    data_path=os.environ.get("REAL_ESTATE_10K", "data/realestate"),
    indices_path="data/realestate_test_indices.npy")
eval_quality(ps, ds, "eval_out/", num_samples=1, temperature=0.5)
PY
python -m pixelsynth_tpu_torch.eval.calc_errors eval_out/
