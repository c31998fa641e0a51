#!/bin/bash
# Single novel view on the PyTorch port (twin of scripts/demo_img.sh;
# reference scripts/demo_img.sh).  --ckpt-dir: a stitched .npz or the work
# directory of the port's run_dpr.
python -m pixelsynth_tpu_torch.demo --img "${1:-demo.png}" --mode gen_img \
    --ckpt-dir runs/ --result-folder demo_out/ --direction R --rotation 0.3
