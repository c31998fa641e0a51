#!/bin/bash
# Full scene demo on the PyTorch port (twin of scripts/demo_scene.sh;
# reference scripts/demo_scene.sh: 10 directions, num_split 32, 50
# samples/view, T=0.7)
python -m pixelsynth_tpu_torch.demo --img "${1:-demo.png}" --mode gen_scene \
    --ckpt-dir runs/ --result-folder demo_out/ \
    --num-split 32 --num-samples 50 --temperature 0.7
