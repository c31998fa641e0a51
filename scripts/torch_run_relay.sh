#!/bin/bash
# The relay on the PyTorch port (twin of scripts/run_relay.sh): the
# reference's canonical chained pipeline (docs/REALESTATE.md:56-70) trained
# end to end on procedural panorama worlds, stitched into one
# demo-loadable checkpoint + metric report.  Stages are resumable (see
# pixelsynth_tpu_torch/tools/run_relay.py); --smoke runs in minutes,
# --profile fast halves the step counts.  The evidence directory may not
# lie inside evidence/ (the JAX package's artifact).
python -m pixelsynth_tpu_torch.tools.run_relay \
    --workdir "${1:-runs/relay}" --evidence "${2:-runs/relay/evidence}" "${@:3}"
