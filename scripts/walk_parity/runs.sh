#!/bin/bash
# The runs behind evidence/torch/walk_parity/ (the relay walk, port against
# the JAX package, on evidence/relay/stitched.npz).  From the root of the
# repository:
#
#   bash scripts/walk_parity/runs.sh jax        # CPU, JAX: 8 seeds (~16 min)
#   bash scripts/walk_parity/runs.sh jax-zero   # CPU, JAX: the same with zero
#                                               #   decoder noise
#   bash scripts/walk_parity/runs.sh det        # CPU, both: the argmax walk
#   bash scripts/walk_parity/runs.sh card       # on the card: the port's 8
#                                               #   seeds and the factor runs
#   bash scripts/walk_parity/runs.sh fast       # on the card: the fast relay
#                                               #   chain, then collapse.py
#   bash scripts/walk_parity/runs.sh records    # CPU: the records from the
#                                               #   runs' outputs
#
# "jax" and "det" run at once on 5 + 3 cores of an 8-core CPU.  The card's
# runs take ~6 and ~50 min on an H100 and write under $OUT (default
# build/walk_parity/card), which records.py reads (--card).
set -eu
W=build/walk_parity
C=${OUT:-$W/card}
SPREAD="python3 -m pixelsynth_tpu_torch.tools.relay_walk_spread"

case "${1:-}" in
jax)
    JAX_PLATFORMS=cpu taskset -c 0-4 python scripts/walk_parity/jax_spread.py \
        --seeds 0-7 --out $W/jax_rows.jsonl ;;
jax-zero)
    JAX_PLATFORMS=cpu taskset -c 0-4 python scripts/walk_parity/jax_spread.py \
        --seeds 0-7 --noise-mode zero --work $W/jax_zero \
        --out $W/jax_noise_zero_rows.jsonl ;;
det)
    JAX_PLATFORMS=cpu taskset -c 5-7 python scripts/walk_parity/deterministic.py ;;
card)
    mkdir -p $C
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $C/card.txt
    # the artifact's settings, TF32 off (as chip_smoke.py), then one factor
    # at a time: TF32 at the library's default, zero decoder noise, an
    # argmax chain (T = 1e-4, zero noise), one candidate (no re-ranking)
    $SPREAD --seeds 0-7 --out $C/port_card_spread.json
    $SPREAD --seeds 0-7 --tf32 --out $C/factor_tf32.json || true
    $SPREAD --seeds 0-7 --noise-mode zero --out $C/factor_noise_zero.json || true
    $SPREAD --seeds 0-7 --temperature 1e-4 --noise-mode zero \
        --out $C/factor_argmax.json || true
    $SPREAD --seeds 0-7 --num-samples 1 --out $C/factor_s1.json || true ;;
fast)
    mkdir -p $C
    python3 -m pixelsynth_tpu_torch.tools.relay_evidence --profile fast \
        --workdir build/relay_chain_fast --out $C/relay_fast
    python3 scripts/walk_parity/collapse.py \
        --ckpt build/relay_chain_fast/evidence/stitched.npz --seeds 0,1,6 --swap 0,1 \
        --out $C/collapse ;;
records)
    python3 scripts/walk_parity/records.py ;;
*)
    echo "usage: $0 jax|jax-zero|det|card|fast|records" >&2; exit 2 ;;
esac
