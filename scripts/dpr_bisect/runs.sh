#!/bin/bash
# The runs behind evidence/torch/ (the stage-2 evidence protocol, port against
# the JAX package).  From the root of the repository:
#
#   bash scripts/dpr_bisect/runs.sh prepare   # CPU, JAX: init npz + JAX's draws
#   bash scripts/dpr_bisect/runs.sh jax       # CPU, JAX: the package's own run
#   bash scripts/dpr_bisect/runs.sh card1     # on the card, one group at a
#   ...                                       #   time
#   bash scripts/dpr_bisect/runs.sh card6
#   bash scripts/dpr_bisect/runs.sh cpu       # CPU: per-step metrics, both sides
#   bash scripts/dpr_bisect/runs.sh cpu_long  # CPU: the port for 1600 steps
#   bash scripts/dpr_bisect/runs.sh compare   # CPU: step by step from JAX's states
#   bash scripts/dpr_bisect/runs.sh swap      # CPU: one tree on the port's update
#   bash scripts/dpr_bisect/runs.sh card7     # on the card: card against CPU
#   bash scripts/dpr_bisect/runs.sh card8     # on the card: the tool after the repair
#
# card1-6 ran before the average-pool repair (models/layers.py avg_pool);
# card7 before and after it; card8 after it (evidence/torch/dpr*.jsonl).
# The card's groups run their processes at once (one card, ~0.33-0.41 s a
# step each for six on an H100 80GB HBM3 at 700 W); outputs go under
# $OUT/card<n>/ (OUT defaults to build/dpr_bisect) and were copied to
# evidence/torch/bisect/c<n>_<run>.jsonl.  The init npz (137 MB)
# and the draws (33 MB) live under build/dpr_bisect/ (gitignored); with the
# draws beside it, groups 3-5 read the init without the PixelCNN tree (which
# no image loss reaches) to keep the copy sent to the card small.
set -eu
B=build/dpr_bisect
I=$B/jax_init_s0.npz
IN=$B/jax_init_s0_nopcnn.npz
D=$B/jax_draws_s0.npy
P="python3 scripts/dpr_bisect/port_run.py"
S=scripts/dpr_bisect/step_compare.py
OUT=${OUT:-$B}
export OMP_NUM_THREADS=1

together() {  # run the given commands at once; fail if one fails
    local pids=() rc=0
    for c in "$@"; do bash -c "$c" & pids+=($!); done
    for p in "${pids[@]}"; do wait "$p" || rc=1; done
    return $rc
}

case "${1:-}" in
prepare)
    mkdir -p $B
    JAX_PLATFORMS=cpu python scripts/dpr_bisect/jax_run.py --export-init $I
    JAX_PLATFORMS=cpu python scripts/dpr_bisect/jax_run.py --dump-draws $D --steps 3200
    python3 -c "import numpy as np; z = np.load('$I'); np.savez('$IN', **{k: z[k] for k in z.files if not k.startswith('pixelcnn/')})"
    ;;
jax)
    JAX_PLATFORMS=cpu python -m pixelsynth_tpu.tools.training_evidence --stage dpr \
        --steps 3200 --out $B/jax_dpr_s0
    ;;
card1)  # the tool at two seeds; JAX's init with a numpy bank / own draws; own init
    O=$OUT/card1; mkdir -p $O
    together \
        "python3 -m pixelsynth_tpu_torch.tools.training_evidence --stage dpr --steps 3200 --out $O/tool_s0" \
        "python3 -c \"from pixelsynth_tpu_torch.tools.training_evidence import evidence_dpr; evidence_dpr('$O/tool_s1', steps=3200, seed=1)\"" \
        "$P --init jax --jax-init $I --noise bank --out $O/jax_bank" \
        "$P --init jax --jax-init $I --noise own --out $O/jax_own" \
        "$P --init own --noise bank --out $O/own_bank" \
        "$P --init own --noise own --truncated --out $O/trunc_own"
    ;;
card2)  # the tool's 8000 steps (evidence/torch/dpr.jsonl), two more seeds, bf16 operands
    O=$OUT/card2; mkdir -p $O
    together \
        "python3 -m pixelsynth_tpu_torch.tools.training_evidence --stage dpr --steps 8000 --out $O/tool_s0_8000" \
        "python3 -c \"from pixelsynth_tpu_torch.tools.training_evidence import evidence_dpr; evidence_dpr('$O/tool_s2', steps=3200, seed=2)\"" \
        "python3 -c \"from pixelsynth_tpu_torch.tools.training_evidence import evidence_dpr; evidence_dpr('$O/tool_s3', steps=3200, seed=3)\"" \
        "$P --bf16-mm --steps 4000 --out $O/bf16_own" \
        "$P --bf16-mm --seed 1 --steps 4000 --out $O/bf16_own_s1" \
        "$P --init jax --jax-init $I --noise bank --bf16-mm --steps 4000 --out $O/bf16_jax_bank"
    ;;
card3)  # JAX's own draws (the key chain of its tool), with JAX's init or the port's
    O=$OUT/card3; mkdir -p $O
    together \
        "$P --init jax --jax-init $IN --noise bank --bank $D --out $O/jaxinit_jaxdraws" \
        "$P --init jax --jax-init $IN --noise bank --bank $D --out $O/jaxinit_jaxdraws_rep" \
        "$P --init own --noise bank --bank $D --out $O/owninit_jaxdraws" \
        "$P --init jax --jax-init $IN --noise bank --bank $D --bf16-mm --out $O/jaxinit_jaxdraws_bf16"
    ;;
card4)  # float64 / float32 with K2's plain version
    O=$OUT/card4; mkdir -p $O
    R="$P --init jax --jax-init $IN --noise bank --bank $D --steps 2000 --plain-k2"
    together "$R --float64 --out $O/f64_plaink2" "$R --out $O/f32_plaink2" \
        "$R --float64 --log-every 50 --out $O/f64_plaink2_rep"
    ;;
card5)  # JAX's init and draws, 1500 steps
    $P --init jax --jax-init $IN --noise bank --bank $D --steps 1500 --out $OUT/card5/state1500
    ;;
card6)  # the tool at six more seeds
    O=$OUT/card6; mkdir -p $O
    cmds=()
    for k in 4 5 6 7 8 9; do
        cmds+=("python3 -c \"from pixelsynth_tpu_torch.tools.training_evidence import evidence_dpr; evidence_dpr('$O/tool_s$k', steps=3200, seed=$k)\"")
    done
    together "${cmds[@]}"
    ;;
card8)     # the tool at seed 0 for 8000 steps and at seeds 1-3 for 3200 (evidence/torch/dpr*)
    O=$OUT/card8; mkdir -p $O
    cmds=("python3 -m pixelsynth_tpu_torch.tools.training_evidence --stage dpr --width 64 --steps 8000 --out $O/dpr_s0")
    for k in 1 2 3; do
        cmds+=("python3 -c \"from pixelsynth_tpu_torch.tools.training_evidence import evidence_dpr; evidence_dpr('$O/dpr_s$k', steps=3200, seed=$k)\"")
    done
    together "${cmds[@]}"
    ;;
cpu)    # per-step metrics of the first 120 steps, both packages, JAX's init and draws
    together \
        "JAX_PLATFORMS=cpu taskset -c 2-4 python scripts/dpr_bisect/jax_run.py --noise bank --bank $D --steps 120 --metrics-only --out $B/cpu_steps_jax" \
        "taskset -c 5-7 $P --init jax --jax-init $I --noise bank --bank $D --device cpu --threads 3 --steps 120 --metrics-only --out $B/cpu_steps_port"
    ;;
cpu_long)  # the port on the CPU for 1600 steps, JAX's init and draws (bisect/cpu_port_jaxinit_jaxdraws_1600)
    taskset -c 0-3 $P --init jax --jax-init $I --noise bank --bank $D --device cpu --threads 4 \
        --steps 1600 --metrics-only --out $B/cpu_port_long
    ;;
compare)   # one step of each package from each JAX state 0-111 (bisect/cpu_step_compare)
    together \
        "JAX_PLATFORMS=cpu taskset -c 0-6 python $S reference --steps 113 --init $I --draws $D --dir $B/states" \
        "JAX_PLATFORMS=cpu taskset -c 5-7 python $S compare --steps 112 --init $I --draws $D --dir $B/states --consume --out $B/compare.jsonl"
    ;;
swap)      # 112 steps, one tree on the port's update (bisect/cpu_swap)
    together \
        "JAX_PLATFORMS=cpu taskset -c 0-6 python $S swap --tree none --init $I --draws $D --out $B/swap.jsonl" \
        "JAX_PLATFORMS=cpu taskset -c 5-7 python $S swap --tree none --init $I --draws $D --out $B/swap.jsonl" \
        "JAX_PLATFORMS=cpu taskset -c 0-6 python $S swap --tree projector --init $I --draws $D --out $B/swap.jsonl" \
        "JAX_PLATFORMS=cpu taskset -c 0-6 python $S swap --tree disc --init $I --draws $D --out $B/swap.jsonl"
    ;;
card7)     # on the card: the step beside the CPU's in float64, and the operations' gradients (card_vs_cpu/)
    O=$OUT/card7; mkdir -p $O
    python3 scripts/dpr_bisect/card_vs_cpu.py --float64 --steps 6 --leaves 2 --init $IN --bank $D --out $O/cvc_f64.jsonl
    python3 scripts/dpr_bisect/op_grads.py --init $IN --out $O/ops.json
    ;;
*)
    sed -n '2,/^set -eu/p' "$0" | sed '$d'; exit 2
    ;;
esac
