#!/usr/bin/env bash
# Full experiment on the CUDA card: train + periodic val + best-checkpoint
# test, through repmode_tpu_torch. The port's counterpart of
# scripts/run/train_and_eval.sh, with its flags and defaults.
# Usage: bash scripts_torch/run/train_and_eval.sh [MODEL] [EXP_DIR] [args...]
# Extra arguments go on to cli.train. No --device is passed: the CLI runs on
# the card and raises without one (a caller may pass --device cpu).
set -euo pipefail
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

MODEL_NAME=${1:-RepMode}
EXP_NAME=${2:-exps/test}

exec python3 -m repmode_tpu_torch.cli.train \
       --nn_module "${MODEL_NAME}" \
       --path_exp_dir "${EXP_NAME}" \
       --path_load_dataset data/all_data \
       --num_epochs 1000 \
       --batch_size 8 \
       --lr 0.0001 \
       --interval_val 20 \
       "${@:3}"
