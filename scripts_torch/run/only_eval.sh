#!/usr/bin/env bash
# Test-only evaluation of a saved checkpoint on the CUDA card, through
# repmode_tpu_torch. The port's counterpart of scripts/run/only_eval.sh, with
# one difference: that script loads an Orbax directory (--path_load_model
# exps/test/checkpoints/model_best_test), which the port does not read. The
# port keeps its best checkpoint as a reference .p file,
# <EXP_DIR>/checkpoints/model_best_<exp>.p, and cli.evaluate takes it with
# --torch_checkpoint; the default is the file train_and_eval.sh's default
# EXP_DIR leaves behind.
# Usage: bash scripts_torch/run/only_eval.sh [MODEL] [EXP_DIR] [CHECKPOINT] [args...]
set -euo pipefail
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

MODEL_NAME=${1:-RepMode}
EXP_NAME=${2:-exps/test}
CHECKPOINT=${3:-exps/test/checkpoints/model_best_test.p}

exec python3 -m repmode_tpu_torch.cli.evaluate \
       --nn_module "${MODEL_NAME}" \
       --path_exp_dir "${EXP_NAME}" \
       --torch_checkpoint "${CHECKPOINT}" \
       --path_load_dataset data/all_data \
       "${@:4}"
