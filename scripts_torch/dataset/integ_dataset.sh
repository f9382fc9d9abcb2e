#!/usr/bin/env bash
# Ingest CZIs -> npz store; doubles as a pipeline smoke test (num_epochs 0).
# The port's counterpart of scripts/dataset/integ_dataset.sh, through
# repmode_tpu_torch. Its arguments go on to cli.train: the CLI runs on the
# card and raises without one, so '--device cpu' ingests on the CPU.
# Usage: bash scripts_torch/dataset/integ_dataset.sh [args...]
set -euo pipefail
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

exec python3 -m repmode_tpu_torch.cli.train \
       --path_exp_dir exps/integ_dataset \
       --path_dataset_csv data/csvs \
       --path_dataset_czi data \
       --path_save_dataset data/all_data \
       --num_epochs 0 \
       "$@"
