#!/usr/bin/env bash
# 0.75 train / 0.25 test split per dataset (seed 42), through
# repmode_tpu_torch's pandas-free CSV tools: the port's counterpart of
# scripts/dataset/split_train_set.sh, with the same files as output. One
# python3 process loops over the tasks.
# Usage: bash scripts_torch/dataset/split_train_set.sh   (reads data/csvs/)
set -euo pipefail
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

python3 - beta_actin myosin_iib membrane_caax_63x desmoplakin sec61_beta \
          st6gal1 fibrillarin lamin_b1 alpha_tubulin tom20 zo1 <<'PY'
import sys
from repmode_tpu_torch.data.csv_tools import split_dataset
for name in sys.argv[1:]:
    split_dataset(f"data/csvs/{name}.csv", "data/csvs", train_size=0.75,
                  names=("train", "test"))
PY
