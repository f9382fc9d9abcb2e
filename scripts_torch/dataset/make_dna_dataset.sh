#!/usr/bin/env bash
# Synthesize the 'dna' task (54/6/20 samples) from the other 11 datasets —
# every image carries a DNA channel annotation — through repmode_tpu_torch's
# pandas-free CSV tools: the port's counterpart of
# scripts/dataset/make_dna_dataset.sh, with the same files as output.
# Usage: bash scripts_torch/dataset/make_dna_dataset.sh   (after both splits)
set -euo pipefail
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

python3 - <<'PY'
from repmode_tpu_torch.data.csv_tools import make_sampled_dataset
USED = ["alpha_tubulin", "beta_actin", "desmoplakin", "fibrillarin",
        "lamin_b1", "membrane_caax_63x", "myosin_iib", "sec61_beta",
        "st6gal1", "tom20", "zo1"]
for ds_type, n in [("train", 54), ("val", 6), ("test", 20)]:
    make_sampled_dataset("data/csvs", "data/csvs/dna.csv", "data/csvs",
                         ds_type, USED, sample_num=n)
PY
