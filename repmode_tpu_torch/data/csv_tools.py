"""Dataset CSV tooling without pandas: the port's copy of
``repmode_tpu.data.csv_tools`` (train/val/test splits and DNA-task synthesis).

The card's machine has no pandas, so the CSVs are read and written with the
``csv`` module and numpy, and hold pandas' conventions, so the same input
gives byte-equal files:

  * ``read_csv`` infers a column's type as ``pandas.read_csv`` does with its
    defaults: a column of integers reads as ints, integers with an empty
    field or any float as floats (the empty field NaN), true/false as bools,
    anything else as strings (an empty field NaN);
  * ``write_csv`` writes as ``DataFrame.to_csv(index=False)``: NaN and None as
    an empty field, a float column's values in their shortest repr ("3.0"),
    an int column's as integers, minimal quoting, "\\n" line ends.

The shuffles keep the reference's RNG protocol (np.random.RandomState(seed),
pandas ``sample(frac=1.0)``, which draws ``permutation(n)``), so the same
seeds reproduce the same splits:
  * split_dataset        -- scripts/python/split_dataset.py:17-57
  * make_sampled_dataset -- scripts/python/make_dataset.py:8-77 (the 'dna'
    task is sampled from the 11 other datasets, since every image carries a
    DNA channel annotation; README.md:80-81)
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Row = Dict[str, Any]

# pandas.read_csv's default NA strings (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|[+-]?(inf|infinity)", re.I)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


def is_na(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def _parse_column(raw: List[str]) -> List[Any]:
    """One column's strings -> values typed as pandas.read_csv infers them."""
    present = [s for s in raw if s not in NA_STRINGS]
    has_na = len(present) < len(raw)
    if not present:
        return [math.nan] * len(raw)
    if all(_INT.fullmatch(s) for s in present):
        if not has_na:
            return [int(s) for s in raw]
        return [math.nan if s in NA_STRINGS else float(int(s)) for s in raw]
    if all(_FLOAT.fullmatch(s) for s in present):
        return [math.nan if s in NA_STRINGS else float(s) for s in raw]
    if all(s in _BOOLS for s in present):
        return [math.nan if s in NA_STRINGS else _BOOLS[s] for s in raw]
    return [math.nan if s in NA_STRINGS else s for s in raw]


def read_csv(path: str) -> Tuple[List[str], List[Row]]:
    """(columns, rows): the header and one dict a row, typed per column."""
    with open(path, newline="", encoding="utf-8") as f:
        lines = [r for r in csv.reader(f) if r]  # pandas skips blank lines
    if not lines:
        raise ValueError(f"{path}: no header")
    columns, body = lines[0], lines[1:]
    raw = {c: [r[j] if j < len(r) else "" for r in body] for j, c in enumerate(columns)}
    typed = {c: _parse_column(v) for c, v in raw.items()}
    rows = [{c: typed[c][i] for c in columns} for i in range(len(body))]
    return columns, rows


def concat(tables: Sequence[Tuple[List[str], List[Row]]]) -> Tuple[List[str], List[Row]]:
    """Rows of several tables in order, as ``pd.concat`` joins them: the union
    of the columns (NaN where a table lacks one), a column of ints in one
    table and floats or NaN in another becomes floats, and a column mixing
    strings or bools with anything else keeps each value as it was."""
    columns: List[str] = []
    for cols, _ in tables:
        columns += [c for c in cols if c not in columns]
    rows = [{c: r.get(c, math.nan) for c in columns} for _, rs in tables for r in rs]
    for c in columns:
        kinds = {_kind([r[c] for r in rs] if c in cols else [math.nan])
                 for cols, rs in tables}
        if kinds <= {"int", "float"} and "float" in kinds:
            for r in rows:
                if not is_na(r[c]):
                    r[c] = float(r[c])
    return columns, rows


def _kind(values: Sequence[Any]) -> str:
    """The dtype pandas gives a column of these values: bool, int, float32,
    float or object."""
    if not values:
        return "object"
    if all(isinstance(v, (bool, np.bool_)) for v in values):
        return "bool"
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
           for v in values):
        return "int"
    numbers = [v for v in values if v is not None]
    if not numbers:
        return "object"
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in numbers):
        if len(numbers) == len(values) and all(isinstance(v, np.float32) for v in values):
            return "float32"
        return "float"
    return "object"


def _format_column(values: Sequence[Any]) -> List[str]:
    kind = _kind(values)
    if kind == "int":
        return [str(int(v)) for v in values]
    if kind == "float32":
        return ["" if is_na(v) else str(v) for v in values]
    if kind == "float":
        return ["" if is_na(v) else repr(float(v)) for v in values]
    return ["" if is_na(v) else str(v) for v in values]


def write_csv(path: str, columns: Sequence[str], rows: Sequence[Row]) -> None:
    """Write rows as ``pd.DataFrame(rows, columns=columns).to_csv(path,
    index=False)`` does (each column formatted by the dtype its values take)."""
    cells = {c: _format_column([r[c] for r in rows]) for c in columns}
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for i in range(len(rows)):
            w.writerow([cells[c][i] for c in columns])


def split_dataset(
    src_csv: str,
    dst_dir: str,
    train_size: Union[int, float] = 0.8,
    seed: int = 42,
    shuffle: bool = True,
    names=("train", "test"),
    name: Optional[str] = None,
) -> Optional[Tuple[List[Row], List[Row]]]:
    """Shuffle + head/tail split of one dataset CSV into <dst>/<name>/{a,b}.csv.

    `name` overrides the dataset-directory name; the train/val pass must pass
    the dataset name explicitly because its src is `<ds>/train.csv` (the
    reference's split_dataset_val.py derives it as src.split('/')[-2]).
    Returns the two row lists, or None when both files exist already.
    """
    if name is None:
        name = os.path.basename(src_csv).split(".")[0]
    out_dir = os.path.join(dst_dir, name)
    path_a = os.path.join(out_dir, f"{names[0]}.csv")
    path_b = os.path.join(out_dir, f"{names[1]}.csv")
    if os.path.exists(path_a) and os.path.exists(path_b):
        return None  # keep existing split (split_dataset.py:32-34)

    rng = np.random.RandomState(seed)
    columns, rows = read_csv(src_csv)
    if shuffle:
        rows = [rows[i] for i in rng.permutation(len(rows))]
    if train_size == 0:
        rows_a, rows_b = [], rows
    else:
        idx = (
            int(train_size)
            if isinstance(train_size, int) and not isinstance(train_size, bool)
            else round(len(rows) * float(train_size))
        )
        rows_a, rows_b = rows[:idx], rows[idx:]
    os.makedirs(out_dir, exist_ok=True)
    write_csv(path_a, columns, rows_a)
    write_csv(path_b, columns, rows_b)
    return rows_a, rows_b


def make_sampled_dataset(
    src_dir: str,
    src_csv: str,
    dst_dir: str,
    ds_type: str,
    used_ds: Sequence[str],
    sample_num: int = 54,
    seed: int = 42,
    shuffle: bool = True,
) -> Optional[List[Row]]:
    """Build a derived task CSV by sampling rows whose images appear in the
    other tasks' splits (make_dataset.py semantics, e.g. the 'dna' task).
    Returns the rows written, or None when the file exists already."""
    # rstrip strips characters, not the suffix: kept as the JAX package has it
    ds_name = os.path.basename(src_csv).rstrip(".csv")
    out_dir = os.path.join(dst_dir, ds_name)
    path_out = os.path.join(out_dir, f"{ds_type}.csv")
    if os.path.exists(path_out):
        return None

    rng = np.random.RandomState(seed)
    _, used = concat([read_csv(os.path.join(src_dir, ds, f"{ds_type}.csv")) for ds in used_ds])
    columns, src = read_csv(src_csv)
    if shuffle:
        used = [used[i] for i in rng.permutation(len(used))]

    idxs = np.arange(len(used))
    rng.shuffle(idxs)
    src_paths = [r["path_czi"] for r in src]
    selected: List[Row] = []
    cnt = 0
    for idx in idxs:
        path = used[idx]["path_czi"]
        if path in src_paths:
            selected += [r for r in src if r["path_czi"] == path]
            cnt += 1
        if cnt >= sample_num:
            break
    if not cnt:
        raise ValueError("No objects to concatenate: no sampled image is in the source CSV")

    os.makedirs(out_dir, exist_ok=True)
    write_csv(path_out, columns, selected)
    return selected
