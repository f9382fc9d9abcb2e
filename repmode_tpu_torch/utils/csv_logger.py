"""Dict-of-lists logger with CSV round-trip, without pandas: the port's copy
of ``repmode_tpu.utils.csv_logger``.

Equivalent of the reference's legacy FnetLogger (fnet/fnetlogger.py:4-33,
exported by fnet/__init__.py but unused on the main path): accumulate row
dicts, dump/load as CSV. Its files are byte-equal to the JAX package's
(``data/csv_tools.read_csv`` / ``write_csv`` keep pandas' conventions). The
main path logs through utils/tracking instead.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from repmode_tpu_torch.data.csv_tools import read_csv, write_csv


class CsvLogger:
    def __init__(self, path: Optional[str] = None, columns: Optional[Iterable[str]] = None):
        if path is not None:
            names, rows = read_csv(path)
            self.data = {c: [r[c] for r in rows] for c in names}
        else:
            self.data = {c: [] for c in (columns or [])}

    def add(self, entry: Dict) -> None:
        for key, value in entry.items():
            self.data.setdefault(key, []).append(value)

    def to_csv(self, path: str) -> None:
        lengths = {len(v) for v in self.data.values()}
        if len(lengths) > 1:
            raise ValueError("All arrays must be of the same length")
        n = lengths.pop() if lengths else 0
        columns = list(self.data)
        write_csv(path, columns, [{c: self.data[c][i] for c in columns} for i in range(n)])

    def __len__(self) -> int:
        return max((len(v) for v in self.data.values()), default=0)
