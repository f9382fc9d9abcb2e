"""Experiment tracking: local JSONL always, wandb when available; the port's
own copy of ``repmode_tpu.utils.tracking``.

The reference depends hard on wandb (main.py:79-108,168,180; fnet_model.py:123).
Here tracking is a thin seam: every log_dict/summary lands in
<log_dir>/metrics.jsonl (machine-readable, survives offline runs), and is
mirrored to wandb only when the run is online and the package imports,
matching the reference's offline toggle (--debugging, main.py:57-60).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger("repmode_tpu_torch")


class Tracker:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        project: str = "SSP",
        run_name: Optional[str] = None,
        config: Optional[dict] = None,
        tags=(),
        offline: bool = False,
        run_id: Optional[str] = None,
        entry_point: str = "train",
        code_files=(),
    ):
        self._jsonl = None
        self._code_files = []
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if config is not None:
                # snapshot the full run config next to the metrics
                # (reference main.py:107-108 json.dump(vars(opts))). Named
                # per entry point so an evaluate run pointed at the same
                # logs dir cannot clobber the training run's record.
                name = ("config.json" if entry_point == "train"
                        else f"config_{entry_point}.json")
                with open(os.path.join(log_dir, name), "w") as f:
                    json.dump(config, f, indent=2, sort_keys=True)
            if code_files:
                self._snapshot_code(log_dir, code_files)
        self.summary: Dict = {}
        self._wandb = None
        if not offline:
            try:
                import wandb  # optional
            except ImportError:
                wandb = None
            if wandb is not None:
                if run_id is not None:
                    os.environ["WANDB_RESUME"] = "must"
                try:
                    self._wandb = wandb.init(
                        project=project,
                        name=run_name,
                        tags=list(tags) or None,
                        config=config,
                        id=run_id,
                    )
                except Exception as e:  # wandb init failures must be loud
                    log.warning("wandb.init failed (%s: %s) — local JSONL "
                                "tracking only", type(e).__name__, e)
                    self._wandb = None
            if self._wandb is not None and self._code_files:
                # mirror the local code snapshot into the run
                # (reference main.py:100-106 wandb.save of the key sources)
                for src in self._code_files:
                    try:
                        self._wandb.save(src, policy="now")
                    except Exception as e:
                        log.warning("wandb.save(%s) failed: %s", src, e)

    def _snapshot_code(self, log_dir: str, files):
        """Copy key source files into <log_dir>/code/ and, when wandb is on,
        save them into the run (reference main.py:100-106 wandb.save of
        SSPdataset/fnet_model/<nn_module>/config)."""
        import shutil

        code_dir = os.path.join(log_dir, "code")
        os.makedirs(code_dir, exist_ok=True)
        for src in files:
            if not os.path.isfile(src):
                log.warning("code snapshot: %s not found, skipped", src)
                continue
            shutil.copy2(src, os.path.join(code_dir, os.path.basename(src)))
            self._code_files.append(src)

    def log(self, d: Dict):
        if self._jsonl is not None:
            rec = {"_ts": time.time()}
            rec.update({k: v for k, v in d.items() if _scalar(v)})
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(d)

    def set_summary(self, key: str, value):
        self.summary[key] = value
        if self._wandb is not None:
            self._wandb.summary[key] = value

    def finish(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish(quiet=True)


def _scalar(v) -> bool:
    return isinstance(v, (int, float, str, bool)) or (
        hasattr(v, "ndim") and getattr(v, "ndim", 1) == 0
    )
