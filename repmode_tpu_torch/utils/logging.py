"""Experiment logging: file (DEBUG) + stdout (INFO); the port's copy of
``repmode_tpu.utils.logging``.

Mirrors the reference's logger setup (main.py:62-72) minus its hardcoded
UTC+8 timestamp shim — timestamps are local time here.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logger(log_dir: Optional[str] = None, exp_name: str = "exp") -> logging.Logger:
    logger = logging.getLogger("SSP")
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    logger.propagate = False

    sh = logging.StreamHandler(sys.stdout)
    sh.setLevel(logging.INFO)
    logger.addHandler(sh)

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(log_dir, f"run_{exp_name}.log"), mode="w"
        )
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
        logger.addHandler(fh)

    return logger
