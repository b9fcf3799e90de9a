"""Structured metrics logging (JSONL).

The port's copy of ``gsplat_tpu/utils/logging.py``, without its console
stream (``fit()`` prints its own lines through ``log_fn``); ``fit()``
writes ``train_metrics.jsonl`` through it, a machine-readable record for
dashboards and regression tracking.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Append-only JSONL metrics, one record per ``log`` call."""

    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, f"{name}_metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()
