"""Experiment tracking (mmvae_tpu/utils/tracking.py): a JSONL metrics sink,
metrics.jsonl in the run dir, one JSON object per `log`. The JAX package
also logs to wandb where it is importable and enabled; the port does not
import wandb."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class Tracker:
    def __init__(self, run_path: Optional[str] = None):
        self._file = None
        if run_path is not None:
            os.makedirs(run_path, exist_ok=True)
            self._file = open(os.path.join(run_path, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        payload = {k: _to_py(v) for k, v in metrics.items()}
        if step is not None:
            payload["epoch"] = step
        payload["_t"] = time.time()
        if self._file is not None:
            self._file.write(json.dumps(payload) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
