"""Metrics logging: a local JSONL stream always, wandb as well when it is
importable. A copy of `argus_tpu/logging_utils.py`: per-step train `loss`
and per-validation `val_loss`, under a generated run id that also names the
checkpoint. Records go to `outputs/logs/<run_id>.jsonl` under the
repository root unless a `log_dir` is given.
"""

from __future__ import annotations

import json
import os
import string
import time
from typing import Optional

import numpy as np

from argus_tpu_torch import ROOT


def generate_run_id(length: int = 8) -> str:
    """Short lowercase-alphanumeric run id (wandb-style)."""
    alphabet = string.ascii_lowercase + string.digits
    rng = np.random.default_rng()
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), size=length))


class MetricsLogger:
    """JSONL(+wandb) metrics sink. Construct on process 0 only, or pass enabled=False."""

    def __init__(
        self,
        project: str,
        run_id: Optional[str] = None,
        config: Optional[dict] = None,
        enabled: bool = True,
        log_dir: Optional[str] = None,
    ) -> None:
        self.project = project
        self.run_id = run_id or generate_run_id()
        self.enabled = enabled
        self._step = 0
        self._file = None
        self._wandb = None
        if not enabled:
            return

        log_dir = log_dir or os.path.join(ROOT, "outputs", "logs")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{self.run_id}.jsonl")
        self._file = open(self.path, "a", buffering=1)
        header = {"_type": "run_start", "project": project, "run_id": self.run_id, "time": time.time()}
        if config is not None:
            header["config"] = _jsonable(config)
        self._file.write(json.dumps(header) + "\n")

        try:  # optional wandb sink
            import wandb  # type: ignore

            self._wandb = wandb
            wandb.init(project=project, config=config, id=self.run_id, resume="allow")
        except Exception:
            self._wandb = None

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        if step is None:
            step = self._step
            self._step += 1
        record = {"step": step, "time": time.time()}
        record.update({k: _jsonable(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(v):
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if hasattr(v, "__dataclass_fields__"):
        return {k: _jsonable(getattr(v, k)) for k in v.__dataclass_fields__}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
