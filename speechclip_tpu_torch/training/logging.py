"""Metrics and run logging (port of speechclip_tpu/training/logging.py):
python logging set-up, and a metrics sink that always appends JSON lines to
``metrics.jsonl`` in the run directory, with TensorBoard
(``torch.utils.tensorboard``, when it imports) or wandb beside it as
``trainer.logger`` selects. A backend that does not import logs a warning
and leaves the JSON lines as the record.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def set_logging(level: str = "INFO") -> None:
    logging.basicConfig(
        level=getattr(logging, str(level).upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        force=True,
    )


class MetricsLogger:
    def __init__(self, log_dir: str, backend: Optional[str] = "tb",
                 project: Optional[str] = None, run_name: Optional[str] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        self._wandb = None
        if backend in ("tb", "tensorboard"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except ImportError as e:
                logging.getLogger(__name__).warning("tensorboard unavailable: %s", e)
        elif backend == "wandb":
            try:
                import wandb

                self._wandb = wandb.init(project=project or "speechclip_tpu", name=run_name,
                                         dir=log_dir)
            except Exception as e:  # wandb raises its own errors on init
                logging.getLogger(__name__).warning(
                    "wandb unavailable (%s); falling back to jsonl only", e)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        flat = {}
        for k, v in metrics.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    flat[f"{k}/{kk}"] = float(vv)
            else:
                try:
                    flat[k] = float(v)
                except (TypeError, ValueError):
                    continue
        record = {"step": int(step), "time": time.time(), **flat}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(flat, step=step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
