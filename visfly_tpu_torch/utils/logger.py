"""Metrics logging: stdout and CSV, and TensorBoard where
``torch.utils.tensorboard`` imports (counterpart of
``visfly_tpu/utils/logger.py``; the same stdout table and ``progress.csv``)."""
from __future__ import annotations

import csv
import os
import time
from typing import Any, Dict, Optional


class Logger:
    def __init__(self, log_dir: Optional[str] = None,
                 formats=("stdout", "csv", "tensorboard")):
        self.log_dir = log_dir
        self.formats = formats
        self._values: Dict[str, Any] = {}
        self._csv_file = None
        self._csv_writer = None
        self._csv_keys = None
        self._tb = None
        self._t0 = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            if "tensorboard" in formats:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:  # no tensorboard package: stdout and CSV only
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(log_dir)

    def record(self, key: str, value: Any) -> None:
        self._values[key] = value

    def record_dict(self, values: Dict[str, Any], prefix: str = "") -> None:
        for k, v in values.items():
            self.record(prefix + k, v)

    def dump(self, step: int) -> None:
        vals = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                for k, v in self._values.items()}
        vals["time/elapsed"] = round(time.time() - self._t0, 1)
        if "stdout" in self.formats:
            width = max((len(k) for k in vals), default=10)
            lines = [f"| {'step':<{width}} | {step} |"]
            for k in sorted(vals):
                v = vals[k]
                s = f"{v:.4g}" if isinstance(v, float) else str(v)
                lines.append(f"| {k:<{width}} | {s} |")
            print("\n".join(lines), flush=True)
        if self.log_dir and "csv" in self.formats:
            if self._csv_writer is None or set(vals) - set(self._csv_keys):
                # new keys: the file is reopened with them (its header stays
                # the first one, as in the JAX package)
                if self._csv_file is not None:
                    self._csv_file.close()
                self._csv_keys = ["step"] + sorted(vals)
                self._csv_file = open(os.path.join(self.log_dir, "progress.csv"), "a",
                                      newline="")
                self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=self._csv_keys,
                                                  extrasaction="ignore")
                if self._csv_file.tell() == 0:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow({"step": step, **vals})
            self._csv_file.flush()
        if self._tb is not None:
            for k, v in vals.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()
        self._values = {}

    def close(self) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = self._csv_writer = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def append_csv(path: str, row: Dict[str, Any]) -> None:
    """One-shot CSV appender."""
    exists = os.path.exists(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            w.writeheader()
        w.writerow(row)
