"""Run logging: metric aggregation, JSON history, TensorBoard, best tracking.

Counterpart of `phoregen_tpu/train/logger.py`: run-dir lifecycle with
restart modes, `parameters.yml` + `model.conf` dumps, per-batch record ->
per-epoch weighted means, `history.log` (the whole history as JSON,
rewritten every epoch), best-valid-loss tracking, separate train/valid
TensorBoard writers where `tensorboardX` is installed, coarse epoch
wall-clock timing. Metrics are read from the device once per epoch.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import yaml

from .checkpoint import prepare_run_dir

try:  # gated: available in this image, but keep the loop importable anywhere
    from tensorboardX import SummaryWriter
    _HAS_TB = True
except Exception:  # pragma: no cover
    SummaryWriter = None
    _HAS_TB = False


class MetricLogger:
    """`resume` None: this process owns the run directory (prepares it,
    dumps the config, writes the history and prints). A bool: a reader
    for the other ranks of a process group, after rank 0 has prepared the
    directory and decided `resume`; it keeps the same history, writes
    nothing and prints nothing."""

    def __init__(self, config, run_dir: Optional[str] = None,
                 resume: Optional[bool] = None):
        self.config = config
        lcfg = config.logger
        self.run_dir = run_dir or os.path.join(lcfg.result, lcfg.run_name)
        self.writer = resume is None
        self.resume = (prepare_run_dir(self.run_dir, lcfg.restart)
                       if self.writer else resume)
        self.history: Dict[str, List[Dict[str, float]]] = {"train": [],
                                                           "valid": []}
        self.best_valid = float("inf")
        self.best_epoch = -1
        self.start_epoch = 0
        self.epoch = 0
        self.lr = config.train.optimizer.lr
        self._records: Dict[str, list] = {}
        self._t0 = 0.0
        self._writers = {}

        self.history_path = os.path.join(self.run_dir, "history.log")
        if self.resume and os.path.exists(self.history_path):
            self._load_history()

        if not self.writer:
            return
        # dump the run's config
        with open(os.path.join(self.run_dir, "parameters.yml"), "w") as f:
            yaml.safe_dump(config.to_dict(), f)
        with open(os.path.join(self.run_dir, "model.conf"), "w") as f:
            json.dump(config.to_dict()["model"], f, indent=1)

        if lcfg.tensorboard and _HAS_TB:
            for mode in ("train", "valid"):
                self._writers[mode] = SummaryWriter(
                    os.path.join(self.run_dir, "tb", mode))

    # ----- resume -----
    def _load_history(self):
        with open(self.history_path) as f:
            h = json.load(f)
        self.history = h.get("history", {"train": [], "valid": []})
        self.best_valid = h.get("best_valid", float("inf"))
        self.best_epoch = h.get("best_epoch", -1)
        self.start_epoch = h.get("epoch", -1) + 1
        # truncate any partial tail
        for mode in self.history:
            self.history[mode] = self.history[mode][:self.start_epoch]

    # ----- per-epoch protocol -----
    def start(self):
        self._t0 = time.time()

    def add_new_epoch(self, epoch: int):
        self.epoch = epoch
        self._records = {"train": [], "valid": []}

    def record(self, metrics: Dict[str, Any], mode: str,
               weight: float = 1.0):
        """`weight` down-weights a cycled tail batch (its duplicates would
        otherwise skew the epoch mean). Values may be tensors on the
        device: they are read when the epoch is summarized."""
        self._records.setdefault(mode, []).append(
            (dict(metrics), float(weight)))

    def summarize_epoch(self, mode: str) -> Dict[str, float]:
        rows = self._records.get(mode, [])
        if not rows:
            return {}
        w = np.asarray([weight for _, weight in rows])
        summary = {k: float(np.average([float(r[k]) for r, _ in rows],
                                       weights=w))
                   for k in rows[0][0]}
        summary["time_cost"] = time.time() - self._t0
        summary["lr"] = self.lr
        summary["epoch"] = self.epoch
        self.history[mode].append(summary)
        w = self._writers.get(mode)
        if w is not None:
            for k, v in summary.items():
                if k != "epoch":
                    w.add_scalar(k, v, self.epoch)
        return summary

    def update_best(self) -> bool:
        """Track best valid loss (train loss when no valid split exists);
        returns True when this epoch is a new best."""
        rows = self.history["valid"] or self.history["train"]
        if not rows:
            return False
        v = rows[-1].get("loss", float("inf"))
        if v < self.best_valid:
            self.best_valid = v
            self.best_epoch = self.epoch
            return True
        return False

    def flush_history(self):
        if not self.writer:
            return
        with open(self.history_path, "w") as f:
            json.dump({"history": self.history, "best_valid": self.best_valid,
                       "best_epoch": self.best_epoch, "epoch": self.epoch},
                      f, indent=1)

    def close(self):
        for w in self._writers.values():
            w.close()

    def log(self, msg: str, level: str = "I"):
        if self.writer:
            print(f"[{level}] {msg}", flush=True)
