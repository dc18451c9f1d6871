"""The training runtime: epoch loop, plateau LR schedule, checkpoints.

Counterpart of `phoregen_tpu/train/loop.py`: the host orchestrates the
epochs; one train step per batch (`train/step.py`); plateau scheduling on
the validation loss once per epoch; `last_model.*` every epoch and
`best_model.*` on the best validation loss; milestone snapshots of the
best model at epochs 160 and 250 for pretraining runs; stage-2 warm start
from a pretrain checkpoint when `dataset.checkpoint` is set and the
dataset is pdbbind; resume from `last_model` (`logger.restart`).

In a process group (`parallel/group.py`; `cli/train.py` starts one) each
rank runs this loop on its own device with the whole state, on its slice
of each global batch (`train/step.py` reduces): rank 0 logs and writes
the run directory, `history.log`, `last_model` and `best_model`, and the
other ranks wait for it at a barrier and read what it wrote. The history
is the one a single process writes on the same global batches.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.loader import PhoreDataLoader, RawSample
from ..models.phoregen import PhoreGen, init_params
from ..parallel import group
from ..utils.profiling import profile_trace
from .checkpoint import load_checkpoint, load_params_only, save_checkpoint
from .logger import MetricLogger
from .state import (TrainState, create_train_state, get_learning_rate,
                    set_learning_rate)
from .step import make_eval_step, make_train_step


def mix_step_seed(seed: int, epoch: int, mode: str, idx: int) -> np.uint32:
    """splitmix-style host-scalar seed for one step: mixes (run seed, epoch,
    train/valid mode, batch index) so no two steps of a run collide.
    uint64 wraparound is intentional (masked from numpy's overflow warning)."""
    with np.errstate(over="ignore"):
        mode_salt = np.uint64(0x9E3779B97F4A7C15 if mode == "train"
                              else 0xC2B2AE3D27D4EB4F)
        base = (np.uint64(seed) * np.uint64(0x100000001B3)
                ^ (np.uint64(epoch) * np.uint64(0x9E3779B97F4A7C15))
                ^ mode_salt)
        mixed = (base + np.uint64(idx)) * np.uint64(0xBF58476D1CE4E5B9)
        return np.uint32((mixed ^ (mixed >> np.uint64(31)))
                         & np.uint64(0xFFFFFFFF))


class PlateauScheduler:
    """ReduceLROnPlateau(min): factor, patience, min_lr, on the host."""

    def __init__(self, factor: float, patience: int, min_lr: float,
                 lr: float):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.lr = lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict:
        return {"lr": self.lr, "best": self.best,
                "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: Dict):
        self.lr = d.get("lr", self.lr)
        self.best = d.get("best", self.best)
        self.bad_epochs = d.get("bad_epochs", self.bad_epochs)


class Run:
    """Builds logger -> model -> state -> loaders; runs the epoch loop.
    `device`: where the model and this rank's batches live ('cuda' unless
    the caller asks for the CPU). In a process group, `train.num_devices`
    (when not 0) must be its world size."""

    def __init__(self, config, run_dir: Optional[str] = None,
                 device="cuda"):
        n = config.train.num_devices
        if n > 0 and n != group.world_size():
            raise ValueError(
                f"train.num_devices is {n} but this process group has "
                f"{group.world_size()} rank(s): start one process per "
                "device (phoregen_tpu_torch.cli.train does, or torchrun)")
        self.config = config
        self.device = torch.device(device)
        self.is_writer = group.rank() == 0
        # rank 0 prepares the run directory; the others follow its verdict
        # on resuming once it has
        self.logger = (MetricLogger(config, run_dir=run_dir)
                       if self.is_writer else None)
        resume = group.broadcast_object(
            self.logger.resume if self.is_writer else None)
        if not self.is_writer:
            self.logger = MetricLogger(config, run_dir=run_dir,
                                       resume=resume)
        self.pg = PhoreGen(config)
        self.train_step = None
        self.eval_step = None
        self.state: Optional[TrainState] = None
        self.scheduler: Optional[PlateauScheduler] = None

    # ----- init -----
    def init_state(self) -> TrainState:
        cfg = self.config
        net = self.pg.net
        init_params(net, cfg.train.seed)
        net.to(self.device).train()
        n_params = sum(p.numel() for p in net.parameters())
        self.logger.log(f"Model initialized with {n_params/1e6:.4f} M "
                        "parameters")

        # stage-2 warm start
        ds = cfg.dataset
        if ds.data_name == "pdbbind" and ds.checkpoint and \
                os.path.exists(ds.checkpoint + ".msgpack"):
            load_params_only(ds.checkpoint, net)
            self.logger.log(
                f"Loaded pretrained zinc weights from {ds.checkpoint}")

        state = create_train_state(cfg.train, net)
        self.scheduler = PlateauScheduler(
            cfg.train.scheduler.lr_decay_factor,
            cfg.train.scheduler.scheduler_patience,
            cfg.train.scheduler.min_lr,
            get_learning_rate(state.optimizer))

        # resume
        last = os.path.join(self.logger.run_dir, "last_model")
        if self.logger.resume and os.path.exists(last + ".msgpack"):
            state, meta = load_checkpoint(last, state)
            self.scheduler.load_state_dict(meta.get("scheduler", {}))
            self.logger.log(f"Resumed from epoch {meta.get('epoch')}")

        self.train_step = make_train_step(self.pg, cfg)
        self.eval_step = make_eval_step(self.pg, cfg)
        self.state = state
        return state

    # ----- epoch bodies -----
    def run_on_epoch(self, loader: PhoreDataLoader, mode: str,
                     epoch: int) -> None:
        cfg = self.config
        self.logger.start()
        loader.set_epoch(epoch)
        # optional torch.profiler capture of steps [1, 1+N) of epoch 0
        prof_n = cfg.logger.profile_steps if (
            mode == "train" and epoch == 0 and self.is_writer) else 0
        prof = None
        for idx, (batch, real_size) in enumerate(loader.iter_with_sizes()):
            if prof_n and idx == 1:
                prof = self._start_profile()
            if prof is not None and idx == 1 + prof_n:
                prof = self._stop_profile(prof)
            seed = mix_step_seed(cfg.train.seed, epoch, mode, idx)
            batch = batch.to(self.device)
            if mode == "train":
                metrics = self.train_step(self.state, seed, batch)
            else:
                # rows >= real_size in a cycled tail batch are duplicates;
                # the eval step zero-weights them so epoch means are exact
                # over distinct samples
                gmask = (torch.arange(loader.batch_size,
                                      device=self.device) < real_size
                         )[group.local_batch_slice(loader.batch_size)]
                metrics = self.eval_step(seed, batch, gmask)
            self.logger.record(metrics, mode=mode,
                               weight=real_size / loader.batch_size)
            if mode == "train" and idx and \
                    idx % cfg.train.n_report_steps == 0:
                self.logger.log(
                    f"Epoch {epoch} batch {idx}/{len(loader)} "
                    f"loss {float(metrics['loss']):.2f} "
                    f"grad_norm {float(metrics['grad_norm']):.1f}")
        if prof is not None:  # short epoch: close the trace cleanly
            self._stop_profile(prof)
        self.logger.summarize_epoch(mode)

    def _start_profile(self):
        prof = profile_trace(os.path.join(self.logger.run_dir, "profile"))
        prof.__enter__()
        return prof

    def _stop_profile(self, prof):
        prof.__exit__(None, None, None)
        self.logger.log("Profiler trace written to "
                        f"{os.path.join(self.logger.run_dir, 'profile')}")
        return None

    # ----- top-level train -----
    def train(self, train_samples: Sequence[RawSample],
              valid_samples: Sequence[RawSample],
              epochs: Optional[int] = None) -> Dict:
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.train.epochs
        train_loader = PhoreDataLoader(
            train_samples, cfg, cfg.train.batch_size, shuffle=True,
            seed=cfg.train.seed, augment=True)
        valid_loader = PhoreDataLoader(
            valid_samples, cfg, cfg.train.batch_size, shuffle=False,
            augment=False)

        have_valid = len(valid_loader) > 0
        if not have_valid:
            self.logger.log("validation set is empty: best-checkpoint and "
                            "plateau scheduling fall back to train loss", "W")
        if self.state is None:
            self.init_state()

        for epoch in range(self.logger.start_epoch, epochs):
            self.logger.add_new_epoch(epoch)
            self.logger.lr = get_learning_rate(self.state.optimizer)
            self.run_on_epoch(train_loader, "train", epoch)
            if have_valid:
                self.run_on_epoch(valid_loader, "valid", epoch)

            is_best = self.logger.update_best()
            if self.is_writer:
                self.save(epoch, is_best)
                self.logger.flush_history()
            group.barrier()

            # plateau schedule on the validation loss; train loss when no
            # validation split is configured
            src_hist = self.logger.history["valid" if have_valid else "train"]
            new_lr = self.scheduler.step(src_hist[-1]["loss"])
            if abs(new_lr - get_learning_rate(self.state.optimizer)) > 1e-12:
                set_learning_rate(self.state.optimizer, new_lr)
                self.logger.log(f"Plateau: lr -> {new_lr:.3e}")
        self.logger.close()
        return self.logger.history

    def save(self, epoch: int, is_best: bool):
        extra = {"scheduler": self.scheduler.state_dict()}
        last = os.path.join(self.logger.run_dir, "last_model")
        save_checkpoint(last, self.state, epoch, self.config, extra)
        best = os.path.join(self.logger.run_dir, "best_model")
        if is_best:
            save_checkpoint(best, self.state, epoch, self.config, extra)
        # milestone snapshots of the best model at epochs 160/250 of
        # pretraining (non-pdbbind) runs
        if (self.config.dataset.data_name != "pdbbind"
                and epoch in (160, 250)):
            snap = os.path.join(
                self.logger.run_dir,
                f"best_model_epoch{self.logger.best_epoch}")
            for ext in (".msgpack", ".json"):
                if os.path.exists(best + ext):
                    shutil.copyfile(best + ext, snap + ext)
