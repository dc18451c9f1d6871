"""Training CLI: `python -m phoregen_tpu_torch.cli.train --config x.yml`.

Counterpart of `phoregen_tpu/cli/train.py` (argparse --config, host banner,
`Run().train`). The dataset is `get_dataset`'s: the ZINC / PDBBind file
lists when the config names them (read through the per-item cache under
`dataset.save_path` first), else the hermetic corpus it generates from a
seed (`--synthetic_size N` sets its size). Runs on the card unless
`--device cpu` is given.

Data-parallel training (`parallel/group.py`), where the JAX CLI shards
over a `data` mesh of `train.num_devices` devices (0 = all):
- under `torchrun` (`RANK` and `WORLD_SIZE` set) this process joins the
  group torchrun describes, on `cuda:$LOCAL_RANK` (NCCL) or the CPU
  (gloo);
- otherwise, when `train.num_devices` stands for more than one device,
  the CLI builds the CUDA kernels once and starts one process per device
  with `torch.multiprocessing.spawn` (NCCL, rank r on `cuda:r`; with
  `--device cpu`, that many gloo ranks on the CPU). More CUDA devices than
  are visible is a SystemExit that names both numbers.
`train.batch_size` is the global batch, as in the JAX package.
"""
from __future__ import annotations

import argparse
import os
import socket


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PhoreGen training (PyTorch port)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--epochs", type=int, default=None,
                   help="override train.epochs")
    p.add_argument("--synthetic_size", type=int, default=0,
                   help="use N hermetic pairs instead of dataset files")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device kind: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _train(args, device):
    """Build the dataset and the `Run` on `device`; train; returns the
    history (the same on every rank)."""
    from ..config import load_config
    from ..data.dataset import get_dataset
    from ..parallel import group
    from ..train.loop import Run
    cfg = load_config(args.config)
    lead = group.rank() == 0
    try:
        train_set, valid_set, _ = get_dataset(
            cfg, synthetic_size=args.synthetic_size)
        if lead:
            print(f"[I] Dataset: {len(train_set)} train / "
                  f"{len(valid_set)} valid")
        run = Run(cfg, device=device)
    except NotImplementedError as e:
        raise SystemExit(f"[E] {e}")
    history = run.train(train_set, valid_set, epochs=args.epochs)
    if lead:
        print(f"[I] Done. best valid loss "
              f"{run.logger.best_valid:.4f} @ epoch {run.logger.best_epoch}")
    return history


def _worker(rank, world, init_method, args):
    """One spawned rank: join the group on its device, train."""
    from ..parallel import group
    kind = "cuda" if args.device.startswith("cuda") else "cpu"
    device = group.device_for(rank, kind)
    group.init(rank, world, init_method, device)
    try:
        return _train(args, device)
    finally:
        group.shutdown()


def _needs_kernels(cfg) -> bool:
    d = cfg.model.denoiser
    return d.fused_stack.startswith("pallas") or d.use_pallas_triplet


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..config import load_config
    from ..parallel import group
    kind = "cuda" if args.device.startswith("cuda") else "cpu"
    if kind == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[E] no CUDA device found; pass --device cpu to "
                         "train on the CPU")
    if group.in_torchrun():
        device = group.init_from_env(kind)
        try:
            return _train(args, device)
        finally:
            group.shutdown()
    cfg = load_config(args.config)
    n = group.device_count(cfg.train.num_devices, kind, "train.num_devices")
    name = torch.cuda.get_device_name(0) if kind == "cuda" else "cpu"
    print(f"[I] Host: {socket.gethostname()} PID: {os.getpid()} "
          f"Device: {args.device} ({name}) x {n}")
    if n == 1:
        return _train(args, torch.device(args.device))
    if kind == "cuda" and _needs_kernels(cfg):
        # once, before the ranks start: they would build into one
        # directory at the same time
        from ..ops import _build
        _build.build()
    return group.launch(_worker, n, (args,))[0]


if __name__ == "__main__":
    main()
