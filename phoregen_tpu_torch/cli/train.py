"""Training CLI: `python -m phoregen_tpu_torch.cli.train --config x.yml`.

Counterpart of `phoregen_tpu/cli/train.py` (argparse --config, host banner,
`Run().train`). The dataset is the hermetic corpus `get_dataset` generates
from a seed (`--synthetic_size N` sets its size). Runs on the card unless
`--device cpu` is given.
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
                   help="torch device: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..config import load_config
    from ..data.dataset import get_dataset
    from ..train.loop import Run
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("[E] no CUDA device found; pass --device cpu to "
                         "train on the CPU")
    cfg = load_config(args.config)
    kind = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
            else "cpu")
    print(f"[I] Host: {socket.gethostname()} PID: {os.getpid()} "
          f"Device: {args.device} ({kind})")
    try:
        train_set, valid_set, _ = get_dataset(
            cfg, synthetic_size=args.synthetic_size)
        print(f"[I] Dataset: {len(train_set)} train / {len(valid_set)} valid")
        run = Run(cfg, device=args.device)
    except NotImplementedError as e:
        raise SystemExit(f"[E] {e}")
    history = run.train(train_set, valid_set, epochs=args.epochs)
    print(f"[I] Done. best valid loss "
          f"{run.logger.best_valid:.4f} @ epoch {run.logger.best_epoch}")
    return history


if __name__ == "__main__":
    main()
