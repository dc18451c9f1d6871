"""Write the seeded checkpoint of PhoreGen's published denoiser: the
port's reading of `configs/train_lig-phore.yml` with the dense triplet
bond attention (`denoiser.triplet_mode: dense`, every triplet k -> j -> i
at the full hidden width), in the release format (`<prefix>.msgpack` +
`<prefix>.json`) that `load_release_model` and the sampling CLI read.

The weights are `init_params(seed=11)`, but for the two atom-count heads:
their kernels are zero and their output biases are set so that the count
interval is [14, 38] atoms for every phore (the interval the trained
`release/flagship_r4` head gives P03211), and so pools land in the NL=48
bucket. Nothing else is trained.

    python scripts/make_upstream_dense.py [--out release/upstream_dense]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join("release", "upstream_dense")
SEED = 11
# the count interval the heads are pinned to, in atoms
COUNT_LOWER, COUNT_UPPER = 14, 38


def published_config():
    """The port's reading of `configs/train_lig-phore.yml` with the dense
    triplet bond update, the per-layer module path and float32."""
    from phoregen_tpu_torch.config import load_config
    cfg = load_config(os.path.join(REPO, "configs", "train_lig-phore.yml"))
    dcfg = cfg.model.denoiser
    dcfg.triplet_mode = "dense"
    dcfg.fused_stack = "none"
    cfg.model.compute_dtype = "float32"
    return cfg


def make_model(cfg=None, interval=(COUNT_LOWER, COUNT_UPPER)):
    """(PhoreGen, Config) with the checkpoint's weights, on the CPU: of
    `cfg` (default `published_config()`), the count heads pinned to
    `interval` atoms."""
    import torch

    from phoregen_tpu_torch.constants import MAX_ATOMS, MIN_ATOMS
    from phoregen_tpu_torch.models.phoregen import PhoreGen, init_params

    cfg = cfg if cfg is not None else published_config()
    pg = PhoreGen(cfg)
    init_params(pg.net, seed=SEED)
    # sigmoid(bias) = the normalised count; the lower head's mean is the
    # lower bound and the all-points head's the upper one
    logit = lambda n: math.log((n - MIN_ATOMS) / (MAX_ATOMS - n))
    with torch.no_grad():
        for name, n in zip(("atom_mlp_1_2", "atom_mlp_2"), interval):
            getattr(pg.net, name).kernel.zero_()
            getattr(pg.net, name).bias.fill_(logit(n))
    return pg, cfg


def write(prefix: str, cfg=None, interval=(COUNT_LOWER, COUNT_UPPER)
          ) -> None:
    """Write `<prefix>.msgpack` and `<prefix>.json` (`make_model`'s
    arguments)."""
    from phoregen_tpu_torch.utils.checkpoint import (msgpack_serialize,
                                                     to_jax_params)
    pg, cfg = make_model(cfg, interval)
    tree = {"params": to_jax_params(pg.net.state_dict())}
    with open(prefix + ".msgpack", "wb") as f:
        f.write(msgpack_serialize(tree))
    meta = {"release": True, "ema": False, "step": 0, "seed": SEED,
            "count_interval": list(interval), "config": cfg.to_dict()}
    with open(prefix + ".json", "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="checkpoint prefix (default %(default)s)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    write(args.out)
    print(f"wrote {args.out}.msgpack and {args.out}.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
