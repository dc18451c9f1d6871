"""Sampling CLI: `python -m phoregen_tpu_torch.cli.sample --ckpt ... --phore ...`.

Counterpart of `phoregen_tpu/cli/sample.py` for the PyTorch port: the same
flags where the port supports them, flax msgpack release checkpoints read
without flax, and the fused layer stack (`--fused_stack pallas`, the
hand-written CUDA kernels) as the default. Runs on the card unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PhoreGen sampling (PyTorch port)")
    p.add_argument("--config", type=str, default="",
                   help="YAML config; defaults to the one in the checkpoint")
    p.add_argument("--ckpt", "--check_point", dest="ckpt", type=str,
                   required=True,
                   help="checkpoint prefix (expects <ckpt>.msgpack/.json)")
    p.add_argument("--phore", "--phore_file_list", dest="phore", type=str,
                   nargs="+", required=True,
                   help=".phore files, a directory, or a file_index.json")
    p.add_argument("--result_path", "--outdir", dest="result_path", type=str,
                   default="./results/sampling")
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=30)
    p.add_argument("--sample_nodes_mode", type=str, default="uniform",
                   choices=["uniform", "normal"])
    p.add_argument("--normal_scale", type=float, default=4.0)
    p.add_argument("--add_edge", type=str, default="predicted",
                   choices=["predicted", "distance", "openbabel"])
    p.add_argument("--pos_guidance_opt", type=str, default="",
                   help='JSON, e.g. \'[{"type":"atom_prox","min_d":1.0,'
                        '"max_d":3.0},{"type":"center_prox"}]\'')
    p.add_argument("--sample_steps", type=int, default=0,
                   help="strided sampling: number of denoiser evaluations "
                        "(0 = all T steps)")
    p.add_argument("--fused_stack", default="pallas",
                   choices=["none", "xla", "xla2", "pallas", "pallas3",
                            "pallas2"],
                   help="denoiser layer-stack path; the port runs 'pallas' "
                        "(four CUDA kernels per layer), the others are later "
                        "slices")
    p.add_argument("--fused_block_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--time_budget", type=float, default=0.0,
                   help="per-phore wall-time budget in seconds (0 = none)")
    p.add_argument("--max_batches", type=int, default=0,
                   help="per-phore cap on sampled batches (0 = none)")
    p.add_argument("--triplet_knn", type=int, default=-1,
                   help="override denoiser.triplet_knn (-1 = checkpoint's)")
    p.add_argument("--force", action="store_true",
                   help="allow sampling triplet_knn narrower than trained")
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    p.add_argument("--sample_devices", type=int, default=1,
                   help="devices to shard sampling pools over (the port "
                        "samples on one device)")
    return p.parse_args(argv)


def resolve_phore_paths(specs):
    paths = []
    for s in specs:
        if s.endswith(".json"):
            with open(s) as f:
                index = json.load(f)
            base = os.path.dirname(s)
            vals = index.values() if isinstance(index, dict) else index
            for v in vals:
                v = v if isinstance(v, str) else v.get("phore", "")
                if os.path.isabs(v):
                    paths.append(v)
                    continue
                cands = [v, os.path.join(base, v),
                         os.path.join(base, os.path.basename(v))]
                paths.append(next((c for c in cands if os.path.exists(c)),
                                  cands[1]))
        elif os.path.isdir(s):
            paths.extend(sorted(glob.glob(os.path.join(s, "*.phore"))))
        else:
            paths.append(s)
    return paths


def main(argv=None):
    args = parse_args(argv)
    if args.ckpt.endswith(".pt"):
        raise SystemExit("[E] the PyTorch port reads flax msgpack release "
                         "checkpoints (<prefix>.msgpack + <prefix>.json); "
                         "reference .pt checkpoints are not supported yet")
    if args.sample_devices > 1:
        raise SystemExit("[E] --sample_devices > 1: multi-GPU sampling "
                         "pools are not ported yet; the port samples on one "
                         "device")
    if args.use_ema:
        raise SystemExit("[E] --use_ema: release checkpoints carry bare "
                         "model weights")
    from ..config import config_from_dict, load_config
    from ..data.phore import parse_phore_file
    from ..models.phoregen import load_release_model
    from ..sample.pipeline import GenerationPipeline
    from ..sample.sampler import GuidanceOpt

    with open(args.ckpt + ".json") as f:
        meta = json.load(f)
    cfg = load_config(args.config) if args.config \
        else config_from_dict(meta["config"])
    if args.triplet_knn >= 0:
        trained = int(meta["config"]["model"]["denoiser"].get(
            "triplet_knn", 0))
        if args.triplet_knn != trained and not args.force and (
                args.triplet_knn == 0 or args.triplet_knn < trained):
            raise SystemExit(
                f"[E] sampling triplet_knn={args.triplet_knn} differs from "
                f"the trained {trained} in a way that collapses acceptance; "
                f"use K >= trained or --force")
        cfg.model.denoiser.triplet_knn = args.triplet_knn
    cfg.model.denoiser.fused_block_dtype = args.fused_block_dtype
    pg, meta = load_release_model(args.ckpt, device=args.device, config=cfg,
                                  fused_stack=args.fused_stack)
    print(f"[I] Loaded checkpoint {args.ckpt} (step {meta.get('step')})")
    guidance = None
    if args.pos_guidance_opt:
        guidance = [GuidanceOpt(**g) for g in
                    json.loads(args.pos_guidance_opt)]
    pipeline = GenerationPipeline(
        pg, guidance=guidance, sample_nodes_mode=args.sample_nodes_mode,
        normal_scale=args.normal_scale, add_edge=args.add_edge,
        batch_size=args.batch_size, seed=args.seed,
        sample_steps=args.sample_steps, device=args.device)
    os.makedirs(args.result_path, exist_ok=True)
    n_ok = n_fail = 0
    for path in resolve_phore_paths(args.phore):
        res = pipeline.generate(parse_phore_file(path), args.num_samples,
                                out_dir=args.result_path,
                                time_budget=args.time_budget,
                                max_batches=args.max_batches)
        n_ok += res["n_finished"]
        n_fail += res["n_failed"]
        print(f"[I] {res['name']}: {res['n_finished']}/{args.num_samples} "
              f"in {res['seconds']:.1f}s (sampled {res['n_sampled']}, "
              f"failed {res['n_failed']}, "
              f"count interval {res['count_interval']})"
              + (" [ABANDONED]" if res["abandoned"] else ""))
    print(f"[I] Total generated: {n_ok}, failed reconstructions: {n_fail}")


if __name__ == "__main__":
    main()
