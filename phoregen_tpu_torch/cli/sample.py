"""Sampling CLI: `python -m phoregen_tpu_torch.cli.sample --ckpt ... --phore ...`.

Counterpart of `phoregen_tpu/cli/sample.py` for the PyTorch port, with its
flags: flax msgpack release checkpoints read without flax,
and reference PhoreGen `.pt` checkpoints (`--ckpt x.pt --config <yml>`,
`denoiser.triplet_mode: dense`) read through a restricted unpickler.
`--device` stands for the JAX CLI's `--platform`; its `--unroll` (XLA's
scan unrolling) has no counterpart, since the reverse loop here is a Python
loop. `--sample_devices N` shards each pool over N devices (0 = every
visible CUDA device, 1 = unsharded; `sample/pipeline.py`): on `cuda`,
`cuda:0` to `cuda:N-1`, and more than are visible is a SystemExit; with
`--device cpu`, N shards on the CPU; with `--chunk_steps` > 0 a warning
and one device, as in the JAX CLI. The denoiser's path follows the
checkpoint's own configuration (the release checkpoints: the per-layer module path,
`fused_stack: none`) unless overridden: `--fused_stack pallas` selects the
fused layer stack (four CUDA kernels per layer; `pallas3` three, `pallas2`
two, with merged stages), `--triplet_knn 0` the
exact all-k triplets, `--use_pallas_triplet 1` their CUDA kernel. Runs on
the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="PhoreGen sampling (PyTorch port)",
        epilog="The JAX CLI's --unroll (XLA's scan unrolling) has no "
               "counterpart here: the reverse loop is a Python loop. "
               "--device takes the place of --platform.")
    p.add_argument("--config", type=str, default="",
                   help="YAML config; defaults to the one in the checkpoint")
    p.add_argument("--ckpt", "--check_point", dest="ckpt", type=str,
                   required=True,
                   help="checkpoint prefix (expects <ckpt>.msgpack/.json), "
                        "or a reference PhoreGen .pt file (needs --config)")
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
    p.add_argument("--save_traj", action="store_true")
    p.add_argument("--save_traj_prob", type=float, default=0.0,
                   help="save each accepted molecule's trajectory with this "
                        "probability (implies trajectory capture when > 0)")
    p.add_argument("--save_pool", action="store_true",
                   help="dump raw sampled pools as <name>_samples_all.npz")
    p.add_argument("--chunk_steps", type=int, default=0,
                   help="wait for the card after every this many reverse "
                        "steps, where the JAX package splits its scan into "
                        "device calls (the same steps and outputs bit for "
                        "bit; 0 = no waits)")
    p.add_argument("--fused_stack", default="",
                   choices=["", "none", "xla", "xla2", "pallas", "pallas3",
                            "pallas2"],
                   help="override denoiser.fused_stack ('' = the "
                        "checkpoint's own value): 'none' = per-layer "
                        "modules, 'pallas' = the fused layer stack (four "
                        "CUDA kernels per layer), 'pallas3'/'pallas2' = the "
                        "same with merged stages (three / two kernels per "
                        "layer), 'xla'/'xla2' = the fused stack's plain "
                        "PyTorch stages")
    p.add_argument("--fused_block_dtype", default="",
                   choices=["", "float32", "bfloat16"],
                   help="override denoiser.fused_block_dtype: 'bfloat16' "
                        "stores the fused stack's inter-stage blocks pre_t "
                        "and q_z in bf16 on 'pallas*' (arithmetic float32) "
                        "and runs the carries, packed weights and feature "
                        "products in bf16 on 'xla2'")
    p.add_argument("--edge_mlp_apply", default="",
                   choices=["", "split", "concat"],
                   help="override denoiser.edge_mlp_apply (same parameters, "
                        "same algebra)")
    p.add_argument("--use_pallas_triplet", type=int, default=-1,
                   choices=[-1, 0, 1],
                   help="override denoiser.use_pallas_triplet: 1 = the CUDA "
                        "kernel for the all-k triplet pool, 0 = its plain "
                        "PyTorch version, -1 = the checkpoint's own value")
    p.add_argument("--time_budget", type=float, default=0.0,
                   help="per-phore wall-time budget in seconds (0 = none)")
    p.add_argument("--max_batches", type=int, default=0,
                   help="per-phore cap on sampled batches (0 = none)")
    p.add_argument("--triplet_knn", type=int, default=-1,
                   help="override denoiser.triplet_knn (0 = exact all-k "
                        "triplet attention, K > 0 = the K nearest "
                        "neighbours; -1 = the checkpoint's own value)")
    p.add_argument("--force", action="store_true",
                   help="allow sampling triplet_knn narrower than trained")
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--use_ema", action="store_true",
                   help="sample a training checkpoint's EMA shadow "
                        "(ema_params; needs train.ema true)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    p.add_argument("--recon_workers", type=int, default=0,
                   help="reconstruct and check sampled molecules in this "
                        "many spawned worker processes (0 = in-process)")
    p.add_argument("--sample_devices", type=int, default=0,
                   help="shard each sampling pool's graphs over this many "
                        "devices (0 = all visible CUDA devices; 1 = no "
                        "sharding; with --device cpu, shards on the CPU). "
                        "Graphs are independent, so the shards need no "
                        "collective.")
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


def _check_knn_narrowing(args, trained_knn: int, source: str):
    """Sampling with fewer triplet sources than the model was trained with
    collapses acceptance (the JAX package's knn-match finding); widening,
    or exact 0, is safe."""
    if args.triplet_knn == trained_knn:
        return
    narrowing = (args.triplet_knn != 0
                 and (trained_knn == 0 or args.triplet_knn < trained_knn))
    if narrowing and not args.force:
        raise SystemExit(
            f"[E] sampling triplet_knn={args.triplet_knn} narrows below "
            f"the {source} triplet_knn={trained_knn}, which collapses "
            f"acceptance. Use 0 (exact), K >= trained, or --force.")
    print(f"[W] sampling triplet_knn={args.triplet_knn} != {source} "
          f"triplet_knn={trained_knn}: 0 (exact) or K >= trained is safe")


def _override(args, dcfg):
    """The denoiser overrides of the command line, on the config."""
    if args.fused_stack:
        dcfg.fused_stack = args.fused_stack
    if args.fused_block_dtype:
        dcfg.fused_block_dtype = args.fused_block_dtype
    if args.edge_mlp_apply:
        dcfg.edge_mlp_apply = args.edge_mlp_apply
    if args.use_pallas_triplet >= 0:
        dcfg.use_pallas_triplet = bool(args.use_pallas_triplet)


def load_model(args):
    """(pg, meta) of the checkpoint `args.ckpt` on `args.device`, with the
    command line's overrides."""
    from ..config import config_from_dict, load_config
    from ..models.phoregen import load_reference_model, load_release_model

    if args.ckpt.endswith(".pt"):
        # a reference PhoreGen checkpoint: bare model weights, read with
        # the restricted unpickler and mapped onto a dense-triplet config
        if not args.config:
            raise SystemExit(
                "[E] loading a reference .pt checkpoint requires --config "
                "(a YAML matching the reference architecture, with "
                "model.denoiser.triplet_mode: dense)")
        if args.use_ema:
            raise SystemExit("[E] --use_ema: reference .pt checkpoints "
                             "are imported as bare model weights")
        cfg = load_config(args.config)
        dcfg = cfg.model.denoiser
        if args.triplet_knn >= 0:
            _check_knn_narrowing(args, dcfg.triplet_knn, "config")
            dcfg.triplet_knn = args.triplet_knn
        _override(args, dcfg)
        pg, meta = load_reference_model(args.ckpt, cfg, device=args.device)
        print(f"[I] Imported reference checkpoint {args.ckpt} "
              f"(epoch {meta.get('epoch', '?')})")
        return pg, meta

    with open(args.ckpt + ".json") as f:
        meta = json.load(f)
    if args.use_ema and not bool(meta.get("config", {}).get(
            "train", {}).get("ema", False)):
        raise SystemExit(
            "[E] --use_ema: this checkpoint was trained with "
            "train.ema=false, so its EMA shadow is the untrained init "
            "copy. Re-run without --use_ema (or retrain with ema=true).")
    cfg = load_config(args.config) if args.config \
        else config_from_dict(meta["config"])
    dcfg = cfg.model.denoiser
    if args.triplet_knn >= 0:
        _check_knn_narrowing(args, int(
            meta["config"]["model"]["denoiser"].get("triplet_knn", 0)),
            "trained")
        dcfg.triplet_knn = args.triplet_knn
    _override(args, dcfg)
    try:
        pg, meta = load_release_model(args.ckpt, device=args.device,
                                      config=cfg, use_ema=args.use_ema)
    except ValueError as e:
        if not args.use_ema:
            raise
        raise SystemExit(f"[E] --use_ema: {e}")
    print(f"[I] Loaded checkpoint {args.ckpt} (step {meta.get('step')})")
    return pg, meta


def main(argv=None):
    """Sample every phore of `--phore`; returns {"pipeline": the closed
    GenerationPipeline (its timing and bucket fields), "results": one
    `generate` result per phore}."""
    args = parse_args(argv)
    from ..parallel import group
    kind = "cuda" if args.device.startswith("cuda") else "cpu"
    n_dev = group.device_count(args.sample_devices, kind, "--sample_devices")
    devices = None
    if n_dev > 1 and args.chunk_steps > 0:
        print("[W] --sample_devices is ignored with --chunk_steps > 0 "
              "(chunked execution is single-device); running unsharded")
    elif n_dev > 1:
        devices = ([f"cuda:{i}" for i in range(n_dev)] if kind == "cuda"
                   else ["cpu"] * n_dev)
        print(f"[I] Pool-parallel sampling over {n_dev} devices")
    from .. import native
    from ..data.phore import parse_phore_file
    from ..sample.pipeline import GenerationPipeline
    from ..sample.sampler import GuidanceOpt

    try:
        pg, _ = load_model(args)
    except NotImplementedError as e:
        raise SystemExit(f"[E] {e}")
    print("[I] host bond perception: " + (
        f"native library {native.library_path()}" if native.available()
        else f"Python loop ({native.load_error()})"))
    guidance = None
    if args.pos_guidance_opt:
        guidance = [GuidanceOpt(**g) for g in
                    json.loads(args.pos_guidance_opt)]
    os.makedirs(args.result_path, exist_ok=True)
    n_ok = n_fail = 0
    results = []
    with GenerationPipeline(
            pg, guidance=guidance, sample_nodes_mode=args.sample_nodes_mode,
            normal_scale=args.normal_scale, add_edge=args.add_edge,
            batch_size=args.batch_size,
            keep_traj=args.save_traj or args.save_traj_prob > 0,
            seed=args.seed, sample_steps=args.sample_steps,
            device=args.device, chunk_steps=args.chunk_steps,
            devices=devices,
            recon_workers=args.recon_workers) as pipeline:
        for path in resolve_phore_paths(args.phore):
            res = pipeline.generate(
                parse_phore_file(path), args.num_samples,
                out_dir=args.result_path, save_pool=args.save_pool,
                traj_prob=(args.save_traj_prob if args.save_traj_prob > 0
                           else 1.0),
                time_budget=args.time_budget, max_batches=args.max_batches)
            results.append(res)
            n_ok += res["n_finished"]
            n_fail += res["n_failed"]
            print(f"[I] {res['name']}: {res['n_finished']}/"
                  f"{args.num_samples} in {res['seconds']:.1f}s (sampled "
                  f"{res['n_sampled']}, failed {res['n_failed']}, count "
                  f"interval {res['count_interval']})"
                  + (" [ABANDONED]" if res["abandoned"] else ""))
    print(f"[I] Total generated: {n_ok}, failed reconstructions: {n_fail}")
    return {"pipeline": pipeline, "results": results}


if __name__ == "__main__":
    main()
