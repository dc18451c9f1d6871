"""Where one reverse step's time goes, on the card.

    python -m phoregen_tpu_torch.tools.profile_sampling --batch 16 --nl 48
    python -m phoregen_tpu_torch.tools.profile_sampling --nl 48 \
        --fused_stack none --triplet_knn 0 --use_pallas_triplet 1
    python -m phoregen_tpu_torch.tools.profile_sampling --nl 48 \
        --fused_stack pallas2 --fused_block_dtype bfloat16 \
        --compute_dtype bfloat16

Loads release/flagship_r4, builds a sampling batch of `--batch` graphs for
one pharmacophore in the `--nl` ligand bucket, and runs reverse steps of
the port's sampler: `--fused_stack pallas` (the default here: the fused
stack's four CUDA kernels), `pallas3` / `pallas2` (its merged kernels,
three / two a layer) or `none` (the per-layer module path, with
`--triplet_knn` and `--use_pallas_triplet` as in the sampling CLI; -1 keeps
the checkpoint's value; `--fused_block_dtype` and `--compute_dtype`
override `denoiser.fused_block_dtype` and `model.compute_dtype`, '' keeps
the checkpoint's). `--warmup` steps, then
`--steps` timed steps (host clock around work that ends in a synchronize),
then `--steps` steps under torch.profiler. Prints ms/step, the device's busy
time per step (sum of kernel times), its idle share, and the kernels by
total device time, then one JSON line with the same numbers. The idle share
is given twice: against the step time under the profiler (the window the
busy time was summed in), and against the step time without it, which is
what a user's run sees; they part where a step makes thousands of small
launches and the profiler's own cost per launch stretches the host's time.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


# kernel-name fragment -> stage; the merged kernels first, since
# "att_pos_kernel" also contains "pos_kernel"
STAGE_NAMES = (("node_pre_kernel", "stage_node_pre (A+B1)"),
               ("att_pos_kernel", "stage_att_pos (B2+C)"),
               ("node_kernel", "stage_node (A)"),
               ("trip_pre_kernel", "stage_triplet_pre (B1)"),
               ("trip_att_kernel", "stage_triplet_att (B2)"),
               ("pos_kernel", "stage_pos (C)"),
               ("rows_gemm", "node projections (A, B1, C)"),
               ("node_pos_query_kernel",
                "folded queries (A, A+B1, C, B2+C)"),
               ("triplet_pool_kernel", "triplet_pool (all-k)"))


def stage_label(key: str) -> str:
    return next((v for k, v in STAGE_NAMES if k in key), "")


def kernel_rows(prof, steps: int):
    """(ms/step, calls/step, name) of the device-side kernel events of a
    profile, largest first. Device events only: a CPU op (aten::mul) also
    reports the device time of the kernels it launched, which would count
    them twice."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = e.self_device_time_total
        if dt > 0:
            rows.append((dt / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    return rows


def stage_times(rows):
    out = {v: 0.0 for _, v in STAGE_NAMES}
    for ms, _, key in rows:
        if stage_label(key):
            out[stage_label(key)] += ms
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="release/flagship_r4")
    ap.add_argument("--phore",
                    default="tests/fixtures/phores/P03211_merge.phore")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--nl", type=int, default=48)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--fused_stack", default="pallas",
                    choices=["none", "xla", "xla2", "pallas", "pallas3",
                             "pallas2"])
    ap.add_argument("--triplet_knn", type=int, default=-1)
    ap.add_argument("--use_pallas_triplet", type=int, default=-1,
                    choices=[-1, 0, 1])
    ap.add_argument("--fused_block_dtype", default="",
                    choices=["", "float32", "bfloat16"])
    ap.add_argument("--compute_dtype", default="",
                    choices=["", "float32", "bfloat16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("[E] needs a CUDA device")

    from ..data.batching import replicate_phore
    from ..data.phore import parse_phore_file
    from ..models.phoregen import load_release_model
    from ..ops import layer_stack as ls
    from ..ops import pallas_triplet as pt
    from ..sample.pipeline import GenerationPipeline
    from ..sample.sampler import GuidanceOpt

    pg, _ = load_release_model(
        args.ckpt, device="cuda", fused_stack=args.fused_stack,
        triplet_knn=None if args.triplet_knn < 0 else args.triplet_knn,
        use_pallas_triplet=(None if args.use_pallas_triplet < 0
                            else bool(args.use_pallas_triplet)),
        fused_block_dtype=args.fused_block_dtype or None,
        compute_dtype=args.compute_dtype or None)
    dcfg = pg.config.model.denoiser
    pipe = GenerationPipeline(
        pg, guidance=[GuidanceOpt(type="atom_prox"),
                      GuidanceOpt(type="center_prox")], device="cuda")
    sample = pipe.prepare_phore(parse_phore_file(args.phore))
    rng = np.random.default_rng(0)
    counts = rng.integers(max(4, args.nl // 2), args.nl + 1, args.batch)
    counts[0] = args.nl
    batch = replicate_phore(sample, args.batch, counts, args.nl).to("cuda")
    sp = pipe.sampler
    gen = torch.Generator(device="cuda").manual_seed(0)
    inv = sp.prepare(batch)
    state = sp.init_state(batch, gen)
    i = 0

    def run(n):
        nonlocal state, i
        for _ in range(n):
            state, _ = sp.step(state, i, batch, inv, False, gen)
            i += 1

    run(args.warmup)
    torch.cuda.synchronize()
    t0 = time.time()
    run(args.steps)
    torch.cuda.synchronize()
    ms_step = (time.time() - t0) * 1e3 / args.steps

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(args.steps)
        torch.cuda.synchronize()
        prof_ms_step = (time.time() - t0) * 1e3 / args.steps
    rows = kernel_rows(prof, args.steps)
    busy = sum(r[0] for r in rows)
    gpu = torch.cuda.get_device_name(0)
    print(f"[profile] {gpu}; batch {args.batch}, NL {args.nl}, "
          f"NP {batch.phore_x.shape[1]}; fused_stack {dcfg.fused_stack}, "
          f"triplet_knn {dcfg.triplet_knn}, use_pallas_triplet "
          f"{dcfg.use_pallas_triplet}, fused_block_dtype "
          f"{dcfg.fused_block_dtype}, compute_dtype "
          f"{pg.config.model.compute_dtype}")
    print(f"[profile] ms/step {ms_step:.3f} (under the profiler "
          f"{prof_ms_step:.3f}); device busy {busy:.3f} ms/step; idle share "
          f"{1 - busy / prof_ms_step:.3f} of the profiled step, "
          f"{1 - busy / ms_step:.3f} of the unprofiled step")
    for ms, cnt, key in rows[:args.top]:
        print(f"[profile] {ms:9.4f} ms/step {cnt:7.1f} calls/step  "
              f"{key[:70]} {stage_label(key)}")
    stage_ms = stage_times(rows)
    print(json.dumps({"gpu": gpu, "batch": args.batch, "nl": args.nl,
                      "fused_stack": dcfg.fused_stack,
                      "triplet_knn": dcfg.triplet_knn,
                      "use_pallas_triplet": dcfg.use_pallas_triplet,
                      "fused_block_dtype": dcfg.fused_block_dtype,
                      "compute_dtype": pg.config.model.compute_dtype,
                      "ms_per_step": ms_step,
                      "profiled_ms_per_step": prof_ms_step,
                      "device_busy_ms_per_step": busy,
                      "idle_share": 1 - busy / prof_ms_step,
                      "idle_share_unprofiled": 1 - busy / ms_step,
                      "stage_ms_per_step": stage_ms,
                      "launch_counts": dict(ls.LAUNCHES, **pt.LAUNCHES)}))


if __name__ == "__main__":
    main()
