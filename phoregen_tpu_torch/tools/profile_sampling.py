"""Where one reverse step's time goes, on the card.

    python -m phoregen_tpu_torch.tools.profile_sampling --batch 16 --nl 48

Loads release/flagship_r4, builds a sampling batch of `--batch` graphs for
one pharmacophore in the `--nl` ligand bucket, and runs reverse steps of
the port's sampler (fused stack, CUDA kernels): `--warmup` steps, then
`--steps` timed steps (host clock around work that ends in a synchronize),
then `--steps` steps under torch.profiler. Prints ms/step, the device's busy
time per step (sum of kernel times), its idle share, and the kernels by
total device time, then one JSON line with the same numbers.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("[E] needs a CUDA device")

    from ..data.batching import replicate_phore
    from ..data.phore import parse_phore_file
    from ..models.phoregen import load_release_model
    from ..ops import layer_stack as ls
    from ..sample.pipeline import GenerationPipeline
    from ..sample.sampler import GuidanceOpt

    pg, _ = load_release_model(args.ckpt, device="cuda")
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
    # device-side kernel events only: a CPU op (aten::mul) also reports the
    # device time of the kernels it launched, which would count them twice
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = e.self_device_time_total
        if dt > 0:
            rows.append((dt / 1e3 / args.steps, e.count / args.steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    stage_names = {"node_kernel": "stage_node (A)",
                   "trip_pre_kernel": "stage_triplet_pre (B1)",
                   "trip_att_kernel": "stage_triplet_att (B2)",
                   "pos_kernel": "stage_pos (C)",
                   "rows_gemm": "node projections (A, B1, C)"}
    gpu = torch.cuda.get_device_name(0)
    print(f"[profile] {gpu}; batch {args.batch}, NL {args.nl}, "
          f"NP {batch.phore_x.shape[1]}")
    print(f"[profile] ms/step {ms_step:.3f} (under the profiler "
          f"{prof_ms_step:.3f}); device busy {busy:.3f} ms/step; idle share "
          f"{1 - busy / prof_ms_step:.3f}")
    for ms, cnt, key in rows[:args.top]:
        label = next((v for k, v in stage_names.items() if k in key), "")
        print(f"[profile] {ms:9.4f} ms/step {cnt:7.1f} calls/step  "
              f"{key[:70]} {label}")
    stage_ms = {v: sum(r[0] for r in rows if k in r[2])
                for k, v in stage_names.items()}
    print(json.dumps({"gpu": gpu, "batch": args.batch, "nl": args.nl,
                      "ms_per_step": ms_step,
                      "profiled_ms_per_step": prof_ms_step,
                      "device_busy_ms_per_step": busy,
                      "idle_share": 1 - busy / prof_ms_step,
                      "stage_ms_per_step": stage_ms,
                      "launch_counts": dict(ls.LAUNCHES)}))


if __name__ == "__main__":
    main()
