"""Where one train step's time goes, on the card.

    python -m phoregen_tpu_torch.tools.profile_training --nl 80
    python -m phoregen_tpu_torch.tools.profile_training --nl 48 \
        --fused_stack none
    python -m phoregen_tpu_torch.tools.profile_training --nl 80 \
        --dtype float32 --fused_block_dtype bfloat16

Builds the flagship trainer (`flagship_trainer`: release/flagship_r4's
configuration and weights, its own `train.dtype` (bfloat16 for the release
configs) unless `--dtype` asks for another, `--fused_block_dtype` likewise,
the given `fused_stack`, default `pallas2`: kernels forward, plain stages
recomputed backward),
makes batches of `--batch` graphs of the hermetic `mixed` corpus in the
`--nl` ligand bucket from a seed, and runs `Run`'s own train step:
`--warmup` steps, `--steps` timed steps (host clock around work that ends
in a synchronize), a forward / backward split on one batch, then `--steps`
steps under torch.profiler. Prints ms/step, forward and backward ms, the
device's busy time per step (sum of kernel times), its idle share, peak
memory and the kernels by total device time, then one JSON line.
`--sensitivity EPS` also prints how far the parameter gradients of the
all-plain path (`fused_stack=xla`) move when the noised ligand positions
move by EPS (relative L2 of the whole gradient, worst leaf): the yardstick
for comparing gradients across two forwards that differ by rounding.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch


def flagship_trainer(ckpt: str, device="cuda", fused_stack: str = "pallas2",
                     run_dir: str = None, seed: int = None,
                     dtype: str = None, fused_block_dtype: str = None):
    """A `Run` at the width of the checkpoint `ckpt` with its weights (and
    the EMA shadow equal to them), training through `fused_stack`; the
    fused stacks get `block_knn_freeze`, as they require. `dtype`
    (`train.dtype`) and `fused_block_dtype`: None keeps the checkpoint's
    own."""
    from ..config import config_from_dict
    from ..train.checkpoint import load_params_only
    from ..train.loop import Run

    with open(ckpt + ".json") as f:
        cfg = config_from_dict(json.load(f)["config"])
    dcfg = cfg.model.denoiser
    dcfg.fused_stack = fused_stack
    if fused_stack != "none":
        dcfg.block_knn_freeze = True
    if dtype is not None:
        cfg.train.dtype = dtype
    if fused_block_dtype is not None:
        dcfg.fused_block_dtype = fused_block_dtype
    cfg.train.num_devices = 0
    cfg.logger.tensorboard = False
    if seed is not None:
        cfg.train.seed = seed
    run = Run(cfg, run_dir=run_dir or tempfile.mkdtemp(prefix="phoregen_"),
              device=device)
    state = run.init_state()
    load_params_only(ckpt, state.net)
    for n, p in state.net.named_parameters():
        state.ema_params[n].copy_(p.detach())
    return run


def bucket_samples(cfg, nl: int, need: int, seed: int = 0):
    """`need` samples of the `mixed` corpus that all fall in the ligand
    bucket `nl`: sizes are drawn around the bucket's middle and samples of
    other buckets are dropped."""
    from ..data.batching import pick_bucket
    from ..data.realcorpus import mixed_corpus

    ds = cfg.dataset
    buckets = sorted(ds.ligand_buckets)
    lo = max([b for b in buckets if b < nl] + [0]) + 1
    hi = min(nl, ds.max_atom)
    samples, tries = [], 0
    while len(samples) < need and tries < 20:
        got = mixed_corpus(seed + 1000 * tries, need, ds.data_name,
                           max_phore=ds.max_phore, max_atoms=hi,
                           real_frac=ds.real_frac,
                           size_mean=(lo + hi) / 2, size_std=(hi - lo) / 4)
        samples += [s for s in got
                    if pick_bucket(s.n_atoms, buckets) == nl]
        tries += 1
    if len(samples) < need:
        raise RuntimeError(f"could not grow {need} samples for bucket {nl}")
    return samples[:need]


def bucket_batches(cfg, nl: int, n_batches: int, seed: int = 0):
    """`n_batches` training batches (host numpy) of `bucket_samples`."""
    from ..data.loader import PhoreDataLoader

    samples = bucket_samples(cfg, nl, n_batches * cfg.train.batch_size, seed)
    loader = PhoreDataLoader(samples, cfg, cfg.train.batch_size,
                             shuffle=True, seed=seed, augment=True)
    return [b for b in loader]


def forward_backward_ms(run, batch, seed: int = 0):
    """(forward ms, backward ms) of one loss evaluation on `batch`, each
    ending in a synchronize; leaves no gradient behind."""
    tcfg = run.config.train
    gen = torch.Generator(device=batch.lig_pos.device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.time()
    loss, _ = run.pg.compute_loss(
        batch, gen, lig_noise_std=tcfg.lig_noise_std if tcfg.add_lig_noise
        else 0.0, compute_dtype=tcfg.dtype)
    torch.cuda.synchronize()
    t1 = time.time()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.time()
    run.state.net.zero_grad(set_to_none=True)
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def gradient_sensitivity(run, batch, eps: float, seed: int = 7):
    """(relative L2 change of the whole gradient, worst leaf's change over
    its largest gradient, floored at 1e-4 of the largest leaf's) of the
    all-plain path when the position noise moves by `eps` * N(0, 1)."""
    import copy

    from ..models.phoregen import PhoreGen
    cfg = copy.deepcopy(run.config)
    cfg.model.denoiser.fused_stack = "xla"
    pg = PhoreGen(cfg)
    pg.net.load_state_dict(run.state.net.state_dict())
    pg.net.to(batch.lig_pos.device)
    dev = batch.lig_pos.device
    noise = torch.randn(batch.lig_pos.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    grads = []
    for shift in (0.0, eps):
        pg.net.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(seed)
        pert = pg.perturb(batch, gen, run.config.train.lig_noise_std)
        pert["pos_pert"] = pert["pos_pert"] + shift * noise
        loss, _ = pg.loss_from_perturbation(batch, pert,
                                            compute_dtype=cfg.train.dtype)
        loss.backward()
        grads.append({n: p.grad.clone()
                      for n, p in pg.net.named_parameters()})
    a, b = grads
    top = max(float(g.abs().max()) for g in a.values())
    l2 = (sum(float(((a[n] - b[n]) ** 2).sum()) for n in a)
          / sum(float((g ** 2).sum()) for g in a.values())) ** 0.5
    worst = max(float((a[n] - b[n]).abs().max())
                / max(float(a[n].abs().max()), 1e-4 * top) for n in a)
    return l2, worst


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="release/flagship_r4")
    ap.add_argument("--nl", type=int, default=80)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--sensitivity", type=float, default=0.0)
    ap.add_argument("--fused_stack", default="pallas2",
                    choices=["none", "xla", "xla2", "pallas", "pallas3",
                             "pallas2"])
    ap.add_argument("--dtype", default="", choices=["", "float32",
                                                    "bfloat16"],
                    help="train.dtype ('' = the checkpoint's own)")
    ap.add_argument("--fused_block_dtype", default="",
                    choices=["", "float32", "bfloat16"],
                    help="denoiser.fused_block_dtype ('' = the checkpoint's "
                         "own)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("[E] needs a CUDA device")
    from ..ops import layer_stack as ls
    from ..ops import pallas_triplet as pt
    from .profile_sampling import kernel_rows, stage_label, stage_times

    run = flagship_trainer(args.ckpt, "cuda", args.fused_stack,
                           dtype=args.dtype or None,
                           fused_block_dtype=args.fused_block_dtype or None)
    cfg = run.config
    batches = [b.to("cuda") for b in bucket_batches(
        cfg, args.nl, args.warmup + args.steps)]
    state, n = run.state, 0

    def steps(bs):
        nonlocal n
        for b in bs:
            m = run.train_step(state, n, b)
            n += 1
        return m

    torch.cuda.reset_peak_memory_stats()
    steps(batches[:args.warmup])
    torch.cuda.synchronize()
    timed = batches[args.warmup:]
    t0 = time.time()
    m = steps(timed)
    torch.cuda.synchronize()
    ms_step = (time.time() - t0) * 1e3 / len(timed)
    peak = torch.cuda.max_memory_allocated()
    fwd_ms, bwd_ms = forward_backward_ms(run, timed[0])

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        steps(timed)
        torch.cuda.synchronize()
        prof_ms_step = (time.time() - t0) * 1e3 / len(timed)
    rows = kernel_rows(prof, len(timed))
    busy = sum(r[0] for r in rows)
    gpu = torch.cuda.get_device_name(0)
    dcfg = cfg.model.denoiser
    print(f"[profile] {gpu}; train step, batch {cfg.train.batch_size}, NL "
          f"{args.nl}, NP {cfg.dataset.max_phore}; fused_stack "
          f"{dcfg.fused_stack}; train.dtype {cfg.train.dtype}; "
          f"fused_block_dtype {dcfg.fused_block_dtype}; loss "
          f"{float(m['loss']):.3f}")
    print(f"[profile] ms/step {ms_step:.3f} (under the profiler "
          f"{prof_ms_step:.3f}); forward {fwd_ms:.3f} ms, backward "
          f"{bwd_ms:.3f} ms; device busy {busy:.3f} ms/step; idle share "
          f"{1 - busy / prof_ms_step:.3f} of the profiled step, "
          f"{1 - busy / ms_step:.3f} of the unprofiled step; peak memory "
          f"{peak / 2 ** 30:.3f} GiB")
    for ms, cnt, key in rows[:args.top]:
        print(f"[profile] {ms:9.4f} ms/step {cnt:7.1f} calls/step  "
              f"{key[:70]} {stage_label(key)}")
    sens = None
    if args.sensitivity > 0:
        sens = gradient_sensitivity(run, timed[0], args.sensitivity)
        print(f"[profile] plain-path gradients when the noised positions "
              f"move by {args.sensitivity:g}: relative L2 {sens[0]:.3e}, "
              f"worst leaf {sens[1]:.3e}")
    print(json.dumps({
        "gpu": gpu, "gradient_sensitivity": sens, "batch": cfg.train.batch_size, "nl": args.nl,
        "fused_stack": dcfg.fused_stack, "dtype": cfg.train.dtype,
        "fused_block_dtype": dcfg.fused_block_dtype, "ms_per_step": ms_step,
        "profiled_ms_per_step": prof_ms_step, "forward_ms": fwd_ms,
        "backward_ms": bwd_ms, "device_busy_ms_per_step": busy,
        "idle_share": 1 - busy / prof_ms_step,
        "idle_share_unprofiled": 1 - busy / ms_step,
        "peak_memory_bytes": peak,
        "stage_ms_per_step": stage_times(rows),
        "launch_counts": dict(ls.LAUNCHES, **pt.LAUNCHES)}))


if __name__ == "__main__":
    main()
