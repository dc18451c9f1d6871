#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
1. build: compiles the hand-written CUDA kernels from
   phoregen_tpu_torch/csrc/ with nvcc (sm_90a), one nvcc per source, all
   started together;
2. kernels: holds each kernel against its plain PyTorch version on the
   card and times both with CUDA events: the four layer-stack kernels and
   the two merged ones (A + B1, B2 + C) at flagship shapes (B=16, NP=96,
   H=128, 16 heads, Wt=32, kNN 32, K8 32) in the NL=80 bucket and in the
   NL=48 bucket that the main paths below run in, within atol = rtol = 1e-4
   (5e-4 for the triplet pre-features, whose angle arithmetic the merged
   kernel shares); the forms of rows 2, 3, 5 and 6 with bf16 inter-stage
   blocks at the same shapes (stored blocks within those tolerances plus
   one bf16 unit in the last place, and at most 1% of their elements
   unlike the plain version's, the rest within the float32 rows'
   tolerances); rows 1, 4, 5 and 6 on the hybrid cutoff's neighbour table
   at NL=80 (NL + 32 = 112 sources a ligand row); and the all-k triplet
   pool at B=16, 16 heads, Wt=32 for N=48 and N=80 and at Wt=18, 36 heads
   (two launches), N=48, with padded slots, within 5e-4 on the unmasked
   (j, i) pairs (masked ones must be exactly 0); see
   ops/kernel_check.py::TOLERANCE for why;
3. main path 1, the fused layer stack (`fused_stack='pallas'`): loads
   release/flagship_r4 with the port's own msgpack reader and samples one
   batch of 16 molecules for tests/fixtures/phores/P03211_merge.phore
   through GenerationPipeline with the canonical recipe (1000 steps,
   normal count mode with scale 6.0, atom_prox + center_prox guidance,
   predicted edges), writing SDFs to a temporary directory; each of the
   four layer-stack kernels must have been launched, the triplet pool not;
4. main path 2, the per-layer module path as the release checkpoints
   configure it (`fused_stack='none'`) with exact all-k triplets
   (`triplet_knn=0`) through the triplet-pool kernel
   (`use_pallas_triplet=True`): the same recipe at the same width and
   depth; the triplet pool must have been launched steps x layers x blocks
   times and the layer-stack kernels not at all;
5. main path 3, training at full width: the trainer's own step (`Run`,
   release/flagship_r4's configuration and weights, `fused_stack='pallas2'`,
   float32) for 8 steps of 16 graphs of the hermetic `mixed` corpus, four
   in the NL=48 bucket and four in the NL=80 bucket. Loss and gradient norm
   must be finite on every step, parameters and EMA must have moved, the
   two merged kernels must have been launched steps x 6 times each and no
   other kernel; and on one NL=80 batch the loss and every parameter
   gradient with kernels forward must agree with the all-plain path
   (`fused_stack='xla'`) on the same draws, in both buckets: loss within
   1e-4 relative, the whole gradient within 3e-3 (L2 norm of the difference
   over the L2 norm), each leaf within 5e-2 of its largest gradient. These
   are looser than the 1e-4 per leaf that tests/test_torch_port_cuda.py
   holds the same backward to on one small stack, because here the two
   forwards differ by float32 rounding (kernels against plain stages)
   before six layers at full width, and the trained weights sit near a
   stationary point, where a gradient is a small remainder of large terms
   that cancel: moving the noised positions by 1e-6 moves the plain path's
   own gradients by 6e-5 (L2) and 2.5e-3 (worst leaf) at NL=80
   (`tools/profile_training --sensitivity 1e-6`), and the kernels' forward
   differs from the plain one by several such roundings (measured 4.2e-4
   and 8.9e-3). Leaves whose gradient is below 1e-4 of the largest leaf's
   are held to that floor (a softmax's key bias has an exactly zero
   gradient and only rounding noise). Prints
   steps/s, ms/step by bucket, forward and backward ms and peak memory;
6. main path 4, sampling with `fused_stack='pallas2'`: the recipe of path
   1 through the two merged kernels, steps x 6 launches each;
7. main path 5, bf16 sampling: the recipe of path 1 with
   `fused_stack='pallas2'`, `fused_block_dtype='bfloat16'` and
   `model.compute_dtype='bfloat16'`: the bf16-block forms of the two merged
   kernels, 6000 launches each; then `fused_stack='pallas'` with bf16 blocks
   and compute on a strided chain of 100 steps (the bf16 forms of B1 and
   B2, 600 launches each);
8. main path 6, bf16 training: release/flagship_r4's own `train.dtype`
   (bfloat16, no override), two steps in each bucket (NL=48, 80) through
   `pallas2` with bf16 blocks and through the configuration's own module
   path (`fused_stack='none'`, kNN triplets, no kernel): finite losses,
   float32 master parameters and EMA, leaves that moved, the bf16 merged
   kernels launched steps x 6 times (and the float32 ones steps x 5: the
   straight-through backward remakes the float32 layer boundaries with
   them); and the loss and parameter gradients with kernels forward
   against the plain stages' on the same draws and bf16 weights (the
   kernels' path rounds its inter-stage blocks to bf16, the plain stages
   keep them float32): loss within 1e-4 relative, gradient relative L2
   within 5e-3, each leaf within 0.5 of its largest gradient
   (`BF16_TOLS`). Prints steps/s, ms/step and peak memory;
9. check: accepted molecules are finite and written, and one forward of
   the flagship network on a small input agrees between the card (kernels)
   and the CPU (plain versions), on the three sampling paths, within
   atol = rtol = 1e-3 (6 layers of float32 attention, different summation
   order). Every kernel of the `kernels` line must have been launched on
   its main path.
The second-to-last lines are the `kernels` JSON and the card's name and
power limit; the last line is the device JSON.
"""
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

FORWARD_TOL = 1e-3
NUM_STEPS = 1000
BATCH = 16
TRAIN_STEPS_PER_BUCKET = 4
TRAIN_BUCKETS = (48, 80)
STACK_NL = (80, 48)     # kernel check: the table's row, then the paths' bucket
LOSS_TOL = 1e-4
GRAD_TOL = 3e-3        # whole gradient, relative L2
LEAF_GRAD_TOL = 5e-2   # each leaf, of its largest gradient
GRAD_FLOOR = 1e-4
BF16_TRAIN_STEPS_PER_BUCKET = 2
# kernels forward vs plain stages, train.dtype bfloat16 on the same draws:
# both run the network in bf16 on the same bf16 weights; the kernels' path
# stores its inter-stage blocks in bf16 where the plain stages keep float32.
# Loss relative, gradient relative L2, worst leaf. On flagship_r4's weights
# (H100) these read up to 2.7e-6, 2.3e-3 and 0.34: a bf16 activation that
# rounds the other way moves a small leaf's gradient (a phore-encoder
# bias) by a third, so the leaf limit cannot be the float32 check's. A
# store that gives each quad's fourth element the third's value reads
# 4.3e-3, 0.16 and 8.1.
BF16_TOLS = (LOSS_TOL, 5e-3, 0.5)
# the bf16-block path with four kernels a layer runs a strided chain
PALLAS_BF16_STEPS = 100
PATHS = {
    "fused": dict(fused_stack="pallas"),
    "module": dict(fused_stack="none", triplet_knn=0,
                   use_pallas_triplet=True),
    "pallas2": dict(fused_stack="pallas2"),
    "pallas2_bf16": dict(fused_stack="pallas2", fused_block_dtype="bfloat16",
                         compute_dtype="bfloat16"),
    "pallas_bf16": dict(fused_stack="pallas", fused_block_dtype="bfloat16",
                        compute_dtype="bfloat16"),
}
# the paths whose flagship forward is held card vs CPU (float32)
REFERENCE_PATHS = ("fused", "module", "pallas2")
# kernels a path launches steps x layers x blocks times; every other: never
PATH_KERNELS = {
    "fused": ("stage_node", "stage_triplet_pre", "stage_triplet_att",
              "stage_pos"),
    "module": ("triplet_pool",),
    "pallas2": ("stage_node_pre", "stage_att_pos"),
    "pallas2_bf16": ("stage_node_pre_bf16", "stage_att_pos_bf16"),
    "pallas_bf16": ("stage_node", "stage_triplet_pre_bf16",
                    "stage_triplet_att_bf16", "stage_pos"),
}
# shapes of the kernel rows beyond the flagship's kNN table at NL = 80, 48:
# the hybrid cutoff's table (NL + 32 sources a ligand row), and the pool
# at widths no multiple of 4 and more heads than one launch takes
HYBRID_NL = 80
ODD_POOL = dict(N=48, heads=36, Wt=18)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_name_power() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def print_row(r, shape: str) -> None:
    from phoregen_tpu_torch.ops.kernel_check import BLOCK_MISMATCH_SHARE
    print(f"[kernels] {r['name']} {shape}: max_abs_err={r['max_abs_err']:.3e} "
          f"max_rel_err={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
          f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, "
          f"{r['flops'] / 1e9:.2f} GFLOP on the slots the masks leave"
          + (f", {r['flops_all_slots'] / 1e9:.2f} on all slots"
             if "flops_all_slots" in r else "")
          + ")" + (f"; share of stored block elements unlike the plain "
                   f"version's {r['block_mismatch_share']:.3e} (at most "
                   f"{BLOCK_MISMATCH_SHARE:g})"
                   if r["block_mismatch_share"] is not None else "")
          + f" tol={r['tol']:g} ok={r['ok']}", flush=True)


def phase_kernels(kc):
    """Rows of the six layer-stack kernels and of the four bf16-block forms
    for each NL, of the four kNN-table kernels on the hybrid cutoff's table,
    and the triplet pool's rows for each N and at odd widths. Returns
    {shape label: rows} for the stack and {shape label: row} for the
    pool."""
    import torch
    stack = {}
    for nl in STACK_NL:
        case = kc.flagship_case(B=16, NP=96, NL=nl, device="cuda", seed=0)
        label = f"B=16 NP=96 NL={nl}"
        stack[label] = kc.check_kernels(case, reps=5) + kc.check_kernels(
            case, reps=5, kernels=kc.BF16_KERNELS)
        for r in stack[label]:
            print_row(r, label)
        del case
        torch.cuda.empty_cache()
    case = kc.flagship_case(B=16, NP=96, NL=HYBRID_NL, device="cuda", seed=0,
                            cutoff="hybrid")
    label = f"B=16 NP=96 NL={HYBRID_NL} hybrid K={case['d'].K}"
    stack[label] = kc.check_kernels(case, reps=5, kernels=kc.KNN_KERNELS)
    for r in stack[label]:
        print_row(r, label)
    del case
    torch.cuda.empty_cache()
    pool = {}
    for n in (48, 80):
        pool[f"B=16 N={n}"] = kc.check_triplet_pool(
            kc.triplet_case(B=16, N=n, device="cuda", seed=0), reps=5)
    odd = "B=16 N={N} heads={heads} Wt={Wt}".format(**ODD_POOL)
    pool[odd] = kc.check_triplet_pool(
        kc.triplet_case(B=16, device="cuda", seed=0, **ODD_POOL), reps=5)
    for label, r in pool.items():
        print_row(r, label)
    torch.cuda.empty_cache()
    bad = [(r["name"], label) for label, rs in stack.items() for r in rs
           if not r["ok"]] + [(r["name"], label) for label, r in pool.items()
                              if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return stack, pool


def phase_main(root, label, ls, pt, steps=NUM_STEPS):
    """Sample one batch through the path `label` (a chain of `steps`
    denoiser evaluations: all 1000, or strided); returns (launch counts of
    all the kernels on that run, the NL bucket)."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.data.phore import parse_phore_file
    from phoregen_tpu_torch.models.phoregen import load_release_model
    from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
    from phoregen_tpu_torch.sample.sampler import GuidanceOpt

    tag = f"[main {label}]"
    pg, _ = load_release_model(os.path.join(root, "release", "flagship_r4"),
                               device="cuda", **PATHS[label])
    dcfg = pg.config.model.denoiser
    if pg.config.model.diff.num_timesteps != NUM_STEPS:
        fail("flagship_r4 is expected to sample with 1000 steps")
    pipe = GenerationPipeline(
        pg, guidance=[GuidanceOpt(type="atom_prox", min_d=1.0, max_d=3.0),
                      GuidanceOpt(type="center_prox")],
        sample_nodes_mode="normal", normal_scale=6.0, add_edge="predicted",
        batch_size=BATCH, seed=2024, device="cuda",
        sample_steps=0 if steps == NUM_STEPS else steps)
    phore = parse_phore_file(os.path.join(
        root, "tests", "fixtures", "phores", "P03211_merge.phore"))
    with tempfile.TemporaryDirectory() as out_dir:
        ls.reset_launch_counts()
        pt.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = pipe.generate(phore, num_samples=BATCH, out_dir=out_dir,
                            max_batches=1)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(ls.LAUNCHES, **pt.LAUNCHES)
        mol_dir = os.path.join(out_dir, res["name"])
        sdfs = [f for f in os.listdir(mol_dir) if f.endswith(".sdf")]
    per_kernel = steps * dcfg.num_layers * dcfg.num_blocks
    print(f"{tag} fused_stack={dcfg.fused_stack} triplet_knn="
          f"{dcfg.triplet_knn} use_pallas_triplet={dcfg.use_pallas_triplet} "
          f"fused_block_dtype={dcfg.fused_block_dtype} compute_dtype="
          f"{pg.config.model.compute_dtype}; {steps} steps, "
          f"{dcfg.num_blocks} block x {dcfg.num_layers} "
          f"layers, hidden {dcfg.hidden_dim}, {dcfg.n_heads} heads")
    print(f"{tag} phore {res['name']}: count interval "
          f"{res['count_interval']}")
    print(f"{tag} accepted: {res['n_finished']}/{res['n_sampled']}")
    print(f"{tag} NL bucket: {pipe.last_bucket}")
    print(f"{tag} molecules/s (sampled, reverse loop): "
          f"{res['n_sampled'] / pipe.sample_seconds:.4f} "
          f"(loop {pipe.sample_seconds:.3f} s, "
          f"{1e3 * pipe.sample_seconds / steps:.3f} ms/step)")
    print(f"{tag} molecules/s (accepted, wall incl. reconstruction): "
          f"{res['n_finished'] / wall:.4f} (wall {wall:.3f} s)")
    print(f"{tag} launches: {json.dumps(launches)} "
          f"(a kernel of this path: {per_kernel})", flush=True)
    want = {k: per_kernel * (k in PATH_KERNELS[label]) for k in launches}
    if launches != want:
        fail(f"the {label} path must launch {PATH_KERNELS[label]} "
             f"{per_kernel} times each and no other kernel: {launches}")
    if res["n_sampled"] != BATCH:
        fail(f"{res['n_sampled']} sampled, expected {BATCH}")
    if len(sdfs) != res["n_finished"]:
        fail(f"{len(sdfs)} SDF files for {res['n_finished']} accepted")
    for mol in res["mols"]:
        pos = np.asarray(mol.pos if hasattr(mol, "pos")
                         else mol.GetConformer().GetPositions())
        if not np.isfinite(pos).all():
            fail("non-finite coordinates in an accepted molecule")
    lo, up = res["count_interval"]
    if not 4 <= lo <= up <= 78:
        fail(f"count interval {res['count_interval']} out of bounds")
    return launches, pipe.last_bucket


def check_gradients(pg, plain, batch, nl, lig_noise_std,
                    compute_dtype="float32",
                    tols=(LOSS_TOL, GRAD_TOL, LEAF_GRAD_TOL)):
    """Loss and parameter gradients of `pg` (kernels forward) against
    `plain` (the plain stages) on one batch and the same draws, at
    `compute_dtype` (`train.dtype`); fails beyond `tols` (loss relative,
    whole gradient relative L2, worst leaf of its largest gradient).
    Returns the three readings."""
    import torch
    res = []
    for model in (pg, plain):
        model.net.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(7)
        loss, _ = model.compute_loss(batch, gen, lig_noise_std=lig_noise_std,
                                     compute_dtype=compute_dtype)
        loss.backward()
        res.append((float(loss.detach()), {
            n: p.grad.clone() for n, p in model.net.named_parameters()}))
        model.net.zero_grad(set_to_none=True)
    (l_k, g_k), (l_p, g_p) = res
    rel_loss = abs(l_k - l_p) / abs(l_p)
    top = max(float(g.abs().max()) for g in g_p.values())
    diff2 = sum(float(((g_k[n] - g) ** 2).sum()) for n, g in g_p.items())
    rel_grad = (diff2 / sum(float((g ** 2).sum())
                            for g in g_p.values())) ** 0.5
    worst, worst_name = 0.0, ""
    for n, g in g_p.items():
        if not torch.isfinite(g_k[n]).all():
            fail(f"non-finite gradient of {n}")
        err = float((g_k[n] - g).abs().max()) / max(
            float(g.abs().max()), GRAD_FLOOR * top)
        if err > worst:
            worst, worst_name = err, n
    tag = "[check train]" if compute_dtype == "float32" else \
        f"[check {compute_dtype} train]"
    print(f"{tag} NL={nl} batch, kernels forward vs plain stages: "
          f"loss {l_k:.6f} vs {l_p:.6f} (relative {rel_loss:.3e}, tol "
          f"{tols[0]}); gradient relative L2 error {rel_grad:.3e} (tol "
          f"{tols[1]}); worst leaf relative error {worst:.3e} "
          f"({worst_name}; tol {tols[2]})", flush=True)
    readings = (rel_loss, rel_grad, worst)
    if any(not r <= t for r, t in zip(readings, tols)):
        fail("loss or gradients with kernels forward disagree with the "
             "plain path")
    return readings


def check_bf16_train(run, batches, tols=None):
    """At `train.dtype` bfloat16: `run`'s model (kernels with bf16 blocks
    forward, the float32 stack's backward) against the plain stages
    (float32 blocks) on the same bf16 weights and draws, one batch of each
    bucket in `batches`; see `check_gradients`."""
    import torch
    from phoregen_tpu_torch.models.phoregen import PhoreGen
    cfg = run.config
    pcfg = copy.deepcopy(cfg)
    pcfg.model.denoiser.fused_stack = "xla"
    plain = PhoreGen(pcfg)
    plain.net.load_state_dict(run.pg.net.state_dict())
    plain.net.to("cuda")
    out = [check_gradients(run.pg, plain, batches[nl][0], nl,
                           cfg.train.lig_noise_std, cfg.train.dtype,
                           tols or BF16_TOLS) for nl in batches]
    del plain
    torch.cuda.empty_cache()
    return out


def phase_train(root, ls, pt):
    """Main path 3: train steps at full width through `fused_stack=pallas2`;
    returns the launch counts of all seven kernels on those steps."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.models.phoregen import PhoreGen
    from phoregen_tpu_torch.tools.profile_training import (
        bucket_batches, flagship_trainer, forward_backward_ms)

    tag = "[main train]"
    prefix = os.path.join(root, "release", "flagship_r4")
    with tempfile.TemporaryDirectory() as run_dir:
        # float32 asked for: the gradient check against the plain path
        # below is reckoned in float32 ([main bf16 train] runs the
        # configuration's own bfloat16)
        run = flagship_trainer(prefix, "cuda", "pallas2", run_dir=run_dir,
                               dtype="float32")
        cfg, state = run.config, run.state
        dcfg = cfg.model.denoiser
        if cfg.train.batch_size != BATCH:
            fail(f"flagship_r4 is expected to train with batches of {BATCH}")
        batches = {nl: [b.to("cuda") for b in bucket_batches(
            cfg, nl, TRAIN_STEPS_PER_BUCKET + 1, seed=2024)]
            for nl in TRAIN_BUCKETS}
        named = dict(state.net.named_parameters())
        before = {n: p.detach().clone() for n, p in named.items()}
        # one step per bucket outside the count, so that the timed steps
        # find the allocator warm
        for nl in TRAIN_BUCKETS:
            run.train_step(state, 0, batches[nl][-1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ls.reset_launch_counts()
        pt.reset_launch_counts()
        ms = {}
        step = 0
        t_all = time.time()
        for nl in TRAIN_BUCKETS:
            t0 = time.time()
            for b in batches[nl][:TRAIN_STEPS_PER_BUCKET]:
                m = run.train_step(state, 1 + step, b)
                step += 1
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                print(f"{tag} step {step} NL={nl}: loss {loss:.4f} "
                      f"grad_norm {gnorm:.4f}")
                if not (np.isfinite(loss) and np.isfinite(gnorm)):
                    fail(f"non-finite loss or gradient norm at step {step}")
            torch.cuda.synchronize()
            ms[nl] = (time.time() - t0) * 1e3 / TRAIN_STEPS_PER_BUCKET
        wall = time.time() - t_all
        launches = dict(ls.LAUNCHES, **pt.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        per_kernel = step * dcfg.num_layers * dcfg.num_blocks
        print(f"{tag} fused_stack={dcfg.fused_stack} train.dtype="
              f"{cfg.train.dtype}; {step} steps of {BATCH} graphs, "
              f"{dcfg.num_blocks} block x {dcfg.num_layers} layers, hidden "
              f"{dcfg.hidden_dim}, {dcfg.n_heads} heads")
        print(f"{tag} steps/s {step / wall:.4f}; ms/step "
              + ", ".join(f"NL={nl}: {v:.3f}" for nl, v in ms.items()))
        for nl in TRAIN_BUCKETS:
            f_ms, b_ms = forward_backward_ms(run, batches[nl][0])
            print(f"{tag} NL={nl}: forward {f_ms:.3f} ms, backward "
                  f"{b_ms:.3f} ms")
        print(f"{tag} peak memory {peak / 2 ** 30:.3f} GiB "
              f"(torch.cuda.max_memory_allocated over the {step} steps)")
        print(f"{tag} launches: {json.dumps(launches)} "
              f"(a kernel of this path: {per_kernel})", flush=True)
        want = {k: per_kernel * (k in PATH_KERNELS["pallas2"])
                for k in launches}
        if launches != want:
            fail(f"training through pallas2 must launch "
                 f"{PATH_KERNELS['pallas2']} {per_kernel} times each and no "
                 f"other kernel: {launches}")
        if state.step != step + len(TRAIN_BUCKETS):
            fail(f"the state counts {state.step} steps")
        moved = sum(not torch.equal(before[n], p.detach())
                    for n, p in named.items())
        ema_moved = sum(not torch.equal(before[n], state.ema_params[n])
                        for n in named)
        print(f"{tag} leaves moved: params {moved}/{len(named)}, EMA "
              f"{ema_moved}/{len(named)}")
        # a decay of 0.9999 moves a leaf's shadow by less than one float32
        # step where the leaf itself barely moved
        if moved < 0.9 * len(named) or ema_moved < 0.5 * len(named):
            fail("parameters or EMA did not move")

        # kernels forward vs the all-plain path, same weights, same draws
        pcfg = copy.deepcopy(cfg)
        pcfg.model.denoiser.fused_stack = "xla"
        plain = PhoreGen(pcfg)
        plain.net.load_state_dict(state.net.state_dict())
        plain.net.to("cuda")
        for nl in TRAIN_BUCKETS:
            check_gradients(run.pg, plain, batches[nl][0], nl,
                            cfg.train.lig_noise_std)
    return launches


def phase_train_bf16(root, ls, pt):
    """Main path 5: release/flagship_r4's own `train.dtype` (bfloat16, no
    override), a few steps in each bucket, through `pallas2` with bf16
    blocks and through the configuration's own module path. Returns the
    launch counts of the pallas2 run."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.tools.profile_training import (
        bucket_batches, flagship_trainer)

    prefix = os.path.join(root, "release", "flagship_r4")
    launches_p2 = None
    for label, fused, bdt in (("pallas2", "pallas2", "bfloat16"),
                              ("module", None, None)):
        tag = f"[main bf16 train {label}]"
        with tempfile.TemporaryDirectory() as run_dir:
            run = flagship_trainer(prefix, "cuda", fused or "none",
                                   run_dir=run_dir, fused_block_dtype=bdt)
            cfg, state = run.config, run.state
            dcfg = cfg.model.denoiser
            if cfg.train.dtype != "bfloat16":
                fail(f"flagship_r4 is expected to train in bfloat16, not "
                     f"{cfg.train.dtype}")
            batches = {nl: [b.to("cuda") for b in bucket_batches(
                cfg, nl, BF16_TRAIN_STEPS_PER_BUCKET + 1, seed=2025)]
                for nl in TRAIN_BUCKETS}
            named = dict(state.net.named_parameters())
            before = {n: p.detach().clone() for n, p in named.items()}
            for nl in TRAIN_BUCKETS:
                run.train_step(state, 0, batches[nl][-1])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ls.reset_launch_counts()
            pt.reset_launch_counts()
            ms, step, t_all = {}, 0, time.time()
            for nl in TRAIN_BUCKETS:
                t0 = time.time()
                for b in batches[nl][:BF16_TRAIN_STEPS_PER_BUCKET]:
                    m = run.train_step(state, 1 + step, b)
                    step += 1
                    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                    print(f"{tag} step {step} NL={nl}: loss {loss:.4f} "
                          f"grad_norm {gnorm:.4f}")
                    if not (np.isfinite(loss) and np.isfinite(gnorm)):
                        fail(f"non-finite loss or gradient norm at step "
                             f"{step}")
                torch.cuda.synchronize()
                ms[nl] = (time.time() - t0) * 1e3 / BF16_TRAIN_STEPS_PER_BUCKET
            wall = time.time() - t_all
            launches = dict(ls.LAUNCHES, **pt.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            per_kernel = step * dcfg.num_layers * dcfg.num_blocks
            print(f"{tag} fused_stack={dcfg.fused_stack} "
                  f"fused_block_dtype={dcfg.fused_block_dtype} train.dtype="
                  f"{cfg.train.dtype} triplet_knn={dcfg.triplet_knn}; {step} "
                  f"steps of {BATCH} graphs")
            print(f"{tag} steps/s {step / wall:.4f}; ms/step "
                  + ", ".join(f"NL={nl}: {v:.3f}" for nl, v in ms.items()))
            print(f"{tag} peak memory {peak / 2 ** 30:.3f} GiB "
                  f"(torch.cuda.max_memory_allocated over the {step} steps)")
            print(f"{tag} launches: {json.dumps(launches)}", flush=True)
            # the bf16-block kernels forward; the straight-through
            # backward remakes the float32 layer boundaries 1..L-1 first,
            # through the float32 merged kernels
            want = dict.fromkeys(launches, 0)
            if label == "pallas2":
                for k in PATH_KERNELS["pallas2_bf16"]:
                    want[k] = per_kernel
                for k in PATH_KERNELS["pallas2"]:
                    want[k] = step * (dcfg.num_layers - 1) * dcfg.num_blocks
            if launches != want:
                fail(f"bf16 training through {label} must launch {want}: "
                     f"{launches}")
            if any(p.dtype != torch.float32 for p in named.values()) or any(
                    v.dtype != torch.float32
                    for v in state.ema_params.values()):
                fail("master parameters or EMA are not float32")
            moved = sum(not torch.equal(before[n], p.detach())
                        for n, p in named.items())
            print(f"{tag} leaves moved: {moved}/{len(named)}, all float32")
            if moved < 0.9 * len(named):
                fail("parameters did not move")
            if label == "pallas2":
                launches_p2 = launches
                check_bf16_train(run, batches)
            del run, state, batches
            torch.cuda.empty_cache()
    return launches_p2


def phase_reference(root, label):
    """Flagship forward on a small input through the path `label`: kernels
    (card) vs plain versions (CPU)."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.data.batching import replicate_phore
    from phoregen_tpu_torch.data.phore import parse_phore_file
    from phoregen_tpu_torch.models.phoregen import load_release_model
    from phoregen_tpu_torch.sample.pipeline import GenerationPipeline

    prefix = os.path.join(root, "release", "flagship_r4")
    pg_gpu, _ = load_release_model(prefix, device="cuda", **PATHS[label])
    pg_cpu, _ = load_release_model(prefix, device="cpu", **PATHS[label])
    pipe = GenerationPipeline(pg_cpu, device="cpu")
    sample = pipe.prepare_phore(parse_phore_file(os.path.join(
        root, "tests", "fixtures", "phores", "P03211_merge.phore")))
    hb = replicate_phore(sample, 2, np.asarray([20, 29]), 32)
    rng = np.random.default_rng(0)
    B, NL = hb.lig_mask.shape
    node = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (B, NL))]
    edge = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (B, NL, NL))]
    pos = (1.5 * rng.normal(size=(B, NL, 3))).astype(np.float32)
    t = np.asarray([500, 20])
    outs = []
    for pg, dev in ((pg_gpu, "cuda"), (pg_cpu, "cpu")):
        b = hb.to(dev)
        T = lambda a: torch.as_tensor(a, device=dev)
        with torch.no_grad():
            o = pg.net(T(node), T(pos), b.lig_mask, T(edge), T(t),
                       b.phore_x, b.phore_pos, b.phore_norm, b.phore_mask)
        outs.append([a.detach().cpu().numpy() for a in o[:3]])
    lm = hb.lig_mask
    sel = [lm, lm, lm[:, :, None] & lm[:, None, :]]
    errs = []
    for (g, c, m, name) in zip(outs[0], outs[1], sel,
                               ("pred_node", "pred_pos", "pred_edge")):
        if not np.isfinite(g).all():
            fail(f"non-finite {name} on the card ({label} path)")
        err = float(np.abs(g[m] - c[m]).max())
        errs.append(err)
        if not np.allclose(g[m], c[m], atol=FORWARD_TOL, rtol=FORWARD_TOL):
            fail(f"{label} path, {name}: card vs CPU max abs err {err:.3e} "
                 f"> {FORWARD_TOL}")
    print(f"[check {label}] flagship forward, card kernels vs CPU plain: max "
          f"abs err node {errs[0]:.3e}, pos {errs[1]:.3e}, edge "
          f"{errs[2]:.3e} (tol {FORWARD_TOL})", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from phoregen_tpu_torch.ops import _build
        from phoregen_tpu_torch.ops import kernel_check as kc
        from phoregen_tpu_torch.ops import layer_stack as ls
        from phoregen_tpu_torch.ops import pallas_triplet as pt
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    try:
        paths = _build.build()
        for name in paths:
            _build.load(name)
    except Exception as e:
        fail(f"kernel build failed: {e}")
    print(f"[build] {sorted(paths.values())} in "
          f"{time.time() - t_start:.1f} s", flush=True)

    stack, pool = phase_kernels(kc)
    torch.cuda.empty_cache()
    launches, _ = phase_main(root, "fused", ls, pt)
    torch.cuda.empty_cache()
    launches_mod, bucket = phase_main(root, "module", ls, pt)
    torch.cuda.empty_cache()
    launches_train = phase_train(root, ls, pt)
    torch.cuda.empty_cache()
    launches_p2, _ = phase_main(root, "pallas2", ls, pt)
    torch.cuda.empty_cache()
    launches_p2b, _ = phase_main(root, "pallas2_bf16", ls, pt)
    torch.cuda.empty_cache()
    launches_pb, _ = phase_main(root, "pallas_bf16", ls, pt,
                                steps=PALLAS_BF16_STEPS)
    torch.cuda.empty_cache()
    launches_train_bf16 = phase_train_bf16(root, ls, pt)
    torch.cuda.empty_cache()
    for label in REFERENCE_PATHS:
        phase_reference(root, label)

    # the triplet pool's row at the N the module path gave it; the other N
    # and the odd widths ride along under "other_shapes"
    main_n = f"B=16 N={bucket}" if f"B=16 N={bucket}" in pool \
        else next(iter(pool))
    shape_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "bytes", "flops", "tol")
    pool_row = dict(pool[main_n], shape=main_n, other_shapes=[
        {"shape": label, **{k: r[k] for k in shape_keys}}
        for label, r in pool.items() if label != main_n])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches of each kernel on the main path that runs it (by path where
    # more than one does)
    by_path = {
        "stage_node": {"fused": launches, "pallas_bf16": launches_pb},
        "stage_triplet_pre": {"fused": launches},
        "stage_triplet_att": {"fused": launches},
        "stage_pos": {"fused": launches, "pallas_bf16": launches_pb},
        "stage_node_pre": {"train": launches_train, "pallas2": launches_p2},
        "stage_att_pos": {"train": launches_train, "pallas2": launches_p2},
        "stage_triplet_pre_bf16": {"pallas_bf16": launches_pb},
        "stage_triplet_att_bf16": {"pallas_bf16": launches_pb},
        "stage_node_pre_bf16": {"pallas2_bf16": launches_p2b,
                                "train_bf16": launches_train_bf16},
        "stage_att_pos_bf16": {"pallas2_bf16": launches_p2b,
                               "train_bf16": launches_train_bf16},
    }
    kernels = []
    # the layer-stack kernels' rows are the first NL's; the other NL and the
    # hybrid table ride along
    main_shape = f"B=16 NP=96 NL={STACK_NL[0]}"
    for r in stack[main_shape]:
        name = r["name"]
        counts = {path: c[name] for path, c in by_path[name].items()}
        kernels.append(dict(
            {k: dict(r, launches=next(iter(counts.values())))[k]
             for k in keys}, launches_by_path=counts, shape=main_shape,
            other_shapes=[{"shape": label, **{k: o[k] for k in shape_keys}}
                          for label, rows in stack.items()
                          if label != main_shape
                          for o in rows if o["name"] == name]))
    pool_row["launches"] = launches_mod["triplet_pool"]
    kernels.append({k: pool_row[k]
                    for k in keys + ("shape", "other_shapes")})
    if any(k["launches"] <= 0 for k in kernels):
        fail(f"a kernel was launched no time on its main path: "
             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(f"[chip_smoke] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
