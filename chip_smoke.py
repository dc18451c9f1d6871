#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only filelist,evalacc    # those phases alone

Phases (any failure exits non-zero and prints no result):
1. build: compiles the hand-written CUDA kernels from
   phoregen_tpu_torch/csrc/ with nvcc (sm_90a), one nvcc per source, all
   started together, and counts the tensor-core (HMMA) instructions in the
   SASS of `node_kernel`, `trip_att_kernel`, `trip_pre_kernel`, `pos_kernel`
   and `att_pos_kernel` (`cuobjdump -sass`), which must each hold some:
   their products (and B1's angle-encoding product) run in 3xTF32 on the
   tensor cores;
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
   ops/kernel_check.py::TOLERANCE for why; and the dense triplet bond
   update (the layer's prologue and `csrc/dense_triplet.cu`) against the
   layer's plain `_dense` at B=16, H=128, 16 heads, N=48 and N=80 with
   N/2..N atoms, on every output slot within 1e-5 of the largest value;
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
9. [cli]: `python -m phoregen_tpu_torch.cli.sample` in-process as a user
   runs it: release/flagship_r4 on its own configuration (the module path
   with kNN triplets, no kernel), the recipe above over the full 1000
   steps for one batch of 30, `--save_pool --recon_workers 2`; the pool
   file must have the JAX key layout, the workers must accept what an
   in-process reconstruction of the same pool accepts, and the native
   host library (which must have built) must perceive the same bonds as
   the Python loop on every molecule. Prints ms/step, the bucket and the
   idle share (device busy time from 20 profiled steps of the same
   sampler on the same batch);
10. [pt]: a reference-format `.pt` of configs/train_lig-phore.yml's
   widths (H 128, 16 heads, 6 layers, kNN 32) with `triplet_mode: dense`,
   seeded weights under the upstream names and an EasyDict pickled
   beside them, written with torch.save, imported exactly and sampled
   through the CLI (100 steps, batch 16): every dense layer call through
   the dense triplet kernel (100 x 6 launches), none through `_dense`;
   ms/step and peak memory;
11. [continuous], [no-bond]: flagship_r4's configuration with
   `categorical_space: continuous` (through `pallas2`) or `bond_diffusion:
   false` (through `pallas`) and seeded random weights: a 100-step chain
   (kernels 5, 6 or 1-4 launched 100 x 6 times each; no pred_edge without
   bonds), the loss and gradients of one batch of 8 at NL=48 against the
   plain stages on the CPU (the float32 training check's limits), one
   train step;
12. [chunked]: a 50-step `pallas2` chain whole and with `chunk_steps` 7,
   equal bit for bit;
13. [ddp], [shard], [xla2 bf16]: data-parallel training of flagship_r4
   through `pallas2` (two gloo ranks on the one card, one NCCL rank, one
   process; save at world size 2, resume at 1), pools sharded over
   [cuda:0, cuda:0] against the unsharded pool, and the `xla2` bf16-block
   network against the float32 plain stages (`phase_ddp`, `phase_shard`,
   `phase_xla2_bf16` say what each holds);
14. [filelist]: training from a file list at full width: 32 `mixed`
   samples (16 at NL=48, 16 at NL=80) written as `PairDataset`'s per-item
   cache behind zinc_300 JSON file lists and a pickled pdbbind index;
   `get_dataset` must return them equal field for field through both
   branches, none skipped; then `Run.train` through `pallas2` in float32
   for 4 steps from the file list and from the same samples handed to
   `Run` directly: the same seeds and host batches, losses and gradient
   norms within DDP_TOLS, kernels 5 and 6 launched 4 x 6 times each;
15. [evalacc]: `eval_accuracies` of release/flagship_r4 as it is (module
   path, kNN triplets, bf16), 4 x 16 samples, under `profile_trace`, whose
   trace must hold CUDA kernel events; its first batch's eval step with
   draws made on the CPU on the card and on the CPU, in float32 compute
   (loss within 1e-4 relative) and in the config's bf16 (within 2^-8, one
   bf16 unit roundoff), accuracies within 1/64; the block printed beside
   the JAX package's recorded one (QUALITY_r05.json, no limit);
16. check: accepted molecules are finite and written, and one forward of
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
import re
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
    "continuous": ("stage_node_pre", "stage_att_pos"),
    "no-bond": ("stage_node", "stage_triplet_pre", "stage_triplet_att",
                "stage_pos"),
    "chunked": ("stage_node_pre", "stage_att_pos"),
    "shard": ("stage_node", "stage_triplet_pre", "stage_triplet_att",
              "stage_pos"),
    "filelist": ("stage_node_pre", "stage_att_pos"),
    # flagship_r4 as it is (kNN triplets, module path): no kernel
    "cli": (),
    # the dense reference form: the dense triplet bond update's kernel
    "pt": ("dense_triplet",),
}
# shapes of the kernel rows beyond the flagship's kNN table at NL = 80, 48:
# the hybrid cutoff's table (NL + 32 sources a ligand row), and the pool
# at widths no multiple of 4 and more heads than one launch takes
HYBRID_NL = 80
ODD_POOL = dict(N=48, heads=36, Wt=18)
# the dense triplet bond update's rows: B=16 graphs of N/2..N atoms in the
# NL=48 bucket that [pt] samples in, and in the NL=80 one
DENSE_NL = (48, 80)
# [cli]: the sample.sh recipe through `python -m phoregen_tpu_torch.cli.sample`
CLI_BATCH = 30
CLI_GUIDANCE = [{"type": "atom_prox", "min_d": 1.0, "max_d": 3.0},
                {"type": "center_prox"}]
CLI_PROFILE_STEPS = 20
# [pt]: a reference-format checkpoint of configs/train_lig-phore.yml's
# widths with dense triplets, sampled through the CLI
PT_STEPS = 100
PT_CONFIG = os.path.join("configs", "train_lig-phore.yml")
# [continuous], [no-bond]: flagship_r4's configuration with one option
# changed, seeded random weights, a strided chain, one train step
OPTION_STEPS = 100
OPTION_NL = 48
OPTION_TRAIN_BATCH = 8
OPTIONS = {
    "continuous": dict(categorical_space="continuous", fused_stack="pallas2"),
    "no-bond": dict(bond_diffusion=False, fused_stack="pallas"),
}
# [chunked]: one pallas2 chain whole and in chunks, bit for bit
CHUNK_STEPS, CHUNK = 50, 7
# [ddp]: data-parallel training, flagship_r4 through pallas2 in float32
DDP_STEPS = 4
DDP_NL = 48
DDP_TIMEOUT = 600.0
# a step's loss and gradient norm (relative), and the parameters after the
# steps: max abs (10 x lr: Adam moves an entry whose gradient is rounding
# noise by about lr a step, in a direction the rounding picks; measured
# up to 4.9e-4 on an H100, 700 W) and relative L2 over all of them
DDP_TOLS = (1e-5, 1e-4, 1e-3, 1e-4)
# [shard]: pools sharded over [cuda:0, cuda:0] against the unsharded pool
SHARD_POOLS = (30, 31)
SHARD_STEPS = 100
SHARD_NL = 48
SHARD_COUNTS = (36, 48)     # atom counts drawn in the NL=48 bucket
# positions, max abs (Angstrom): the shards' products over 15 or 16 rows
# round unlike the pool's over 30 or 32, and 100 guided steps carry that
# along (measured 6.1e-4 and 7.6e-6 on an H100, 700 W); a pool whose
# guidance divided by the shard's size, or whose draws were the shard's
# own, misses by far more
SHARD_TOL = 1e-2
# [xla2 bf16]: relative L2 difference of each output from the float32
# plain stages (bf16 keeps 8 bits of mantissa, 0.4% a rounding)
XLA2_BF16_TOL = 0.05
# [filelist]: flagship_r4 trained from zinc_300 file lists through
# PairDataset's per-item cache: FILELIST_PER_BUCKET samples in each bucket,
# `Run.train` for FILELIST_EPOCHS epochs of one batch a bucket, through
# pallas2 in float32, against the same samples handed to `Run` directly
FILELIST_BUCKETS = (48, 80)
FILELIST_PER_BUCKET = 16
FILELIST_EPOCHS = 2
# [evalacc]: eval_accuracies of flagship_r4 as its config stands; the card
# against the CPU on the first batch's draws, by compute dtype: loss
# (relative) and each accuracy (one graph of the 64 eval_accuracies
# averages is 1/64). In float32 only the summation order differs; in the
# config's bf16 the two backends round the network's products and
# activations differently (measured 2.2e-4 on an H100, 700 W), so the
# loss is held to one unit roundoff of bf16 (2^-8)
EVALACC = dict(seed=9999, n_batches=4, batch_size=16)
EVALACC_TOLS = {"float32": (1e-4, 1 / 64), "bfloat16": (2 ** -8, 1 / 64)}


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


# the layer-stack kernels whose SASS must hold tensor-core instructions
HMMA_KERNELS = ("node_kernel", "trip_att_kernel", "trip_pre_kernel",
                "pos_kernel", "att_pos_kernel")


def hmma_counts(lib_path: str) -> dict:
    """{kernel function (mangled name): HMMA instructions in its SASS} of
    the layer-stack kernels of HMMA_KERNELS (cuobjdump from the toolkit
    that built them)."""
    from phoregen_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if re.search(
                r"\d(" + "|".join(HMMA_KERNELS) + ")", m.group(1)) else None
            if fn:
                counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


def print_row(r, shape: str) -> None:
    from phoregen_tpu_torch.ops.kernel_check import BLOCK_MISMATCH_SHARE
    print(f"[kernels] {r['name']} {shape}: max_abs_err={r['max_abs_err']:.3e} "
          f"max_rel_err={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
          f"bound_tc_ms={r['bound_tc_ms']:.4f} "
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
    the triplet pool's rows for each N and at odd widths, and the dense
    triplet bond update's for each N of DENSE_NL. Returns {shape label:
    rows} for the stack and {shape label: row} for the pool and for the
    dense layer."""
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
    dense = {}
    for n in DENSE_NL:
        label = f"B=16 N={n}"
        dense[label] = kc.check_dense_triplet(
            kc.dense_case(B=16, N=n, device="cuda", seed=0), reps=5)
        r = dense[label]
        print(f"[kernels] dense_triplet {label}: max_abs_err="
              f"{r['max_abs_err']:.3e} max_rel_err={r['max_rel_err']:.3e} "
              f"ms={r['ms']:.4f} (the prologue and the kernel; the kernel "
              f"alone {r['kernel_ms']:.4f}) plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']} at the TF32 "
              f"peak; {r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.2f} "
              f"G operations on the real atoms) tol={r['tol']:g} of the "
              f"largest value ok={r['ok']}", flush=True)
        torch.cuda.empty_cache()
    bad = [(r["name"], label) for label, rs in stack.items() for r in rs
           if not r["ok"]] + [(r["name"], label) for label, r in
                              list(pool.items()) + list(dense.items())
                              if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return stack, pool, dense


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
        _reset_launches(ls, pt)
        torch.cuda.synchronize()
        t0 = time.time()
        res = pipe.generate(phore, num_samples=BATCH, out_dir=out_dir,
                            max_batches=1)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _launches(ls, pt)
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
        _reset_launches(ls, pt)
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
        launches = _launches(ls, pt)
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
            _reset_launches(ls, pt)
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
            launches = _launches(ls, pt)
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


def _reset_launches(ls, pt):
    """Zero the launch counts of every kernel library."""
    from phoregen_tpu_torch.ops import dense_triplet
    for mod in (ls, pt, dense_triplet):
        mod.reset_launch_counts()


def _launches(ls, pt):
    """The launch counts of every kernel since `_reset_launches`."""
    from phoregen_tpu_torch.ops import dense_triplet
    return dict(ls.LAUNCHES, **pt.LAUNCHES, **dense_triplet.LAUNCHES)


def _want_only(label, launches, per_kernel):
    want = {k: per_kernel * (k in PATH_KERNELS[label]) for k in launches}
    if launches != want:
        fail(f"the {label} path must launch {PATH_KERNELS[label]} "
             f"{per_kernel} times each and no other kernel: {launches}")


def _phore_batch(pg, root, n, nl, dev, seed=0):
    """A sampling batch of `n` graphs for P03211_merge in the bucket `nl`:
    atom counts in [nl/2, nl], the first at nl."""
    import numpy as np
    from phoregen_tpu_torch.data.batching import replicate_phore
    from phoregen_tpu_torch.data.phore import parse_phore_file
    from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
    sample = GenerationPipeline(pg, device=dev).prepare_phore(
        parse_phore_file(os.path.join(root, "tests", "fixtures", "phores",
                                      "P03211_merge.phore")))
    counts = np.random.default_rng(seed).integers(nl // 2, nl + 1, n)
    counts[0] = nl
    return replicate_phore(sample, n, counts, nl).to(dev)


def phase_cli(root, ls, pt, dev="cuda", steps=0, batch=CLI_BATCH,
              profile_steps=CLI_PROFILE_STEPS):
    """[cli]: `python -m phoregen_tpu_torch.cli.sample` as a user runs it,
    in-process: release/flagship_r4 on its own configuration (module path,
    kNN triplets, no kernel), the sample.sh recipe, one batch of `batch`
    for P03211_merge over the full schedule (`steps` 0), `--save_pool
    --recon_workers 2`. Checks the pool file's JAX key layout, that the
    workers accepted what an in-process reconstruction of the same pool
    accepts, that the native and the Python bond perception agree on
    every molecule of the pool, and that the native library was used.
    Then times `profile_steps` steps of the same sampler on the same batch
    under torch.profiler for the device's busy time: idle share = 1 -
    busy / the CLI's ms/step. Returns the launch counts of the CLI run."""
    import numpy as np
    import torch
    from phoregen_tpu_torch import native
    from phoregen_tpu_torch.cli import sample as cli
    from phoregen_tpu_torch.data.batching import replicate_phore
    from phoregen_tpu_torch.data.phore import parse_phore_file
    from phoregen_tpu_torch.sample.decode import decode_batch
    from phoregen_tpu_torch.sample.predict_bonds import predict_bonds_python
    from phoregen_tpu_torch.sample.reconstruct import recon_task
    from phoregen_tpu_torch.tools.profile_sampling import kernel_rows

    tag = "[cli]"
    if not native.available():
        fail(f"the native host library did not load: {native.load_error()}")
    phore_path = os.path.join(root, "tests", "fixtures", "phores",
                              "P03211_merge.phore")
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["--ckpt", os.path.join(root, "release", "flagship_r4"),
                "--phore", phore_path, "--result_path", out_dir,
                "--num_samples", str(batch), "--batch_size", str(batch),
                "--max_batches", "1", "--sample_nodes_mode", "normal",
                "--normal_scale", "6.0", "--add_edge", "predicted",
                "--pos_guidance_opt", json.dumps(CLI_GUIDANCE),
                "--sample_steps", str(steps), "--save_pool",
                "--recon_workers", "2", "--device", dev, "--seed", "2024"]
        print(f"{tag} python -m phoregen_tpu_torch.cli.sample "
              + " ".join(argv), flush=True)
        _reset_launches(ls, pt)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        out = cli.main(argv)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _launches(ls, pt)
        pipe, res = out["pipeline"], out["results"][0]
        name = res["name"]
        npz = os.path.join(out_dir, name, f"{name}_samples_all.npz")
        if not os.path.exists(npz):
            fail(f"{npz} was not written")
        with np.load(npz) as f:
            pool = {k: f[k] for k in f.files}
        sdfs = [f for f in os.listdir(os.path.join(out_dir, name))
                if f.endswith(".sdf")]
    keys = sorted(f"{k}_0" for k in ("pred_node", "pred_pos", "pred_edge",
                                     "lig_mask"))
    if sorted(pool) != keys:
        fail(f"pool file keys {sorted(pool)}, expected {keys}")
    dcfg = pipe.cfg.model.denoiser
    S = len(pipe.sampler.schedule()[0])
    ms_step = 1e3 * pipe.sample_seconds / S
    if res["n_sampled"] != batch or len(sdfs) != res["n_finished"]:
        fail(f"sampled {res['n_sampled']} (expected {batch}), "
             f"{len(sdfs)} SDF files for {res['n_finished']} accepted")
    _want_only("cli", launches, 0)

    # the workers' verdicts against an in-process reconstruction
    decoded = decode_batch(pool["pred_node_0"], pool["pred_pos_0"],
                           pool["pred_edge_0"], pool["lig_mask_0"],
                           include_bond=True)
    serial = [r[1][1] for r in (recon_task(d, "predicted") for d in decoded)
              if r[0]]
    if serial != res["smiles"]:
        fail(f"recon workers accepted {res['smiles']}, in-process "
             f"reconstruction {serial}")
    # native against Python bond perception on every molecule
    n_bonds = 0
    for i, d in enumerate(decoded):
        got = native.predict_bonds_native(d["element"], d["atom_pos"])
        want = predict_bonds_python(d["element"], d["atom_pos"])
        if got[0] != want[0] or got[1] != want[1]:
            fail(f"native and Python bond perception differ on molecule {i}")
        n_bonds += len(got[1]) // 2
    print(f"{tag} fused_stack={dcfg.fused_stack} triplet_knn="
          f"{dcfg.triplet_knn} use_pallas_triplet={dcfg.use_pallas_triplet}"
          f"; {S} steps, batch {batch}; native library "
          f"{os.path.basename(native.library_path())}")
    print(f"{tag} accepted {res['n_finished']}/{res['n_sampled']} (failed "
          f"{res['n_failed']}); recon workers = in-process on all "
          f"{len(decoded)}; native = Python bond perception on all "
          f"{len(decoded)} ({n_bonds} bonds); pool keys {keys}")

    # device busy time: the same sampler on the same batch, profiled
    counts = pool["lig_mask_0"].sum(1)
    bucket = pool["lig_mask_0"].shape[1]
    sp = pipe.sampler
    sample = pipe.prepare_phore(parse_phore_file(phore_path))
    b = replicate_phore(sample, batch, counts, bucket).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    inv = sp.prepare(b)
    state = sp.init_state(b, gen)
    n_prof = min(profile_steps, S - 1)
    for i in range(min(3, S - 1)):
        state, _ = sp.step(state, i, b, inv, False, gen)
    busy = float("nan")
    if dev == "cuda":
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(n_prof):
                state, _ = sp.step(state, i, b, inv, False, gen)
            torch.cuda.synchronize()
        rows = kernel_rows(prof, n_prof)
        busy = sum(r[0] for r in rows)
        for ms, calls, key in rows[:6]:
            print(f"{tag} kernel {ms:8.3f} ms/step {calls:6.1f} calls/step "
                  f"{key[:90]}")
    print(f"{tag} ms/step {ms_step:.3f}, bucket NL={bucket}, idle share "
          f"{1 - busy / ms_step:.3f} (device busy {busy:.3f} ms/step over "
          f"{n_prof} profiled steps of the same batch)")
    print(f"{tag} molecules/s (sampled, reverse loop) "
          f"{res['n_sampled'] / pipe.sample_seconds:.4f}; accepted per "
          f"batch {res['n_finished']}/{batch}; accepted molecules/s (wall "
          f"incl. reconstruction and start-up) {res['n_finished'] / wall:.4f}"
          f" (wall {wall:.3f} s, loop {pipe.sample_seconds:.3f} s)",
          flush=True)
    return launches


class EasyDict(dict):
    """A dict with attribute access, as the upstream project's
    `easydict.EasyDict` configs are pickled into its checkpoints."""

    def __init__(self, d=None):
        super().__init__(d or {})
        for k, v in self.items():
            setattr(self, k, v)


def reference_state(tree):
    """The port's flax-layout parameter tree (one `layer_<i>` a layer,
    dense triplets) -> the upstream project's `PhoreDiff.state_dict()`
    names and layouts (the inverse of `utils/torch_import.py`)."""
    import numpy as np
    import torch
    dst = {}
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))

    def lin(prefix, t):
        dst[f"{prefix}.weight"] = T(t["kernel"].T)
        if "bias" in t:
            dst[f"{prefix}.bias"] = T(t["bias"])

    def mlp(prefix, t):
        lin(f"{prefix}.net.0", t["Dense_0"])
        dst[f"{prefix}.net.1.weight"] = T(t["LayerNorm_0"]["scale"])
        dst[f"{prefix}.net.1.bias"] = T(t["LayerNorm_0"]["bias"])
        lin(f"{prefix}.net.3", t["Dense_1"])

    def node(prefix, t):
        for ours in ("hk", "hv", "hq"):
            mlp(f"{prefix}.{ours}_func", t[ours])
        if "node_output" in t:
            mlp(f"{prefix}.node_output", t["node_output"])

    for name in ("node_embedder", "edge_embedder", "phore_embedding"):
        lin(name, tree[name])
    for name in ("v_inference", "atom_mlp", "atom_mlp_1", "bond_inference"):
        lin(f"{name}.0", tree[f"{name}_0"])
        lin(f"{name}.2", tree[f"{name}_2"])
    node("phore_encoder", tree["phore_encoder"])
    den = tree["denoiser"]
    i = 0
    while f"layer_{i}" in den:
        lt, pre = den[f"layer_{i}"], f"denoiser.base_block.{i}"
        lin(f"{pre}.lin_node", lt["lin_node"])
        node(f"{pre}.node_layer_with_edge", lt["node_layer_with_edge"])
        node(f"{pre}.node_layer_with_bond", lt["node_layer_with_bond"])
        bt, H = lt["bond_layer"], lt["lin_node"]["kernel"].shape[0]
        for ours in ("hk", "hv"):
            kj = bt[f"{ours}_kj"]["kernel"]
            w = np.concatenate([kj[:H + 20], bt[f"{ours}_ji"]["kernel"],
                                bt[f"{ours}_ang"]["kernel"], kj[H + 20:]])
            p = f"{pre}.bond_layer.{ours}_func"
            dst[f"{p}.net.0.weight"] = T(w.T)
            dst[f"{p}.net.0.bias"] = T(bt[f"{ours}_kj"]["bias"])
            dst[f"{p}.net.1.weight"] = T(bt[f"{ours}_ln"]["scale"])
            dst[f"{p}.net.1.bias"] = T(bt[f"{ours}_ln"]["bias"])
            lin(f"{p}.net.3", bt[f"{ours}_out"])
        mlp(f"{pre}.bond_layer.hq_func", bt["hq"])
        for side in ("pos_layer_with_edge", "pos_layer_with_bond"):
            for ours in ("xk", "xv", "xq"):
                mlp(f"{pre}.{side}.{ours}_func", lt[side][ours])
        if "dire_embedding" in lt:
            lin(f"{pre}.dire_embedding", lt["dire_embedding"])
        i += 1
    if "edge_pred_layer" in den:
        mlp("denoiser.edge_pred_layer", den["edge_pred_layer"])
    return dst


def phase_pt(root, ls, pt, dev="cuda", steps=PT_STEPS, batch=BATCH,
             config=None):
    """[pt]: a reference-format `.pt` (seeded random weights under the
    upstream project's names, an EasyDict config pickled beside `model`,
    written with torch.save) of configs/train_lig-phore.yml at its own
    widths with `triplet_mode: dense`, sampled through the CLI with
    `--sample_steps steps --batch_size batch --max_batches 1`. The
    port's import must equal the tree the weights were made from, leaf by
    leaf. The count head is set to a narrow interval ([0.25, 0.5] of the
    normalised count: 22-41 atoms) so that the batch lands in the NL=48
    bucket. Every dense layer call runs the dense triplet kernel (steps x
    layers launches), none the plain `_dense`. Returns the launch
    counts."""
    import numpy as np
    import torch
    import yaml
    from phoregen_tpu_torch.cli import sample as cli
    from phoregen_tpu_torch.models import layers
    from phoregen_tpu_torch.config import load_config
    from phoregen_tpu_torch.models.phoregen import PhoreGen, init_params
    from phoregen_tpu_torch.utils.checkpoint import (flatten_tree,
                                                     to_jax_params)
    from phoregen_tpu_torch.utils.torch_import import \
        load_reference_checkpoint

    tag = "[pt]"
    cfg = config or load_config(os.path.join(root, PT_CONFIG))
    m, dcfg = cfg.model, cfg.model.denoiser
    dcfg.triplet_mode = "dense"
    # the weights are made one layer a tree (the reference's layout)
    dcfg.scan_layers = False
    pg = PhoreGen(cfg)
    init_params(pg.net, seed=11)
    with torch.no_grad():
        for name, bias in (("atom_mlp_1_2", -1.0986123), ("atom_mlp_2", 0.0)):
            getattr(pg.net, name).kernel.zero_()
            getattr(pg.net, name).bias.fill_(bias)
    tree = to_jax_params(pg.net.state_dict())
    state = reference_state(tree)
    dcfg.scan_layers = True
    with tempfile.TemporaryDirectory() as tmp:
        pt_path = os.path.join(tmp, "reference.pt")
        torch.save({"model": state, "epoch": 7, "config": EasyDict(
            {"model": {"hidden_dim": m.hidden_dim}, "seed": 11})}, pt_path)
        cfg_path = os.path.join(tmp, "dense.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg.to_dict(), f)
        # the import against the tree the weights came from (stacked, as
        # the config's scan_layers asks), every tensor consumed
        imported, meta = load_reference_checkpoint(pt_path, cfg)
        got = flatten_tree(imported["params"])
        want = {}
        for k, v in flatten_tree(tree).items():
            if k.startswith("denoiser.layer_"):
                i, rest = k[len("denoiser.layer_"):].split(".", 1)
                want.setdefault(f"denoiser.layers.layer.{rest}", {})[
                    int(i)] = v
            else:
                want[k] = v
        want = {k: np.stack([v[i] for i in sorted(v)])
                if isinstance(v, dict) else v for k, v in want.items()}
        bad = sorted(set(got) ^ set(want)) + [
            k for k in want if k in got and not np.array_equal(got[k],
                                                               want[k])]
        if bad or meta.get("epoch") != 7:
            fail(f"the .pt import differs from the tree it was made from: "
                 f"{bad[:5]} (epoch {meta.get('epoch')})")
        print(f"{tag} import of {len(state)} reference tensors: "
              f"{len(got)} leaves equal to the source tree, epoch "
              f"{meta['epoch']}")
        argv = ["--ckpt", pt_path, "--config", cfg_path, "--phore",
                os.path.join(root, "tests", "fixtures", "phores",
                             "P03211_merge.phore"),
                "--result_path", os.path.join(tmp, "out"),
                "--num_samples", str(batch), "--batch_size", str(batch),
                "--max_batches", "1", "--sample_steps", str(steps),
                "--device", dev]
        _reset_launches(ls, pt)
        layers.DENSE_TRIP.update(kernel=0, plain=0)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = cli.main(argv)
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    launches = _launches(ls, pt)
    pipe, res = out["pipeline"], out["results"][0]
    per_kernel = steps * dcfg.num_layers * dcfg.num_blocks
    print(f"{tag} launches: {json.dumps(launches)}, dense calls by path "
          f"{json.dumps(layers.DENSE_TRIP)} (a kernel of this path: "
          f"{per_kernel})", flush=True)
    _want_only("pt", launches, per_kernel if dev == "cuda" else 0)
    if dev == "cuda" and layers.DENSE_TRIP != {"kernel": per_kernel,
                                               "plain": 0}:
        fail(f"[pt] dense calls must all take the kernel: "
             f"{layers.DENSE_TRIP}")
    if res["n_sampled"] != batch:
        fail(f"[pt] sampled {res['n_sampled']}, expected {batch}")
    print(f"{tag} triplet_mode=dense, hidden {m.hidden_dim}, "
          f"{dcfg.n_heads} heads, {dcfg.num_layers} layers, knn {dcfg.knn};"
          f" {steps} steps, batch {batch}, bucket NL={pipe.last_bucket}")
    print(f"{tag} ms/step {1e3 * pipe.sample_seconds / steps:.3f}; peak "
          f"memory {peak / 2 ** 30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated); accepted "
          f"{res['n_finished']}/{res['n_sampled']}", flush=True)
    return launches


def option_model(root, label, dev="cuda", seed=5):
    """flagship_r4's configuration with the option `label` of OPTIONS and
    seeded random weights (the release weights are of the other form)."""
    from phoregen_tpu_torch.config import config_from_dict
    from phoregen_tpu_torch.models.phoregen import PhoreGen, init_params
    with open(os.path.join(root, "release", "flagship_r4.json")) as f:
        cfg = config_from_dict(json.load(f)["config"])
    opts = dict(OPTIONS[label])
    cfg.model.denoiser.fused_stack = opts.pop("fused_stack")
    cfg.model.denoiser.block_knn_freeze = True
    if "categorical_space" in opts:
        cfg.model.diff.categorical_space = opts.pop("categorical_space")
    for k, v in opts.items():
        setattr(cfg.model, k, v)
    cfg.train.dtype = "float32"
    pg = PhoreGen(cfg)
    init_params(pg.net, seed)
    pg.net.to(dev).eval()
    return pg


def check_cpu_gradients(pg, batch, draws, tag, dev="cuda"):
    """Loss and parameter gradients of `pg` on `dev` (kernels forward)
    against the plain stages (`fused_stack='xla'`) on the CPU, same
    weights, batch and injected draws; the float32 training check's
    limits."""
    import torch
    from phoregen_tpu_torch.models.phoregen import PhoreGen
    pcfg = copy.deepcopy(pg.config)
    pcfg.model.denoiser.fused_stack = "xla"
    plain = PhoreGen(pcfg)
    plain.net.load_state_dict({k: v.cpu() for k, v in
                               pg.net.state_dict().items()})
    res = []
    for model, d in ((pg, dev), (plain, "cpu")):
        model.net.zero_grad(set_to_none=True)
        loss, _ = model.compute_loss(
            batch.to(d), None, lig_noise_std=pg.config.train.lig_noise_std,
            **{k: torch.as_tensor(v, device=d) for k, v in draws.items()})
        loss.backward()
        res.append((float(loss.detach()), {
            n: p.grad.detach().cpu() for n, p in model.net.named_parameters()
            if p.grad is not None}))
        model.net.zero_grad(set_to_none=True)
    (l_k, g_k), (l_p, g_p) = res
    if set(g_k) != set(g_p):
        fail(f"{tag} gradients of different leaves")
    rel_loss = abs(l_k - l_p) / abs(l_p)
    top = max(float(g.abs().max()) for g in g_p.values())
    diff2 = sum(float(((g_k[n] - g) ** 2).sum()) for n, g in g_p.items())
    rel_grad = (diff2 / sum(float((g ** 2).sum())
                            for g in g_p.values())) ** 0.5
    worst, worst_name = 0.0, ""
    for n, g in g_p.items():
        if not torch.isfinite(g_k[n]).all():
            fail(f"{tag} non-finite gradient of {n}")
        err = float((g_k[n] - g).abs().max()) / max(
            float(g.abs().max()), GRAD_FLOOR * top)
        if err > worst:
            worst, worst_name = err, n
    print(f"{tag} train check, card kernels vs CPU plain stages: loss "
          f"{l_k:.6f} vs {l_p:.6f} (relative {rel_loss:.3e}, tol "
          f"{LOSS_TOL}); gradient relative L2 {rel_grad:.3e} (tol "
          f"{GRAD_TOL}); worst leaf {worst:.3e} ({worst_name}; tol "
          f"{LEAF_GRAD_TOL})", flush=True)
    if not (rel_loss <= LOSS_TOL and rel_grad <= GRAD_TOL
            and worst <= LEAF_GRAD_TOL):
        fail(f"{tag} loss or gradients on the card disagree with the CPU")


def phase_option(root, label, ls, pt, dev="cuda", steps=OPTION_STEPS,
                 nl=OPTION_NL, batch=BATCH, train_batch=OPTION_TRAIN_BATCH):
    """[continuous] / [no-bond]: a strided chain of `steps` through the
    option's fused stack (kernels 5 and 6 for continuous, 1-4 for
    no-bond), steps x layers launches each; then the loss and gradients of
    one batch at `nl` held against the CPU plain path, and one train step
    on the card. Returns the chain's launch counts."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.data.batching import PhoreGraphBatch
    from phoregen_tpu_torch.sample.sampler import GuidanceOpt, Sampler
    from phoregen_tpu_torch.tools.profile_training import bucket_batches
    from phoregen_tpu_torch.train.state import create_train_state
    from phoregen_tpu_torch.train.step import make_train_step

    tag = f"[{label}]"
    pg = option_model(root, label, dev)
    cfg = pg.config
    mcfg, dcfg = cfg.model, cfg.model.denoiser
    sp = Sampler(pg, [GuidanceOpt(**g) for g in CLI_GUIDANCE],
                 sample_steps=steps)
    b = _phore_batch(pg, root, batch, nl, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    _reset_launches(ls, pt)
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    out = sp.sample(b, gen)
    if dev == "cuda":
        torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / steps
    launches = _launches(ls, pt)
    _want_only(label, launches, steps * dcfg.num_layers * dcfg.num_blocks)
    fin = out["final_state"]
    continuous = mcfg.diff.categorical_space == "continuous"
    B = b.lig_mask.shape[0]
    if (out["pred_edge"] is None) != (not mcfg.bond_diffusion):
        fail(f"{tag} pred_edge is {type(out['pred_edge']).__name__}")
    if continuous and tuple(fin["node"].shape) != (B, nl, 12):
        fail(f"{tag} relaxed one-hots of shape {tuple(fin['node'].shape)}")
    for k in ("pred_node", "pred_pos"):
        if not torch.isfinite(out[k]).all():
            fail(f"{tag} non-finite {k}")
    if not mcfg.bond_diffusion and not torch.equal(
            fin["edge"], sp.init_state(b, torch.Generator(
                device=dev).manual_seed(3))["edge"]):
        fail(f"{tag} the bond state moved without bond diffusion")
    print(f"{tag} categorical_space={mcfg.diff.categorical_space} "
          f"bond_diffusion={mcfg.bond_diffusion} fused_stack="
          f"{dcfg.fused_stack}; {steps} steps, batch {B}, NL={nl}: "
          f"{ms:.3f} ms/step; pred_edge "
          f"{'None' if out['pred_edge'] is None else 'present'}; "
          f"launches {json.dumps(launches)}", flush=True)

    tb = bucket_batches(cfg, nl, 1, seed=2026)[0]
    tb = PhoreGraphBatch(**{k: np.asarray(v)[:train_batch]
                            for k, v in vars(tb).items()})
    rng = np.random.default_rng(9)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    Bt, NLt = tb.lig_mask.shape
    draws = dict(t=rng.integers(0, mcfg.diff.num_timesteps, Bt),
                 jitter=f32(Bt, NLt, 3), pos_noise=f32(Bt, NLt, 3))
    if continuous:
        draws.update(node_noise=f32(Bt, NLt, 12),
                     edge_noise=f32(Bt, NLt, NLt, 6))
    else:
        draws.update(node_uniform=rng.uniform(size=(Bt, NLt, 12)).astype(
            np.float32), edge_uniform=rng.uniform(size=(Bt, NLt, NLt, 6)
                                                  ).astype(np.float32))
    check_cpu_gradients(pg, tb, draws, tag, dev)
    pg.net.train()
    state = create_train_state(cfg.train, pg.net)
    before = {n: p.detach().clone() for n, p in pg.net.named_parameters()}
    metrics = make_train_step(pg, cfg)(state, 1, tb.to(dev))
    loss = float(metrics["loss"])
    moved = sum(not torch.equal(before[n], p.detach())
                for n, p in pg.net.named_parameters())
    print(f"{tag} one train step on the card: loss {loss:.4f}, grad_norm "
          f"{float(metrics['grad_norm']):.4f}, leaves moved {moved}/"
          f"{len(before)}; metrics {sorted(metrics)}", flush=True)
    if not np.isfinite(loss) or moved < 0.5 * len(before):
        fail(f"{tag} the train step did not train")
    return launches


def phase_chunked(root, ls, pt, dev="cuda", steps=CHUNK_STEPS, chunk=CHUNK,
                  batch=BATCH, nl=OPTION_NL):
    """[chunked]: one `pallas2` chain of flagship_r4 with `steps` strided
    steps, whole and with `chunk_steps` = chunk (the host waits for the
    card at every chunk boundary): every output and the generator's state
    must be equal bit for bit. Returns the chunked run's launch counts."""
    import torch
    from phoregen_tpu_torch.models.phoregen import load_release_model
    from phoregen_tpu_torch.sample.sampler import GuidanceOpt, Sampler

    pg, _ = load_release_model(os.path.join(root, "release", "flagship_r4"),
                               device=dev, fused_stack="pallas2")
    b = _phore_batch(pg, root, batch, nl, dev)
    outs, gens = [], []
    for c in (0, chunk):
        sp = Sampler(pg, [GuidanceOpt(**g) for g in CLI_GUIDANCE],
                     sample_steps=steps)
        gen = torch.Generator(device=dev).manual_seed(17)
        _reset_launches(ls, pt)
        outs.append(sp.sample(b, gen, chunk_steps=c))
        gens.append(gen.get_state())
    launches = _launches(ls, pt)
    dcfg = pg.config.model.denoiser
    _want_only("chunked", launches,
               steps * dcfg.num_layers * dcfg.num_blocks)
    a, c = outs
    diff = [k for k in ("pred_node", "pred_pos", "pred_edge")
            if not torch.equal(a[k], c[k])]
    diff += [f"final_state.{k}" for k in a["final_state"]
             if not torch.equal(a["final_state"][k], c["final_state"][k])]
    if not torch.equal(gens[0], gens[1]):
        diff.append("generator state")
    print(f"[chunked] pallas2, {steps} steps, batch {batch}, NL={nl}: "
          f"chunk_steps {chunk} vs one pass: "
          f"{'bit for bit equal' if not diff else f'differ in {diff}'}",
          flush=True)
    if diff:
        fail(f"chunked sampling differs from one pass: {diff}")
    return launches


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


def _ddp_rank(rank, world, init_method, root, backend, batches, steps,
              ck_path):
    """One rank of [ddp]: flagship_r4's trainer through `pallas2` in
    float32 on cuda:0, in a process group of `world` ranks over `backend`;
    `steps` train steps on this rank's rows of the global `batches` (host
    numpy), seeds 1, 2, ...; rank 0 writes the state to `ck_path` (when
    given) after them. Returns per-step (loss, grad_norm), ms/step, the
    kernels' launch counts on the steps and the parameters."""
    import torch
    from phoregen_tpu_torch.data.batching import PhoreGraphBatch
    from phoregen_tpu_torch.ops import layer_stack as ls
    from phoregen_tpu_torch.ops import pallas_triplet as pt
    from phoregen_tpu_torch.parallel import group
    from phoregen_tpu_torch.tools.profile_training import (
        flagship_trainer, forward_backward_ms)
    from phoregen_tpu_torch.train.checkpoint import save_checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    group.init(rank, world, init_method, dev, backend=backend)
    try:
        with tempfile.TemporaryDirectory() as run_dir:
            return _ddp_steps(flagship_trainer(
                os.path.join(root, "release", "flagship_r4"), dev, "pallas2",
                run_dir=run_dir, dtype="float32"), batches, steps, ck_path,
                dev, ls, pt, PhoreGraphBatch, forward_backward_ms,
                save_checkpoint)
    finally:
        group.shutdown()


def _ddp_steps(run, batches, steps, ck_path, dev, ls, pt, batch_cls,
               forward_backward_ms, save_checkpoint):
    """The timed steps of [ddp] on `run` (in a process group or not)."""
    import torch
    from phoregen_tpu_torch.parallel import group
    rows = group.local_batch_slice(BATCH)
    local = [batch_cls(**{k: v[rows] for k, v in b.items()}).to(dev)
             for b in batches]
    forward_backward_ms(run, local[0])      # warm-up; leaves no gradient
    torch.cuda.synchronize()
    _reset_launches(ls, pt)
    metrics = []
    for i in range(steps):
        if i == 1:      # the first step sets up the optimizer and the
            t0 = time.time()    # collectives' communicators: not timed
        m = run.train_step(run.state, 1 + i, local[i])
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / (steps - 1)
    launches = _launches(ls, pt)
    if ck_path and group.rank() == 0:
        save_checkpoint(ck_path, run.state, 0, run.config)
    group.barrier()
    return {"metrics": metrics, "ms": ms, "launches": launches,
            "params": {n: p.detach().cpu().numpy()
                       for n, p in run.state.net.named_parameters()}}


def _param_diff(a, b):
    """(max abs difference, relative L2 difference) over all parameters."""
    import numpy as np
    mx = max(float(np.abs(a[n] - b[n]).max()) for n in b)
    num = sum(float(((a[n] - b[n]).astype(np.float64) ** 2).sum()) for n in b)
    den = sum(float((b[n].astype(np.float64) ** 2).sum()) for n in b)
    return mx, (num / den) ** 0.5


def phase_ddp(root, ls, pt):
    """[ddp]: data-parallel training of flagship_r4 through `pallas2` in
    float32, global batches of 16 from the NL=48 bucket of the `mixed`
    corpus, DDP_STEPS steps from one state on the same batches and draws:
    (a) world size 2 on this one card over gloo (NCCL refuses two ranks on
    one device), (b) world size 1 over NCCL, (c) the single-process `Run`.
    (a) and (b) must match (c) on each step's loss and gradient norm and
    on every parameter after the last step (DDP_TOLS); then the state (a)
    wrote resumes at world size 1 for one step, held to (c)'s next step.
    Returns the launch counts of kernels 5 and 6 over the three runs."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.data.batching import PhoreGraphBatch
    from phoregen_tpu_torch.parallel import group
    from phoregen_tpu_torch.tools.profile_training import (
        bucket_batches, flagship_trainer, forward_backward_ms)
    from phoregen_tpu_torch.train.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    tag = "[ddp]"
    prefix = os.path.join(root, "release", "flagship_r4")
    with tempfile.TemporaryDirectory() as tmp:
        single = flagship_trainer(prefix, "cuda", "pallas2",
                                  run_dir=os.path.join(tmp, "c"),
                                  dtype="float32")
        cfg = single.config
        if cfg.train.batch_size != BATCH:
            fail(f"flagship_r4 is expected to train with batches of {BATCH}")
        batches = [{k: np.asarray(v) for k, v in vars(b).items()}
                   for b in bucket_batches(cfg, DDP_NL, DDP_STEPS + 1,
                                           seed=2024)]
        ck = os.path.join(tmp, "ddp2")
        runs = {}
        try:
            runs["a"] = group.launch(_ddp_rank, 2, (
                root, "gloo", batches[:DDP_STEPS], DDP_STEPS, ck),
                timeout=DDP_TIMEOUT)
            runs["b"] = group.launch(_ddp_rank, 1, (
                root, "nccl", batches[:DDP_STEPS], DDP_STEPS, None),
                timeout=DDP_TIMEOUT)
        except Exception as e:
            fail(f"{tag} a rank failed: {e}")
        c = _ddp_steps(single, batches[:DDP_STEPS], DDP_STEPS, None,
                       torch.device("cuda"), ls, pt, PhoreGraphBatch,
                       forward_backward_ms, save_checkpoint)
        nxt = PhoreGraphBatch(**batches[DDP_STEPS]).to("cuda")
        m = single.train_step(single.state, 1 + DDP_STEPS, nxt)
        c_next = (float(m["loss"]), float(m["grad_norm"]))
        c_next_params = {n: p.detach().cpu().numpy()
                         for n, p in single.state.net.named_parameters()}
        # the state world size 2 wrote, one more step at world size 1
        resumed = flagship_trainer(prefix, "cuda", "pallas2",
                                   run_dir=os.path.join(tmp, "r"),
                                   dtype="float32")
        load_checkpoint(ck, resumed.state)
        r = resumed.train_step(resumed.state, 1 + DDP_STEPS, nxt)
        r_metrics = (float(r["loss"]), float(r["grad_norm"]))
        r_params = {n: p.detach().cpu().numpy()
                    for n, p in resumed.state.net.named_parameters()}
    loss_tol, gnorm_tol, param_tol, param_l2_tol = DDP_TOLS
    print(f"{tag} flagship_r4 through pallas2, float32, global batch "
          f"{BATCH} at NL={DDP_NL}, {DDP_STEPS} steps; (a) 2 ranks on one "
          f"card over gloo, (b) 1 rank over NCCL, (c) one process")
    worst = {"a": [0.0, 0.0], "b": [0.0, 0.0]}
    for i in range(DDP_STEPS):
        lc, gc = c["metrics"][i]
        line = f"{tag} step {i + 1}: (c) loss {lc:.6f} grad_norm {gc:.6f}"
        for k in ("a", "b"):
            for rk, res in enumerate(runs[k]):
                la, ga = res["metrics"][i]
                dl, dg = abs(la - lc) / abs(lc), abs(ga - gc) / abs(gc)
                worst[k] = [max(worst[k][0], dl), max(worst[k][1], dg)]
                if rk == 0:
                    line += f"; ({k}) rel. diff loss {dl:.3e} grad_norm " \
                            f"{dg:.3e}"
        print(line)
    a0, a1 = (res["params"] for res in runs["a"])
    same_ranks = all(np.array_equal(a0[n], a1[n]) for n in a0)
    pa = _param_diff(a0, c["params"])
    pb = _param_diff(runs["b"][0]["params"], c["params"])
    print(f"{tag} worst rel. diff vs (c): (a) loss {worst['a'][0]:.3e} "
          f"grad_norm {worst['a'][1]:.3e}; (b) loss {worst['b'][0]:.3e} "
          f"grad_norm {worst['b'][1]:.3e} (limits {loss_tol:g}, "
          f"{gnorm_tol:g})")
    print(f"{tag} parameters after {DDP_STEPS} steps vs (c): (a) max abs "
          f"{pa[0]:.3e}, rel. L2 {pa[1]:.3e}; (b) max abs {pb[0]:.3e}, rel. "
          f"L2 {pb[1]:.3e} (limits {param_tol:g} max abs, {param_l2_tol:g} rel. "
          f"L2); the two ranks of (a) bit for bit equal: {same_ranks}")
    pr = _param_diff(r_params, c_next_params)
    dl = abs(r_metrics[0] - c_next[0]) / abs(c_next[0])
    dg = abs(r_metrics[1] - c_next[1]) / abs(c_next[1])
    print(f"{tag} saved at world size 2, resumed at world size 1: step "
          f"{DDP_STEPS + 1} rel. diff vs (c) loss {dl:.3e} grad_norm "
          f"{dg:.3e}; parameters max abs {pr[0]:.3e}, rel. L2 {pr[1]:.3e}")
    ms = {"a": runs["a"][0]["ms"], "b": runs["b"][0]["ms"], "c": c["ms"]}
    print(f"{tag} ms/step over steps 2-{DDP_STEPS}: (a) {ms['a']:.3f}, "
          f"(b) {ms['b']:.3f}, (c) {ms['c']:.3f}")
    launches = {k: sum(res["launches"][k] for res in runs["a"])
                + runs["b"][0]["launches"][k] + c["launches"][k]
                for k in c["launches"]}
    per_rank = DDP_STEPS * cfg.model.denoiser.num_layers
    print(f"{tag} launches (a) rank 0: {json.dumps(runs['a'][0]['launches'])}"
          f"; (b): {json.dumps(runs['b'][0]['launches'])}; (c): "
          f"{json.dumps(c['launches'])}", flush=True)
    for res in runs["a"] + runs["b"]:
        want = {k: per_rank * (k in PATH_KERNELS["pallas2"])
                for k in res["launches"]}
        if res["launches"] != want:
            fail(f"{tag} a rank must launch {PATH_KERNELS['pallas2']} "
                 f"{per_rank} times each and no other kernel: "
                 f"{res['launches']}")
    if not same_ranks:
        fail(f"{tag} the two ranks of (a) hold different parameters")
    if max(worst["a"][0], worst["b"][0], dl) > loss_tol or \
            max(worst["a"][1], worst["b"][1], dg) > gnorm_tol:
        fail(f"{tag} loss or gradient norm off the single process")
    if max(pa[0], pb[0], pr[0]) > param_tol or \
            max(pa[1], pb[1], pr[1]) > param_l2_tol:
        fail(f"{tag} parameters off (c): (a) {pa[0]:.3e}, (b) {pb[0]:.3e}, "
             f"resumed {pr[0]:.3e} > {param_tol}")
    return {k: launches[k] for k in launches}


def phase_shard(root, ls, pt):
    """[shard]: `GenerationPipeline` on flagship_r4 through `pallas`, its
    pools sharded over devices [cuda:0, cuda:0], against the unsharded
    pipeline on the same seed: a pool of 30 and then one of 31 (rounded up
    to 32), NL=48, SHARD_STEPS strided steps with atom_prox + center_prox
    guidance: the same atom types and bonds, positions within SHARD_TOL.
    Then the CLI with --sample_devices 1 and 0 (one visible card:
    unsharded), pool files equal. Returns the sharded runs' launches."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.cli import sample as cli
    from phoregen_tpu_torch.data.phore import parse_phore_file
    from phoregen_tpu_torch.models.phoregen import load_release_model
    from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
    from phoregen_tpu_torch.sample.sampler import GuidanceOpt

    tag = "[shard]"
    phore_path = os.path.join(root, "tests", "fixtures", "phores",
                              "P03211_merge.phore")
    pg, _ = load_release_model(os.path.join(root, "release", "flagship_r4"),
                               device="cuda", fused_stack="pallas")
    guidance = [GuidanceOpt(**g) for g in CLI_GUIDANCE]
    pipes = {k: GenerationPipeline(
        pg, guidance=guidance, sample_nodes_mode="normal", normal_scale=6.0,
        batch_size=32, seed=2024, device="cuda", sample_steps=SHARD_STEPS,
        devices=devs) for k, devs in (("single", None),
                                      ("sharded", ["cuda:0", "cuda:0"]))}
    ps = pipes["single"].prepare_phore(parse_phore_file(phore_path))
    lo, up = SHARD_COUNTS
    per_kernel = SHARD_STEPS * pg.config.model.denoiser.num_layers
    launches = None
    for pool in SHARD_POOLS:
        n_eff = -(-pool // 2) * 2
        out = {}
        for k, pipe in pipes.items():
            _reset_launches(ls, pt)
            torch.cuda.synchronize()
            t0 = time.time()
            _, raw = pipe.sample_pool(ps, pool if k == "sharded" else n_eff,
                                      lo, up)
            torch.cuda.synchronize()
            out[k] = ({n: None if v is None else v.cpu() for n, v in
                       raw.items() if n != "final_state"},
                      (time.time() - t0) * 1e3 / SHARD_STEPS,
                      _launches(ls, pt), pipe.last_bucket)
        (s, s_ms, _, s_nl), (p, p_ms, p_l, p_nl) = out["single"], \
            out["sharded"]
        if s_nl != SHARD_NL or p_nl != SHARD_NL:
            fail(f"{tag} pools in bucket {s_nl}/{p_nl}, expected {SHARD_NL}")
        if p["pred_pos"].shape[0] != n_eff:
            fail(f"{tag} pool of {pool} sharded to "
                 f"{p['pred_pos'].shape[0]} rows, expected {n_eff}")
        _want_only("shard", p_l, 2 * per_kernel)
        launches = p_l if launches is None else {
            kk: launches[kk] + v for kk, v in p_l.items()}
        lm = s["lig_mask"]
        bm = lm[:, :, None] & lm[:, None, :]
        types = torch.equal(s["pred_node"].argmax(-1)[lm],
                            p["pred_node"].argmax(-1)[lm])
        bonds = torch.equal(s["pred_edge"].argmax(-1)[bm],
                            p["pred_edge"].argmax(-1)[bm])
        err = float((s["pred_pos"] - p["pred_pos"])[lm].abs().max())
        print(f"{tag} pool {pool} -> {n_eff} rows on [cuda:0, cuda:0], "
              f"NL={p_nl}, {SHARD_STEPS} steps: same atom types {types}, "
              f"same bonds {bonds}, positions max abs diff {err:.3e} (tol "
              f"{SHARD_TOL:g}); ms/step sharded {p_ms:.3f}, unsharded "
              f"{s_ms:.3f}", flush=True)
        if not (types and bonds and err <= SHARD_TOL):
            fail(f"{tag} the sharded pool of {pool} differs from the "
                 "unsharded one")
    # the CLI: 1 = unsharded; 0 = every visible card (here one)
    pools = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for n in ("1", "0"):
            argv = ["--ckpt", os.path.join(root, "release", "flagship_r4"),
                    "--phore", phore_path, "--fused_stack", "pallas",
                    "--result_path", os.path.join(out_dir, n),
                    "--num_samples", "4", "--batch_size", "4",
                    "--max_batches", "1", "--sample_steps", "10",
                    "--save_pool", "--sample_devices", n, "--seed", "7"]
            res = cli.main(argv)
            name = res["results"][0]["name"]
            with np.load(os.path.join(out_dir, n, name,
                                      f"{name}_samples_all.npz")) as f:
                pools[n] = {k: f[k] for k in f.files}
            print(f"{tag} cli --sample_devices {n}: devices "
                  f"{[str(d) for d in res['pipeline'].devices]}, sampled "
                  f"{res['results'][0]['n_sampled']}", flush=True)
            if len(res["pipeline"].devices) != 1:
                fail(f"{tag} --sample_devices {n} on one card must run "
                     "unsharded")
    if sorted(pools["1"]) != sorted(pools["0"]) or not all(
            np.array_equal(pools["1"][k], pools["0"][k]) for k in pools["1"]):
        fail(f"{tag} --sample_devices 1 and 0 wrote different pools")
    return launches


def phase_xla2_bf16(root):
    """[xla2 bf16]: flagship_r4's network through `fused_stack: xla2` with
    `fused_block_dtype: bfloat16` (`ops/layer_stack.layer_stack_xla2_bf16`:
    bf16 carries, weights and feature products; no kernel) against the
    float32 plain stages (`xla`) on the card, one forward of a batch of 16
    at NL=48 on seeded noisy states: each output's relative L2 difference
    on the valid slots within XLA2_BF16_TOL."""
    import torch
    from phoregen_tpu_torch.models.phoregen import load_release_model

    prefix = os.path.join(root, "release", "flagship_r4")
    nets = {k: load_release_model(prefix, device="cuda", fused_stack=f,
                                  fused_block_dtype=bdt)[0]
            for k, f, bdt in (("xla2_bf16", "xla2", "bfloat16"),
                              ("xla", "xla", "float32"))}
    b = _phore_batch(nets["xla"], root, BATCH, OPTION_NL, "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    B, NL = b.lig_mask.shape
    node = torch.nn.functional.one_hot(torch.randint(
        0, 12, (B, NL), generator=g, device="cuda"), 12).float()
    edge = torch.nn.functional.one_hot(torch.randint(
        0, 6, (B, NL, NL), generator=g, device="cuda"), 6).float()
    pos = 1.5 * torch.randn(B, NL, 3, generator=g, device="cuda")
    t = torch.randint(0, 1000, (B,), generator=g, device="cuda")
    outs, ms = {}, {}
    for k, pg in nets.items():
        with torch.no_grad():
            for rep in range(2):            # the second call is timed
                torch.cuda.synchronize()
                t0 = time.time()
                o = pg.net(node, pos, b.lig_mask, edge, t, b.phore_x,
                           b.phore_pos, b.phore_norm, b.phore_mask)
                torch.cuda.synchronize()
                ms[k] = (time.time() - t0) * 1e3
        outs[k] = [a.float() for a in o[:3]]
    lm = b.lig_mask
    sel = [lm, lm, lm[:, :, None] & lm[:, None, :]]
    rel, mx = [], []
    for a, r, m, name in zip(outs["xla2_bf16"], outs["xla"], sel,
                             ("pred_node", "pred_pos", "pred_edge")):
        if not torch.isfinite(a).all():
            fail(f"[xla2 bf16] non-finite {name}")
        d = a[m] - r[m]
        mx.append(float(d.abs().max()))
        rel.append(float(d.norm() / r[m].norm()))
    print(f"[xla2 bf16] flagship forward, B={B}, NL={NL}: xla2 with bf16 "
          f"blocks vs the float32 plain stages on the card: rel. L2 diff "
          f"node {rel[0]:.3e}, pos {rel[1]:.3e}, edge {rel[2]:.3e} (tol "
          f"{XLA2_BF16_TOL:g}); max abs node {mx[0]:.3e}, pos {mx[1]:.3e}, "
          f"edge {mx[2]:.3e}; forward ms {ms['xla2_bf16']:.3f} vs "
          f"{ms['xla']:.3f}", flush=True)
    if max(rel) > XLA2_BF16_TOL:
        fail(f"[xla2 bf16] off the float32 plain stages: rel. L2 {rel}")


def _recording(step, record):
    """`Run.train_step` wrapped to append (seed, host batch, loss,
    grad_norm, ms) of each step to `record`."""
    import torch

    def wrapped(state, seed, batch):
        torch.cuda.synchronize()
        t0 = time.time()
        m = step(state, seed, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        record.append((int(seed), {k: v.cpu().numpy() for k, v in
                                   vars(batch).items()},
                       loss, gnorm, (time.time() - t0) * 1e3))
        return m
    return wrapped


def _same_samples(a, b):
    """Two RawSample lists equal field for field."""
    import dataclasses
    import numpy as np
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        for f in dataclasses.fields(y):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(v, np.ndarray):
                if not (isinstance(u, np.ndarray) and u.dtype == v.dtype
                        and np.array_equal(u, v)):
                    return False
            elif u != v:
                return False
    return True


def phase_filelist(root, ls, pt):
    """[filelist]: training from a file list at full width. 16 samples of
    the `mixed` corpus in each of the NL=48 and NL=80 buckets (under
    flagship_r4's max_atom) written as PairDataset's per-item cache under
    the basenames of a zinc_300 JSON file list (train: all 32; valid and
    test: two each) and of a pickled pdbbind index; the phore paths are
    bundled real ones, the molecule files do not exist (the cache is read
    first; there is no RDKit to parse them). `get_dataset` must return the
    samples equal field for field through both branches. Then `Run.train`
    at flagship_r4's configuration and weights through `pallas2` in
    float32, FILELIST_EPOCHS epochs (one batch a bucket: 4 steps), from
    the file list and from the same samples handed to `Run` directly: the
    same seeds and host batches, losses and gradient norms within
    DDP_TOLS (the backward's atomic adds reorder), kernels 5 and 6
    launched steps x 6 times each in the file-list run. Returns that
    run's launches."""
    import copy
    import pickle
    import numpy as np
    import torch
    from phoregen_tpu_torch.data.dataset import get_dataset
    from phoregen_tpu_torch.data.realcorpus import list_real_phore_files
    from phoregen_tpu_torch.tools.profile_training import (
        bucket_samples, flagship_trainer)

    tag = "[filelist]"
    prefix = os.path.join(root, "release", "flagship_r4")
    with tempfile.TemporaryDirectory() as tmp:
        runs = {k: flagship_trainer(prefix, "cuda", "pallas2",
                                    run_dir=os.path.join(tmp, k),
                                    dtype="float32")
                for k in ("filelist", "direct")}
        cfg = runs["filelist"].config
        samples = [s for i, nl in enumerate(FILELIST_BUCKETS)
                   for s in bucket_samples(cfg, nl, FILELIST_PER_BUCKET,
                                           seed=2027 + i)]
        phores = list_real_phore_files(include_sampling=False)
        save = os.path.join(tmp, "cache")
        os.makedirs(save)
        pairs = []
        for i, s in enumerate(samples):
            name = f"zinc_{i:02d}"
            pairs.append([os.path.join(tmp, "mols", name + ".sdf"),
                          phores[i]])
            with open(os.path.join(save, name + ".pkl"), "wb") as f:
                pickle.dump(s, f)
        splits = {"train": pairs, "valid": pairs[:2], "test": pairs[-2:]}
        want = (samples, samples[:2], samples[-2:])
        ds = cfg.dataset
        ds.save_path = save
        for split, rows in splits.items():
            path = os.path.join(tmp, f"{split}.json")
            with open(path, "w") as f:
                json.dump(rows, f)
            setattr(ds, f"zinc_{split}_filelist", path)
        index = os.path.join(tmp, "index.pkl")
        with open(index, "wb") as f:
            pickle.dump({f"pdbbind_{k}": [tuple(r) for r in v]
                         for k, v in splits.items()}, f)
        pcfg = copy.deepcopy(cfg)
        pcfg.dataset.data_name = "pdbbind"
        pcfg.dataset.pdbbind_filelist = index
        t0 = time.time()
        got = {"zinc_300": get_dataset(cfg), "pdbbind": get_dataset(pcfg)}
        read_s = time.time() - t0
        for branch, sets in got.items():
            if [len(x) for x in sets] != [len(x) for x in want] or not all(
                    _same_samples(a, b) for a, b in zip(sets, want)):
                fail(f"{tag} get_dataset through {branch} returned "
                     f"{[len(x) for x in sets]} samples, not the "
                     f"{[len(x) for x in want]} written")
        print(f"{tag} get_dataset: {len(samples)} train samples "
              f"({FILELIST_PER_BUCKET} each at NL={FILELIST_BUCKETS}) equal "
              f"field for field through zinc_300 file lists and a pdbbind "
              f"index, none skipped; both read in {read_s:.2f} s",
              flush=True)

        records = {}
        for k, run in runs.items():
            records[k] = []
            run.train_step = _recording(run.train_step, records[k])
            _reset_launches(ls, pt)
            run.train(got["zinc_300"][0] if k == "filelist" else samples,
                      [], epochs=FILELIST_EPOCHS)
            if k == "filelist":
                launches = _launches(ls, pt)
            del run.state
            torch.cuda.empty_cache()
    fl, di = records["filelist"], records["direct"]
    steps = len(FILELIST_BUCKETS) * FILELIST_EPOCHS
    if len(fl) != steps or len(di) != steps:
        fail(f"{tag} {len(fl)} and {len(di)} steps, expected {steps}")
    same = all(a[0] == b[0] and a[1].keys() == b[1].keys() and all(
        np.array_equal(a[1][n], b[1][n]) for n in a[1]) for a, b in
        zip(fl, di))
    worst = [max(abs(a[i] - b[i]) / abs(b[i]) for a, b in zip(fl, di))
             for i in (2, 3)]
    for i, (a, b) in enumerate(zip(fl, di)):
        print(f"{tag} step {i + 1} NL={a[1]['lig_pos'].shape[1]} seed "
              f"{a[0]}: loss {a[2]:.6f} vs {b[2]:.6f}, grad_norm "
              f"{a[3]:.6f} vs {b[3]:.6f}; ms {a[4]:.3f} vs {b[4]:.3f}")
    ms = {nl: [a[4] for a in fl[1:] if a[1]["lig_pos"].shape[1] == nl]
          for nl in FILELIST_BUCKETS}
    print(f"{tag} Run.train through {cfg.model.denoiser.fused_stack}, "
          f"{cfg.train.dtype}, {steps} steps of "
          f"{BATCH} graphs from the file list: ms/step over steps 2-{steps} "
          f"{np.mean([a[4] for a in fl[1:]]):.3f} ("
          + ", ".join(f"NL={nl}: {np.mean(v):.3f}" for nl, v in ms.items()
                      if v)
          + f"); the same seeds and host batches as the direct run: {same};"
          f" worst rel. diff loss {worst[0]:.3e}, grad_norm {worst[1]:.3e} "
          f"(limits {DDP_TOLS[0]:g}, {DDP_TOLS[1]:g}); launches "
          f"{json.dumps(launches)}", flush=True)
    if not same:
        fail(f"{tag} the file list gave other batches than the samples")
    if worst[0] > DDP_TOLS[0] or worst[1] > DDP_TOLS[1]:
        fail(f"{tag} loss or gradient norm off the direct run")
    _want_only("filelist", launches, steps * cfg.model.denoiser.num_layers)
    return launches


def phase_evalacc(root):
    """[evalacc]: `eval_accuracies` of release/flagship_r4 as its config
    stands (module path, kNN triplets, train.dtype bfloat16) on the card,
    4 batches of 16, seed 9999, inside `profile_trace`: the trace must
    hold CUDA kernel events. Then its first batch through the same eval
    step with draws made on the CPU, once on the card and once all on the
    CPU, in the config's bf16 and in float32 compute: the loss and each
    accuracy within EVALACC_TOLS of that dtype. The card's block is printed beside the JAX package's
    recorded one (QUALITY_r05.json; other draws, so no limit)."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.data.loader import PhoreDataLoader
    from phoregen_tpu_torch.data.realcorpus import mixed_corpus
    from phoregen_tpu_torch.models.phoregen import load_release_model
    from phoregen_tpu_torch.train.step import make_eval_step
    from phoregen_tpu_torch.utils.evalacc import ACC_KEYS, eval_accuracies
    from phoregen_tpu_torch.utils.profiling import TRACE_NAME, profile_trace

    tag = "[evalacc]"
    prefix = os.path.join(root, "release", "flagship_r4")
    pg, _ = load_release_model(prefix, "cuda")
    cfg = pg.config
    secs = {}
    with tempfile.TemporaryDirectory() as logdir:
        for k in ("plain", "profiled"):
            torch.cuda.synchronize()
            t0 = time.time()
            with profile_trace(logdir, enabled=k == "profiled"):
                card = eval_accuracies(pg, cfg, **EVALACC)
            secs[k] = time.time() - t0
        with open(os.path.join(logdir, TRACE_NAME)) as f:
            events = json.load(f)["traceEvents"]
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"{tag} flagship_r4 as configured (fused_stack="
          f"{cfg.model.denoiser.fused_stack}, triplet_knn="
          f"{cfg.model.denoiser.triplet_knn}, train.dtype={cfg.train.dtype})"
          f", {EVALACC['n_batches']} x {EVALACC['batch_size']} samples, "
          f"seed {EVALACC['seed']}: {card}; {secs['plain']:.2f} s, "
          f"{secs['profiled']:.2f} s under profile_trace ({n_kernels} CUDA "
          f"kernel events in the trace)", flush=True)
    if tuple(card) != ACC_KEYS or not all(np.isfinite(v)
                                          for v in card.values()):
        fail(f"{tag} eval accuracies {card}")
    if n_kernels == 0:
        fail(f"{tag} the trace holds no CUDA kernel event")

    # the first batch of that run, through the eval step eval_accuracies
    # runs, with draws made on the CPU: on the card, then all on the CPU,
    # in the config's bf16 and in float32 (unrounded: eval_accuracies
    # rounds to 4 places, 4e-5 of this loss)
    loader = PhoreDataLoader(mixed_corpus(EVALACC["seed"], EVALACC[
        "n_batches"] * EVALACC["batch_size"]), cfg, EVALACC["batch_size"],
        shuffle=False)
    vb, real = next(loader.iter_with_sizes())
    B, NL = vb.lig_type.shape
    rng = np.random.default_rng(EVALACC["seed"])
    draws = dict(t=rng.integers(0, cfg.model.diff.num_timesteps, B),
                 pos_noise=rng.normal(size=(B, NL, 3)).astype(np.float32),
                 node_uniform=rng.uniform(size=(
                     B, NL, cfg.model.num_atom_classes)).astype(np.float32),
                 edge_uniform=rng.uniform(size=(
                     B, NL, NL, cfg.model.num_bond_classes)).astype(
                         np.float32))
    first = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            del pg
            torch.cuda.empty_cache()
            pg, _ = load_release_model(prefix, "cpu")
        for dt in EVALACC_TOLS:
            dcfg = copy.deepcopy(cfg)
            dcfg.train.dtype = dt
            t0 = time.time()
            m = make_eval_step(pg, dcfg)(
                np.uint32(EVALACC["seed"]), vb.to(dev),
                torch.arange(B, device=dev) < real,
                **{k: torch.as_tensor(v, device=dev)
                   for k, v in draws.items()})
            first[dev, dt] = ({k: float(m[k]) for k in ACC_KEYS},
                              time.time() - t0)
    fmt = lambda d: ", ".join(f"{k} {v:.6f}" for k, v in d.items())
    bad = []
    for dt, (loss_tol, acc_tol) in EVALACC_TOLS.items():
        (on_card, card_s), (on_cpu, cpu_s) = first["cuda", dt], \
            first["cpu", dt]
        d_loss = abs(on_card["loss"] - on_cpu["loss"]) / abs(on_cpu["loss"])
        d_acc = max(abs(on_card[k] - on_cpu[k]) for k in ACC_KEYS[1:])
        print(f"{tag} first batch ({real} graphs, NL={NL}), {dt} compute, "
              f"draws made on the CPU: card {fmt(on_card)} ({card_s:.2f} "
              f"s); CPU {fmt(on_cpu)} ({cpu_s:.2f} s); rel. diff loss "
              f"{d_loss:.3e} (tol {loss_tol:.3g}), worst accuracy diff "
              f"{d_acc:.4f} (tol {acc_tol:.4f})", flush=True)
        if d_loss > loss_tol or d_acc > acc_tol:
            bad.append(dt)
    gap = abs(first["cuda", "bfloat16"][0]["loss"] - first[
        "cuda", "float32"][0]["loss"]) / first["cuda", "float32"][0]["loss"]
    print(f"{tag} bf16 against float32 compute on the card: rel. diff loss "
          f"{gap:.3e}", flush=True)
    with open(os.path.join(root, "QUALITY_r05.json")) as f:
        ref = json.load(f)["eval_acc"]
    print(f"{tag} the card's block beside the JAX package's recorded one "
          f"(QUALITY_r05.json, CPU, JAX draws; no limit: the draws differ): "
          + ", ".join(f"{k} {card[k]} vs {ref[k]}" for k in ACC_KEYS),
          flush=True)
    if bad:
        fail(f"{tag} the card disagrees with the CPU on the same draws in "
             f"{bad} compute")


def main():
    import torch
    only = None     # `--only filelist,evalacc`: those phases alone
    if sys.argv[1:]:
        if len(sys.argv) != 3 or sys.argv[1] != "--only":
            fail("usage: chip_smoke.py [--only ddp,shard,xla2_bf16,"
                 "filelist,evalacc]")
        only = sys.argv[2].split(",")
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
    hmma = hmma_counts(paths["layer_stack"])
    print(f"[sass] HMMA instructions (cuobjdump -sass): " + ", ".join(
        f"{k} {v}" for k, v in sorted(hmma.items())), flush=True)
    bare = [k for k in HMMA_KERNELS if not any(
        re.search(r"\d" + k, fn) and v for fn, v in hmma.items())]
    if bare:
        fail(f"{bare} hold no HMMA: {hmma}")
    if only is not None:
        solo = {"ddp": lambda: phase_ddp(root, ls, pt),
                "shard": lambda: phase_shard(root, ls, pt),
                "xla2_bf16": lambda: phase_xla2_bf16(root),
                "filelist": lambda: phase_filelist(root, ls, pt),
                "evalacc": lambda: phase_evalacc(root)}
        for name in only:
            if name not in solo:
                fail(f"no phase {name!r} (one of {sorted(solo)})")
            t0 = time.time()
            solo[name]()
            print(f"[chip_smoke] {name} passed in {time.time() - t0:.1f} s",
                  flush=True)
        return

    stack, pool, dense = phase_kernels(kc)
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
    phase_cli(root, ls, pt)
    torch.cuda.empty_cache()
    launches_pt = phase_pt(root, ls, pt)
    torch.cuda.empty_cache()
    launches_cont = phase_option(root, "continuous", ls, pt)
    torch.cuda.empty_cache()
    launches_nb = phase_option(root, "no-bond", ls, pt)
    torch.cuda.empty_cache()
    launches_chunked = phase_chunked(root, ls, pt)
    torch.cuda.empty_cache()
    launches_ddp = phase_ddp(root, ls, pt)
    torch.cuda.empty_cache()
    launches_shard = phase_shard(root, ls, pt)
    torch.cuda.empty_cache()
    phase_xla2_bf16(root)
    torch.cuda.empty_cache()
    launches_fl = phase_filelist(root, ls, pt)
    torch.cuda.empty_cache()
    phase_evalacc(root)
    torch.cuda.empty_cache()
    for label in REFERENCE_PATHS:
        phase_reference(root, label)

    # the triplet pool's row at the N the module path gave it; the other N
    # and the odd widths ride along under "other_shapes"
    main_n = f"B=16 N={bucket}" if f"B=16 N={bucket}" in pool \
        else next(iter(pool))
    shape_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "bound_tc_ms", "bytes", "flops", "tol")
    pool_row = dict(pool[main_n], shape=main_n, other_shapes=[
        {"shape": label, **{k: r[k] for k in shape_keys}}
        for label, r in pool.items() if label != main_n])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
            "library_ms")
    # launches of each kernel on the main path that runs it (by path where
    # more than one does)
    by_path = {
        "stage_node": {"fused": launches, "pallas_bf16": launches_pb,
                       "no-bond": launches_nb, "shard": launches_shard},
        "stage_triplet_pre": {"fused": launches, "no-bond": launches_nb,
                              "shard": launches_shard},
        "stage_triplet_att": {"fused": launches, "no-bond": launches_nb,
                              "shard": launches_shard},
        "stage_pos": {"fused": launches, "pallas_bf16": launches_pb,
                      "no-bond": launches_nb, "shard": launches_shard},
        "stage_node_pre": {"train": launches_train, "pallas2": launches_p2,
                           "continuous": launches_cont,
                           "chunked": launches_chunked, "ddp": launches_ddp,
                           "filelist": launches_fl},
        "stage_att_pos": {"train": launches_train, "pallas2": launches_p2,
                          "continuous": launches_cont,
                          "chunked": launches_chunked, "ddp": launches_ddp,
                          "filelist": launches_fl},
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
    # the dense layer's row at the N that [pt] gave it
    dense_n = f"B=16 N={DENSE_NL[0]}"
    kernels.append(dict(
        {k: dense[dense_n][k] for k in keys if k != "launches"},
        launches=launches_pt["dense_triplet"], shape=dense_n,
        kernel_ms=dense[dense_n]["kernel_ms"], other_shapes=[
            {"shape": label, "kernel_ms": r["kernel_ms"],
             **{k: r[k] for k in shape_keys}}
            for label, r in dense.items() if label != dense_n]))
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
