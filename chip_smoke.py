#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
1. build: compiles the hand-written CUDA kernels from
   phoregen_tpu_torch/csrc/ with nvcc (sm_90a), one nvcc per source, all
   started together;
2. kernels: holds each kernel against its plain PyTorch version on the
   card and times both with CUDA events: the four layer-stack kernels at
   flagship shapes (B=16, NP=96, NL=80, H=128, 16 heads, Wt=32, kNN 32,
   K8 32) within atol = rtol = 1e-4 (5e-4 for the triplet pre-features),
   and the all-k triplet pool at B=16, 16 heads, Wt=32 for N=48 and N=80
   with padded slots, within 5e-4 on the unmasked (j, i) pairs (masked
   ones must be exactly 0); see ops/kernel_check.py::TOLERANCE for why;
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
5. check: accepted molecules are finite and written, and one forward of
   the flagship network on a small input agrees between the card (kernels)
   and the CPU (plain versions), on both paths, within atol = rtol = 1e-3
   (6 layers of float32 attention, different summation order).
The second-to-last lines are the `kernels` JSON and the card's name and
power limit; the last line is the device JSON.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

FORWARD_TOL = 1e-3
NUM_STEPS = 1000
BATCH = 16
PATHS = {
    "fused": dict(fused_stack="pallas"),
    "module": dict(fused_stack="none", triplet_knn=0,
                   use_pallas_triplet=True),
}


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
    print(f"[kernels] {r['name']} {shape}: max_abs_err={r['max_abs_err']:.3e} "
          f"max_rel_err={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
          f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, "
          f"{r['flops'] / 1e9:.2f} GFLOP) tol={r['tol']:g} ok={r['ok']}",
          flush=True)


def phase_kernels(kc):
    """Rows of the four layer-stack kernels, and the triplet pool's row for
    each N."""
    import torch
    case = kc.flagship_case(B=16, NP=96, NL=80, device="cuda", seed=0)
    rows = kc.check_kernels(case, reps=5)
    for r in rows:
        print_row(r, "B=16 NP=96 NL=80")
    del case
    torch.cuda.empty_cache()
    pool = {}
    for n in (48, 80):
        pool[n] = kc.check_triplet_pool(
            kc.triplet_case(B=16, N=n, device="cuda", seed=0), reps=5)
        print_row(pool[n], f"B=16 N={n}")
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows + list(pool.values()) if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return rows, pool


def phase_main(root, label, ls, pt):
    """Sample one batch through the path `label`; returns (launch counts of
    all five kernels on that run, the NL bucket)."""
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
        batch_size=BATCH, seed=2024, device="cuda")
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
    per_kernel = NUM_STEPS * dcfg.num_layers * dcfg.num_blocks
    print(f"{tag} fused_stack={dcfg.fused_stack} triplet_knn="
          f"{dcfg.triplet_knn} use_pallas_triplet={dcfg.use_pallas_triplet}; "
          f"{NUM_STEPS} steps, {dcfg.num_blocks} block x {dcfg.num_layers} "
          f"layers, hidden {dcfg.hidden_dim}, {dcfg.n_heads} heads")
    print(f"{tag} phore {res['name']}: count interval "
          f"{res['count_interval']}")
    print(f"{tag} accepted: {res['n_finished']}/{res['n_sampled']}")
    print(f"{tag} NL bucket: {pipe.last_bucket}")
    print(f"{tag} molecules/s (sampled, reverse loop): "
          f"{res['n_sampled'] / pipe.sample_seconds:.4f} "
          f"(loop {pipe.sample_seconds:.3f} s, "
          f"{1e3 * pipe.sample_seconds / NUM_STEPS:.3f} ms/step)")
    print(f"{tag} molecules/s (accepted, wall incl. reconstruction): "
          f"{res['n_finished'] / wall:.4f} (wall {wall:.3f} s)")
    print(f"{tag} launches: {json.dumps(launches)} "
          f"(a kernel of this path: {per_kernel})", flush=True)
    stack = [v for k, v in launches.items() if k != "triplet_pool"]
    if label == "fused":
        if any(v <= 0 for v in stack) or launches["triplet_pool"] != 0:
            fail(f"the fused path must launch each layer-stack kernel and "
                 f"no triplet pool: {launches}")
    elif launches["triplet_pool"] != per_kernel or any(stack):
        fail(f"the module path must launch the triplet pool {per_kernel} "
             f"times and no layer-stack kernel: {launches}")
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

    rows, pool = phase_kernels(kc)
    torch.cuda.empty_cache()
    launches, _ = phase_main(root, "fused", ls, pt)
    torch.cuda.empty_cache()
    launches_mod, bucket = phase_main(root, "module", ls, pt)
    torch.cuda.empty_cache()
    phase_reference(root, "fused")
    phase_reference(root, "module")

    # the triplet pool's row at the N the module path gave it; the other N
    # rides along under "other_shapes"
    main_n = bucket if bucket in pool else min(pool)
    pool_row = dict(pool[main_n], shape=f"B=16 N={main_n}", other_shapes=[
        {"shape": f"B=16 N={n}", **{k: r[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}}
        for n, r in pool.items() if n != main_n])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: dict(r, launches=launches[r["name"]])[k] for k in keys}
               for r in rows]
    pool_row["launches"] = launches_mod["triplet_pool"]
    kernels.append({k: pool_row[k]
                    for k in keys + ("shape", "other_shapes")})
    print(f"[chip_smoke] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
