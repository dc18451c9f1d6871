#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
1. build: compiles the hand-written CUDA kernels from
   phoregen_tpu_torch/csrc/ with nvcc (sm_90a);
2. kernels: holds each layer-stack kernel against its plain PyTorch
   version on the card at flagship shapes (B=16, NP=96, NL=80, H=128,
   16 heads, Wt=32, kNN 32, K8 32), within atol = rtol = 1e-4 (5e-4 for
   the triplet pre-features, see ops/kernel_check.py::TOLERANCE), and
   times both with CUDA events;
3. main path: loads release/flagship_r4 with the port's own msgpack reader
   and samples one batch of 16 molecules for
   tests/fixtures/phores/P03211_merge.phore through GenerationPipeline
   with the canonical recipe (1000 steps, normal count mode with scale
   6.0, atom_prox + center_prox guidance, predicted edges), writing SDFs
   to a temporary directory; every kernel's launch count on that run must
   be > 0;
4. check: accepted molecules are finite and written, and one forward of
   the flagship network on a small input agrees between the card (kernels)
   and the CPU (plain versions) within atol = rtol = 1e-3 (3 layers of
   float32 attention, different summation order).
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


def phase_kernels(kc):
    case = kc.flagship_case(B=16, NP=96, NL=80, device="cuda", seed=0)
    rows = kc.check_kernels(case, reps=5)
    for r in rows:
        print(f"[kernels] {r['name']}: max_abs_err={r['max_abs_err']:.3e} "
              f"max_rel_err={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, "
              f"{r['flops'] / 1e9:.2f} GFLOP) tol={r['tol']:g} ok={r['ok']}",
              flush=True)
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return rows


def phase_main(root, ls):
    import torch
    from phoregen_tpu_torch.data.phore import parse_phore_file
    from phoregen_tpu_torch.models.phoregen import load_release_model
    from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
    from phoregen_tpu_torch.sample.sampler import GuidanceOpt

    pg, meta = load_release_model(os.path.join(root, "release", "flagship_r4"),
                                  device="cuda", fused_stack="pallas")
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
        torch.cuda.synchronize()
        t0 = time.time()
        res = pipe.generate(phore, num_samples=BATCH, out_dir=out_dir,
                            max_batches=1)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(ls.LAUNCHES)
        mol_dir = os.path.join(out_dir, res["name"])
        sdfs = [f for f in os.listdir(mol_dir) if f.endswith(".sdf")]
    L = pg.config.model.denoiser.num_layers * pg.config.model.denoiser.num_blocks
    print(f"[main] phore {res['name']}: count interval "
          f"{res['count_interval']}, NL bucket {pipe.last_bucket}, "
          f"{res['n_sampled']} sampled, {res['n_finished']} accepted",
          flush=True)
    print(f"[main] accepted: {res['n_finished']}/{res['n_sampled']}")
    print(f"[main] NL bucket: {pipe.last_bucket}")
    print(f"[main] molecules/s (sampled, reverse loop): "
          f"{res['n_sampled'] / pipe.sample_seconds:.4f} "
          f"(loop {pipe.sample_seconds:.3f} s, "
          f"{1e3 * pipe.sample_seconds / NUM_STEPS:.3f} ms/step)")
    print(f"[main] molecules/s (accepted, wall incl. reconstruction): "
          f"{res['n_finished'] / wall:.4f} (wall {wall:.3f} s)")
    print(f"[main] launches: {json.dumps(launches)} "
          f"(expected {NUM_STEPS * L} each)", flush=True)
    if any(v <= 0 for v in launches.values()):
        fail(f"a kernel was not launched on the main path: {launches}")
    if len(sdfs) != res["n_finished"]:
        fail(f"{len(sdfs)} SDF files for {res['n_finished']} accepted")
    for mol in res["mols"]:
        import numpy as np
        pos = np.asarray(mol.pos if hasattr(mol, "pos")
                         else mol.GetConformer().GetPositions())
        if not np.isfinite(pos).all():
            fail("non-finite coordinates in an accepted molecule")
    lo, up = res["count_interval"]
    if not 4 <= lo <= up <= 78:
        fail(f"count interval {res['count_interval']} out of bounds")
    return launches


def phase_reference(root):
    """Flagship forward on a small input: kernels (card) vs plain (CPU)."""
    import numpy as np
    import torch
    from phoregen_tpu_torch.data.batching import replicate_phore
    from phoregen_tpu_torch.data.phore import parse_phore_file
    from phoregen_tpu_torch.models.phoregen import load_release_model
    from phoregen_tpu_torch.sample.pipeline import GenerationPipeline

    prefix = os.path.join(root, "release", "flagship_r4")
    pg_gpu, _ = load_release_model(prefix, device="cuda")
    pg_cpu, _ = load_release_model(prefix, device="cpu")
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
            fail(f"non-finite {name} on the card")
        err = float(np.abs(g[m] - c[m]).max())
        errs.append(err)
        if not np.allclose(g[m], c[m], atol=FORWARD_TOL, rtol=FORWARD_TOL):
            fail(f"{name}: card vs CPU max abs err {err:.3e} > "
                 f"{FORWARD_TOL}")
    print(f"[check] flagship forward, card kernels vs CPU plain: max abs err "
          f"node {errs[0]:.3e}, pos {errs[1]:.3e}, edge {errs[2]:.3e} "
          f"(tol {FORWARD_TOL})", flush=True)


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
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    try:
        _build.build()
        _build.load()
    except Exception as e:
        fail(f"kernel build failed: {e}")
    print(f"[build] {_build.library_path()} in {time.time() - t0:.1f} s",
          flush=True)

    rows = phase_kernels(kc)
    torch.cuda.empty_cache()
    launches = phase_main(root, ls)
    torch.cuda.empty_cache()
    phase_reference(root)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for r in rows:
        r = dict(r, launches=launches[r["name"]])
        kernels.append({k: r[k] for k in keys})
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
