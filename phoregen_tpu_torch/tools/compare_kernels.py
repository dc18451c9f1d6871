"""Time two builds of one kernel library against each other on the card.

    python -m phoregen_tpu_torch.tools.compare_kernels --other path/to/layer_stack.cu
        [--library layer_stack] [--nl 80 48] [--batch 16] [--reps 5]
        [--kernels stage_att_pos ...]
    python -m phoregen_tpu_torch.tools.compare_kernels --library triplet_pool
        --other path/to/triplet_pool.cu [--nl 80 48] [--batch 16] [--reps 5]
    python -m phoregen_tpu_torch.tools.compare_kernels --library dense_triplet
        [--other path/to/dense_triplet.cu] [--nl 80 48] [--batch 16]

Builds `--other` (another version of the library's source, `csrc/
layer_stack.cu` or `csrc/triplet_pool.cu`, with the same C entries and
pointer slots, e.g. the parent commit's) and the tree's own source with
`nvcc -Xptxas -v`, prints each kernel's registers, stack, spills and static
shared memory, and the launch plan where the build exports one
(`ls_launch_plan`: source rows a pass, dynamic shared memory a block,
destination nodes a block and blocks an SM;
`tp_launch_plan`: dynamic shared memory, resident blocks an SM, threads and
target atoms a block). It checks both builds against the plain versions,
then times every kernel in the order other, this, this, other, so that both
builds meet the same card, clocks and neighbours. Times of two separate
runs differ by several percent; these do not.

`layer_stack`: the six layer-stack kernels at the flagship widths (B graphs,
NP=96, NL in `--nl`; `kernel_check.flagship_case`), and on request
(`--kernels`) the bf16-block forms of rows 2, 3, 5 and 6
(`stage_triplet_pre_bf16`, ...; a build without their entries stops
the run with AttributeError). `triplet_pool`: the
all-k triplet pool at B graphs of N = each of `--nl` slots, 16 heads,
Wt=32 (`kernel_check.triplet_case`), held by `check_triplet_pool` (5e-4 on
the unmasked pairs, exact zeros on the masked ones). `dense_triplet`: the
dense triplet bond update at B graphs of N = each of `--nl` slots with N/2
to N atoms (`kernel_check.dense_case`), held against the layer's plain
`_dense` by `check_dense_triplet`, timed as the layer's kernel path
(prologue and kernel) and as the launch alone, beside `_dense` and the
layer's least time (`kernel_check._dense_work` at the HBM and TF32 peaks);
without `--other` only this build is timed.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import tempfile

import torch

from ..ops import _build
from ..ops import kernel_check as kc
from ..ops import pallas_triplet as pt


def build(source: str, out: str, library: str):
    """nvcc `source` into the shared library `out`; returns the loaded
    library (the C entries of `library` declared) and ptxas's resource lines
    per kernel."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
           source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    # ptxas prints, per entry: "Compiling entry function 'E'", "Function
    # properties for E", E's stack / spill line, "Used N registers"; the
    # properties of the non-inlined functions it calls follow with their
    # own stack lines, which are not E's
    usage, name, props = {}, None, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            name = re.sub(r"^_Z\d+", "", entry)
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            usage[name]["static_smem"] = int(m.group(1)) if m else 0
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and name and props == entry:
            usage.setdefault(name, {}).update(stack=int(m.group(1)),
                                              spill=int(m.group(2)))
    # another version of the source may lack entries of this one (an older
    # source has no bf16-block entries): declare those it exports; timing
    # one it lacks raises AttributeError
    lib = ctypes.CDLL(out)
    _build.declare(lib, [e for e in _build.LIBRARIES[library][1]
                         if hasattr(lib, e)])
    return lib, usage


PLAN_KERNELS = ("node_kernel", "trip_pre_kernel", "trip_att_kernel",
                "pos_kernel", "att_pos_kernel")


def launch_plan(lib, dims):
    """{kernel: (source rows a pass, dynamic shared memory a block in bytes,
    destination nodes a block, blocks an SM)} from `ls_launch_plan` for
    `dims` (B, NP, NL, K, K8, H, heads, Wt); None if it refuses them."""
    plan = lib.ls_launch_plan
    plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    out = (ctypes.c_int * (4 * len(PLAN_KERNELS)))()
    if plan((ctypes.c_int * 8)(*dims), out):
        return None
    return {k: tuple(out[4 * i:4 * i + 4])
            for i, k in enumerate(PLAN_KERNELS)}


def layer_stack_plans(lib, args):
    for nl in args.nl:
        plan = launch_plan(lib, (args.batch, 96, nl, 32, 32, 128, 16, 32))
        if plan is None:
            raise SystemExit("ls_launch_plan refused the flagship dims")
        print(f"[this] B={args.batch} NL={nl} source rows a pass, dynamic "
              f"shared memory a block, destinations a block, blocks an SM: "
              + ", ".join(f"{k} {r} rows {by} B G={g} {n}/SM"
                          for k, (r, by, g, n) in plan.items()))


def triplet_pool_plans(libs, args):
    for label, lib in libs.items():
        try:
            plan = lib.tp_launch_plan
        except AttributeError:
            print(f"[{label}] exports no tp_launch_plan")
            continue
        plan.argtypes = [ctypes.POINTER(ctypes.c_int),
                         ctypes.POINTER(ctypes.c_int)]
        for n in args.nl:
            dims = (ctypes.c_int * 7)(args.batch, n, 16, 32, 3, 1, 0)
            out = (ctypes.c_int * 4)()
            if plan(dims, out):
                raise SystemExit(f"[{label}] tp_launch_plan refused N={n}")
            print(f"[{label}] B={args.batch} N={n}: dynamic shared memory "
                  f"{out[0]} B a block, {out[1]} blocks an SM, {out[2]} "
                  f"threads and {out[3]} target atoms a block")


def compare(kern, check, libs, name, tag, args):
    """Time `kern` with library `name` of each build in the order other,
    this, this, other; `check()` describes the current build's error
    against the plain version."""
    ms = {"other": [], "this": []}
    err = {}
    for label in ("other", "this", "this", "other"):
        _build._libs[name] = libs[label]
        err[label] = check()
        ms[label].append(kc._time_ms(kern, args.reps))
    o, t = min(ms["other"]), min(ms["this"])
    print(f"{tag}: other {o:.4f} ms {ms['other']}, this {t:.4f} ms "
          f"{ms['this']}, other/this {o / t:.3f}; vs plain: other "
          f"{err['other']}, this {err['this']}", flush=True)


def compare_layer_stack(libs, args):
    layer_stack_plans(libs["this"], args)
    for nl in args.nl:
        case = kc.flagship_case(B=args.batch, NP=96, NL=nl, device="cuda",
                                seed=0)
        calls = kc.stage_calls(case)
        for name in args.kernels:
            kern, plain = calls[name]
            ref = plain()
            ref = ref if isinstance(ref, tuple) else (ref,)

            def check():
                got = kern()
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                # q_z / new_h / hb_new / x_new; pre_t is held by chip_smoke
                # on the triplets the attention reads
                return "max abs err %.2e" % max(
                    float((g.float() - r.float()).abs().max())
                    for g, r in zip(got, ref) if g.dim() < 5)
            compare(kern, check, libs, "layer_stack",
                    f"B={args.batch} NL={nl} {name}", args)
        del case, calls
        torch.cuda.empty_cache()


def compare_triplet_pool(libs, args):
    triplet_pool_plans(libs, args)
    for n in args.nl:
        case = kc.triplet_case(B=args.batch, N=n, device="cuda", seed=0)
        a = [case[k] for k in ("a_kj", "a_ji", "q", "pos", "mask", "w_ang",
                               "ln_scale", "ln_bias", "act", "norm",
                               "num_ang_funcs")]

        def check():
            row = kc.check_triplet_pool(case, reps=1)
            return f"max abs err {row['max_abs_err']:.2e} ok {row['ok']}"
        compare(lambda: pt.triplet_pool_cuda(*a), check, libs,
                "triplet_pool", f"B={args.batch} N={n} triplet_pool", args)
        del case, a
        torch.cuda.empty_cache()


def compare_dense_triplet(libs, args):
    plan = libs["this"].dt_launch_plan
    plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    for n in args.nl:
        out = (ctypes.c_int * 4)()
        if plan((ctypes.c_int * 9)(args.batch, n, 1, 0, 384, 512, 512, 640,
                                   256), out):
            raise SystemExit(f"dt_launch_plan refused N={n}")
        print(f"[this] B={args.batch} N={n}: dynamic shared memory {out[0]} "
              f"B a block, {out[1]} blocks an SM, {out[2]} threads and "
              f"{out[3]} target bonds a block")
    order = ("other", "this", "this", "other") if "other" in libs else (
        "this", "this")
    for n in args.nl:
        case = kc.dense_case(B=args.batch, N=n, device="cuda", seed=0)
        rows = {"other": [], "this": []}
        for label in order:
            _build._libs["dense_triplet"] = libs[label]
            rows[label].append(kc.check_dense_triplet(case, args.reps))
        for label in ("other", "this"):
            if not rows[label]:
                continue
            ms = min(r["ms"] for r in rows[label])
            r0 = rows[label][0]
            print(f"B={args.batch} N={n} dense_triplet [{label}]: path "
                  f"{[round(r['ms'], 4) for r in rows[label]]} ms, launch "
                  f"{[round(r['kernel_ms'], 4) for r in rows[label]]} ms, "
                  f"plain _dense {r0['plain_ms']:.4f} ms, bound "
                  f"{r0['bound_ms']:.5f} ms ({r0['bytes'] / 1e6:.1f} MB, "
                  f"{r0['flops'] / 1e9:.3f} G operations), path / bound "
                  f"{ms / r0['bound_ms']:.1f}, max abs err "
                  f"{max(r['max_abs_err'] for r in rows[label]):.2e} (rel "
                  f"{max(r['max_rel_err'] for r in rows[label]):.2e}), ok "
                  f"{all(r['ok'] for r in rows[label])}", flush=True)
        del case
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None)
    ap.add_argument("--library", choices=sorted(_build.LIBRARIES),
                    default="layer_stack")
    ap.add_argument("--nl", type=int, nargs="+", default=[80, 48])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", nargs="+",
                    default=[k for k, _ in kc.KERNELS],
                    choices=[k for k, _ in kc.KERNELS + kc.BF16_KERNELS])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.other is None and args.library != "dense_triplet":
        raise SystemExit(f"--library {args.library} needs --other")
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, src in (("other", args.other),
                           ("this", _build.source_path(args.library))):
            if src is None:
                continue
            libs[label], usage = build(src, os.path.join(tmp, f"{label}.so"),
                                       args.library)
            for kern, u in sorted(usage.items()):
                print(f"[{label}] {kern}: {u}")
    if args.library == "layer_stack":
        compare_layer_stack(libs, args)
    elif args.library == "triplet_pool":
        compare_triplet_pool(libs, args)
    else:
        compare_dense_triplet(libs, args)


if __name__ == "__main__":
    main()
