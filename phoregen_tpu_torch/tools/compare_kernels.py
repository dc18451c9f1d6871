"""Time two builds of the layer-stack kernels against each other on the card.

    python -m phoregen_tpu_torch.tools.compare_kernels --other path/to/layer_stack.cu
        [--nl 80 48] [--batch 16] [--reps 5] [--kernels stage_att_pos ...]

Builds `--other` (another version of `csrc/layer_stack.cu` with the same C
entries and pointer slots, e.g. the parent commit's) and the tree's own
source with `nvcc -Xptxas -v`, prints each kernel's registers, stack and
spills and this tree's shared memory and source rows a pass per block
(`ls_launch_plan`), checks both against the plain versions, and times every kernel at
the flagship widths in the order other, this, this, other, so that both
builds meet the same card, clocks and neighbours. Times of two separate
runs differ by several percent; these do not.
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


def build(source: str, out: str):
    """nvcc `source` into the shared library `out`; returns the loaded
    library and ptxas's resource lines per kernel."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
           source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    usage, name = {}, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"^_Z\d+", "", m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and name:
            usage.setdefault(name, {}).update(stack=int(m.group(1)),
                                              spill=int(m.group(2)))
    return _build.bind(out, "layer_stack"), usage


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--nl", type=int, nargs="+", default=[80, 48])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", nargs="+",
                    default=[k for k, _ in kc.KERNELS])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, src in (("other", args.other),
                           ("this", _build.source_path("layer_stack"))):
            libs[label], usage = build(src, os.path.join(tmp, f"{label}.so"))
            for kern, u in sorted(usage.items()):
                print(f"[{label}] {kern}: {u}")
    plan = libs["this"].ls_launch_plan
    plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    for nl in args.nl:
        dims = (ctypes.c_int * 8)(args.batch, 96, nl, 32, 32, 128, 16, 32)
        out = (ctypes.c_int * 10)()
        if plan(dims, out):
            raise SystemExit("ls_launch_plan refused the flagship dims")
        print(f"[this] B={args.batch} NL={nl} source rows a pass, dynamic "
              f"shared memory a block: " + ", ".join(
                  f"{k} {out[2 * i]} rows {out[2 * i + 1]} B" for i, k in
                  enumerate(("node_kernel", "trip_pre_kernel",
                             "trip_att_kernel", "pos_kernel",
                             "att_pos_kernel"))))
    for nl in args.nl:
        case = kc.flagship_case(B=args.batch, NP=96, NL=nl, device="cuda",
                                seed=0)
        calls = kc.stage_calls(case)
        for name in args.kernels:
            kern, plain = calls[name]
            ref = plain()
            ref = ref if isinstance(ref, tuple) else (ref,)
            ms = {"other": [], "this": []}
            err = {}
            for label in ("other", "this", "this", "other"):
                _build._libs["layer_stack"] = libs[label]
                got = kern()
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                # q_z / new_h / hb_new / x_new; pre_t is held by chip_smoke
                # on the triplets the attention reads
                err[label] = max(float((g - r).abs().max())
                                 for g, r in zip(got, ref) if g.dim() < 5)
                ms[label].append(kc._time_ms(kern, args.reps))
            o, t = min(ms["other"]), min(ms["this"])
            print(f"B={args.batch} NL={nl} {name}: other {o:.4f} ms "
                  f"{ms['other']}, this {t:.4f} ms {ms['this']}, "
                  f"other/this {o / t:.3f}; max abs err vs plain other "
                  f"{err['other']:.2e}, this {err['this']:.2e}", flush=True)
        del case, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
