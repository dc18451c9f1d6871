"""Where a layer-stack block's time goes, by call site, on the card.

    python -m phoregen_tpu_torch.tools.stage_phases [--source path/to/layer_stack.cu]
        [--kernels stage_node stage_triplet_att] [--nl 80 48] [--batch 16]
        [--reps 3]

Makes a development copy of `csrc/layer_stack.cu` (or `--source`) in a
temporary directory in which every statement that calls one of `SITES`
(the products, LayerNorms, softmaxes, pools, the two attention bodies and
the kernel bodies) is wrapped in `clock64()` stamps: thread 0 of each block
adds the cycles of the call to that call site's counter. Builds it with
nvcc, runs each of `--kernels` `--reps` times at the flagship widths
(`kernel_check.flagship_case`) and prints, per call site that ran, its calls
and its cycles as a share of those of the sites called by a kernel itself
(`*_kernel`, `rows_gemm`); the sites nest: an `edge_attention` holds its
`mm`s. What a kernel does outside its stamped calls (reading the masks, a
padded block's copy) is left out of the total. Each outermost `for`
statement of `LOOP_BODIES` is stamped too, reported as callee `for` (in B1,
the q_z passes and the pre_t phase; loops that a warp runs on its own are
timed on warp 0). The package's own source holds no timing code; this
copy exists only for the run.
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
from .compare_kernels import build

# callees whose statement-form calls are stamped
SITES = ("mm", "mm_fold", "load_fold", "vec_mat", "pool_cols", "ln_rows",
         "softmax_heads", "edge_attention", "bond_attention", "load_rows",
         "node_body", "trip_att_pairs", "trip_att_void_pairs",
         "trip_pre_body", "pos_body")
MAX_SITES = 256
# functions whose outermost loops main() stamps: the phases of stage B1 and
# stage C that run no stamped call
LOOP_BODIES = ("trip_pre_body", "pos_body")

PRELUDE = f"""
__device__ unsigned long long g_site_cycles[{MAX_SITES}];
__device__ unsigned long long g_site_calls[{MAX_SITES}];
#define SITE_BEGIN long long site_t0_ = clock64();
#define SITE_END(i)                                                     \\
  if (threadIdx.x == 0) {{                                              \\
    atomicAdd(&g_site_cycles[i],                                        \\
              (unsigned long long)(clock64() - site_t0_));              \\
    atomicAdd(&g_site_calls[i], 1ull);                                  \\
  }}
"""
READER = f"""
extern "C" int ls_site_read(unsigned long long* cycles,
                            unsigned long long* calls, int reset) {{
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(cycles, g_site_cycles, sizeof(g_site_cycles));
  cudaMemcpyFromSymbol(calls, g_site_calls, sizeof(g_site_calls));
  if (reset) {{
    static unsigned long long zero[{MAX_SITES}];
    cudaMemcpyToSymbol(g_site_cycles, zero, sizeof(zero));
    cudaMemcpyToSymbol(g_site_calls, zero, sizeof(zero));
  }}
  return (int)cudaDeviceSynchronize();
}}
"""


def _close_paren(src: str, i: int) -> int:
    """Index just past the parenthesis that closes the one at src[i]."""
    depth = 0
    for j in range(i, len(src)):
        if src[j] == "(":
            depth += 1
        elif src[j] == ")":
            depth -= 1
            if depth == 0:
                return j + 1
    raise ValueError("unbalanced parentheses")


def _enclosing(src: str, pos: int) -> str:
    """Name of the function whose definition precedes `pos` (`Rows::()` for
    a functor's call operator)."""
    defs = list(re.finditer(
        r"^(?:template <[^>]*>\s*)?(?:__launch_bounds__\([^)]*\)\s*|static "
        r"|__global__ |__device__ |__host__ |inline |void |int |bool |\w+ )+"
        r"(\w+)\(|^\s+__device__ void (operator\(\))\(", src[:pos], re.M))
    if not defs:
        return "?"
    name = defs[-1].group(1) or defs[-1].group(2)
    if name == "operator()":
        owner = re.findall(r"^struct (\w+)", src[:pos], re.M)
        name = f"{owner[-1] if owner else ''}::()"
    return name


def _body_span(src: str, name: str):
    """(start, end) of the braces of function `name`'s definition."""
    m = re.search(r"^(?:__device__|__global__)[^;{]*?\b" + name + r"\(",
                  src, re.M)
    if not m:
        raise ValueError(f"no definition of {name}")
    open_ = src.index("{", _close_paren(src, m.end() - 1))
    depth = 0
    for j in range(open_, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return open_, j + 1
    raise ValueError("unbalanced braces")


def _statement_end(src: str, i: int) -> int:
    """Index just past the statement that starts at src[i] (a `for` whose
    body is a block or one statement)."""
    j = _close_paren(src, src.index("(", i))
    k = j + len(src[j:]) - len(src[j:].lstrip())
    if src[k] == "{":
        depth = 0
        for e in range(k, len(src)):
            depth += {"{": 1, "}": -1}.get(src[e], 0)
            if depth == 0:
                return e + 1
        raise ValueError("unbalanced braces")
    if src.startswith("for", k) and not src[k + 3].isalnum():
        return _statement_end(src, k)
    depth = 0
    for e in range(k, len(src)):
        depth += {"(": 1, ")": -1}.get(src[e], 0)
        if src[e] == ";" and depth == 0:
            return e + 1
    raise ValueError("unterminated statement")


def _outer_loops(src: str, name: str):
    """[(start, end)] of the `for` statements at the top level of function
    `name`'s body (comments skipped)."""
    start, end = _body_span(src, name)
    spans, depth, i = [], 0, start
    while i < end:
        if src.startswith("//", i):
            i = src.index("\n", i)
            continue
        c = src[i]
        if c in "{}":
            depth += 1 if c == "{" else -1
        elif depth == 1 and src.startswith("for", i) and \
                not src[i - 1].isalnum() and src[i - 1] != "_" and \
                not (src[i + 3].isalnum() or src[i + 3] == "_"):
            e = _statement_end(src, i)
            spans.append((i, e))
            i = e
            continue
        i += 1
    return spans


def instrument(src: str, loops=()):
    """(stamped source, [(site index, callee, line, enclosing function)]);
    `loops`: functions whose outermost `for` statements are stamped too
    (callee `for`)."""
    sites = []
    if loops:
        spans = sorted((s, e, name) for name in loops
                       for s, e in _outer_loops(src, name))
        out, pos = [], 0
        for s, e, name in spans:
            i = len(sites)
            sites.append((i, "for", src.count("\n", 0, s) + 1, name))
            out += [src[pos:s], "{ SITE_BEGIN ", src[s:e],
                    f" SITE_END({i}) }}"]
            pos = e
        src = "".join(out + [src[pos:]])
    call = re.compile(r"(?<![\w.>])(" + "|".join(SITES)
                      + r")(<[^;(){}]*>)?\(")
    out, pos = [], 0
    for m in call.finditer(src):
        if m.start() < pos:
            continue
        line_start = src.rfind("\n", 0, m.start()) + 1
        before = src[line_start:m.start()]
        # statement-form calls only: the name starts the statement
        prev = src[:m.start()].rstrip()
        if re.search(r"\b(void|int|bool|float|struct)\s*$", before) or (
                prev and prev[-1] not in ";{})"):
            continue
        end = _close_paren(src, m.end() - 1)
        if src[end:].lstrip()[:1] != ";":
            continue
        semi = src.index(";", end) + 1
        i = len(sites)
        if i >= MAX_SITES:
            raise ValueError("more call sites than MAX_SITES")
        sites.append((i, m.group(1), src.count("\n", 0, m.start()) + 1,
                      _enclosing(src, m.start())))
        out.append(src[pos:m.start()])
        out.append("{ SITE_BEGIN " + src[m.start():semi]
                   + f" SITE_END({i}) }}")
        pos = semi
    out.append(src[pos:])
    body = "".join(out)
    inc = body.index("#define NEG_INF_F")
    return body[:inc] + PRELUDE + body[inc:] + READER, sites


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=_build.source_path("layer_stack"))
    ap.add_argument("--kernels", nargs="+",
                    default=["stage_node", "stage_triplet_att"],
                    choices=[k for k, _ in kc.KERNELS + kc.BF16_KERNELS])
    ap.add_argument("--nl", type=int, nargs="+", default=[80, 48])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with open(args.source) as f:
        stamped, sites = instrument(f.read(), LOOP_BODIES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "layer_stack_stamped.cu")
        with open(path, "w") as f:
            f.write(stamped)
        lib, usage = build(path, os.path.join(tmp, "stamped.so"),
                           "layer_stack")
    for kern, u in sorted(usage.items()):
        print(f"[stamped] {kern}: {u}")
    read = lib.ls_site_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    cyc = (ctypes.c_ulonglong * MAX_SITES)()
    calls = (ctypes.c_ulonglong * MAX_SITES)()
    _build._libs["layer_stack"] = lib
    for nl in args.nl:
        case = kc.flagship_case(B=args.batch, NP=96, NL=nl, device="cuda",
                                seed=0)
        calls_by_name = kc.stage_calls(case)
        for name in args.kernels:
            kern = calls_by_name[name][0]
            kern()
            read(ctypes.addressof(cyc), ctypes.addressof(calls), 1)
            for _ in range(args.reps):
                kern()
            if read(ctypes.addressof(cyc), ctypes.addressof(calls), 1):
                raise SystemExit("reading the site counters failed")
            total = sum(cyc[i] for i, _, _, encl in sites
                        if encl.endswith("_kernel") or encl == "rows_gemm")
            print(f"B={args.batch} NL={nl} {name}: {total / args.reps:.4g} "
                  f"block cycles a launch in the kernel bodies")
            for i, callee, line, encl in sites:
                if calls[i]:
                    print(f"  {callee:<20} line {line:<5} in {encl:<22} "
                          f"calls {calls[i] / args.reps:>9.0f}  "
                          f"share {cyc[i] / max(total, 1):.4f}")
        del case, calls_by_name
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
