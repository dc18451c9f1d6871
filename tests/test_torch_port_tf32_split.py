"""The error-compensated 3xTF32 products of `csrc/layer_stack.cu` (`mm_tc`),
emulated in numpy on the CPU, against a float32 FMA loop and against
float64, at the widths of stage A's and stage B2's products. This is an
emulation only: it runs no code of the port, and the card's own errors
are measured by `tools/compare_kernels` and chip_smoke.py.

`cvt.rna.tf32.f32` rounds a float32 to 10 mantissa bits, to nearest with
ties away from zero. The textbook split of an operand x is hi = rna(x) and
lo = rna(x - hi) ("rna" below, rounded by float64 arithmetic). The
kernel's split rounds hi by two integer operations and passes lo = x - hi,
exact in float32, of which the tensor core reads the top 11 significant
bits ("kernel": emulated as lo truncated, the worst it can read). Each
k-step of 8 (an
m16n8k8 tile) is added to the float32 sum as lo.hi, then hi.lo, then
hi.hi. The emulation takes each term's k-step sum exactly (in float64) and
adds it to the float32 accumulator with one rounding; the tensor core's
own accumulation rounds more coarsely than that, so the card's errors are
larger than these (PERF.md). The FMA loop is a float32 fused
multiply-add per k.

The study this holds: on seeded flagship-width inputs the split sits
within a few float32 roundings of the exact product, like the FMA loop,
while plain TF32 (hi.hi alone) is some thousand times further off
(printed). The kernels' rows are held to 1e-4 against their plain
versions."""
import numpy as np
import pytest

# (name, rows, k, columns, input kind) of the products the kernels run at
# the flagship widths (H=128, 16 heads, Wt=32): the kNN edge first layer
# (two nodes' 64 edges, 93 feature columns padded to 96), the bond grid's
# first and second layers (80 sources), B2's per-head queries and its
# output layer (48 pairs a block, all 16 heads, at NL=48)
PRODUCTS = [
    ("edge_first_layer", 64, 93, 256, "features"),
    ("bond_first_layer", 80, 128, 256, "normal"),
    ("bond_second_layer", 80, 128, 128, "relu"),
    ("b2_q_h", 48, 128, 512, "relu"),
    ("b2_t_out", 48, 512, 128, "pooled"),
]


def tf32_rna(x):
    """float32 -> float32 rounded to 10 mantissa bits, ties away from 0."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_rna_reference(x):
    """rna by float64 arithmetic: 11 significant bits, ties away from 0."""
    m, e = np.frexp(np.asarray(x, np.float32).astype(np.float64))
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def tf32_trunc(x):
    """float32 -> float32 with its low 13 bits cleared (toward zero)."""
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """hi = rna(x), lo = rna(x - hi), rounded by float64 arithmetic."""
    hi = tf32_rna_reference(x)
    return hi, tf32_rna_reference(x - hi)


def split_kernel(x):
    """mm_tc's split (`split_tf32`): hi = rna(x) by integer operations, lo =
    x - hi as the tensor core reads it at worst (truncated to TF32)."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


SPLITS = {"rna": split, "kernel": split_kernel}


def product_3xtf32(a, w, split=split):
    """Per k-step of 8, lo.hi + hi.lo + hi.hi."""
    ah, al = split(a)
    wh, wl = split(w)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, wh), (ah, wl), (ah, wh)):
            term = x[:, s].astype(np.float64) @ y[s].astype(np.float64)
            acc = (acc.astype(np.float64) + term).astype(np.float32)
    return acc


def product_tf32(a, w):
    """Plain TF32: hi.hi alone, float32 accumulation per k-step."""
    ah, wh = tf32_rna(a), tf32_rna(w)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        term = ah[:, s].astype(np.float64) @ wh[s].astype(np.float64)
        acc = (acc.astype(np.float64) + term).astype(np.float32)
    return acc


def product_fma(a, w):
    """The FMA loop: one float32 fused multiply-add per k (the product of
    two float32 values is exact in float64, so one rounding a step)."""
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    a64, w64 = a.astype(np.float64), w.astype(np.float64)
    for k in range(a.shape[1]):
        acc = (acc + a64[:, k:k + 1] * w64[k:k + 1]).astype(np.float32)
    return acc


def operands(rows, k, cols, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "features":      # rbf x edge type, edge type, dire terms
        a = rng.uniform(0.0, 1.0, size=(rows, k))
    elif kind == "relu":        # after LayerNorm + ReLU
        a = np.maximum(rng.normal(size=(rows, k)), 0.0)
    elif kind == "pooled":      # softmax-weighted pools of pre_t (>= 0)
        a = np.abs(rng.normal(size=(rows, k)))
    else:
        a = rng.normal(size=(rows, k))
    # the layer weights of kernel_check.flagship_case: 0.3 / sqrt(fan in)
    w = 0.3 * rng.normal(size=(k, cols)) / np.sqrt(k)
    return a.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("how", sorted(SPLITS))
@pytest.mark.parametrize("name,rows,k,cols,kind", PRODUCTS,
                         ids=[p[0] for p in PRODUCTS])
def test_3xtf32_is_as_close_as_float32(name, rows, k, cols, kind, how):
    a, w = operands(rows, k, cols, kind, seed=len(name))
    exact = a.astype(np.float64) @ w.astype(np.float64)
    err = {label: float(np.abs(f(a, w) - exact).max())
           for label, f in (
               ("3xtf32", lambda a, w: product_3xtf32(a, w, SPLITS[how])),
               ("fma", product_fma), ("tf32", product_tf32))}
    print(f"{name} [{rows} x {k}] @ [{k} x {cols}]: max abs error vs "
          f"float64: 3xTF32 ({how} split) {err['3xtf32']:.3e}, float32 FMA "
          f"{err['fma']:.3e}, plain TF32 {err['tf32']:.3e}")
    assert err["3xtf32"] <= 4 * err["fma"]
    assert err["3xtf32"] < 1e-5
    # plain TF32 alone could not meet the kernels' 1e-4 tolerances at
    # these widths with any margin
    assert err["tf32"] > 100 * err["3xtf32"]


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)       # TF32 spacing at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.999,
                  one + ulp * 1.5, 3.0e38, 0.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp,
                     np.float32(3.0e38), 0.0], np.float32)
    got = tf32_rna(x)
    np.testing.assert_array_equal(got[:4], want[:4])
    assert got[5] == 0.0
    # low 13 bits clear, and the kernel's integer rounding is rna
    r = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    assert not (tf32_rna(r).view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(tf32_rna(x[:5]), tf32_rna_reference(x[:5]))
    np.testing.assert_array_equal(tf32_rna(r), tf32_rna_reference(r))


def test_kernel_split_carries_22_bits():
    """The kernel's split: x - hi is exact in float32 (hi is x rounded to 11
    bits), and hi + lo is x to within 2^-22 of |x| when the tensor core
    truncates lo, with lo no larger than 2^-11 of hi."""
    x = np.random.default_rng(4).normal(size=4096).astype(np.float32) \
        * np.float32(2.0) ** np.random.default_rng(5).integers(
            -20, 20, 4096).astype(np.float32)
    hi, lo = split_kernel(x)
    assert (x.astype(np.float64) - hi.astype(np.float64)
            == (x - hi).astype(np.float64)).all()
    rest = np.abs(x.astype(np.float64) - hi.astype(np.float64)
                  - lo.astype(np.float64))
    assert (rest <= np.abs(x.astype(np.float64)) * 2.0 ** -22).all()
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11).all()


def test_split_carries_22_bits():
    """hi + lo is x to within 2^-22 of |x| (a float32 has 24 bits; lo's own
    rounding drops what lies beyond hi's 11 and lo's 11)."""
    x = np.random.default_rng(1).normal(size=4096).astype(np.float32) \
        * np.float32(2.0) ** np.random.default_rng(2).integers(
            -20, 20, 4096).astype(np.float32)
    hi, lo = split(x)
    rest = np.abs(x.astype(np.float64) - hi.astype(np.float64)
                  - lo.astype(np.float64))
    assert (rest <= np.abs(x.astype(np.float64)) * 2.0 ** -22).all()
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11).all()


def test_widened_bf16_splits_exactly():
    """A bf16 block widened to float32 (8 significant bits) is its own TF32
    hi: lo is 0 and the product is exact (the `_bf16` forms of B2)."""
    x = np.random.default_rng(3).normal(size=256).astype(np.float32)
    bf = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    for how in SPLITS.values():
        hi, lo = how(bf)
        np.testing.assert_array_equal(hi, bf)
        assert not lo.any()
