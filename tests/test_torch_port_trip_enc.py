"""Stage B1's angle encodings as `csrc/layer_stack.cu` computes them, on the
CPU. The reference (`_stage_triplet_pre`, phoregen_tpu/ops/layer_stack.py:
516) encodes a triplet angle a as the 13 values [a, sin(f a), cos(f a)]
over the bands f = [1, 2, 3, 1, 1/2, 1/3]; band 1 appears twice, so the 13
take 11 distinct values. The kernel computes those 11 from three sincos
(a, a/2, a/3), with sin 2a = 2 s c, cos 2a = 1 - 2 s^2, sin 3a =
s (3 - 4 s^2), cos 3a = c (4 c^2 - 3), and multiplies them by t_Wang with
the rows of each duplicate summed (`c_enc_rows`), as a [32, 16] tile (5
zero columns) on the tensor cores in 3xTF32 starting from a_kj + a_ji.

Held here:
- in float64, the 11-encoding form equals the 13-encoding form over
  angles in [0, pi], within 1e-3 of 0 and of pi included (1e-12);
- in float32, the kernel's arithmetic (float32 sincos and identities, the
  3xTF32 product emulated with the split of
  tests/test_torch_port_tf32_split.py, the float32 LayerNorm) against the
  13-encoding form in float64 through the LayerNorm: its max abs error
  (printed) against the 5e-4 pre_t tolerance of
  `ops/kernel_check.py::TOLERANCE` (measured ~1e-6);
- the whole of stage B1 in that arithmetic (a numpy rebuild from the packed
  weights) against the JAX package's `_stage_triplet_pre` on the small
  stack, on the triplets the attention reads, within 5e-4 (the JAX stage's
  polynomial atan2 is accurate to ~1e-5 rad).
The kernel itself runs on the card (tests/test_torch_port_cuda.py,
chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phoregen_tpu.ops import layer_stack as jls
from phoregen_tpu.ops.rbf import angular_encoding_freq_bands
from phoregen_tpu_torch.ops.rbf import gaussian_smearing_offsets

import torch_port_common as C
from test_torch_port_tf32_split import split_kernel

PRE_T_TOL = 5e-4
# the rows of t_Wang behind each of the 11 encodings (csrc c_enc_rows)
ENC_ROWS = ((0,), (1, 4), (2,), (3,), (5,), (6,), (7, 10), (8,), (9,),
            (11,), (12,))


def angles64():
    """[0, pi], and within 1e-3 of each end."""
    near = np.geomspace(1e-9, 1e-3, 200)
    return np.concatenate([np.linspace(0.0, np.pi, 4001), near,
                           np.pi - near, [0.0, np.pi]])


def enc13(a, dtype):
    """The reference's encodings: [a, sin(f a), cos(f a)] with its bands."""
    f = angular_encoding_freq_bands(3).astype(dtype)
    a = np.asarray(a, dtype)[..., None]
    return np.concatenate([a, np.sin(a * f), np.cos(a * f)], -1).astype(dtype)


def enc11(a, dtype):
    """The kernel's 11 encodings from sincos of a, a/2 and a/3 (the band
    1/3 as the float32 0.33333334 the reference multiplies by)."""
    a = np.asarray(a, dtype)
    s1, c1 = np.sin(a), np.cos(a)
    a2, a3 = a * dtype(0.5), a * dtype(np.float32(1.0 / 3.0))
    one, two, three, four = (dtype(v) for v in (1, 2, 3, 4))
    cols = [a, s1, two * s1 * c1, s1 * (three - four * s1 * s1),
            np.sin(a2), np.sin(a3), c1, one - two * s1 * s1,
            c1 * (four * c1 * c1 - three), np.cos(a2), np.cos(a3)]
    return np.stack([np.asarray(c, dtype) for c in cols], -1)


def merge_wang(w13):
    """t_Wang [13, Wt] -> [11, Wt], duplicate rows summed."""
    return np.stack([sum(w13[r] for r in rows) for rows in ENC_ROWS])


def product_3xtf32_from(init, a, w):
    """init + a @ w as the kernel's pre_t phase takes it: a [n, 16] and w
    [16, Wt] in k-steps of 8, lo.hi + hi.lo + hi.hi, each term's k-step sum
    added to the float32 accumulator with one rounding (the emulation of
    test_torch_port_tf32_split.py, started from a_kj + a_ji)."""
    ah, al = split_kernel(a)
    wh, wl = split_kernel(w)
    acc = np.asarray(init, np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, wh), (ah, wl), (ah, wh)):
            term = x[:, s].astype(np.float64) @ y[s].astype(np.float64)
            acc = (acc.astype(np.float64) + term).astype(np.float32)
    return acc


def ln_relu(x, scale, bias, dtype):
    x = np.asarray(x, dtype)
    mu = x.mean(-1, keepdims=True, dtype=dtype)
    var = (x * x).mean(-1, keepdims=True, dtype=dtype) - mu * mu
    y = (x - mu) / np.sqrt(var + dtype(1e-6)) * scale.astype(dtype) \
        + bias.astype(dtype)
    return np.maximum(y, 0).astype(dtype)


def kernel_pre_t(init, a32, w13, scale, bias):
    """pre_t rows as the kernel makes them from float32 angles a32 [n] and
    the float32 start a_kj + a_ji [n, Wt]."""
    e = np.zeros((a32.shape[0], 16), np.float32)
    e[:, :11] = enc11(a32, np.float32)
    w = np.zeros((16, w13.shape[1]), np.float32)
    w[:11] = merge_wang(w13.astype(np.float32))
    return ln_relu(product_3xtf32_from(init, e, w), scale, bias, np.float32)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(5)
    Wt = 32                                     # the flagship's width
    return dict(w13=(0.3 * rng.normal(size=(13, Wt)) / 2.0).astype(
                    np.float32),
                scale=(1.0 + 0.1 * rng.normal(size=Wt)).astype(np.float32),
                bias=(0.1 * rng.normal(size=Wt)).astype(np.float32),
                rng=rng)


def test_eleven_encodings_equal_thirteen_in_float64(weights):
    a = angles64()
    w13 = weights["w13"].astype(np.float64)
    ref = enc13(a, np.float64) @ w13
    got = enc11(a, np.float64) @ merge_wang(w13)
    err = float(np.abs(got - ref).max())
    print(f"11 vs 13 encodings @ t_Wang, float64: max abs error {err:.2e}")
    assert err < 1e-12


def test_kernel_arithmetic_within_pre_t_tolerance(weights):
    a = angles64()
    a32 = a.astype(np.float32)
    rng = weights["rng"]
    init = rng.normal(size=(a.shape[0], 32)).astype(np.float32)
    w13, scale, bias = weights["w13"], weights["scale"], weights["bias"]
    # the reference: 13 encodings of the same float32 angle, float64
    ref = ln_relu(init.astype(np.float64)
                  + enc13(a32.astype(np.float64), np.float64)
                  @ w13.astype(np.float64), scale, bias, np.float64)
    got = kernel_pre_t(init, a32, w13, scale, bias)
    plain = ln_relu(init + enc13(a32, np.float32) @ w13, scale, bias,
                    np.float32)
    err = float(np.abs(got - ref).max())
    err_plain = float(np.abs(plain - ref).max())
    ends = (a < 1e-3) | (a > np.pi - 1e-3)
    err_ends = float(np.abs(got - ref)[ends].max())
    print(f"pre_t in the kernel's float32 arithmetic vs the 13-encoding "
          f"form in float64: max abs error {err:.2e} ({err_ends:.2e} within "
          f"1e-3 of 0 and pi; the plain float32 form {err_plain:.2e}), "
          f"tolerance {PRE_T_TOL:g}")
    assert err < PRE_T_TOL / 100
    # the encodings themselves, near the ends included
    e_err = float(np.abs(enc11(a32, np.float32)
                         - enc13(a32.astype(np.float64), np.float64)[
                             :, [0, 1, 2, 3, 5, 6, 7, 8, 9, 11, 12]]).max())
    assert e_err < 2e-6


def b1_rebuild(w, h, x, hb, trip_idx, NP, num_ang=3):
    """Stage B1's pre_t for one graph in the kernel's arithmetic, from the
    packed weights (numpy, float32): a_kj and a_ji as the reference takes
    them, the angles in float32, then `kernel_pre_t`."""
    f = lambda k: np.asarray(w[k], np.float32)
    Wt = f("t_ln_s").shape[-1]
    pos_l, h_l = x[NP:], h[NP:]
    NL, K8 = trip_idx.shape
    rel = pos_l[:, None] - pos_l[None]                     # [x, i] = x - i
    off, coeff = gaussian_smearing_offsets(fix_offset=True)
    dist = np.sqrt((rel * rel).sum(-1) + np.float32(1e-12))
    r_feat = np.exp(np.float32(coeff) * (dist[..., None] - off) ** 2,
                    dtype=np.float32)
    npj = h_l @ f("t_Wn")
    a_kj = (hb @ f("t_Whb") + r_feat @ f("t_Wr") + f("t_b")
            + npj[:, None, :Wt] + npj[None, :, Wt:])        # [k, j]
    a_ji = r_feat @ f("t_Wji")                             # [j, i]
    jj = np.arange(NL)[:, None]
    a_kj_sel = a_kj[trip_idx, jj]                          # [j, K8]
    pos_k = pos_l[trip_idx]                                # [j, K8, 3]
    rel_ki = pos_k[:, None] - pos_l[None, :, None]         # [j, i, K8, 3]
    dot = (rel[:, :, None] * rel_ki).sum(-1)
    njsq = (rel * rel).sum(-1)[..., None]
    nksq = (rel_ki * rel_ki).sum(-1)
    cross = np.sqrt(np.maximum(njsq * nksq - dot * dot, np.float32(1e-12)))
    ang = np.arctan2(cross, dot).astype(np.float32)        # [j, i, K8]
    init = (a_kj_sel[:, None] + a_ji[:, :, None]).astype(np.float32)
    out = kernel_pre_t(init.reshape(-1, Wt), ang.reshape(-1), f("t_Wang"),
                       f("t_ln_s"), f("t_ln_b"))
    return out.reshape(NL, NL, K8, Wt)


def test_stage_b1_in_kernel_arithmetic_matches_jax():
    tree = C.layer_tree(0)
    inp = C.stack_inputs(1)
    jt, nbr_idx, nbr_mask, etype = C.jax_tables(inp)
    pt = C.port_tables(inp, nbr_idx, nbr_mask, etype)
    jw = jax.tree_util.tree_map(
        lambda a: a[1], jls.pack_layer_params(
            jax.tree_util.tree_map(jnp.asarray, tree), C.H, C.FE))
    jd = jls.StackDims(NP=C.NP, NL=C.NL, K=C.K, K8=min(C.TRIP_K, C.NL - 1),
                       H=C.H, heads=C.HEADS, Wt=C.WT)
    worst = 0.0
    for b in range(C.B):
        sl, _ = jls._stage_triplet_pre(
            jw, inp["h"][b], inp["x"][b], inp["hb"][b],
            {k: v[b] for k, v in jt.items()}, jd)
        ref = np.stack([np.asarray(a) for a in sl], 2)     # [j, i, K8, Wt]
        got = b1_rebuild(jw, inp["h"][b], inp["x"][b], inp["hb"][b],
                         pt["trip_idx"][b].numpy(), C.NP)
        # slots of masked triplet sources are inert downstream (see
        # test_torch_port_layer_stack.py): compare the valid sources
        valid = pt["trip_mask"][b].numpy().astype(bool)    # [j, K8]
        sel = np.broadcast_to(valid[:, None, :, None], got.shape)
        np.testing.assert_allclose(got[sel], ref[sel], atol=PRE_T_TOL,
                                   rtol=PRE_T_TOL)
        worst = max(worst, float(np.abs(got[sel] - ref[sel]).max()))
    print(f"stage B1 in the kernel's arithmetic vs JAX _stage_triplet_pre: "
          f"max abs error {worst:.2e} (tolerance {PRE_T_TOL:g})")
