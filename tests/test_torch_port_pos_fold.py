"""The query fold of stages A and C, on the CPU: the scores of each stage's
two attentions (the kNN edges and the bond grid) taken as LN(pre_k) @ W_kq
+ b_kq, with

    W_kq[:, h] = k2W[:, h-slice] @ q[h-slice] / sqrt(dh)
    b_kq[h]    = k2b[h-slice] . q[h-slice] / sqrt(dh)

formed once a destination, as `csrc/layer_stack.cu` forms them
(`node_pos_query_kernel`, then `load_fold`), equal the unfolded ((LN(pre_k)
@ k2W + k2b) * q) summed over each head's dh features / sqrt(dh), and
equal the scores of the JAX package's stages: `_stage_node`
(phoregen_tpu/ops/layer_stack.py:449: `qk @ hm`, `qkb @ hm`; branches
`node_edge`, `node_bond`) and `_stage_pos` (layer_stack.py:629: `xqk @
hm`, `pqk @ hm`; branches `edge`, `bond`). The JAX scores are rebuilt from
the stage's own intermediates, step by step with the JAX package's
helpers, and the rebuild is held to the stage's output, so they are the
scores it computes. Everything here is float32 (numpy for the fold); the
kernel's products of the fold run on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerance: 1e-6 absolute and relative. The fold reassociates a sum of H
products and the query's scale; on these seeded inputs the three forms
sit within a few float32 roundings of each other (at most 9e-8, printed),
far inside the stage's 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phoregen_tpu.ops import layer_stack as jls
from phoregen_tpu_torch.models.denoiser import layer_param_shapes

import torch_port_common as C

TOL = 1e-6
# (H, heads, Wt): the small stack of torch_port_common and the flagship
# widths
WIDTHS = {"small": (C.H, C.HEADS, C.WT), "flagship": (128, 16, 32)}


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def case(request):
    H, heads, Wt = WIDTHS[request.param]
    tree = C.random_tree(layer_param_shapes(H, heads, Wt, C.FE, 1),
                         np.random.default_rng(7))
    w = jax.tree_util.tree_map(
        lambda a: a[0], jls.pack_layer_params(
            jax.tree_util.tree_map(jnp.asarray, tree), H, C.FE))
    inp = C.stack_inputs(8)
    rng = np.random.default_rng(9)
    new_h = rng.normal(size=(C.B, C.NP + C.NL, H)).astype(np.float32)
    hb_new = rng.normal(size=(C.B, C.NL, C.NL, H)).astype(np.float32)
    jt = C.jax_tables(inp)[0]
    d = jls.StackDims(NP=C.NP, NL=C.NL, K=C.K, K8=min(C.TRIP_K, C.NL - 1),
                      H=H, heads=heads, Wt=Wt)
    return dict(w=w, t=jt, d=d, x=inp["x"], new_h=new_h, hb_new=hb_new,
                name=request.param)


def jax_pos_scores(w, new_h, x, hb_new, t, d):
    """`_stage_pos` (layer_stack.py:629) step by step for one graph: its
    intermediates (LN'd key inputs, queries, scores of both branches) and
    its output, from the same JAX helpers in the same order."""
    N, NL, NP, K, H, heads = d.N, d.NL, d.NP, d.K, d.H, d.heads
    dh = H // heads
    hm = w["head_mask"]
    e_pre2, rel = jls._knn_edge_prefeat(w, x, t, d, 2 * H, 4 * H)
    nproj_x = new_h @ w["e_Wn_nh"]
    j_x = t["nbr_onehot"] @ nproj_x[:, 2 * H:]
    pre_x = ((e_pre2 + j_x).reshape(N, K, 2 * H)
             + jnp.expand_dims(nproj_x[:, :2 * H], 1)).reshape(N * K, 2 * H)
    xk_ln = jax.nn.relu(jls._ln(pre_x[:, :H], w["e_ln_s"][2],
                                w["e_ln_b"][2]))
    xv = jax.nn.relu(jls._ln(pre_x[:, H:], w["e_ln_s"][3], w["e_ln_b"][3]))
    xk = xk_ln @ w["e_xk2"] + w["e_xk2b"]
    xv = (xv @ w["e_xv2"] + w["e_xv2b"]) * t["e_w"]
    xq = jls._qmlp(new_h, w["q_W0"][2], w["q_b0"][2], w["q_ln_s"][2],
                   w["q_ln_b"][2], w["q_W1"][2], w["q_b1"][2])
    xqk = (xk.reshape(N, K, H) * xq[:, None, :]).reshape(N * K, H)
    sc_x = (xqk @ hm / float(np.sqrt(dh))).reshape(N, K, heads)
    al_x = jls._softmax0_unrolled(sc_x.transpose(1, 0, 2),
                                  t["nbr_mask"].transpose(1, 0, 2))
    w_e = jnp.sum(al_x * xv.reshape(N, K, heads).transpose(1, 0, 2), -1,
                  keepdims=True) / heads
    dx_edge = jls._reduce0(w_e * rel.reshape(N, K, 3).transpose(1, 0, 2),
                           jnp.add)

    pos_l, nh_l = x[NP:], new_h[NP:]
    pp = hb_new.reshape(NL * NL, H) @ w["p_W"] + w["p_b"]
    nproj_p = nh_l @ w["p_Wn"]
    pre_p = (pp.reshape(NL, NL, 2 * H)
             + jnp.expand_dims(nproj_p[:, :2 * H], 0)
             + jnp.expand_dims(nproj_p[:, 2 * H:], 1)).reshape(NL * NL,
                                                             2 * H)
    pk_ln = jax.nn.relu(jls._ln(pre_p[:, :H], w["p_ln_s"][0],
                                w["p_ln_b"][0]))
    pv = jax.nn.relu(jls._ln(pre_p[:, H:], w["p_ln_s"][1], w["p_ln_b"][1]))
    pk = pk_ln @ w["p_xk2"] + w["p_xk2b"]
    pv = pv @ w["p_xv2"] + w["p_xv2b"]
    pq = jls._qmlp(nh_l, w["q_W0"][3], w["q_b0"][3], w["q_ln_s"][3],
                   w["q_ln_b"][3], w["q_W1"][3], w["q_b1"][3])
    pqk = (pk.reshape(NL, NL, H) * pq[None, :, :]).reshape(NL * NL, H)
    sc_p = (pqk @ hm / float(np.sqrt(dh))).reshape(NL, NL, heads)
    al_p = jls._softmax0_unrolled(sc_p, t["pair_mask"])
    rel_bond = pos_l[None, :, :] - pos_l[:, None, :]
    w_p = jnp.sum(al_p * pv.reshape(NL, NL, heads), -1, keepdims=True) \
        / heads
    dx_bond_l = jls._reduce0(w_p * rel_bond, jnp.add)
    dx = dx_edge + jnp.concatenate([jnp.zeros((NP, 3), x.dtype), dx_bond_l],
                                   0)
    lig_mask = jnp.concatenate([jnp.zeros((NP, 1), x.dtype), t["mask_l"]], 0)
    out = x + dx * lig_mask
    f = lambda a: np.asarray(a, np.float32)
    return dict(edge=(f(xk_ln).reshape(N, K, H), f(xq), f(sc_x)),
                bond=(f(pk_ln).reshape(NL, NL, H).transpose(1, 0, 2),
                      f(pq), f(sc_p).transpose(1, 0, 2)),
                out=f(out))


def jax_node_scores(w, h, x, hb, t, d):
    """`_stage_node` (layer_stack.py:449) step by step for one graph: its
    intermediates (LN'd key inputs, queries, scores of both branches) and
    its output, from the same JAX helpers in the same order."""
    N, NL, NP, K, H, heads = d.N, d.NL, d.NP, d.K, d.H, d.heads
    dh = H // heads
    hm = w["head_mask"]
    e_pre2, _ = jls._knn_edge_prefeat(w, x, t, d, 0, 2 * H)
    nproj_h = h @ w["e_Wn_h"]
    j_h = t["nbr_onehot"] @ nproj_h[:, 2 * H:]
    pre_kv = ((e_pre2 + j_h).reshape(N, K, 2 * H)
              + jnp.expand_dims(nproj_h[:, :2 * H], 1)).reshape(N * K,
                                                               2 * H)
    k_ln = jax.nn.relu(jls._ln(pre_kv[:, :H], w["e_ln_s"][0],
                               w["e_ln_b"][0]))
    v_n = jax.nn.relu(jls._ln(pre_kv[:, H:], w["e_ln_s"][1], w["e_ln_b"][1]))
    k_n = k_ln @ w["e_k2"][0] + w["e_b2"][0]
    v_n = (v_n @ w["e_k2"][1] + w["e_b2"][1]) * t["e_w"]
    q_n = jls._qmlp(h, w["q_W0"][0], w["q_b0"][0], w["q_ln_s"][0],
                    w["q_ln_b"][0], w["q_W1"][0], w["q_b1"][0])
    qk = (k_n.reshape(N, K, H) * q_n[:, None, :]).reshape(N * K, H)
    sc_e = (qk @ hm / float(np.sqrt(dh))).reshape(N, K, heads)
    alpha = jls._softmax0_unrolled(sc_e.transpose(1, 0, 2),
                                   t["nbr_mask"].transpose(1, 0, 2))
    alpha_h = alpha.transpose(1, 0, 2).reshape(N * K, heads) @ hm.T
    out_e = jls._reduce0((alpha_h * v_n).reshape(N, K, H).transpose(1, 0, 2),
                         jnp.add)

    h_l = h[NP:]
    b_pre = hb.reshape(NL * NL, H) @ w["b_W"] + w["b_b"]
    nproj_b = h_l @ w["b_Wn"]
    pre_b = (b_pre.reshape(NL, NL, 2 * H)
             + jnp.expand_dims(nproj_b[:, :2 * H], 0)
             + jnp.expand_dims(nproj_b[:, 2 * H:], 1)).reshape(NL * NL,
                                                             2 * H)
    kb_ln = jax.nn.relu(jls._ln(pre_b[:, :H], w["b_ln_s"][0],
                                w["b_ln_b"][0]))
    v_b = jax.nn.relu(jls._ln(pre_b[:, H:], w["b_ln_s"][1], w["b_ln_b"][1]))
    k_b = kb_ln @ w["b_k2"][0] + w["b_b2"][0]
    v_b = v_b @ w["b_k2"][1] + w["b_b2"][1]
    q_b = jls._qmlp(h_l, w["q_W0"][1], w["q_b0"][1], w["q_ln_s"][1],
                    w["q_ln_b"][1], w["q_W1"][1], w["q_b1"][1])
    qkb = (k_b.reshape(NL, NL, H) * q_b[None, :, :]).reshape(NL * NL, H)
    sc_b = (qkb @ hm / float(np.sqrt(dh))).reshape(NL, NL, heads)
    al_b = jls._softmax0_unrolled(sc_b, t["pair_mask"])
    al_b_h = al_b.reshape(NL * NL, heads) @ hm.T
    out_b_l = jls._reduce0((al_b_h * v_b).reshape(NL, NL, H), jnp.add)
    out_b = jnp.concatenate([jnp.zeros((NP, H), h.dtype), out_b_l], 0)
    out = h + (out_e + out_b) @ w["lin_W"] + w["lin_b"]
    f = lambda a: np.asarray(a, np.float32)
    return dict(node_edge=(f(k_ln).reshape(N, K, H), f(q_n), f(sc_e)),
                node_bond=(f(kb_ln).reshape(NL, NL, H).transpose(1, 0, 2),
                           f(q_b), f(sc_b).transpose(1, 0, 2)),
                out=f(out))


# branch -> the key layer (k2W, k2b) its query folds into, the rebuild of
# the JAX stage's scores and the stage itself
BRANCHES = {
    "edge": (lambda w: (w["e_xk2"], w["e_xk2b"]), jax_pos_scores,
             jls._stage_pos),
    "bond": (lambda w: (w["p_xk2"], w["p_xk2b"]), jax_pos_scores,
             jls._stage_pos),
    "node_edge": (lambda w: (w["e_k2"][0], w["e_b2"][0]), jax_node_scores,
                  jls._stage_node),
    "node_bond": (lambda w: (w["b_k2"][0], w["b_b2"][0]), jax_node_scores,
                  jls._stage_node),
}


def fold_query(k2W, k2b, q, heads):
    """W_kq [M, H, heads] and b_kq [M, heads] of M queries q [M, H] (the
    1/sqrt(dh) of the scores taken in), float32."""
    M, H = q.shape
    dh = H // heads
    qs = (q * np.float32(1.0 / np.sqrt(dh))).reshape(M, heads, dh)
    W = np.einsum("che,mhe->mch", k2W.reshape(H, heads, dh), qs,
                  dtype=np.float32)
    b = np.einsum("he,mhe->mh", k2b.reshape(heads, dh), qs,
                  dtype=np.float32)
    return W.astype(np.float32), b.astype(np.float32)


def folded_scores(k_ln, q, k2W, k2b, heads):
    """k_ln [M, R, H] (the R key rows of each of M destinations) ->
    [M, R, heads] as LN(pre_k) @ W_kq + b_kq."""
    W, b = fold_query(k2W, k2b, q, heads)
    return (np.einsum("mrc,mch->mrh", k_ln, W, dtype=np.float32)
            + b[:, None, :]).astype(np.float32)


def unfolded_scores(k_ln, q, k2W, k2b, heads):
    """(LN(pre_k) @ k2W + k2b) * q summed a head / sqrt(dh), float32."""
    M, R, H = k_ln.shape
    dh = H // heads
    k = (k_ln @ k2W + k2b).astype(np.float32)
    return ((k * q[:, None, :]).reshape(M, R, heads, dh).sum(-1)
            / np.float32(np.sqrt(dh))).astype(np.float32)


@pytest.mark.parametrize("branch", ["edge", "bond", "node_edge",
                                    "node_bond"])
def test_folded_scores_match_unfolded_and_jax(case, branch):
    """Stage C's branches (`edge`, `bond`) and stage A's (`node_edge`,
    `node_bond`); the node stage takes the case's new_h and hb_new as its
    h and hb."""
    w, t, d = case["w"], case["t"], case["d"]
    key, scores, stage = BRANCHES[branch]
    k2W, k2b = (np.asarray(a, np.float32) for a in key(w))
    worst = {}
    for b in range(C.B):
        tb = {k: v[b] for k, v in t.items()}
        args = (w, jnp.asarray(case["new_h"][b]), jnp.asarray(case["x"][b]),
                jnp.asarray(case["hb_new"][b]), tb, d)
        js = scores(*args)
        # the rebuild is the stage itself
        ref = np.asarray(stage(*args))
        np.testing.assert_allclose(js["out"], ref, atol=1e-6, rtol=1e-6)
        k_ln, q, sc_jax = js[branch]
        if branch.endswith("bond"):   # destinations: the ligand rows
            q = q[: d.NL]
        fold = folded_scores(k_ln, q, k2W, k2b, d.heads)
        plain = unfolded_scores(k_ln, q, k2W, k2b, d.heads)
        assert fold.shape == sc_jax.shape
        np.testing.assert_allclose(fold, plain, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(fold, sc_jax, atol=TOL, rtol=TOL)
        for name, a in (("unfolded", plain), ("jax", sc_jax)):
            worst[name] = max(worst.get(name, 0.0),
                              float(np.abs(fold - a).max()))
    print(f"{case['name']} {branch}: folded vs unfolded "
          f"{worst['unfolded']:.2e}, vs JAX {stage.__name__} "
          f"{worst['jax']:.2e} (tolerance {TOL:g})")


def test_fold_is_exact_algebra(case):
    """In float64 the fold and the unfolded scores agree to rounding: the
    fold changes no result, only where the sums are taken. On the key
    layers of stage C's kNN edges and of both of stage A's attentions."""
    w, d = case["w"], case["d"]
    rng = np.random.default_rng(11)
    k_ln = np.maximum(rng.normal(size=(3, 5, d.H)), 0.0)
    q = rng.normal(size=(3, d.H))
    dh = d.H // d.heads
    qs = (q / np.sqrt(dh)).reshape(3, d.heads, dh)
    for branch in ("edge", "node_edge", "node_bond"):
        k2W, k2b = (np.asarray(a, np.float64) for a in BRANCHES[branch][0](w))
        W = np.einsum("che,mhe->mch", k2W.reshape(d.H, d.heads, dh), qs)
        b = np.einsum("he,mhe->mh", k2b.reshape(d.heads, dh), qs)
        fold = np.einsum("mrc,mch->mrh", k_ln, W) + b[:, None]
        plain = ((k_ln @ k2W + k2b) * q[:, None]).reshape(
            3, 5, d.heads, dh).sum(-1) / np.sqrt(dh)
        np.testing.assert_allclose(fold, plain, atol=1e-12, rtol=1e-12,
                                   err_msg=branch)
