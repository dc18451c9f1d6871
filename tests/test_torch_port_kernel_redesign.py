"""What the card holds the redesigned layer-stack kernels to, as far as the
CPU can check it: the work the bound is reckoned from (`kernel_check._work`:
pinned at the two flagship buckets with every slot counted, and counted from
the masks on a small ragged case), and the dims the kernels take
(`layer_stack._check_dims`, the Python side of `dims_ok` in
csrc/layer_stack.cu). The kernels themselves run only on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import dataclasses

import pytest
import torch

from phoregen_tpu_torch.ops import kernel_check as kc
from phoregen_tpu_torch.ops import layer_stack as ls

SMALL = ls.StackDims(NP=6, NL=8, K=4, K8=3, H=16, heads=2, Wt=8)
FLAGSHIP = ls.StackDims(NP=96, NL=80, K=32, K8=32, H=128, heads=16, Wt=32)
RAGGED = ls.StackDims(NP=10, NL=37, K=7, K8=5, H=32, heads=4, Wt=16)


@pytest.fixture(scope="module")
def flagship_weights():
    # one layer's packed weights at the flagship widths; they do not depend
    # on the batch or the bucket
    return kc.flagship_case(B=1, NP=4, NL=6, K=4, trip_k=3, device="cpu")["w"]


# (bytes, float32 operations) of one call at B=16, NP=96 if no slot were
# masked (`kc.all_slots`), and how PERF.md's kernel table prints them
WORK = {
    ("stage_node_pre", 80): (541081120, 31477202944, "541.1 MB", "31.48 G"),
    ("stage_att_pos", 80): (592270880, 48622469120, "592.3 MB", "48.62 G"),
    ("stage_node_pre", 48): (204336672, 16637755392, "204.3 MB", "16.64 G"),
    ("stage_att_pos", 48): (222160416, 18792579072, "222.2 MB", "18.79 G"),
    ("stage_node", 80): (63654672, 24865931264, "63.7 MB", "24.87 G"),
    ("stage_triplet_pre", 80): (531330832, 6611271680, "531.3 MB", "6.61 G"),
    ("stage_triplet_att", 80): (582453008, 33554432000, "582.5 MB",
                                "33.55 G"),
    ("stage_pos", 80): (62246672, 15068037120, "62.2 MB", "15.07 G"),
}


@pytest.mark.parametrize("name,nl", sorted(WORK))
def test_work_of_the_bound_is_pinned(flagship_weights, name, nl):
    d = dataclasses.replace(FLAGSHIP, NL=nl)
    by, fl = kc._work(name, dict(d=d, B=16, w=flagship_weights),
                      kc.all_slots(d, 16))
    want_by, want_fl, mb, g = WORK[(name, nl)]
    assert (by, fl) == (want_by, want_fl)
    assert (f"{by / 1e6:.1f} MB", f"{fl / 1e9:.2f} G") == (mb, g)


def test_merged_work_is_the_parts_less_the_shared_traffic(flagship_weights):
    """A + B1 reads h, x, hb once; B2 + C never reads hb_new back."""
    c = dict(d=FLAGSHIP, B=16, w=flagship_weights)
    d, B, f4 = FLAGSHIP, 16, 4
    w = {n: kc._work(n, c, kc.all_slots(d, B)) for n, _ in kc.KERNELS}
    shared = (B * d.N * (d.H + 3) + B * d.NL * d.NL * d.H) * f4
    assert w["stage_node_pre"] == (
        w["stage_node"][0] + w["stage_triplet_pre"][0] - shared,
        w["stage_node"][1] + w["stage_triplet_pre"][1])
    assert w["stage_att_pos"] == (
        w["stage_triplet_att"][0] + w["stage_pos"][0]
        - B * d.NL * d.NL * d.H * f4,
        w["stage_triplet_att"][1] + w["stage_pos"][1])


# the product operations among them (`kc._work_split`): what `mm` runs on
# the tensor cores at the flagship widths
PRODUCTS = {
    ("stage_node", 80): 24540872704, ("stage_triplet_pre", 80): 3884974080,
    ("stage_triplet_att", 80): 26843545600, ("stage_pos", 80): 14868807680,
}


@pytest.mark.parametrize("name", [k for k, _ in kc.KERNELS + kc.BF16_KERNELS])
@pytest.mark.parametrize("nl", [80, 48])
def test_products_and_the_rest_make_the_work(flagship_weights, name, nl):
    """The tensor-core bound's split adds up to the FMA bound's operations,
    row by row, and its products are the matrix products alone."""
    d = dataclasses.replace(FLAGSHIP, NL=nl)
    c = dict(d=d, B=16, w=flagship_weights)
    every = kc.all_slots(d, 16)
    by, products, rest = kc._work_split(name, c, every)
    assert (by, products + rest) == kc._work(name, c, every)
    assert 0 < rest < products
    if (name, nl) in PRODUCTS:
        assert products == PRODUCTS[(name, nl)]


@pytest.fixture(scope="module")
def ragged_case():
    return kc.flagship_case(B=3, NP=10, NL=13, H=16, heads=2, Wt=8, K=7,
                            trip_k=5, seed=4, device="cpu", empty_first=True)


def test_slot_counts_follow_the_masks(ragged_case):
    """Counted slot by slot from the tables, without the helpers that
    `slot_counts` uses."""
    t, d = ragged_case["t"], ragged_case["d"]
    ml, nm, tm = t["mask_l"], t["nbr_mask"], t["trip_mask"]
    tidx = t["trip_idx"]
    want = dict(edges=0, edges_lig=0, lig_rows=0, pairs=0, trip_src=0,
                trips=0)
    for b in range(ml.shape[0]):
        atoms = [i for i in range(d.NL) if ml[b, i] != 0]
        want["lig_rows"] += len(atoms)
        want["pairs"] += len(atoms) * (len(atoms) - 1)
        want["edges"] += int(nm[b].sum())
        for j in atoms:
            want["edges_lig"] += int(nm[b, d.NP + j].sum())
            srcs = [int(tidx[b, j, k]) for k in range(d.K8)
                    if tm[b, j, k] != 0]
            want["trip_src"] += len(srcs)
            want["trips"] += sum(1 for i in atoms if i != j
                                 for k in srcs if k != i)
    assert kc.slot_counts(t) == want
    assert want["lig_rows"] and ml[0].sum() == 0   # graph 0 holds no atom


@pytest.mark.parametrize("name", [k for k, _ in kc.KERNELS])
def test_work_counts_the_slots_the_masks_leave(ragged_case, name):
    """Fewer operations than with every slot counted, the same bytes; and
    with every slot handed in as left, the all-slot count itself."""
    c = ragged_case
    every = kc.all_slots(c["d"], c["B"])
    left = kc.slot_counts(c["t"])
    assert all(0 < left[k] < every[k] for k in every)
    by, fl = kc._work(name, c)
    by_all, fl_all = kc._work(name, c, every)
    assert by == by_all and 0 < fl < fl_all
    assert kc._work(name, c, left) == (by, fl)


def test_full_graphs_leave_all_but_the_diagonal():
    """With every ligand slot an atom the masks void only j == i and
    k == i, so the count is close under the all-slot one."""
    d = ls.StackDims(NP=4, NL=6, K=9, K8=5, H=16, heads=2, Wt=8)
    B, NL, K8 = 2, d.NL, d.K8
    ar = torch.arange(NL)
    # the K8 nearest of j by index distance, j itself left out
    order = (ar[:, None] - ar[None, :]).abs().float()
    order[ar, ar] = 1e9
    tidx = order.argsort(1)[:, :K8].to(torch.int32)
    t = {"mask_l": torch.ones(B, NL), "nbr_mask": torch.ones(B, d.N, d.K),
         "trip_idx": tidx[None].expand(B, -1, -1).contiguous(),
         "trip_mask": torch.ones(B, NL, K8)}
    n, every = kc.slot_counts(t), kc.all_slots(d, B)
    assert {k: n[k] for k in ("edges", "edges_lig", "lig_rows", "trip_src")} \
        == {k: every[k] for k in ("edges", "edges_lig", "lig_rows",
                                  "trip_src")}
    assert n["pairs"] == B * NL * (NL - 1)
    # each pair (j, i != j) loses the one source k == i if i is among j's
    assert n["trips"] == B * (NL * (NL - 1) * K8 - NL * K8)


def _tensors(d, B=2):
    t = {"nbr_idx": torch.zeros(B, d.N, d.K, dtype=torch.int32),
         "trip_idx": torch.zeros(B, d.NL, d.K8, dtype=torch.int32)}
    named = dict(h=torch.zeros(B, d.N, d.H), x=torch.zeros(B, d.N, 3),
                 hb=torch.zeros(B, d.NL, d.NL, d.H),
                 pre_t=torch.zeros(B, d.NL, d.NL, d.K8, d.Wt),
                 q_z=torch.zeros(B, d.NL, d.NL, d.H))
    return t, named


@pytest.mark.parametrize("d", [SMALL, FLAGSHIP, RAGGED],
                         ids=["small", "flagship", "ragged"])
def test_check_shapes_accepts(d):
    t, named = _tensors(d)
    ls._check_shapes(d, 2, t, **named)


BAD_DIMS = {
    "H": [dict(H=18, heads=2), dict(H=516, heads=4), dict(H=20, heads=3)],
    "Wt": [dict(Wt=6), dict(Wt=36), dict(Wt=0)],
    "heads": [dict(H=132, heads=33)],
    "K8": [dict(K8=33), dict(K8=0)],
    "K": [dict(K=17), dict(K=0)],
    "NL": [dict(NL=513)],
}


@pytest.mark.parametrize("name", sorted(BAD_DIMS))
def test_check_shapes_names_the_dimension_it_refuses(name):
    for change in BAD_DIMS[name]:
        d = dataclasses.replace(SMALL, **change)
        t, named = _tensors(d, B=1)
        with pytest.raises(ValueError, match=rf"^{name}="):
            ls._check_shapes(d, 1, t, **named)


def test_check_shapes_still_refuses_a_wrong_tensor():
    t, named = _tensors(SMALL)
    named["hb"] = named["hb"][:, 1:]
    with pytest.raises(ValueError, match="hb"):
        ls._check_shapes(SMALL, 2, t, **named)
