"""The benchmark's frozen operation and byte counts against the program's
own (`ops/kernel_check.py`) on a small case on the CPU: the slots from the
atom counts alone; with every slot real, every stage's bytes, products
and other operations as the program counts them; on the slots the masks
leave, no more than the program's."""
import pytest

from portbench import workcount

STAGES = ("stage_node", "stage_triplet_pre", "stage_triplet_att",
          "stage_pos", "stage_node_pre", "stage_att_pos",
          "stage_triplet_pre_bf16", "stage_triplet_att_bf16",
          "stage_node_pre_bf16", "stage_att_pos_bf16")
CASES = [(12, 10, 8, 4), (6, 9, 32, 32)]


def _case(NP, NL, K, trip_k):
    from phoregen_tpu_torch.ops import kernel_check as kc
    c = kc.flagship_case(B=3, NP=NP, NL=NL, K=K, trip_k=trip_k, seed=3,
                         device="cpu")
    t, d0 = c["t"], c["d"]
    n_lig = t["mask_l"].sum(1).long().tolist()
    n_phore = (t["nbr_mask"][:, :NP].sum(-1) > 0).sum(1).long().tolist()
    d = workcount.Dims(NP=NP, NL=NL, K=d0.K, K8=d0.K8, H=d0.H,
                       heads=d0.heads, Wt=d0.Wt)
    wbytes = sum(v.numel() for v in c["w"].values()) * 4
    return kc, c, d, workcount.slots(n_lig, n_phore, d), wbytes


@pytest.mark.parametrize("NP,NL,K,trip_k", CASES)
def test_slots_equal_the_programs(NP, NL, K, trip_k):
    kc, c, d, got, _ = _case(NP, NL, K, trip_k)
    want = kc.slot_counts(c["t"])
    assert {k: got[k] for k in want} == want
    assert got["rows"] == got["lig_rows"] + got["phore_rows"]


@pytest.mark.parametrize("name", STAGES)
@pytest.mark.parametrize("NP,NL,K,trip_k", CASES)
def test_counts_with_every_slot_real_are_the_programs(NP, NL, K, trip_k,
                                                      name):
    """The program counts bytes at the tensors' full sizes: with every
    slot real the counts agree, but for B1's reads of the phore rows of h
    and x, which B1 does not need."""
    kc, c, d, _, wbytes = _case(NP, NL, K, trip_k)
    full = workcount.full_slots(d, 3)
    by, pr, rest = kc._work_split(name, c, full)
    if name.startswith("stage_triplet_pre"):
        by -= 3 * NP * (d.H + 3) * 4
    assert workcount.stage_work(name, d, full, wbytes) == (by, pr, rest)


@pytest.mark.parametrize("name", STAGES)
@pytest.mark.parametrize("NP,NL,K,trip_k", CASES)
def test_counts_on_the_real_slots_are_below_the_programs(NP, NL, K, trip_k,
                                                         name):
    """Padding costs nothing: fewer bytes than the program's count at full
    sizes, and no more operations than its count on the same slots."""
    kc, c, d, got, wbytes = _case(NP, NL, K, trip_k)
    by, pr, rest = workcount.stage_work(name, d, got, wbytes)
    kby, kpr, krest = kc._work_split(name, c, kc.slot_counts(c["t"]))
    assert 0 < by < kby and 0 < pr <= kpr and 0 < rest <= krest


def test_network_ops_are_path_independent_and_positive():
    d = workcount.Dims(NP=96, NL=80, K=32, K8=32)
    n = workcount.slots([30] * 4, [90] * 4, d)
    ops = workcount.network_ops(d, n, 6, 12, 6, 10, [90] * 4, 1000)
    four = 6 * sum(sum(workcount.stage_work(s, d, n, 0)[1:])
                   for s in workcount.FOUR)
    assert ops > four > 0
    peaks = {"hbm_bytes_per_s": 3.35e12, "tf32_flops_per_s": 495e12}
    r4 = workcount.stack_roofline_s("pallas", "float32", d, n, 6, peaks)
    r2 = workcount.stack_roofline_s("pallas2", "float32", d, n, 6, peaks)
    assert 0 < r2 <= r4
    assert workcount.stack_roofline_s("none", "float32", d, n, 6,
                                      peaks) is None


def test_layer_weight_bytes_count_the_layers_parameters():
    from phoregen_tpu_torch.models.denoiser import layer_param_shapes
    import numpy as np

    def count(t):
        return sum(count(v) if isinstance(v, dict) else int(np.prod(v))
                   for v in t.values())
    d = workcount.Dims(NP=96, NL=80, K=32, K8=32)
    assert workcount.layer_weight_bytes(d) == \
        4 * count(layer_param_shapes(128, 16, 32, 93))
