"""The port's own spans and its padded-slot counter, on the CPU with a
small seeded network: a reverse step records `sample.step` with its
four phases inside it, a train step through a fused stack (its plain
stages here) records the five train phases and `stack.backward` inside
the backward, the loader records `data.batch` and `data.to_device`, and
`SLOTS` counts the ligand slots that padding made and those with atoms,
and the triplet grid's slots and its triplets of three atoms; the bond
update records `bond.triplet` once a layer on the module path, in both
triplet modes.
The spans are read back through the benchmark's own event reader
(`portbench/trace.py`), as its traced runs read them."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phoregen_tpu_torch.config import default_config
from phoregen_tpu_torch.data import batching
from phoregen_tpu_torch.data.dataset import get_dataset
from phoregen_tpu_torch.data.loader import PhoreDataLoader
from phoregen_tpu_torch.data.phore import parse_phore_text
from phoregen_tpu_torch.models.phoregen import PhoreGen
from phoregen_tpu_torch.sample import sampler as psampler
from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
from phoregen_tpu_torch.train import state as pstate
from phoregen_tpu_torch.train.step import make_train_step

from portbench import spans, trace

PHORE_TEXT = """trace_phore
AR\t1.0\t1\t1\t1.0\t2.0\t3.0\t1\t0.0\t0.0\t1.0\t0\t1
HD\t0.7\t1\t1\t-1.0\t0.5\t2.0\t0\t0.0\t0.0\t0.0\t0\t1
HY\t1.0\t1\t1\t0.5\t-1.0\t1.0\t0\t0.0\t0.0\t0.0\t0\t1
EX\t0.837\t0.5\t1\t4.0\t4.0\t4.0\t0\t0.0\t0.0\t0.0\t0\t1
$$$$
"""
GUIDANCE = [dict(type="atom_prox", min_d=1.0, max_d=3.0),
            dict(type="center_prox")]
SAMPLE_PHASES = ("sample.network", "sample.posterior", "sample.guidance",
                 "sample.position")
TRAIN_PHASES = ("train.forward", "train.backward", "train.clip",
                "train.adam", "train.ema")


def _config(fused: str, layers: int = 2, triplet_mode: str = "factorized"):
    """The small stack of the port's other tests, two layers unless told
    otherwise."""
    cfg = default_config("zinc_300")
    m = cfg.model
    m.hidden_dim = m.denoiser.hidden_dim = 16
    m.denoiser.num_layers = layers
    m.denoiser.triplet_mode = triplet_mode
    m.denoiser.n_heads = 2
    m.denoiser.knn = 4
    m.denoiser.triplet_knn = 3
    m.denoiser.triplet_width = 8
    m.denoiser.fused_stack = fused
    m.diff.num_timesteps = 8
    m.diff.time_dim = 2
    cfg.dataset.ligand_buckets = [16]
    cfg.dataset.max_phore = 16
    cfg.dataset.corpus = "chains"
    cfg.train.batch_size = 3
    cfg.train.dtype = "float32"
    cfg.train.ema = True
    return cfg.finalize()


def _model(fused: str, **kw):
    torch.manual_seed(0)
    cfg = _config(fused, **kw)
    return PhoreGen(cfg), cfg


def _traced(fn):
    """(host events) of `fn()` under the profiler, CPU activity only."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return trace.events(prof)[1]


def _one(host, name):
    got = spans.named(host, name)
    assert len(got) == 1, (name, got)
    return got[0]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _reverse_step(pg):
    pipe = GenerationPipeline(pg, device="cpu")
    sample = pipe.prepare_phore(parse_phore_text(PHORE_TEXT, "trace_phore"))
    batch = batching.replicate_phore(sample, 3, np.asarray([5, 9, 12]),
                                     16).to("cpu")
    sp = psampler.Sampler(pg, [psampler.GuidanceOpt(**g) for g in GUIDANCE])
    inv = sp.prepare(batch)
    state = sp.init_state(batch, torch.Generator().manual_seed(1))
    return lambda: sp.step(state, 3, batch, inv, False,
                           torch.Generator().manual_seed(2))


@pytest.mark.parametrize("fused", ["pallas", "none"])
def test_reverse_step_records_its_span_and_four_phases_in_order(fused):
    pg, _ = _model(fused)
    pg.net.eval()
    host = _traced(_reverse_step(pg))
    step = _one(host, "sample.step")
    phases = [_one(host, name) for name in SAMPLE_PHASES]
    assert all(_inside(p, step) for p in phases)
    # one after the other, none overlapping the next
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


@pytest.mark.parametrize("fused,mode,want", [
    ("none", "factorized", 6), ("none", "dense", 6),
    ("pallas", "factorized", 0)])
def test_bond_update_records_its_span_once_a_layer_in_the_network(
        fused, mode, want):
    """Six layers: six `bond.triplet` spans inside `sample.network` on the
    module path, in both triplet modes; none on the fused stack, which
    never calls the module."""
    pg, _ = _model(fused, layers=6, triplet_mode=mode)
    pg.net.eval()
    host = _traced(_reverse_step(pg))
    net = _one(host, "sample.network")
    got = spans.named(host, "bond.triplet")
    assert len(got) == want
    assert all(_inside(b, net) for b in got)


def test_train_step_records_five_phases_and_the_stack_backward():
    """`pallas` on the CPU runs the fused stack's plain stages forward and
    `LayerStackFn.backward` (one layer recomputed at a time) backward."""
    pg, cfg = _model("pallas")
    ds = get_dataset(cfg, synthetic_size=6)[0]
    tb = next(iter(PhoreDataLoader(ds, cfg, 3, shuffle=False))).to("cpu")
    st = pstate.create_train_state(cfg.train, pg.net)
    step = make_train_step(pg, cfg)
    host = _traced(lambda: step(st, 3, tb))
    phases = [_one(host, name) for name in TRAIN_PHASES]
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    stack = _one(host, "stack.backward")
    assert _inside(stack, phases[1])
    assert st.step == 1


def test_loader_batch_records_its_assembly_and_the_move():
    _, cfg = _model("none")
    ds = get_dataset(cfg, synthetic_size=6)[0]
    it = iter(PhoreDataLoader(ds, cfg, 3, shuffle=True, seed=4,
                              augment=True))
    host = _traced(lambda: next(it).to("cpu"))
    batch, move = _one(host, "data.batch"), _one(host, "data.to_device")
    assert batch[2] <= move[1]


def test_spans_come_back_in_the_host_list_and_not_as_device_work():
    pg, _ = _model("none")
    pg.net.eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _reverse_step(pg)()
    dev, host = trace.events(prof)
    names = {n for n, _, _ in host}
    assert {"sample.step", *SAMPLE_PHASES} <= names
    assert not {n for n, _, _ in dev} & set(spans.PROGRAM_SPANS)


def test_replicate_phore_counts_real_and_padded_slots():
    batching.reset_slot_counts()
    sample = GenerationPipeline(_model("none")[0], device="cpu") \
        .prepare_phore(parse_phore_text(PHORE_TEXT, "trace_phore"))
    b = batching.replicate_phore(sample, 2, np.asarray([3, 5]), 8)
    # triplets: 3*2*1 + 5*4*3 real of 2 * 8^3 slots
    assert batching.SLOTS == {"lig_real": 8, "lig_slots": 16,
                              "trip_real": 66, "trip_slots": 1024}
    assert int(b.lig_mask.sum()) == 8 and b.lig_mask.size == 16
    batching.reset_slot_counts()
    assert batching.SLOTS == {"lig_real": 0, "lig_slots": 0,
                              "trip_real": 0, "trip_slots": 0}


def test_loader_epoch_counts_the_sum_of_its_masks():
    _, cfg = _model("none")
    cfg.dataset.ligand_buckets = [8, 12, 16]
    ds = get_dataset(cfg, synthetic_size=10)[0]
    loader = PhoreDataLoader(ds, cfg, 3, shuffle=True, seed=2,
                             drop_last=False)
    batching.reset_slot_counts()
    real = slots = trip_real = trip_slots = 0
    for b in loader:
        real += int(b.lig_mask.sum())
        slots += b.lig_mask.size
        n = b.lig_mask.sum(1).astype(np.int64)
        trip_real += int((n * (n - 1) * (n - 2)).sum())
        trip_slots += b.lig_mask.shape[0] * b.lig_mask.shape[1] ** 3
    assert batching.SLOTS == {"lig_real": real, "lig_slots": slots,
                              "trip_real": trip_real,
                              "trip_slots": trip_slots}
    assert 0 < real < slots
