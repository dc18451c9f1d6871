"""PhoreGen's published denoiser (`denoiser.triplet_mode: dense`, the
benchmark's `upstream-dense` configuration) against the benchmark's plain
reference of the published bond update in its upstream form
(`portbench/reference/triplet_upstream.py`: graph by graph over the
explicit list of triplets, no padded grid), on the CPU with seeded
weights: the port's dense `BondUpdateTriplet` alone, the whole network
forward with the upstream layer in the reference network, and the
committed seeded checkpoint of the configuration."""
import hashlib
import json
import os
import types

import numpy as np
import pytest
import torch

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.constants import MAX_ATOMS, MIN_ATOMS
from phoregen_tpu_torch.data.batching import collate
from phoregen_tpu_torch.data.phore import parse_phore_file
from phoregen_tpu_torch.models.layers import BondUpdateTriplet
from phoregen_tpu_torch.models.phoregen import load_release_model
from phoregen_tpu_torch.sample.pipeline import GenerationPipeline

from portbench.kinds import sample_pools_dense
from portbench.reference.triplet_upstream import BondUpdateUpstream, triplets
from portbench.tests.dense_small import checkpoint_script, small_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs", "upstream-dense.json")
P03211 = os.path.join(ROOT, "data", "phores_for_sampling",
                      "P03211_merge.phore")
# float32 sums of a few hundred terms taken in another order (per triplet
# here, on the padded grid there) and a softmax over the same triplets:
# the two agree to ~2e-7 of the largest value; a product in TF32 (10
# mantissa bits) would miss by ~1e-3
TOL = 1e-5


def _tree(spec, gen):
    """Seeded parameters of a shape tree: kernels over their fan-in,
    biases and LayerNorm scales and shifts of order one third."""
    if isinstance(spec, dict):
        return {k: _tree(v, gen) for k, v in spec.items()}
    w = torch.randn(spec, generator=gen)
    return w / spec[0] ** 0.5 if len(spec) > 1 else w / 3.0


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def test_triplet_list_is_every_ordered_triple_of_distinct_atoms():
    k, j, i = triplets(5)
    got = set(zip(k.tolist(), j.tolist(), i.tolist()))
    assert len(got) == len(k) == 5 * 4 * 3
    assert all(len({a, b, c}) == 3 for a, b, c in got)


@pytest.mark.parametrize("H,heads,NL,counts", [
    (32, 4, 10, [3, 6, 9]),
    (128, 16, 12, [12, 5])])
def test_dense_bond_update_equals_the_upstream_form(H, heads, NL, counts):
    gen = torch.Generator().manual_seed(H + NL)
    p = _tree(BondUpdateTriplet.shapes(H, heads, mode="dense"), gen)
    B = len(counts)
    h = torch.randn(B, NL, H, generator=gen)
    hb = torch.randn(B, NL, NL, H, generator=gen)
    pos = 1.5 * torch.randn(B, NL, 3, generator=gen)
    mask = torch.arange(NL)[None] < torch.tensor(counts)[:, None]
    prog = BondUpdateTriplet(hidden_dim=H, n_heads=heads, mode="dense")(
        p, h, hb, pos, mask)
    ref = BondUpdateUpstream(hidden_dim=H, n_heads=heads)(p, h, hb, pos,
                                                         mask)
    eye = torch.eye(NL, dtype=torch.bool)
    bonds = mask[:, :, None] & mask[:, None, :] & ~eye
    assert _rel(prog[bonds], ref[bonds]) < TOL
    # nothing off the real bonds, in either
    assert not prog[~bonds].any() and not ref[~bonds].any()


def test_network_forward_equals_the_reference_with_the_upstream_layer(
        tmp_path):
    """A tiny `upstream-dense` (hidden 16, 4 heads, 2 layers) written as
    the configuration's checkpoint is, loaded by the port's
    `load_release_model` and by the benchmark's reference network with
    the published layer in its upstream form (the cell's own check)."""
    conf = small_config(json.load(open(CONFIG))["config"])
    prefix = str(tmp_path / "dense")
    checkpoint_script().write(prefix, config_from_dict(conf), (5, 9))
    pg, _ = load_release_model(prefix, device="cpu",
                               config=config_from_dict(conf))
    assert pg.config.model.denoiser.triplet_mode == "dense"
    ref = sample_pools_dense.reference(types.SimpleNamespace(
        config={"config": conf, "checkpoint": prefix}), "cpu")
    assert isinstance(ref.net.denoiser.bond_update, BondUpdateUpstream)
    gen = torch.Generator().manual_seed(5)
    B, NL, NP = 3, 16, 12
    counts = torch.tensor([3, 9, 14])
    lig_mask = torch.arange(NL)[None] < counts[:, None]
    oh = torch.nn.functional.one_hot
    h_node = oh(torch.randint(0, 12, (B, NL), generator=gen), 12).float()
    h_edge = oh(torch.randint(0, 6, (B, NL, NL), generator=gen), 6).float()
    pos = 1.5 * torch.randn(B, NL, 3, generator=gen)
    t = torch.tensor([5, 400, 900])
    phore_x = oh(torch.randint(0, 18, (B, NP), generator=gen), 18).float()
    phore_pos = 2.0 * torch.randn(B, NP, 3, generator=gen)
    phore_norm = torch.nn.functional.normalize(
        torch.randn(B, NP, 3, generator=gen), dim=-1)
    phore_mask = torch.arange(NP)[None] < torch.tensor([12, 7, 10])[:, None]
    args = (h_node, pos, lig_mask, h_edge, t, phore_x, phore_pos,
            phore_norm, phore_mask)
    with torch.no_grad():
        got = pg.net(*args, compute_count=False)[:3]
        want = ref.net(*args, compute_count=False)[:3]
    eye = torch.eye(NL, dtype=torch.bool)
    bonds = lig_mask[:, :, None] & lig_mask[:, None, :] & ~eye
    for g, w, m in zip(got, want, (lig_mask, lig_mask, bonds)):
        assert _rel(g[m], w[m]) < TOL


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_committed_checkpoint_is_what_its_script_writes(tmp_path):
    prefix = str(tmp_path / "upstream_dense")
    checkpoint_script().write(prefix)
    committed = os.path.join(ROOT, "release", "upstream_dense")
    for ext in (".msgpack", ".json"):
        assert _sha(prefix + ext) == _sha(committed + ext), ext


def test_committed_checkpoint_counts_14_to_38_atoms_on_p03211():
    conf = json.load(open(CONFIG))
    pg, _ = load_release_model(os.path.join(ROOT, conf["checkpoint"]),
                               device="cpu",
                               config=config_from_dict(conf["config"]))
    sample = GenerationPipeline(pg, device="cpu").prepare_phore(
        parse_phore_file(P03211))
    one = collate([sample]).to("cpu")
    with torch.no_grad():
        lo, up = pg.net.count_interval(one.phore_x, one.phore_pos,
                                       one.phore_norm, one.phore_mask)
    den = lambda c: int(np.round(float(c[0, 0]) * (MAX_ATOMS - MIN_ATOMS)
                                 + MIN_ATOMS))
    assert (den(lo), den(up)) == (14, 38)
