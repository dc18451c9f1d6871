"""The port's host input pipeline (numpy copies of the JAX package's data
modules) gives the JAX package's samples and batches from the same seed,
array for array, exactly."""
import dataclasses

import numpy as np
import pytest

from phoregen_tpu.config import default_config as jdefault_config
from phoregen_tpu.data import dataset as jdataset
from phoregen_tpu.data import loader as jloader
from phoregen_tpu.data import realcorpus as jreal
from phoregen_tpu.data import synthetic as jsyn
from phoregen_tpu.data import transforms as jtr

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.data import dataset as pdataset
from phoregen_tpu_torch.data import loader as ploader
from phoregen_tpu_torch.data import realcorpus as preal
from phoregen_tpu_torch.data import synthetic as psyn
from phoregen_tpu_torch.data import transforms as ptr

FIELDS = [f.name for f in dataclasses.fields(ploader.RawSample)]


def _same_samples(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                assert x == y, f


def _cfgs(corpus="mixed"):
    jcfg = jdefault_config("zinc_300")
    jcfg.dataset.corpus = corpus
    jcfg.dataset.ligand_buckets = [16, 32, 48]
    jcfg.train.batch_size = 4
    jcfg.finalize()
    return jcfg, config_from_dict(jcfg.to_dict())


def test_synthetic_dataset_equals_jax():
    _same_samples(psyn.synthetic_dataset(3, 12, max_atoms=20),
                  jsyn.synthetic_dataset(3, 12, max_atoms=20))
    a = psyn.synthetic_batch(5, 3)
    b = jsyn.synthetic_batch(5, 3)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)))


@pytest.mark.parametrize("seed", [0, 7])
def test_mixed_corpus_equals_jax(seed):
    kw = dict(max_phore=96, max_atoms=48, real_frac=0.5)
    ours = preal.mixed_corpus(seed, 10, "zinc_300", **kw)
    _same_samples(ours, jreal.mixed_corpus(seed, 10, "zinc_300", **kw))
    assert max(len(s.phore_x) for s in ours) > 16    # real pharmacophores
    assert len(preal.load_real_phores()) == len(jreal.load_real_phores())


def test_transforms_equal_jax():
    pos = np.random.default_rng(0).normal(size=(9, 3)).astype(np.float32)
    nrm = np.random.default_rng(1).normal(size=(9, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    a = ptr.add_phore_noise(np.random.default_rng(2), pos, nrm, 0.1, 5.0)
    b = jtr.add_phore_noise(np.random.default_rng(2), pos, nrm, 0.1, 5.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shuffle,augment", [(True, True), (False, False)])
def test_loader_batches_equal_jax(shuffle, augment):
    jcfg, pcfg = _cfgs()
    samples = jreal.mixed_corpus(1, 22, max_atoms=48)
    mine = preal.mixed_corpus(1, 22, max_atoms=48)
    jl = jloader.PhoreDataLoader(samples, jcfg, 4, shuffle=shuffle, seed=5,
                                 augment=augment)
    pl = ploader.PhoreDataLoader(mine, pcfg, 4, shuffle=shuffle, seed=5,
                                 augment=augment)
    assert len(pl) == len(jl) > 2
    for epoch in (0, 3):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        n = 0
        for (pb, preal_n), (jb, jreal_n) in zip(pl.iter_with_sizes(),
                                                jl.iter_with_sizes()):
            assert preal_n == jreal_n
            for f in dataclasses.fields(pb):
                x, y = getattr(pb, f.name), np.asarray(getattr(jb, f.name))
                assert x.shape == y.shape and x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            n += 1
        assert n == len(pl)
    # one batch pads to one bucket, on the device side as torch tensors
    tb = next(iter(pl)).to("cpu")
    assert tb.lig_pos.shape[1] in (16, 32, 48)
    assert tb.phore_x.shape[1] == pcfg.dataset.max_phore


def test_batch_slot_and_atom_counts_equal_jax():
    """`num_phore_slots` and `atom_counts` (int32 real ligand atoms per
    graph) of the port's batch, on the host and as torch tensors, equal
    the JAX batch's on the same samples."""
    jcfg, pcfg = _cfgs()
    jb = next(iter(jloader.PhoreDataLoader(
        jreal.mixed_corpus(2, 8, max_atoms=48), jcfg, 8, shuffle=False)))
    pb = next(iter(ploader.PhoreDataLoader(
        preal.mixed_corpus(2, 8, max_atoms=48), pcfg, 8, shuffle=False)))
    want = np.asarray(jb.atom_counts)
    assert want.dtype == np.int32 and len(set(want.tolist())) > 1
    for b in (pb, pb.to("cpu")):
        assert b.num_phore_slots == jb.num_phore_slots
        got = np.asarray(b.atom_counts)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("corpus", ["mixed", "chains"])
def test_get_dataset_hermetic_equals_jax(corpus):
    jcfg, pcfg = _cfgs(corpus)
    for ours, ref in zip(pdataset.get_dataset(pcfg, synthetic_size=12),
                         jdataset.get_dataset(jcfg, synthetic_size=12)):
        _same_samples(ours, ref)
