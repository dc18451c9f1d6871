"""The port's last utilities against the JAX package's: `utils/misc.py`
round trips, `utils/profiling.py` (`StepTimer`, a `profile_trace` written
on the CPU, the trainer's `logger.profile_steps` through it), `ops/mdn.py`
(the NLL within 1e-6 of the JAX one; sampling's concentration as in
tests/test_ops.py), the small ops helpers
(`masked_sum`, `masked_logsumexp`, `angular_encoding_dim`) and the host
float64 transition tables of `build_transition_mats` (within 1e-12), and
the packages' re-exports."""
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.diffusion import build_transition_mats as jbuild
from phoregen_tpu.ops import masked as jmasked
from phoregen_tpu.ops.mdn import mdn_loss as jmdn_loss
from phoregen_tpu.ops.rbf import angular_encoding_dim as jang_dim
from phoregen_tpu.ops.schedules import get_beta_schedule
from phoregen_tpu.utils import misc as jmisc

from phoregen_tpu_torch.diffusion import build_transition_mats
from phoregen_tpu_torch.ops import masked
from phoregen_tpu_torch.ops.mdn import SIGMA_FLOOR, mdn_loss, sample_from_mdn
from phoregen_tpu_torch.ops.rbf import (angular_encoding,
                                        angular_encoding_dim,
                                        angular_encoding_freq_bands)
from phoregen_tpu_torch.utils import misc
from phoregen_tpu_torch.utils.profiling import (TRACE_NAME, StepTimer,
                                                profile_trace)


def test_re_exports_match_the_jax_package():
    import phoregen_tpu.diffusion as jd
    import phoregen_tpu.ops as jo
    import phoregen_tpu.utils as ju
    import phoregen_tpu_torch.diffusion as pd
    import phoregen_tpu_torch.ops as po
    import phoregen_tpu_torch.utils as pu
    from phoregen_tpu_torch.utils import StepTimer as T, seed_all  # noqa
    for j, p in ((jd, pd), (jo, po), (ju, pu)):
        public = {n for n in dir(j) if not n.startswith("_")
                  and not isinstance(getattr(j, n), type(os))}
        missing = {n for n in public if not hasattr(p, n)}
        assert not missing, (j.__name__, missing)
    assert pu.__all__ == ju.__all__


def test_misc_round_trips_and_seeding(tmp_path):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None, "d": True}}
    for save, load, ext in ((misc.save_yaml, misc.load_yaml, "yml"),
                            (misc.save_json, misc.load_json, "json"),
                            (misc.save_pkl, misc.load_pkl, "pkl")):
        path = str(tmp_path / "sub" / f"o.{ext}")
        save(path, obj)
        assert load(path) == obj
        jpath = str(tmp_path / "jax" / f"o.{ext}")
        getattr(jmisc, save.__name__)(jpath, obj)
        with open(path, "rb") as a, open(jpath, "rb") as b:
            assert a.read() == b.read(), ext
    # json falls back to str() as the JAX package's does
    misc.save_json(str(tmp_path / "p.json"), {"p": tmp_path})
    assert json.load(open(tmp_path / "p.json")) == {"p": str(tmp_path)}
    draws = []
    for mod in (misc, jmisc, misc):
        mod.seed_all(17)
        draws.append((random.random(), float(np.random.rand())))
    assert draws[0] == draws[1] == draws[2]


def test_step_timer_statistics(monkeypatch):
    clock = iter([0.0, 1.0, 10.0, 12.0, 20.0, 24.0])
    monkeypatch.setattr("phoregen_tpu_torch.utils.profiling.time."
                        "perf_counter", lambda: next(clock))
    t = StepTimer(skip_first=1)
    assert t.summary() == {"mean_s": 0.0, "min_s": 0.0, "steps": 0}
    for _ in range(3):
        with t:
            pass
    assert t.times == [2.0, 4.0]
    assert t.summary() == {"mean_s": 3.0, "min_s": 2.0, "steps": 2}


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "prof")
    x = torch.randn(64, 64)
    with profile_trace(logdir):
        for _ in range(3):
            x = torch.tanh(x @ x)
    with open(os.path.join(logdir, TRACE_NAME)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:20]
    # disabled: nothing is written
    with profile_trace(str(tmp_path / "off"), enabled=False):
        x @ x
    assert not os.path.exists(tmp_path / "off")


def test_trainer_profile_steps_write_their_trace(tmp_path):
    """`logger.profile_steps` traces steps [1, 1 + N) of the first epoch
    through `profile_trace` into `<run_dir>/profile/`."""
    from phoregen_tpu_torch.data.dataset import get_dataset
    from phoregen_tpu_torch.train.loop import Run
    from test_torch_port_train import _run_cfg
    cfg = _run_cfg(tmp_path, "p", fused="none")
    cfg.logger.profile_steps = 1
    train, _, _ = get_dataset(cfg, synthetic_size=24)
    Run(cfg, device="cpu").train(train, [], epochs=1)
    with open(os.path.join(str(tmp_path), "p", "profile", TRACE_NAME)) as f:
        assert json.load(f)["traceEvents"]


def test_mdn_loss_matches_jax():
    rng = np.random.default_rng(0)
    B, K = 7, 3
    label = rng.normal(size=B).astype(np.float32) * 3
    mu = rng.normal(size=(B, K)).astype(np.float32) * 3
    sigma = rng.uniform(0.2, 2.0, size=(B, K)).astype(np.float32)
    sigma[0, 0] = 0.0                         # under the floor
    pi = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
    ours = float(mdn_loss(*map(torch.from_numpy, (label, mu, sigma, pi))))
    ref = float(jmdn_loss(*map(jnp.asarray, (label, mu, sigma, pi))))
    assert ours == pytest.approx(ref, rel=1e-6, abs=1e-6)
    # single component, unit sigma: NLL = 0.5*log(2*pi) + 0.5*z^2
    one = mdn_loss(torch.tensor([0.0, 1.0]), torch.zeros(2, 1),
                   torch.ones(2, 1), torch.ones(2, 1))
    assert float(one) == pytest.approx(0.5 * np.log(2 * np.pi) + 0.25,
                                       rel=1e-5)
    assert SIGMA_FLOOR == 1e-6


def test_sample_from_mdn_concentrates():
    mu = torch.tensor([[0.0, 10.0]] * 512)
    sigma = torch.full((512, 2), 0.1)
    pi = torch.tensor([[0.001, 0.999]] * 512)
    draws = sample_from_mdn(torch.Generator().manual_seed(0), mu, sigma, pi)
    assert draws.shape == (512,)
    assert float((draws > 5).float().mean()) > 0.98
    assert abs(float(torch.where(draws > 5, draws, torch.tensor(10.0)
                                 ).mean()) - 10) < 0.2
    again = sample_from_mdn(torch.Generator().manual_seed(0), mu, sigma, pi)
    assert torch.equal(draws, again)
    good = mdn_loss(torch.tensor([10.0]), mu[:1], sigma[:1], pi[:1])
    bad = mdn_loss(torch.tensor([0.0]), mu[:1], sigma[:1], pi[:1])
    assert float(good) < float(bad)


@pytest.mark.parametrize("dim,keepdim", [(None, False), (-1, False),
                                         (1, True), ((0, 2), False)])
def test_masked_sum_matches_jax(dim, keepdim):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    m = rng.uniform(size=(3, 4, 5)) > 0.4
    ours = masked.masked_sum(torch.from_numpy(x), torch.from_numpy(m),
                             dim=dim, keepdim=keepdim)
    ref = jmasked.masked_sum(jnp.asarray(x), jnp.asarray(m), axis=dim,
                             keepdims=keepdim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dim,keepdim", [(-1, False), (0, True)])
def test_masked_logsumexp_matches_jax(dim, keepdim):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6)).astype(np.float32) * 4
    m = rng.uniform(size=(4, 6)) > 0.5
    m[1] = False                              # a fully masked row
    ours = masked.masked_logsumexp(torch.from_numpy(x), torch.from_numpy(m),
                                   dim=dim, keepdim=keepdim)
    ref = jmasked.masked_logsumexp(jnp.asarray(x), jnp.asarray(m), axis=dim,
                                   keepdims=keepdim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 7])
def test_angular_encoding_dim_matches_jax(n):
    assert angular_encoding_dim(n) == jang_dim(n)
    enc = angular_encoding(torch.zeros(2), angular_encoding_freq_bands(n))
    assert enc.shape[-1] == angular_encoding_dim(n)


@pytest.mark.parametrize("init_prob,K", [("tomask", 12), ("absorb", 6),
                                         ("uniform", 5), (None, 4),
                                         ([0.5, 0.2, 0.3], 3)])
def test_build_transition_mats_matches_jax(init_prob, K):
    for betas in (np.asarray(get_beta_schedule("cosine", 20, s=0.01)),
                  np.linspace(1e-4, 0.3, 15)):
        ours = build_transition_mats(betas, K, init_prob)
        ref = jbuild(betas, K, init_prob)
        for a, b in zip(ours, ref):
            assert a.dtype == np.float64 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        prob, q_mats, tq = ours
        np.testing.assert_allclose(q_mats.sum(-1), 1.0, atol=1e-12)
        assert q_mats.shape == tq.shape == (len(betas), K, K)
