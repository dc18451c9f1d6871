"""`phoregen_tpu_torch/utils/evalacc.py::eval_accuracies` against the JAX
package's on a small config, 2 batches of 4, the same weights and the JAX
eval step's draws injected (`draws=`; the JAX step keys each batch with
`PRNGKey(uint32(seed))`): the loss within 1e-5 relative, the accuracies
equal, the keys `ACC_KEYS`."""
import jax
import numpy as np
import pytest

from phoregen_tpu.config import default_config
from phoregen_tpu.data.loader import PhoreDataLoader
from phoregen_tpu.data.synthetic import synthetic_dataset
from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
from phoregen_tpu.utils.evalacc import ACC_KEYS as J_ACC_KEYS
from phoregen_tpu.utils.evalacc import eval_accuracies as j_eval_accuracies

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.models.phoregen import PhoreGen
from phoregen_tpu_torch.utils.checkpoint import from_jax_params
from phoregen_tpu_torch.utils.evalacc import ACC_KEYS, eval_accuracies

from test_torch_port_loss import _jax_draws

SEED = 9999


def _config():
    """tests/test_evalacc.py's small config."""
    cfg = default_config("zinc_300")
    m = cfg.model
    m.hidden_dim = 16
    m.denoiser.hidden_dim = 16
    m.denoiser.num_layers = 1
    m.denoiser.n_heads = 2
    m.denoiser.knn = 4
    m.denoiser.num_r_gaussian = 4
    m.diff.num_timesteps = 8
    m.diff.time_dim = 2
    cfg.dataset.ligand_buckets = [32, 48]
    cfg.dataset.max_phore = 96
    return cfg.finalize()


@pytest.fixture(scope="module")
def both():
    jcfg = _config()
    jpg = JPhoreGen(jcfg)
    tmpl = synthetic_dataset(0, 4, max_atoms=12)
    params = jpg.init_params(jax.random.PRNGKey(0),
                             next(iter(PhoreDataLoader(tmpl, jcfg, 4,
                                                       shuffle=False))))
    ref = j_eval_accuracies(jpg, jcfg, params, seed=SEED, n_batches=2,
                            batch_size=4)
    pcfg = config_from_dict(jcfg.to_dict())
    pg = PhoreGen(pcfg)
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    shapes = []

    def draws(batch):
        shapes.append(tuple(batch.lig_type.shape))
        return _jax_draws(jax.random.PRNGKey(np.uint32(SEED)), batch, 0.0,
                          jpg)
    ours = eval_accuracies(pg, pcfg, seed=SEED, n_batches=2, batch_size=4,
                           device="cpu", draws=draws)
    return ours, ref, shapes


def test_eval_accuracies_match_jax(both):
    ours, ref, shapes = both
    assert ACC_KEYS == J_ACC_KEYS
    assert tuple(ours) == tuple(ref) == ACC_KEYS
    assert len(shapes) >= 2 and all(s[0] == 4 for s in shapes)
    assert ours["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    for k in ACC_KEYS[1:]:
        assert ours[k] == ref[k], k
        assert 0.0 <= ours[k] <= 1.0


def test_eval_accuracies_draw_from_the_seed_without_draws(both):
    """Without injected draws the step draws from its seeded generator:
    the same numbers twice, finite, and on the network's device."""
    ours, _, _ = both
    pcfg = config_from_dict(_config().to_dict())
    pg = PhoreGen(pcfg)
    a = eval_accuracies(pg, pcfg, seed=SEED, n_batches=1, batch_size=4)
    b = eval_accuracies(pg, pcfg, seed=SEED, n_batches=1, batch_size=4)
    assert a == b and tuple(a) == ACC_KEYS
    assert all(np.isfinite(v) for v in a.values())
