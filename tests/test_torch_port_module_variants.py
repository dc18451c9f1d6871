"""The port's per-layer module path on parameter trees of other shapes
than the flagship's (unstacked layers, output MLPs, exact-width triplets,
no LayerNorm, no direction or edge-weight features), whole network against
the JAX package, and the settings the port still refuses. Same sizes and
tolerance (1e-4) as tests/test_torch_port_module_path.py."""
import jax
import pytest

from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.models.phoregen import PhoreGen

from test_torch_port_module_path import (_assert_same, _batch, _inputs,
                                         _jax_forward, _port_forward,
                                         _port_net, module_config)

OWN_PARAMS = {
    # layer_0.. parameter layout instead of the stacked one
    "unstacked": dict(scan_layers=False),
    # output MLP over all composed nodes, exact-width triplets, gelu
    "out_fc_dense_gelu": dict(x2h_out_fc=True, triplet_mode="dense",
                              act_fn="gelu"),
    "no_ew_no_dire_no_norm": dict(use_global_ew=False, direction_match=False,
                                  norm=False, h_node_in_bond_net=False),
}


@pytest.mark.parametrize("variant", sorted(OWN_PARAMS))
def test_module_path_other_parameter_trees_match_jax(variant):
    jcfg = module_config(**OWN_PARAMS[variant])
    batch = _batch(jcfg)
    params = JPhoreGen(jcfg).init_params(jax.random.PRNGKey(1), batch)
    x = _inputs(batch, seed=6)
    ref = _jax_forward(jcfg, params, batch, x)
    out = _port_forward(_port_net(jcfg, params), batch, x)
    _assert_same([o.numpy() for o in out[:3]]
                 + [[c.numpy() for c in out[3]]], ref, batch)


@pytest.mark.parametrize("field,value,match", [
    ("fused_block_dtype", "bfloat16", "bf16"),
    ("cutoff_mode", "ball", "cutoff_mode"),
])
def test_unported_denoiser_settings_raise(field, value, match):
    cfg = config_from_dict(module_config().to_dict())
    setattr(cfg.model.denoiser, field, value)
    with pytest.raises(NotImplementedError, match=match):
        PhoreGen(cfg)


def test_bfloat16_compute_raises():
    cfg = config_from_dict(module_config().to_dict())
    cfg.model.compute_dtype = "bfloat16"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PhoreGen(cfg)
