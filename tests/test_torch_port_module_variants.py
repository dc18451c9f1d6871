"""The port's per-layer module path on parameter trees of other shapes
than the flagship's (unstacked layers, output MLPs, exact-width triplets,
no LayerNorm, no direction or edge-weight features, num_r_gaussian other
than 20), whole network against
the JAX package, the settings the port refused and now takes (bf16 blocks,
bf16 compute: 0.08, the JAX package's bf16 bound), and those it still
refuses. Same sizes and tolerance (1e-4) as
tests/test_torch_port_module_path.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.data.batching import PhoreGraphBatch
from phoregen_tpu_torch.models.diffusion_model import apply_net, cast_params
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
    # edge distances stay on the fixed 20-point grid, whatever
    # num_r_gaussian says (the JAX layers infer their widths from it)
    "num_r_gaussian_4": dict(num_r_gaussian=4),
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
    """Of the denoiser settings the port used to refuse, bf16 inter-stage
    blocks now build; on the per-layer module path they change nothing, as
    in the JAX package (the forward equals the float32 one exactly). An
    unknown cutoff_mode still raises."""
    jcfg = module_config()
    cfg = config_from_dict(jcfg.to_dict())
    setattr(cfg.model.denoiser, field, value)
    if field == "cutoff_mode":
        with pytest.raises(NotImplementedError, match=match):
            PhoreGen(cfg)
        return
    batch = _batch(jcfg)
    params = JPhoreGen(jcfg).init_params(jax.random.PRNGKey(1), batch)
    x = _inputs(batch, seed=6)
    net = _port_net(jcfg, params, **{field: value})
    assert net.denoiser.block_dtype == torch.bfloat16
    out = _port_forward(net, batch, x)
    ref = _port_forward(_port_net(jcfg, params), batch, x)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)


def test_bfloat16_compute_raises():
    """`compute_dtype` bfloat16 used to raise; now the module path runs in
    bf16 (bf16 parameters and features, float32 geometry) and agrees with
    the JAX package's bf16 forward within its own bf16 bound, rtol = atol =
    0.08 (tests/test_layer_stack.py), with the same output dtypes."""
    jcfg = module_config()
    jcfg.model.compute_dtype = "bfloat16"
    batch = _batch(jcfg)
    params = JPhoreGen(jcfg).init_params(jax.random.PRNGKey(2), batch)
    x = _inputs(batch, seed=7)
    bf = jnp.bfloat16
    ref = JPhoreGen(jcfg).net.apply(
        jax.tree_util.tree_map(lambda a: a.astype(bf), params),
        jnp.asarray(x["h_node"]).astype(bf), jnp.asarray(x["pos"]),
        batch.lig_mask, jnp.asarray(x["h_edge"]).astype(bf),
        jnp.asarray(x["t"]), jnp.asarray(batch.phore_x).astype(bf),
        batch.phore_pos, batch.phore_norm, batch.phore_mask)
    net = _port_net(jcfg, params)
    tb = PhoreGraphBatch(**{k: np.array(v) for k, v in
                            vars(batch).items()}).to("cpu")
    T, B = torch.from_numpy, torch.bfloat16
    with torch.no_grad():
        out = apply_net(net, cast_params(net, B), T(x["h_node"]).to(B),
                        T(x["pos"]), tb.lig_mask, T(x["h_edge"]).to(B),
                        T(x["t"]), tb.phore_x.to(B), tb.phore_pos,
                        tb.phore_norm, tb.phore_mask)
    assert [str(o.dtype).split(".")[-1] for o in out[:3]] == [
        str(r.dtype) for r in ref[:3]]
    _assert_same([o.float().numpy() for o in out[:3]]
                 + [[c.numpy() for c in out[3]]],
                 [np.asarray(r, np.float32) for r in ref[:3]]
                 + [[np.asarray(c) for c in ref[3]]], batch,
                 tol=dict(atol=0.08, rtol=0.08))
