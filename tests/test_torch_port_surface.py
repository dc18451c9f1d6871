"""The port's public surface against the JAX package's, read from both
packages' sources with `ast`: neither package is imported, so this runs in
milliseconds and needs no JAX backend.

For each `.py` file of `phoregen_tpu/` (one case each), the file of the
same relative path in `phoregen_tpu_torch/` (`parallel/mesh.py` is
`parallel/group.py`) must exist and define:
- every public top-level function and class under the same name;
- every public method and property of each public class;
- every parameter name of each of those that has a counterpart. A class's
  parameters are its `__init__`'s, or a dataclass's fields; a function's
  include the option strings of the `add_argument` calls in its body, so
  the CLIs' flags count too.
`self`, `cls`, `*args`, `**kwargs`, `_`-prefixed names and the members of
`_`-prefixed classes are skipped.

Each miss that is by design has a row in BY_DESIGN with a one-line reason.
A row may give the port's spelling instead (`Renamed`); the port must then
have that name. A new public member of the JAX package needs a counterpart
in the port or a row here.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "phoregen_tpu")
PORT_PKG = os.path.join(ROOT, "phoregen_tpu_torch")
PORT_FILE = {"parallel/mesh.py": "parallel/group.py"}


class Renamed(NamedTuple):
    """The port's spelling of a JAX member or parameter, and why."""
    name: str
    reason: str


Row = Union[str, Renamed]
_KEY = "a torch.Generator in place of a JAX PRNG key"
_NET = "the weights are the nn.Module's own; no params pytree is passed"
_PYTREE = "JAX pytree hook; a torch object needs none"
_TABLE = ("a pytree field that JAX's create fills; the port's constructor "
          "takes create's arguments and builds it")
_TORCH_CLI = Renamed("--device", "torch places tensors on a device "
                     "(cuda or cpu) in place of choosing a JAX platform")

BY_DESIGN: Dict[Tuple[str, str], Row] = {
    # --- CLIs
    ("cli/sample.py", "run_pipeline"):
        "main runs the pipeline after load_model; pg.net holds the weights, "
        "so there is no params tree to hand to a second entry point",
    ("cli/sample.py", "parse_args(--unroll)"):
        "XLA's lax.scan unroll factor; the port's reverse loop is a Python "
        "loop",
    ("cli/sample.py", "parse_args(--platform)"): _TORCH_CLI,
    ("cli/train.py", "parse_args(--platform)"): _TORCH_CLI,
    # --- transitions: pytree classes become plain objects
    ("diffusion/categorical.py", "CategoricalTransition.tree_flatten"):
        _PYTREE,
    ("diffusion/categorical.py", "CategoricalTransition.tree_unflatten"):
        _PYTREE,
    ("diffusion/categorical.py", "CategoricalTransition.create"):
        "the constructor takes create's betas and builds the tables",
    ("diffusion/categorical.py", "CategoricalTransition(q_mats)"): _TABLE,
    ("diffusion/categorical.py",
     "CategoricalTransition(transpose_q_onestep)"): _TABLE,
    ("diffusion/categorical.py", "CategoricalTransition(init_logprob)"):
        _TABLE,
    ("diffusion/categorical.py", "CategoricalTransition.q_vt_sample(key)"):
        Renamed("generator", _KEY),
    ("diffusion/categorical.py", "CategoricalTransition.add_noise(key)"):
        Renamed("generator", _KEY),
    ("diffusion/categorical.py", "CategoricalTransition.sample_init(key)"):
        Renamed("generator", _KEY),
    ("diffusion/categorical.py",
     "UniformCategoricalTransition.tree_flatten"): _PYTREE,
    ("diffusion/categorical.py",
     "UniformCategoricalTransition.tree_unflatten"): _PYTREE,
    ("diffusion/categorical.py", "UniformCategoricalTransition.create"):
        "the constructor takes create's betas and builds the tables",
    ("diffusion/categorical.py",
     "UniformCategoricalTransition(log_alphas)"): _TABLE,
    ("diffusion/categorical.py",
     "UniformCategoricalTransition(log_1m_alphas)"): _TABLE,
    ("diffusion/categorical.py",
     "UniformCategoricalTransition(log_alphas_bar)"): _TABLE,
    ("diffusion/categorical.py",
     "UniformCategoricalTransition(log_1m_alphas_bar)"): _TABLE,
    ("diffusion/categorical.py",
     "UniformCategoricalTransition.add_noise(key)"):
        Renamed("generator", _KEY),
    ("diffusion/categorical.py",
     "UniformCategoricalTransition.sample_init(key)"):
        Renamed("generator", _KEY),
    ("diffusion/gaussian.py", "GaussianTransition.tree_flatten"): _PYTREE,
    ("diffusion/gaussian.py", "GaussianTransition.tree_unflatten"): _PYTREE,
    ("diffusion/gaussian.py", "GaussianTransition(alphas)"): _TABLE,
    ("diffusion/gaussian.py", "GaussianTransition(alphas_bar)"): _TABLE,
    ("diffusion/gaussian.py", "GaussianTransition(alphas_bar_prev)"): _TABLE,
    ("diffusion/gaussian.py", "GaussianTransition(coef_x0)"): _TABLE,
    ("diffusion/gaussian.py", "GaussianTransition(coef_xt)"): _TABLE,
    ("diffusion/gaussian.py", "GaussianTransition(std)"): _TABLE,
    ("diffusion/gaussian.py", "GaussianTransition.add_noise(key)"):
        Renamed("generator", _KEY),
    ("diffusion/gaussian.py", "GaussianTransition.get_prev_from_recon(key)"):
        Renamed("generator", _KEY),
    ("diffusion/gaussian.py", "GaussianTransition.sample_init(key)"):
        Renamed("generator", _KEY),
    ("diffusion/gaussian.py", "GaussianTransition.get_prev_with(key)"):
        Renamed("generator", _KEY),
    # --- models: Flax hooks become nn.Module constructors
    ("models/diffusion_model.py", "PhoreDiffNet.setup"):
        "Flax's setup hook; the nn.Module builds its submodules in __init__",
    ("models/phoregen.py", "PhoreGen.init_params"):
        "flax init traces an example batch; the port's net is built with its "
        "weights, and init_params(net, seed) in the same module redraws them",
    ("models/phoregen.py", "PhoreGen.sample_time(key)"):
        Renamed("generator", _KEY),
    ("models/phoregen.py", "PhoreGen.compute_loss(params)"): _NET,
    ("models/phoregen.py", "PhoreGen.compute_loss(key)"):
        Renamed("generator", _KEY),
    # --- ops: torch spellings and the kernels' PyTorch entry points
    ("ops/layer_stack.py", "build_block_tables(dtype)"):
        "float32 from every caller of the JAX package; bf16 blocks are "
        "layer_stack's block_dtype",
    ("ops/layer_stack.py", "pack_layer_params(dtype)"):
        "float32 from every caller of the JAX package; bf16 blocks are "
        "layer_stack's block_dtype",
    ("ops/layer_stack.py", "layer_stack_xla"):
        Renamed("layer_stack", "use_kernels=False runs the plain PyTorch "
                "stages, the counterpart of the XLA stack"),
    ("ops/layer_stack.py", "layer_stack_xla2"):
        Renamed("layer_stack", "use_kernels=False runs the plain stages, "
                "which compute in the dtype of the carries h and hb"),
    ("ops/layer_stack.py", "layer_stack_xla2(dtype)"):
        "the plain stages with the carries in the dtype: "
        "run_stack('xla2', block_dtype=) casts h, hb and the weights to it",
    ("ops/layer_stack.py", "layer_stack_pallas"):
        Renamed("layer_stack", "use_kernels=True launches the CUDA stage "
                "kernels in place of the Pallas ones"),
    ("ops/layer_stack.py", "layer_stack_pallas(interpret)"):
        "Pallas interpret mode; a CUDA kernel has none, CPU tensors take "
        "the plain stages",
    ("ops/layer_stack.py", "make_layer_stack_grad(interpret)"):
        "Pallas interpret mode; a CUDA kernel has none, CPU tensors take "
        "the plain stages",
    ("ops/masked.py", "masked_softmax(axis)"):
        Renamed("dim", "torch spells axis as dim"),
    ("ops/masked.py", "masked_mean(axis)"):
        Renamed("dim", "torch spells axis as dim"),
    ("ops/masked.py", "masked_mean(keepdims)"):
        Renamed("keepdim", "torch spells keepdims as keepdim"),
    ("ops/masked.py", "masked_sum(axis)"):
        Renamed("dim", "torch spells axis as dim"),
    ("ops/masked.py", "masked_sum(keepdims)"):
        Renamed("keepdim", "torch spells keepdims as keepdim"),
    ("ops/masked.py", "masked_logsumexp(axis)"):
        Renamed("dim", "torch spells axis as dim"),
    ("ops/masked.py", "masked_logsumexp(keepdims)"):
        Renamed("keepdim", "torch spells keepdims as keepdim"),
    ("ops/masked.py", "log_sample_categorical(key)"):
        Renamed("generator", _KEY),
    ("ops/mdn.py", "sample_from_mdn(key)"): Renamed("generator", _KEY),
    ("ops/pallas_triplet.py", "triplet_pool_xla"):
        Renamed("triplet_pool_plain", "the plain PyTorch pool, the "
                "counterpart of the XLA reference"),
    ("ops/pallas_triplet.py", "triplet_pool_pallas"):
        Renamed("triplet_pool_cuda", "the CUDA kernel in place of the "
                "Pallas one"),
    ("ops/pallas_triplet.py", "triplet_pool_pallas(interpret)"):
        "Pallas interpret mode; a CUDA kernel has none, CPU tensors take "
        "the plain pool",
    # --- parallel: a process per device in place of a jax.sharding mesh
    ("parallel/mesh.py", "make_mesh"):
        "a torch.distributed process per device (init, launch) takes the "
        "place of a Mesh over devices",
    ("parallel/mesh.py", "batch_sharding"):
        "a NamedSharding spec; each rank holds whole tensors",
    ("parallel/mesh.py", "replicated_sharding"):
        "a NamedSharding spec; each rank holds whole tensors",
    ("parallel/mesh.py", "shard_batch"):
        "each rank assembles only its slice of the global batch "
        "(local_batch_slice, data/loader.py) instead of a sharded device_put",
    ("parallel/mesh.py", "replicate"):
        "each rank builds the same state from the seed or checkpoint; "
        "nothing is put across a mesh",
    # --- sampling
    ("sample/pipeline.py", "GenerationPipeline(params)"): _NET,
    ("sample/pipeline.py", "GenerationPipeline(unroll)"):
        "XLA's lax.scan unroll factor; the port's reverse loop is a Python "
        "loop",
    ("sample/pipeline.py", "GenerationPipeline(mesh)"):
        Renamed("devices", "a list of torch devices, one pool shard each, in "
                "place of a data mesh"),
    ("sample/sampler.py", "Sampler(unroll)"):
        "XLA's lax.scan unroll factor; the port's reverse loop is a Python "
        "loop",
    ("sample/sampler.py", "Sampler.predict_count_interval(params)"): _NET,
    ("sample/sampler.py", "Sampler.sample_counts(key)"):
        Renamed("rng", "a numpy Generator on the host in place of a JAX PRNG "
                "key"),
    ("sample/sampler.py", "Sampler.sample(params)"): _NET,
    ("sample/sampler.py", "Sampler.sample(key)"): Renamed("generator", _KEY),
    ("sample/sampler.py", "Sampler.sample_chunked(params)"): _NET,
    ("sample/sampler.py", "Sampler.sample_chunked(key)"):
        Renamed("generator", _KEY),
    # --- training: a module and a torch optimizer in place of pytrees
    ("train/checkpoint.py", "save_checkpoint(config_dict)"):
        Renamed("config", "takes the Config: the moments' optax layout "
                "follows config.train, the sidecar gets config.to_dict()"),
    ("train/checkpoint.py", "save_release(config_dict)"):
        Renamed("config", "takes the Config and writes config.to_dict() to "
                "the sidecar"),
    ("train/checkpoint.py", "load_checkpoint(state_template)"):
        Renamed("state", "fills a freshly created TrainState in place; torch "
                "modules and optimizers are loaded, not rebuilt from a "
                "template"),
    ("train/checkpoint.py", "load_params_only(params_template)"):
        Renamed("net", "loads into the nn.Module with load_state_dict; the "
                "module is the template"),
    ("train/loop.py", "Run.init_state(example_batch)"):
        "the nn.Module is built with its weights from the config; flax init "
        "needed a batch to trace",
    ("train/state.py", "GradNormQueue.create"):
        "the constructor makes the empty queue on a device",
    ("train/state.py", "TrainState(params)"):
        Renamed("net", "the nn.Module whose parameters are the params"),
    ("train/state.py", "TrainState(opt_state)"):
        Renamed("optimizer", "the torch optimizer holds its moments"),
    ("train/state.py", "make_optimizer(params)"):
        Renamed("net", "a torch optimizer binds to the module's parameters"),
    ("train/state.py", "get_learning_rate(opt_state)"):
        Renamed("optimizer", "the lr lives in the torch optimizer's "
                "param_groups"),
    ("train/state.py", "set_learning_rate(opt_state)"):
        Renamed("optimizer", "the lr lives in the torch optimizer's "
                "param_groups"),
    ("train/state.py", "create_train_state(params)"):
        Renamed("net", "a torch optimizer binds to the module's parameters"),
    ("train/state.py", "ema_update(params)"):
        Renamed("net", "the shadow follows the module's named parameters"),
    ("train/step.py", "make_train_step(mesh)"):
        "the step reduces over the torch.distributed process group, which "
        "is global, in place of a mesh",
    ("train/step.py", "make_train_step(donate)"):
        "XLA buffer donation; the torch step updates its tensors in place",
    ("train/step.py", "make_train_step(params_for_mask)"):
        "optax builds the freeze mask from a params tree; the torch "
        "optimizer takes the trained parameters from the net",
    ("train/step.py", "make_eval_step(mesh)"):
        "the step reduces over the torch.distributed process group, which "
        "is global, in place of a mesh",
    ("utils/evalacc.py", "eval_accuracies(params)"): _NET,
}


class Member(NamedTuple):
    line: int
    params: Optional[Tuple[str, ...]]    # None: no parameter list to hold


def _params(fn: ast.FunctionDef) -> Tuple[str, ...]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
             if p.arg not in ("self", "cls")]
    for node in ast.walk(fn):         # argparse flags of a CLI function
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            names += [c.value for c in node.args
                      if isinstance(c, ast.Constant)
                      and isinstance(c.value, str)]
    return tuple(names)


def _class_params(cls: ast.ClassDef) -> Optional[Tuple[str, ...]]:
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return _params(node)
    if any("dataclass" in ast.unparse(d) for d in cls.decorator_list):
        return tuple(n.target.id for n in cls.body
                     if isinstance(n, ast.AnnAssign)
                     and isinstance(n.target, ast.Name))
    return None


def surface(source: str) -> Dict[str, Member]:
    """Public top-level functions and classes, and the public methods and
    properties of public classes (as `Class.member`), of one module."""
    out: Dict[str, Member] = {}
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.parse(source).body:
        if (not isinstance(node, funcs + (ast.ClassDef,))
                or node.name.startswith("_")):
            continue
        if isinstance(node, funcs):
            out[node.name] = Member(node.lineno, _params(node))
        elif isinstance(node, ast.ClassDef):
            out[node.name] = Member(node.lineno, _class_params(node))
            for m in node.body:
                if isinstance(m, funcs) and not m.name.startswith("_"):
                    out[f"{node.name}.{m.name}"] = Member(m.lineno,
                                                          _params(m))
    return out


def jax_modules(jax_root: str = JAX_PKG) -> List[str]:
    """Every `.py` file of the JAX package, relative, in sorted order."""
    found = []
    for d, _, files in os.walk(jax_root):
        found += [os.path.relpath(os.path.join(d, f), jax_root).replace(
            os.sep, "/") for f in files if f.endswith(".py")]
    return sorted(found)


def _read(root: str, module: str) -> Optional[str]:
    path = os.path.join(root, module)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def _port_name(module: str, name: str, by_design) -> str:
    """The port's name for a JAX member, through Renamed rows of the
    member or of its class."""
    row = by_design.get((module, name))
    if isinstance(row, Renamed):
        return row.name
    if "." in name:
        cls, member = name.split(".", 1)
        return f"{_port_name(module, cls, by_design)}.{member}"
    return name


def _absent_by_design(module: str, name: str, by_design) -> bool:
    parts = name.split(".")
    return any(isinstance(by_design.get((module, ".".join(parts[:i]))), str)
               for i in range(1, len(parts) + 1))


def module_gaps(module: str, jax_root: str = JAX_PKG,
                port_root: str = PORT_PKG, by_design=BY_DESIGN) -> List[str]:
    """What the port's counterpart of one JAX module lacks, less the
    by-design rows, each as 'phoregen_tpu/<module>:<line> <what>'."""
    port_module = PORT_FILE.get(module, module)
    port_src = _read(port_root, port_module)
    where = f"{os.path.basename(jax_root)}/{module}"
    if port_src is None:
        return [f"{where}:1 no counterpart file {port_module}"]
    jax_side = surface(_read(jax_root, module))
    port_side = surface(port_src)
    gaps = []
    for name, m in jax_side.items():
        if _absent_by_design(module, name, by_design):
            continue
        target = _port_name(module, name, by_design)
        if target not in port_side:
            gaps.append(f"{where}:{m.line} {name}: no {target} in "
                        f"{port_module}")
            continue
        theirs = port_side[target].params
        for p in m.params or ():
            row = by_design.get((module, f"{name}({p})"))
            if isinstance(row, str):
                continue
            want = row.name if isinstance(row, Renamed) else p
            if theirs is None or want not in theirs:
                gaps.append(f"{where}:{m.line} {name}: no parameter {want} "
                            f"in {port_module}::{target}")
    return gaps


def stale_rows(jax_root: str = JAX_PKG, port_root: str = PORT_PKG,
               by_design=BY_DESIGN) -> List[str]:
    """Rows that name nothing in the JAX package, or a member or
    parameter the port has under its JAX name: they could hide a gap."""
    stale = []
    for (module, key), row in by_design.items():
        name, _, param = key.partition("(")
        param = param.rstrip(")")
        jax_src = _read(jax_root, module)
        jax_side = surface(jax_src) if jax_src is not None else {}
        port_src = _read(port_root, PORT_FILE.get(module, module))
        port_side = surface(port_src) if port_src is not None else {}
        here = f"{module}: {key}"
        if name not in jax_side:
            stale.append(f"{here}: no {name} in the JAX package")
        elif param and param not in (jax_side[name].params or ()):
            stale.append(f"{here}: {name} has no parameter {param}")
        elif not param and name in port_side:
            stale.append(f"{here}: the port has {name}")
        elif param:
            target = port_side.get(_port_name(module, name, by_design))
            if target is None or param in (target.params or ()):
                stale.append(f"{here}: the port's counterpart "
                             + ("is missing" if target is None
                                else f"has {param}"))
    return stale


@pytest.mark.parametrize("module", jax_modules())
def test_port_has_the_jax_modules_surface(module):
    gaps = module_gaps(module)
    assert not gaps, ("members of the JAX package with no counterpart in "
                      "the port and no BY_DESIGN row:\n" + "\n".join(gaps))


def test_by_design_table_is_current():
    assert len(jax_modules()) >= 58
    stale = stale_rows()
    assert not stale, "stale BY_DESIGN rows:\n" + "\n".join(stale)
    for row in BY_DESIGN.values():
        reason = row.reason if isinstance(row, Renamed) else row
        assert reason.strip() and "\n" not in reason, row


def test_surface_checker_reports_each_kind_of_gap(tmp_path):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for root in (jax_root, port_root):
        (root / "sub").mkdir(parents=True)
    jax_src = ("def kept(a, b, axis=0):\n    pass\n"
               "def dropped(x):\n    pass\n"
               "def _private(x):\n    pass\n"
               "class Box:\n"
               "    def __init__(self, size):\n        pass\n"
               "    def open(self, key):\n        pass\n"
               "    def shut(self):\n        pass\n")
    (jax_root / "mod.py").write_text(jax_src)
    (jax_root / "sub" / "only_jax.py").write_text("def f():\n    pass\n")
    (port_root / "mod.py").write_text(
        "def kept(a, dim=0):\n    pass\n"
        "class Box:\n"
        "    def __init__(self, size):\n        pass\n"
        "    def open(self, generator):\n        pass\n")
    table = {("mod.py", "kept(axis)"): Renamed("dim", "torch"),
             ("mod.py", "Box.open(key)"): Renamed("generator", "torch")}
    gaps = module_gaps("mod.py", str(jax_root), str(port_root), table)
    assert gaps == [
        "jax/mod.py:1 kept: no parameter b in mod.py::kept",     # parameter
        "jax/mod.py:3 dropped: no dropped in mod.py",            # function
        "jax/mod.py:12 Box.shut: no Box.shut in mod.py"], gaps   # method
    assert module_gaps("sub/only_jax.py", str(jax_root), str(port_root),
                       table) == [
        "jax/sub/only_jax.py:1 no counterpart file sub/only_jax.py"]
    assert stale_rows(str(jax_root), str(port_root), table) == []
    stale = {("mod.py", "gone"): "a member JAX no longer has",
             ("mod.py", "kept"): "a member the port has",
             ("mod.py", "kept(a)"): "a parameter the port has",
             ("mod.py", "Box.open(lid)"): "a parameter JAX does not have"}
    assert stale_rows(str(jax_root), str(port_root), {**table, **stale}) == [
        "mod.py: gone: no gone in the JAX package",
        "mod.py: kept: the port has kept",
        "mod.py: kept(a): the port's counterpart has a",
        "mod.py: Box.open(lid): Box.open has no parameter lid"]
    # a Renamed row whose port name is missing is a gap of its own
    table[("mod.py", "dropped")] = Renamed("kept_too", "renamed")
    assert "jax/mod.py:3 dropped: no kept_too in mod.py" in module_gaps(
        "mod.py", str(jax_root), str(port_root), table)
