"""The dense cell at a size a CPU test run holds: the configuration of
`sample-dense-module` at hidden 16 with 4 heads, 2 layers and kNN 8, its
seeded checkpoint written the way `scripts/make_upstream_dense.py` writes
the cell's own (count heads pinned to 5-9 atoms, bucket 16), pools of 3,
a check of every kept step, a few steps a window."""
import copy
import importlib.util
import json
import os

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = "sample-dense-module"


def checkpoint_script():
    """`scripts/make_upstream_dense.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        "make_upstream_dense",
        os.path.join(ROOT, "scripts", "make_upstream_dense.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_config(conf):
    """The cell's configuration dict cut to the test's size, in place."""
    m, d = conf["model"], conf["model"]["denoiser"]
    m["hidden_dim"] = d["hidden_dim"] = 16
    d["n_heads"] = 4
    d["num_layers"] = 2
    d["knn"] = 8
    conf["dataset"]["ligand_buckets"] = [8, 16]
    return conf


def small_dense_cell(tmp_path):
    from phoregen_tpu_torch.config import config_from_dict
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = harness.Cell(bench, NAME, ROOT)
    cell.config = copy.deepcopy(cell.config)
    conf = small_config(cell.config["config"])
    prefix = os.path.join(str(tmp_path), "dense_small")
    checkpoint_script().write(prefix, config_from_dict(conf), (5, 9))
    cell.config["checkpoint"] = prefix
    cell.traffic = dict(cell.traffic, batch=3, check_every=1, check_max=3,
                        trace_steps=2)
    return cell
