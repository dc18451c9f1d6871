"""The import guard: a run refuses JAX and the JAX package, compared by
whole top-level names (`phoregen_tpu_torch` is not `phoregen_tpu`), and
the plain reference imports nothing of the program or of JAX."""
import ast
import os
import subprocess
import sys
import types

import pytest

from portbench import harness

REF = os.path.join("portbench", "reference")


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "phoregen_tpu_torch_fake",
                        types.ModuleType("phoregen_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake",
                        types.ModuleType("jaxtyping_fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "phoregen_tpu.ops",
                        types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jax", "phoregen_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "reference")) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program(name):
    tops = set(_imports(os.path.join(REF, name)))
    assert not tops & {"phoregen_tpu_torch", "phoregen_tpu", "jax",
                       "jaxlib", "flax", "portbench"}, tops


def test_a_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "sample-lig-module", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120, env=dict(os.environ,
                                             CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_run_without_the_program_fails(tmp_path):
    import shutil
    shutil.copy("BENCHMARK.json", tmp_path)
    shutil.copytree("portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "sample-lig-module", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


DRIVER = '''
import sys
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
from portbench import harness, run


class Kind:
    @staticmethod
    def run(cell, seed, seconds, traced, device, t_origin):
        return {"correct": True, "attempted": 1, "failed": 0,
                "device": {"platform": "gpu", "kind": "stub", "count": 1,
                           "memory_peak_bytes": 1},
                "record": {"kind": "stub", "dev": [], "host": []},
                "checks": [("net_err", 0.0, 1.0)]}


harness.kind_module = lambda kind: Kind
sys.exit(run.main(["--workload", "sample-lig-module", "--seed", "1",
                   "--seconds", "1", "--trace", "1"]))
'''


@pytest.mark.parametrize("planted", [False, True])
def test_a_metric_reader_that_loads_jax_fails_the_run(tmp_path, planted):
    """The guard looks once every metric reader has been loaded: a reader
    that imports a module named `jax` (here a stub in the checkout) makes
    the run print no result and exit non-zero."""
    import json
    import shutil
    bench = json.load(open("BENCHMARK.json"))
    shutil.copytree("portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    reader = "import jax\n" if planted else ""
    (tmp_path / "portbench" / "metrics" / "planted.sample.py").write_text(
        reader + "\n\ndef read(rec):\n    return 1.0\n")
    bench["per_layer"].append({
        "name": "planted.sample", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "sample_mol_per_s", "workloads": ["sample-lig-module"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "driver.py").write_text(DRIVER)
    r = subprocess.run([sys.executable, "driver.py"], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path)
    if planted:
        assert r.returncode != 0 and r.stdout.strip() == "", r.stdout
        assert "jax" in r.stderr
    else:
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout.splitlines()[-1])["metrics"][
            "planted.sample"]["value"] == 1.0
