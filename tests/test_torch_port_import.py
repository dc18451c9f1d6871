"""The port imports torch and never JAX, flax, optax, msgpack or the JAX
package: every module of it, the trainer, the data pipeline and the CLIs
included."""
import os
import pkgutil
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "phoregen_tpu_torch")


def _modules():
    import phoregen_tpu_torch
    return ["phoregen_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(phoregen_tpu_torch.__path__,
                                              "phoregen_tpu_torch.")]


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "phoregen_tpu_torch.ops.layer_stack" in mods
    for m in ("train.state", "train.step", "train.checkpoint", "train.logger",
              "train.loop", "cli.train", "cli.sample", "data.transforms",
              "data.synthetic", "data.realcorpus", "data.loader",
              "data.dataset", "data.sdf", "data.mol", "data.phorefp",
              "data.surface", "data.ligphore", "utils.evalacc",
              "utils.misc", "utils.profiling", "ops.mdn"):
        assert f"phoregen_tpu_torch.{m}" in mods, m
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
            "          'phoregen_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_jax_import_in_source():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|msgpack|"
                     r"phoregen_tpu)(\s|\.|$)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if bad.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders
