"""The port imports torch and never JAX, flax, msgpack or the JAX package."""
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
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'msgpack', 'phoregen_tpu'):\n"
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
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|msgpack|"
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
