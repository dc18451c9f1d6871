"""Small host utilities: seeding and yaml / json / pickle files.

Counterpart of `phoregen_tpu/utils/misc.py`, the same functions and
semantics.
"""
from __future__ import annotations

import json
import os
import pickle
import random
from typing import Any

import numpy as np
import yaml


def seed_all(seed: int) -> None:
    """Seed the host RNGs (`random`, numpy). The port's draws take explicit
    `torch.Generator`s, as the JAX package's take keys, so torch's global
    generator needs no seeding."""
    random.seed(seed)
    np.random.seed(seed)


def load_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


def save_yaml(path: str, obj: Any) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(path: str, obj: Any) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=str)


def load_pkl(path: str) -> Any:
    """Unpickle `path` freely: only for files this program wrote
    (`data/dataset.py` reads dataset pickles through a restricted
    unpickler)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pkl(path: str, obj: Any) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)
