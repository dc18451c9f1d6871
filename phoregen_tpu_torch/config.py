"""Typed configuration system.

Mirrors the reference's single-YAML, four-section (`model/train/dataset/logger`)
schema (reference `configs/train_lig-phore.yml`) with explicit, typed
dataclasses instead of EasyDict, and makes the load-time feature-dim mutation
rules (reference `run/logger.py:76-110`, duplicated at `sample_all.py:41-43`)
an explicit, documented step (`finalize`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .constants import phore_feat_dim as _phore_feat_dim


def _build(cls, d: Dict[str, Any]):
    """Construct dataclass `cls` from a dict, recursing into nested configs."""
    if d is None:
        d = {}
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in d.items():
        if key not in names:
            continue  # tolerate unknown keys like the reference's EasyDict
        f = names[key]
        sub = _NESTED.get((cls.__name__, key))
        if sub is not None and isinstance(val, dict):
            kwargs[key] = _build(sub, val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


@dataclass
class ScheduleConfig:
    """One beta-schedule spec (reference `models/common.py:505-544`)."""
    beta_schedule: str = "advance"
    beta_start: float = 1e-7
    beta_end: float = 2e-3
    scale_start: float = 0.9999
    scale_end: float = 0.0001
    width: float = 3
    s: float = 0.008
    init_prob: Optional[str] = None  # 'tomask' | 'absorb' | 'uniform' | None
    time_segment: Optional[List[int]] = None
    segment_diff: Optional[List[Dict[str, Any]]] = None

    def schedule_kwargs(self) -> Dict[str, Any]:
        kw: Dict[str, Any] = {}
        if self.beta_schedule in ("quad", "linear", "const", "sigmoid"):
            kw.update(beta_start=self.beta_start, beta_end=self.beta_end)
        if self.beta_schedule == "sigmoid":
            kw.update(s=6)
        if self.beta_schedule == "cosine":
            kw.update(s=self.s)
        if self.beta_schedule == "advance":
            kw.update(scale_start=self.scale_start, scale_end=self.scale_end,
                      width=self.width)
        if self.beta_schedule == "segment":
            kw.update(time_segment=self.time_segment,
                      segment_diff=self.segment_diff)
        return kw


@dataclass
class DiffConfig:
    num_timesteps: int = 1000
    time_dim: int = 10
    categorical_space: str = "discrete"  # 'discrete' | 'continuous'
    scaling: List[float] = field(default_factory=lambda: [1.0, 1.0, 1.0])
    diff_pos: ScheduleConfig = field(default_factory=ScheduleConfig)
    diff_atom: ScheduleConfig = field(default_factory=lambda: ScheduleConfig(init_prob="tomask"))
    diff_bond: ScheduleConfig = field(default_factory=lambda: ScheduleConfig(init_prob="absorb"))


@dataclass
class DenoiserConfig:
    name: str = "uni_node_edge"
    num_blocks: int = 1
    num_layers: int = 6
    hidden_dim: int = 128
    n_heads: int = 16
    knn: int = 32
    edge_feat_dim: int = 4
    num_r_gaussian: int = 20
    act_fn: str = "relu"
    norm: bool = True
    cutoff_mode: str = "knn"
    r_max: float = 10.0
    x2h_out_fc: bool = False
    h_node_in_bond_net: bool = True
    direction_match: bool = True
    use_global_ew: bool = True
    # All-k triplet pool (`triplet_knn` 0 or >= NL-1): true = the
    # hand-written CUDA kernel of ops/pallas_triplet.py (nothing
    # O(NL^3)-sized reaches device memory; backward through the plain
    # version), false = its plain PyTorch version. The field keeps the JAX
    # package's name so checkpoints' configs load unchanged.
    use_pallas_triplet: bool = False
    # How the layer stack runs (models/denoiser.py): 'none' = per-layer
    # modules, kNN sets rebuilt every layer (the release checkpoints'
    # value); 'pallas' = the fused stack, four CUDA kernels per layer;
    # 'pallas3' = stages A and B1 merged (three kernels), 'pallas2' = B2
    # and C merged as well (two kernels); 'xla' / 'xla2' = the fused stack
    # through its plain PyTorch stages. Every value trains (the 'pallas*'
    # ones with kernels forward and the plain stages recomputed backward).
    # Fused modes freeze the layer-internal kNN index sets per block and
    # require the flagship configuration.
    fused_stack: str = "none"
    # 'bfloat16': on 'pallas*' the fused stack's inter-stage blocks (pre_t,
    # q_z) are stored in bf16 between the kernels, all arithmetic float32
    # (backward straight through); on 'xla2' the carries, packed weights
    # and feature products run in bf16. 'xla' and 'none' ignore it.
    fused_block_dtype: str = "float32"
    # How the attention layers' edge k/v MLPs are applied: same parameter
    # tree and algebra either way. 'split' applies the first linear layer
    # as per-input-block products (edge term on the grid, node terms on the
    # node axis), 'concat' materializes the [.., Fe+2H] grid concat and
    # applies each MLP whole.
    edge_mlp_apply: str = "split"
    # Freeze the layer-internal kNN tables (dire 3-NN, kNN triplet sources)
    # once per block on the module path.
    block_knn_freeze: bool = False
    # Triplet layer: 'factorized' (width-`triplet_width` per-triplet
    # features) or 'dense' (full hidden-width per-triplet MLPs). See
    # models/layers.py::BondUpdateTriplet.
    triplet_mode: str = "factorized"
    triplet_width: int = 32
    # Under bf16 compute the kNN triplet pool runs in bf16 (scores and
    # softmax float32); false pins it to float32. The all-k pool is always
    # float32.
    triplet_pool_follow_dtype: bool = True
    # Stacked per-layer parameters under `layers/layer` (leading layer
    # axis) instead of `layer_0..`; the port loops over layers either way.
    scan_layers: bool = True
    # Restrict the triplet source bond k->j to the K nearest neighbours of
    # j (0 = all k, exact): O(NL^2 K) instead of O(NL^3).
    triplet_knn: int = 0
    # Training only: recompute each layer in the backward
    # (torch.utils.checkpoint) on the module path and the 'xla' stacks.
    remat_layers: bool = True


@dataclass
class ModelConfig:
    name: str = "diffusion"
    num_atom_classes: int = 12
    num_bond_classes: int = 6
    lig_feat_dim: int = 12
    phore_feat_dim: int = 16
    hidden_dim: int = 128
    bond_diffusion: bool = True
    bond_net_type: str = "lin"  # 'lin' | 'pre_att'
    bond_len_loss: bool = False
    count_pred_type: str = "boundary"
    loss_weight: List[float] = field(default_factory=lambda: [1, 100, 100])
    count_factor: float = 1
    hp_emb_with_pos: bool = True
    # denoiser compute dtype for sampling ('float32' or 'bfloat16': bf16
    # parameters and features); posteriors and positions stay float32.
    compute_dtype: str = "float32"
    diff: DiffConfig = field(default_factory=DiffConfig)
    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)


@dataclass
class OptimizerConfig:
    type: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 1e-12


@dataclass
class SchedulerConfig:
    type: str = "plateau"
    lr_decay_factor: float = 0.9
    scheduler_patience: int = 20
    min_lr: float = 1e-6


@dataclass
class TrainConfig:
    seed: int = 2024
    parallel: bool = False
    batch_size: int = 8
    num_workers: int = 0
    epochs: int = 160
    n_report_steps: int = 3000
    ema: bool = True
    ema_decay: float = 0.9999
    clip_grad: bool = True
    clip_grad_mode: str = "queue"  # 'queue' | 'fixed'
    max_grad_norm: float = 10.0
    add_lig_noise: bool = True
    lig_noise_std: float = 0.1
    add_phore_noise: bool = True
    phore_noise_std: float = 0.1
    phore_norm_angle: float = 5.0
    freeze_pos: bool = False
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    # TPU-specific knobs
    data_axis: str = "data"            # mesh axis name for batch sharding
    num_devices: int = 0               # 0 = all local devices
    # the network's dtype in training ('bfloat16': mixed precision, float32
    # master parameters, optimizer state, EMA and losses)
    dtype: str = "float32"


@dataclass
class DatasetConfig:
    cut_data: bool = False
    zinc_train_filelist: str = ""
    zinc_valid_filelist: str = ""
    zinc_test_filelist: str = ""
    pdbbind_filelist: str = ""
    save_path: str = ""
    checkpoint: str = ""
    remove_H: bool = True
    center: str = "phore"
    pg_data: str = "mol_phore"
    data_name: str = "zinc_300"
    max_atom: int = 78
    charge_weight: float = 0.0
    include_hybrid: bool = False
    hybrid_one_hot: bool = False
    add_core_atoms: bool = False
    include_valencies: bool = False
    include_ring: bool = False
    include_aromatic: bool = False
    include_neib_dist: bool = False
    # TPU-specific padding/bucketing (§7.1 of SURVEY.md): molecules are padded
    # to the smallest bucket >= n_atoms; phore points padded to max_phore.
    ligand_buckets: List[int] = field(default_factory=lambda: [16, 32, 48, 64, 80])
    max_phore: int = 96
    # Hermetic-corpus generator for environments without the ZINC/PDBBind
    # archives: "chains" = the legacy chain pseudo-molecules (fast, tiny
    # phores), "mixed" = branched/ring molecules, half anchored to the 685
    # bundled real pharmacophores (data/real_phores/), half free-grown with
    # derived phores + EX shells (realistic 10-96-point conditioning).
    corpus: str = "mixed"
    # fraction of "mixed" samples anchored to real phores
    real_frac: float = 0.5


@dataclass
class LoggerConfig:
    result: str = "./results"
    run_name: str = "run"
    restart: str = "none"  # none|overwrite|backup|inplace|finetuning
    restart_dir: str = ""
    model_ckp: str = "last"
    tensorboard: bool = True
    # capture a torch.profiler trace of N train steps of the first epoch
    # into <run_dir>/profile (0 = off)
    profile_steps: int = 0


_NESTED = {
    ("ModelConfig", "diff"): DiffConfig,
    ("ModelConfig", "denoiser"): DenoiserConfig,
    ("DiffConfig", "diff_pos"): ScheduleConfig,
    ("DiffConfig", "diff_atom"): ScheduleConfig,
    ("DiffConfig", "diff_bond"): ScheduleConfig,
    ("TrainConfig", "optimizer"): OptimizerConfig,
    ("TrainConfig", "scheduler"): SchedulerConfig,
    ("Config", "model"): ModelConfig,
    ("Config", "train"): TrainConfig,
    ("Config", "dataset"): DatasetConfig,
    ("Config", "logger"): LoggerConfig,
}


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    logger: LoggerConfig = field(default_factory=LoggerConfig)

    def finalize(self) -> "Config":
        """Apply the load-time feature-dim mutation rules.

        Reference: `run/logger.py:76-110` bumps `phore_feat_dim` by 2 for the
        13-type CV-split datasets and bumps `lig_feat_dim` for the optional
        feature flags. We recompute phore_feat_dim from the vocabulary and
        apply the same lig_feat_dim increments.
        """
        ds = self.dataset
        m = self.model
        m.phore_feat_dim = _phore_feat_dim(ds.data_name)
        lig = 12  # base one-hot over 12 atom classes
        if ds.include_hybrid:
            lig += 4 if ds.hybrid_one_hot else 1
        if ds.add_core_atoms:
            lig += 1
        if ds.include_valencies:
            lig += 1
        if ds.include_ring:
            lig += 1
        if ds.include_aromatic:
            lig += 1
        if ds.include_neib_dist:
            lig += 2
        m.lig_feat_dim = lig
        assert m.compute_dtype in ("float32", "bfloat16"), (
            f"model.compute_dtype must be float32 or bfloat16, "
            f"got {m.compute_dtype!r}")
        assert self.train.dtype in ("float32", "bfloat16"), (
            f"train.dtype must be float32 or bfloat16, "
            f"got {self.train.dtype!r}")
        assert m.denoiser.triplet_knn >= 0, (
            "denoiser.triplet_knn must be >= 0 (0 = exact full-k)")
        assert m.denoiser.triplet_mode in ("factorized", "dense"), (
            f"unknown denoiser.triplet_mode {m.denoiser.triplet_mode!r}")
        assert m.denoiser.cutoff_mode in ("knn", "radius", "hybrid"), (
            f"unsupported denoiser.cutoff_mode {m.denoiser.cutoff_mode!r} "
            "(supported: knn, radius, hybrid)")
        assert m.denoiser.hidden_dim == m.hidden_dim, (
            "denoiser.hidden_dim must equal model.hidden_dim "
            "(reference models/diffusion.py:51)")
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def load_config(path: str) -> Config:
    # PyYAML is imported here only: sampling reads the checkpoint's JSON
    # sidecar and must not need it
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return _build(Config, raw).finalize()


def config_from_dict(raw: Dict[str, Any]) -> Config:
    return _build(Config, raw).finalize()


def default_config(data_name: str = "zinc_300") -> Config:
    cfg = Config()
    cfg.dataset.data_name = data_name
    return cfg.finalize()
