"""Per-pharmacophore generation pool with a retry budget and outputs.

Counterpart of `phoregen_tpu/sample/pipeline.py::GenerationPipeline`
(single device, in-process reconstruction): for one pharmacophore, sample
batches of at most `batch_size` graphs until `num_samples` molecules pass
reconstruction (valence check and a connected molecule), or the failure
budget (3 x num_samples) is spent; write per-molecule SDF, the SMILES list
and a timing row.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import MAX_ATOMS, MIN_ATOMS
from ..data.batching import collate, pad_sample, pick_bucket, replicate_phore
from ..data.phore import Phore, featurize_phore
from .chem import MolReconsError, mol_to_smiles
from .decode import decode_batch
from .reconstruct import reconstruct_from_generated_with_edges
from .sampler import GuidanceOpt, Sampler
from .writers import append_timing, write_sdf, write_smiles


class GenerationPipeline:
    def __init__(self, pg, guidance: Optional[Sequence[GuidanceOpt]] = None,
                 sample_nodes_mode: str = "uniform", normal_scale: float = 4.0,
                 add_edge: str = "predicted", batch_size: int = 30,
                 seed: int = 2024, sample_steps: int = 0,
                 device="cuda"):
        self.pg = pg
        self.cfg = pg.config
        self.device = torch.device(device)
        self.sampler = Sampler(pg, guidance=guidance,
                               sample_steps=sample_steps)
        self.sample_nodes_mode = sample_nodes_mode
        self.normal_scale = normal_scale
        self.add_edge = add_edge
        self.batch_size = batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.last_bucket = None
        self.sample_seconds = 0.0   # reverse loops incl. the host copy

    def _count_interval(self, phore_sample: Dict) -> Tuple[int, int]:
        batch = collate([phore_sample]).to(self.device)
        lo, up = self.sampler.predict_count_interval(batch)
        lo = max(MIN_ATOMS, min(int(lo[0]), MAX_ATOMS))
        up = max(lo, min(int(up[0]), MAX_ATOMS))
        return lo, up

    def prepare_phore(self, phore: Phore) -> Dict:
        """Featurize, center and pad one pharmacophore into a sample dict
        with empty ligand stubs; EX volumes beyond `max_phore` points are
        subsampled (`data/realcorpus.py::cap_phore`)."""
        ds = self.cfg.dataset
        n_cr = sum(1 for f in phore.features if f.type == "CR")
        if len(phore.features) - n_cr > ds.max_phore:
            from ..data.realcorpus import cap_phore
            capped = cap_phore(phore, ds.max_phore,
                               np.random.default_rng(self.seed))
            print(f"[W] {phore.name}: {len(phore.features)} phore points > "
                  f"max_phore={ds.max_phore}; EX volumes subsampled to "
                  f"{len(capped.features)}")
            phore = capped
        feats, pos, norm, center = featurize_phore(phore, ds.data_name,
                                                   norm_mode="new")
        return pad_sample(
            np.zeros(0, np.int32), np.zeros((0, 3), np.float32), None, None,
            feats, pos - center, norm, center, min(ds.ligand_buckets),
            ds.max_phore)

    def sample_pool(self, phore_sample: Dict, n_graphs: int, lower: int,
                    upper: int) -> Tuple[List[Dict], Dict]:
        """One sampling batch -> (decoded per-molecule dicts, raw output)."""
        ds = self.cfg.dataset
        t0 = time.time()
        counts = Sampler.sample_counts(self.rng, lower, upper, n_graphs,
                                       mode=self.sample_nodes_mode,
                                       scale=self.normal_scale)
        n_lig = pick_bucket(int(counts.max()), ds.ligand_buckets)
        self.last_bucket = n_lig
        batch = replicate_phore(phore_sample, n_graphs, counts, n_lig
                                ).to(self.device)
        out = self.sampler.sample(batch, self.generator)
        arrays = [out[k].detach().cpu().numpy()
                  for k in ("pred_node", "pred_pos", "pred_edge", "lig_mask")]
        self.sample_seconds += time.time() - t0
        return decode_batch(*arrays, include_bond=True), out

    def reconstruct(self, mol_info: Dict):
        """(mol, smiles) or raises MolReconsError."""
        mol = reconstruct_from_generated_with_edges(mol_info,
                                                    add_edge=self.add_edge)
        smiles = mol_to_smiles(mol)
        if smiles is None or "." in smiles:
            raise MolReconsError("disconnected molecule")
        return mol, smiles

    def generate(self, phore: Phore, num_samples: int,
                 out_dir: Optional[str] = None,
                 fail_budget_factor: int = 3,
                 time_budget: float = 0.0, max_batches: int = 0) -> Dict:
        """Sample pools until `num_samples` molecules are accepted, the
        failure budget is spent, `time_budget` seconds pass (0 = none) or
        `max_batches` pools ran (0 = no limit)."""
        t0 = time.time()
        name = phore.name or "phore"
        phore_sample = self.prepare_phore(phore)
        lower, upper = self._count_interval(phore_sample)
        mols, smiles_list = [], []
        n_failed = n_sampled = 0
        budget = fail_budget_factor * num_samples
        timed_out = False
        n_batches = 0
        while len(mols) < num_samples and n_failed < budget:
            if max_batches and n_batches >= max_batches:
                break
            if time_budget and time.time() - t0 > time_budget:
                timed_out = True
                break
            n = min(self.batch_size, num_samples - len(mols))
            decoded, _ = self.sample_pool(phore_sample, n, lower, upper)
            n_sampled += n
            n_batches += 1
            for info in decoded:
                try:
                    mol, smi = self.reconstruct(info)
                except MolReconsError:
                    n_failed += 1
                    continue
                mols.append(mol)
                smiles_list.append(smi)
        elapsed = time.time() - t0
        if out_dir:
            mol_dir = os.path.join(out_dir, name)
            os.makedirs(mol_dir, exist_ok=True)
            for i, mol in enumerate(mols):
                write_sdf(mol, os.path.join(mol_dir, f"{i}.sdf"),
                          name=f"{name}_{i}")
            write_smiles(smiles_list,
                         os.path.join(mol_dir, f"{name}_smiles.txt"))
            append_timing(os.path.join(out_dir, "time_chain.txt"), name,
                          len(mols), elapsed)
        return {"name": name, "mols": mols, "smiles": smiles_list,
                "n_finished": len(mols), "n_failed": n_failed,
                "n_sampled": n_sampled, "count_interval": (lower, upper),
                "seconds": elapsed, "abandoned": len(mols) < num_samples,
                "timed_out": timed_out}
