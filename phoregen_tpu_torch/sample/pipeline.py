"""Per-pharmacophore generation pool with a retry budget and outputs.

Counterpart of `phoregen_tpu/sample/pipeline.py::GenerationPipeline`:
for one pharmacophore, sample batches of at most `batch_size`
graphs until `num_samples` molecules pass reconstruction (valence check
and a connected molecule), or the failure budget (3 x num_samples) is
spent; write per-molecule SDF, the SMILES list, a timing row and, with
`save_pool`, the raw sampled pools (`<name>_samples_all.npz`).

A batch that runs the card out of memory (`torch.cuda.OutOfMemoryError`,
and nothing else) is charged to the failure budget whole and retried at
half the size. With `recon_workers` > 0 reconstruction runs in a pool of
that many `spawn` processes (`reconstruct.recon_task`; the workers import
no torch), shut down by `close()`.

`devices` (a list of more than one device, where the JAX pipeline takes a
`mesh`) shards each pool's graphs over them: the pool is rounded up to a
multiple of the list's length (the extra rows are real pool members),
the model is replicated to each device, and each shard's reverse loop
runs on its own device with no collective (`sampler.sample_lockstep`).
A shard draws its rows of the pool's draws (`ops/draws.BatchRows`) and
takes the pool's size as the guidance means' divisor, so the sharded pool
equals the unsharded pool on the same seed. The shards are gathered
before decoding. `chunk_steps` > 0 runs unsharded, with a warning, as in
the JAX CLI.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import MAX_ATOMS, MIN_ATOMS
from ..data.batching import (PhoreGraphBatch, collate, pad_sample,
                             pick_bucket, replicate_phore)
from ..data.phore import Phore, featurize_phore, parse_phore_file
from .chem import MolReconsError, SimpleMol, mol_to_smiles
from .decode import decode_batch
from .reconstruct import reconstruct_from_generated_with_edges
from ..ops.draws import BatchRows
from .sampler import GuidanceOpt, Sampler, sample_lockstep
from .writers import append_sdf, append_timing, write_sdf, write_smiles


class GenerationPipeline:
    def __init__(self, pg, guidance: Optional[Sequence[GuidanceOpt]] = None,
                 sample_nodes_mode: str = "uniform", normal_scale: float = 4.0,
                 add_edge: str = "predicted", batch_size: int = 30,
                 keep_traj: bool = False, seed: int = 2024,
                 sample_steps: int = 0, device="cuda", chunk_steps: int = 0,
                 recon_workers: int = 0, devices: Optional[Sequence] = None):
        self.pg = pg
        self.cfg = pg.config
        self.device = torch.device(device)
        self.chunk_steps = chunk_steps
        devices = [torch.device(d) for d in devices or ()]
        if len(devices) > 1 and chunk_steps > 0:
            print(f"[W] sampling devices ({len(devices)}) are ignored with "
                  "chunk_steps > 0 (chunked execution is single-device); "
                  "running unsharded")
            devices = []
        self.devices = devices if len(devices) > 1 else [self.device]
        self._recon_pool = None
        if recon_workers > 0:
            import concurrent.futures as cf
            import multiprocessing as mp
            # spawn, never fork: the parent holds a live CUDA context
            self._recon_pool = cf.ProcessPoolExecutor(
                recon_workers, mp_context=mp.get_context("spawn"))
        self.sampler = Sampler(pg, guidance=guidance, keep_traj=keep_traj,
                               sample_steps=sample_steps)
        # one sampler (and model replica) per distinct device of the shards
        samplers = {next(pg.net.parameters()).device: self.sampler}
        for dev in self.devices:
            if dev not in samplers:
                rep = copy.deepcopy(pg)
                rep.net.to(dev)
                samplers[dev] = Sampler(rep, guidance=guidance,
                                        keep_traj=keep_traj,
                                        sample_steps=sample_steps)
        self._samplers = [samplers[d] for d in self.devices]
        self.keep_traj = keep_traj
        self.sample_nodes_mode = sample_nodes_mode
        self.normal_scale = normal_scale
        self.add_edge = add_edge
        self.batch_size = batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # a shard draws the whole pool's numbers from a generator of its
        # own, seeded alike, and keeps its rows
        self._generators = [self.generator] if len(self.devices) == 1 else [
            torch.Generator(device=d).manual_seed(seed) for d in self.devices]
        self.last_bucket = None
        self.sample_seconds = 0.0   # reverse loops incl. the host copy

    def close(self) -> None:
        """Shut the reconstruction workers down (if any)."""
        if self._recon_pool is not None:
            self._recon_pool.shutdown()
            self._recon_pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

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
        """One sampling batch -> (decoded per-molecule dicts, raw output).
        Sharded over `devices`, the pool is `n_graphs` rounded up to a
        multiple of their number, all of it decoded."""
        ds = self.cfg.dataset
        t0 = time.time()
        nd = len(self.devices)
        n_graphs = -(-n_graphs // nd) * nd
        counts = Sampler.sample_counts(self.rng, lower, upper, n_graphs,
                                       mode=self.sample_nodes_mode,
                                       scale=self.normal_scale)
        n_lig = pick_bucket(int(counts.max()), ds.ligand_buckets)
        self.last_bucket = n_lig
        batch = replicate_phore(phore_sample, n_graphs, counts, n_lig)
        if nd == 1:
            out = self.sampler.sample(batch.to(self.device), self.generator,
                                      chunk_steps=self.chunk_steps)
        else:
            out = self._sample_shards(batch, n_graphs)
        arrays = [None if out[k] is None else out[k].detach().cpu().numpy()
                  for k in ("pred_node", "pred_pos", "pred_edge", "lig_mask")]
        self.sample_seconds += time.time() - t0
        return decode_batch(
            *arrays, include_bond=self.cfg.model.bond_diffusion), out

    def _sample_shards(self, batch, n_graphs: int) -> Dict:
        """The pool's reverse processes, shard k (rows [k*per, (k+1)*per))
        on device k, in lockstep; their outputs gathered on the first
        device in row order."""
        per = n_graphs // len(self.devices)
        runs = []
        for k, (dev, sampler, gen) in enumerate(zip(
                self.devices, self._samplers, self._generators)):
            rows = slice(k * per, (k + 1) * per)
            shard = PhoreGraphBatch(**{
                f.name: getattr(batch, f.name)[rows]
                for f in dataclasses.fields(batch)}).to(dev)
            runs.append((dev, sampler.steps(
                shard, BatchRows(gen, rows.start, rows.stop, n_graphs),
                pool_size=n_graphs)))
        outs = sample_lockstep(runs)
        home = self.devices[0]

        def cat(parts, dim=0):
            if parts[0] is None:
                return None
            if isinstance(parts[0], dict):
                return {k: cat([p[k] for p in parts], dim) for k in parts[0]}
            return torch.cat([p.to(home) for p in parts], dim)
        out = {k: cat([o[k] for o in outs]) for k in outs[0]
               if k != "traj"}
        if "traj" in outs[0]:   # [S+1, B, ...]: graphs on axis 1
            out["traj"] = cat([o["traj"] for o in outs], 1)
        return out

    def reconstruct(self, mol_info: Dict):
        """(mol, smiles) or raises MolReconsError."""
        mol = reconstruct_from_generated_with_edges(mol_info,
                                                    add_edge=self.add_edge)
        smiles = mol_to_smiles(mol)
        if smiles is None or "." in smiles:
            raise MolReconsError("disconnected molecule")
        return mol, smiles

    def _write_traj(self, raw: Dict, graph_idx: int, path: str,
                    stride: int = 10) -> None:
        """Decode every `stride`-th sampled state of one graph into an SDF
        trajectory."""
        traj = raw.get("traj")
        if traj is None:
            return
        ka = self.cfg.model.num_atom_classes
        kb = self.cfg.model.num_bond_classes
        node = traj["node"][:, graph_idx].cpu().numpy()
        pos = traj["pos"][:, graph_idx].cpu().numpy()
        edge = traj["edge"][:, graph_idx].cpu().numpy()
        if not np.issubdtype(node.dtype, np.floating):
            # class ids -> one-hots; relaxed one-hots decode by argmax as
            # they are
            node, edge = np.eye(ka)[node.astype(int)], \
                np.eye(kb)[edge.astype(int)]
        mask = raw["lig_mask"][graph_idx].cpu().numpy()
        with open(path, "w") as f:
            for step in range(0, len(node), stride):
                fr = decode_batch(node[step][None], pos[step][None],
                                  edge[step][None], mask[None],
                                  include_bond=self.cfg.model.bond_diffusion
                                  )[0]
                mol = SimpleMol(fr["element"], fr["atom_pos"],
                                fr["bond_index"], fr["bond_type"])
                append_sdf(mol, f, name=f"step_{step}")

    def generate(self, phore: Phore, num_samples: int,
                 out_dir: Optional[str] = None,
                 fail_budget_factor: int = 3, save_pool: bool = False,
                 traj_stride: int = 10, traj_prob: float = 1.0,
                 time_budget: float = 0.0, max_batches: int = 0) -> Dict:
        """Sample pools until `num_samples` molecules are accepted, the
        failure budget is spent, `time_budget` seconds pass (0 = none) or
        `max_batches` pools ran (0 = no limit; a batch that ran out of
        device memory does not count). With `keep_traj`, each accepted
        molecule's trajectory is written with probability `traj_prob`,
        every `traj_stride`-th state. `save_pool` writes every sampled
        pool's raw output as `<name>_samples_all.npz` with keys
        `{pred_node,pred_pos,pred_edge,lig_mask}_<i>` (no pred_edge
        without `bond_diffusion`)."""
        t0 = time.time()
        name = phore.name or "phore"
        traj_rng = np.random.default_rng(self.seed)
        phore_sample = self.prepare_phore(phore)
        lower, upper = self._count_interval(phore_sample)
        mols, smiles_list, trajs, pool = [], [], [], []
        n_failed = n_sampled = 0
        budget = fail_budget_factor * num_samples
        timed_out = False
        n_batches = 0
        cur_batch = self.batch_size
        while len(mols) < num_samples and n_failed < budget:
            if max_batches and n_batches >= max_batches:
                break
            if time_budget and time.time() - t0 > time_budget:
                timed_out = True
                print(f"[W] {name}: per-phore time budget "
                      f"({time_budget:.0f}s) exhausted with "
                      f"{len(mols)}/{num_samples} accepted", flush=True)
                break
            n = min(cur_batch, num_samples - len(mols))
            try:
                decoded, raw = self.sample_pool(phore_sample, n, lower,
                                                upper)
            except torch.cuda.OutOfMemoryError:
                # the whole batch counts against the budget; the retry is
                # half the size so that it fits
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                n_failed += n
                cur_batch = max(1, n // 2)
                print(f"[W] {name}: sampling batch of {n} ran out of device "
                      f"memory; retrying with batch {cur_batch} "
                      f"({n_failed}/{budget} failures)", flush=True)
                continue
            n_sampled += len(decoded)
            n_batches += 1
            if save_pool:
                pool.append({k: raw[k].detach().cpu().numpy()
                             for k in ("pred_node", "pred_pos", "pred_edge",
                                       "lig_mask") if raw[k] is not None})
            results = None
            if self._recon_pool is not None:
                from .reconstruct import recon_task
                results = list(self._recon_pool.map(
                    recon_task, decoded, [self.add_edge] * len(decoded)))
            for gi, info in enumerate(decoded):
                if len(mols) >= num_samples:
                    break  # surplus rows of a pool rounded up to the shards
                if results is not None:
                    ok, payload = results[gi]
                    if not ok:
                        n_failed += 1
                        continue
                    mol, smi = payload
                else:
                    try:
                        mol, smi = self.reconstruct(info)
                    except MolReconsError:
                        n_failed += 1
                        continue
                mols.append(mol)
                smiles_list.append(smi)
                info["accepted"] = True
                if self.keep_traj and traj_rng.random() < traj_prob:
                    trajs.append((raw, gi))
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
            if save_pool and pool:
                np.savez_compressed(
                    os.path.join(mol_dir, f"{name}_samples_all.npz"),
                    **{f"{k}_{i}": v for i, d in enumerate(pool)
                       for k, v in d.items()})
            for i, (raw, gi) in enumerate(trajs):
                self._write_traj(raw, gi,
                                 os.path.join(mol_dir, f"traj_{i}.sdf"),
                                 stride=traj_stride)
        return {"name": name, "mols": mols, "smiles": smiles_list,
                "n_finished": len(mols), "n_failed": n_failed,
                "n_sampled": n_sampled, "count_interval": (lower, upper),
                "seconds": elapsed, "abandoned": len(mols) < num_samples,
                "timed_out": timed_out}

    def generate_from_file(self, phore_path: str, num_samples: int,
                           out_dir: Optional[str] = None) -> Dict:
        """`generate` on the phore that `parse_phore_file` reads."""
        return self.generate(parse_phore_file(phore_path), num_samples,
                             out_dir)
