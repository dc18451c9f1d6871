"""The plain reference of the fine-tune's first train steps, float32:
the training batch rebuilt from the benchmark's corpus, the forward
noising with the step's draws, the joint loss (positions, atom and bond
types, the atom-count interval), its gradients by autograd, the
queue-based gradient clip and Adam, as the JAX package's train step
computes them. It imports nothing of the measured program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .constants import MAX_ATOMS, MIN_ATOMS
from .masked import masked_sums
from .precision import RoundedOutputs
from .sampling import RefModel

QUEUE_LEN = 50
QUEUE_SEED = 3000.0


def _rotation_angle_ok(a: np.ndarray, b: np.ndarray, deg: float) -> bool:
    cos = float(np.clip(np.dot(a, b), -1.0, 1.0))
    return np.degrees(np.arccos(cos)) <= deg + 1e-3


def rebuild_batch(rows: Dict[str, np.ndarray], corpus: Sequence,
                  noise_std: float, angle_deg: float, device
                  ) -> Tuple[Dict[str, torch.Tensor], List[int], int]:
    """The batch a loader should have made: each row's sample found in
    `corpus` by its ligand (types and positions, which the loader does not
    alter), padded here; the row's phore positions and normals are the
    loader's noisy ones, after a check that they are the sample's moved by
    at most 8 standard deviations of the noise and turned by at most
    `angle_deg`. Returns (tensors, corpus index of each row, rows that
    fail the check)."""
    key = {s.lig_pos.astype(np.float32).tobytes(): i
           for i, s in enumerate(corpus)}
    B, NL = rows["lig_mask"].shape
    NP = rows["phore_mask"].shape[1]
    out = {k: np.zeros_like(rows[k]) for k in (
        "lig_type", "lig_pos", "lig_mask", "bond_type", "phore_x",
        "phore_pos", "phore_norm", "phore_mask", "center")}
    idx, bad = [], 0
    for r in range(B):
        n = int(rows["lig_mask"][r].sum())
        i = key.get(np.asarray(rows["lig_pos"][r, :n], np.float32).tobytes())
        if i is None:
            bad += 1
            idx.append(-1)
            continue
        s = corpus[i]
        idx.append(i)
        p = len(s.phore_x)
        out["lig_type"][r, :n] = s.lig_type
        out["lig_pos"][r, :n] = s.lig_pos
        out["lig_mask"][r, :n] = True
        if s.bond_index is not None and s.bond_index.size:
            out["bond_type"][r][s.bond_index[0], s.bond_index[1]] = \
                s.bond_attr
        out["phore_x"][r, :p] = s.phore_x
        out["phore_mask"][r, :p] = True
        out["center"][r] = s.center
        pos, norm = rows["phore_pos"][r], rows["phore_norm"][r]
        ok = (np.abs(pos[:p] - s.phore_pos).max() <= 8 * noise_std
              and not pos[p:].any() and not norm[p:].any())
        for j in range(p):
            if np.linalg.norm(s.phore_norm[j]) > 1e-6:
                ok &= abs(np.linalg.norm(norm[j]) - 1.0) < 1e-4 and \
                    _rotation_angle_ok(norm[j], s.phore_norm[j], angle_deg)
            else:
                ok &= not norm[j].any()
        bad += not ok
        out["phore_pos"][r], out["phore_norm"][r] = pos, norm
    return ({k: torch.as_tensor(v, device=device) for k, v in out.items()},
            idx, bad)


def qd_loss(y_true, y_l, y_u, a=0.05, s=160.0, nd=15.0, factor=1.0,
            eps=1e-12):
    """Quality-driven interval loss (soft PICP / MPIW) over the batch's
    graphs; y_*: [B, 1]."""
    k_h = torch.relu(torch.sign(y_u - y_true)) * torch.relu(
        torch.sign(y_true - y_l))
    k_s = torch.sigmoid((y_u - y_true) * s) * torch.sigmoid(
        (y_true - y_l) * s)
    n = torch.tensor(float(y_true.shape[0]), device=y_true.device)
    mpiw_c = ((y_u - y_l) * k_h).sum() / (k_h.sum() + eps) * factor
    picp = k_s.sum() / torch.clamp(n, min=1.0)
    return mpiw_c + torch.relu((1 - a) - picp) ** 2 * (n ** 0.5) * nd


class RefTrainer(RefModel):
    """The release weights under the fine-tune's configuration, trained
    in float32."""

    def __init__(self, config: Dict, prefix: str, device):
        super().__init__(config, prefix, device)
        self.net.train()
        self.tcfg = self.cfg.train
        # no recomputation in the backward: the same gradients, and a
        # lower-precision control then rounds the one forward it has
        self.cfg.model.denoiser.remat_layers = False

    def loss(self, b: Dict[str, torch.Tensor], d: Dict[str, torch.Tensor],
             dtype: torch.dtype = torch.float32):
        """The joint loss of batch `b` under the draws `d` (t, jitter,
        pos_noise, node_uniform, edge_uniform). `dtype` bfloat16 runs the
        network on bf16 copies of the parameters and bf16 features (the
        configuration's mixed precision; positions stay float32), its
        predictions widened to float32 before the losses."""
        mcfg = self.cfg.model
        t = d["t"].long()
        lig_pos = b["lig_pos"]
        if self.tcfg.add_lig_noise:
            lig_pos = lig_pos + self.tcfg.lig_noise_std * d["jitter"]
        pos_pert = self.pos_trans.add_noise(lig_pos, t, None, d["pos_noise"])
        h_node, log_node_t, log_node_0 = self.node_trans.add_noise(
            b["lig_type"], t, None, d["node_uniform"])
        h_edge, log_edge_t, log_edge_0 = self.edge_trans.add_noise(
            b["bond_type"], t, None, d["edge_uniform"])
        args = (h_node.to(dtype), pos_pert, b["lig_mask"], h_edge.to(dtype),
                t, b["phore_x"].to(dtype), b["phore_pos"], b["phore_norm"],
                b["phore_mask"])
        if dtype == torch.float32:
            preds = self.net(*args)
        else:
            preds = torch.func.functional_call(
                self.net, {n: p.to(dtype) for n, p in
                           self.net.named_parameters()}, args)
        pred_node, pred_pos, pred_edge = (p.float() for p in preds[:3])
        pred_count = tuple(c.float() for c in preds[3])
        lmask = b["lig_mask"]
        NL = lmask.shape[1]
        eye = torch.eye(NL, dtype=torch.bool, device=lmask.device)
        emask = lmask[:, :, None] & lmask[:, None, :] & ~eye

        def mean(num_den):
            num, den = num_den
            return num / torch.clamp(den, min=1e-12)

        def cat_term(trans, logits, log_v0, log_vt, mask):
            log_recon = torch.log_softmax(logits, dim=-1)
            post_true = trans.q_v_posterior(log_v0, log_vt, t, v0_prob=True)
            post_pred = trans.q_v_posterior(log_recon, log_vt, t,
                                            v0_prob=True)
            return mean(masked_sums(trans.compute_v_Lt(
                post_true, post_pred, log_v0, t), mask))
        w = mcfg.loss_weight
        true_count = lmask.sum(1).float()
        norm_count = ((true_count - MIN_ATOMS) / (MAX_ATOMS - MIN_ATOMS)
                      )[:, None]
        terms = {
            "loss_pos": mean(masked_sums((pred_pos - lig_pos) ** 2,
                                         lmask[..., None])) * w[0],
            "loss_node": cat_term(self.node_trans, pred_node, log_node_0,
                                  log_node_t, lmask) * w[1],
            "loss_edge": cat_term(self.edge_trans, pred_edge, log_edge_0,
                                  log_edge_t, emask) * w[2],
            "loss_count": qd_loss(norm_count, *pred_count,
                                  factor=mcfg.count_factor)}
        self.terms = {k: float(v.detach()) for k, v in terms.items()}
        return sum(terms.values())

    def train(self, batches, draws, trained: Sequence[str], bits: int = 0):
        """Train steps on `batches` with `draws`: (losses, the first step's
        clipped gradient by parameter name, the parameters after the
        steps). `trained` names the parameters the optimizer updates (the
        others' gradients count in the clip norm only). `bits` > 0: the
        control, the network in bfloat16 with every bf16 result rounded to
        that many mantissa bits (`precision.RoundedOutputs`)."""
        params = dict(self.net.named_parameters())
        opt = self.tcfg.optimizer
        lr, b1, b2, eps = float(opt.lr), 0.9, 0.999, 1e-8
        m = {n: torch.zeros_like(params[n]) for n in trained}
        v = {n: torch.zeros_like(params[n]) for n in trained}
        queue = [QUEUE_SEED]
        losses, first = [], None
        self.step_terms = []
        for k, (b, d) in enumerate(zip(batches, draws), start=1):
            self.net.zero_grad(set_to_none=True)
            if bits:
                with RoundedOutputs(bits):
                    loss = self.loss(b, d, torch.bfloat16)
                    loss.backward()
            else:
                loss = self.loss(b, d)
                loss.backward()
            losses.append(float(loss.detach()))
            self.step_terms.append(self.terms)
            grads = {n: p.grad for n, p in params.items()
                     if p.grad is not None}
            q = torch.tensor(queue, dtype=torch.float32)
            mu = q.mean()
            max_norm = float(1.5 * mu + 2.0 * torch.sqrt(((q - mu) ** 2)
                                                           .mean()))
            gnorm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                         for g in grads.values())))
            scale = min(max_norm / (gnorm + 1e-12), 1.0)
            queue = (queue + [min(gnorm, max_norm)])[-QUEUE_LEN:]
            with torch.no_grad():
                g = {n: grads[n] * scale for n in trained if n in grads}
                if first is None:
                    first = {n: x.clone() for n, x in g.items()}
                for n, gn in g.items():
                    m[n].mul_(b1).add_(gn, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(gn, gn, value=1 - b2)
                    mh = m[n] / (1 - b1 ** k)
                    vh = v[n] / (1 - b2 ** k)
                    params[n].sub_(lr * mh / (vh.sqrt() + eps))
        return losses, first, {n: p.detach().clone()
                               for n, p in params.items()}
