"""A configuration dict as nested attributes, for the reference's modules
(which read `cfg.model.denoiser.knn` and the like)."""
from __future__ import annotations

from typing import Any, Dict


class Cfg:
    """Read-only attribute view of a nested dict."""

    def __init__(self, raw: Dict[str, Any]):
        for k, v in raw.items():
            setattr(self, k, Cfg(v) if isinstance(v, dict) else v)

    def schedule_kwargs(self) -> Dict[str, Any]:
        """The keyword arguments of `schedules.get_beta_schedule` for a
        `diff_*` block (as the program's config computes them)."""
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
