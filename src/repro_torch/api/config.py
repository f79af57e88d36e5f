"""Frozen estimation configs for the session API.

Torch counterpart of ``repro.api.config``: one frozen
:class:`EstimateConfig` instead of per-call kwargs, with the
reference's fields and defaults.  The reference's two backend fields
(``sampler_backend``, ``depsum_backend``, resolved from the environment)
become one ``device``: the port has one route per device (the CUDA
kernels on the card, their plain torch versions on the CPU) and reads
no environment variable.  ``resolve()``, called once at ``Session``
construction, checks the device: a CUDA device without a card raises
there, not mid-run.

Configs are frozen dataclasses: hashable, comparable, safe to share
across sessions; ``replace()`` derives variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..core.estimator import require_device


@dataclass(frozen=True)
class EstimateConfig:
    """Session-wide estimation parameters.

    Execution grid
    --------------
    chunk             samples per chunk (one sampler launch per cohort)
    Lmax              DP path-count cap in the validator
    checkpoint_every  chunks per window: the engine syncs (and the
                      session streams / checkpoints / measures RSE) at
                      this granularity

    Planning
    --------
    n_candidates, roots_per_tree   Alg. 7 tree-candidate search width
    use_c2, use_c3                 constraint toggles (paper Table 6)

    Device
    ------
    device            "cuda" (the hand-written kernels; the default) or
                      "cpu" (their plain torch versions)

    Serving
    -------
    seed                   default seed for requests that carry none
    coalesce_window_s      a submit window stays open this long: requests
                           arriving within it drain together (and fuse
                           when they share a plan key)
    coalesce_max_requests  ... or until this many requests are pending
    rse_growth             adaptive-budget growth factor
    k_max_factor           default ``k_max = k_max_factor * k`` for
                           ``target_rse`` requests that set no ``k_max``
    """

    chunk: int = 8192
    Lmax: int = 16
    checkpoint_every: int = 64
    n_candidates: int = 3
    roots_per_tree: int = 2
    use_c2: bool = True
    use_c3: bool = True
    device: str = "cuda"
    seed: int = 0
    coalesce_window_s: float = 0.05
    coalesce_max_requests: int = 64
    rse_growth: float = 2.0
    k_max_factor: int = 64

    def resolve(self) -> "EstimateConfig":
        """Check the device (raises for "cuda" without a card) and return
        the config with ``device`` as its canonical string."""
        return dataclasses.replace(self,
                                   device=str(require_device(self.device)))

    def replace(self, **changes) -> "EstimateConfig":
        return dataclasses.replace(self, **changes)
