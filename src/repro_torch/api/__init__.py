"""Public session-based TIMEST API of the PyTorch port.

Torch counterpart of ``repro.api`` (its docstring is the canonical
usage guide).  A long-lived :class:`Session` keeps the graph on the
device and the preprocess cache warm between requests::

    from repro_torch.api import EstimateConfig, Request, Session
    from repro_torch.graphs import powerlaw_temporal_graph

    g = powerlaw_temporal_graph(n=2_000, m=40_000, time_span=1_000_000)

    with Session(g, EstimateConfig(chunk=8192)) as s:   # device="cuda"
        h1 = s.submit(Request("M5-3", delta=50_000, k=1 << 18))
        h2 = s.submit(Request("M5-3", delta=50_000, k=1 << 18, seed=1))
        print(h1.result().summary())
        for snap in h2.stream():            # one snapshot per window
            print(snap.k_done, snap.estimate, snap.rse)
        h3 = s.submit(Request("M5-1", delta=50_000, k=1 << 14,
                              target_rse=0.05, k_max=1 << 22))
        print(h3.result().k, h3.rse)

``EstimateConfig(device="cpu")`` runs the plain torch versions of the
kernels instead.  Requests draining together whose trees share a
structural signature form one tree cohort: one sample stream per seed
(one tree-sampler launch per chunk for all of them) scored by every
member motif's own count lane; each result stays bit-identical to its
solo ``estimate()``.

``Session(g, cfg, mesh=launch.mesh.make_estimator_mesh())`` shards
every window's chunk range over a data mesh's shards (one per visible
card by default; ``make_estimator_mesh(D)`` places D shards round-robin
on the cards, ``device="cpu"`` on the CPU); results stay bit-identical
on any mesh shape.

``serve_loop`` wraps a session in the reference's NDJSON stdin/stdout
protocol (``python -m repro_torch.launch.estimate --graph ... --serve``);
live streams are ``repro_torch.stream``, the multi-tenant gateway
``repro_torch.gateway``.
"""
from .config import EstimateConfig
from .serve import serve_loop
from .session import Handle, Progress, Request, Session, SessionStats

__all__ = ["EstimateConfig", "Handle", "Progress", "Request", "Session",
           "SessionStats", "serve_loop"]
