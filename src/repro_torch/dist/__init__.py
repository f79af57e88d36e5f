"""Distribution layer (the port's copy of the JAX package's
``repro.dist``): shardings, collectives, the edge-parallel GNN and
GPipe.

* ``sharding``: mesh introspection (``data_axes``, ``n_data``,
  ``n_model``), the reference's placement builders (``lm_param_
  shardings``, ``lm_batch_shardings``, ``opt_state_shardings`` with
  ZeRO, ``replicated``, the GNN and recsys builders) returning a
  ``PartitionSpec`` per leaf, and ``shard`` / ``unshard`` of a leaf on a
  ``launch.mesh.ModelMesh``.
* ``collectives``: the estimator mesh's shard index and exact int64
  combine; on a model mesh, the collectives autograd differentiates
  (Megatron's pairs, shard_map's psum and pmean transposes, the
  ``ppermute`` shift), ``psum_chunked`` and ``sharded_embedding_lookup``.
* ``gnn_sharded``: edge-parallel GNN message passing (the sharded loss
  and the cut of a batch into a rank's piece).
* ``pipeline``: GPipe over the ``"pod"`` axis (``gpipe_forward``).

Everything is mesh-shape-agnostic, as in the reference: axis names come
from the mesh and a dimension that does not divide its axes is
replicated.
"""
from . import collectives, gnn_sharded, pipeline, sharding  # noqa: F401
