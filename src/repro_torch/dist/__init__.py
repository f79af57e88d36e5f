"""Distribution layer (the port's copy of the JAX package's
``repro.dist``): the estimator mesh's introspection and its combine.

``sharding`` reads a mesh's data axes; ``collectives`` holds the
row-major shard index and the exact int64 combine of the engine's shard
sums.  The model-side pieces of the reference (the NamedSharding specs,
``psum_chunked``, ``sharded_embedding_lookup``, the pipeline and the
sharded GNN) belong to the model-side distribution slice.
"""
from . import collectives, sharding  # noqa: F401
