"""The model mesh and the port's collectives (``repro_torch.launch.mesh``,
``repro_torch.dist.collectives``, ``dist.sharding.shard`` / ``unshard``)
on four CPU ranks over gloo.

One spawn of four processes (``run_on_mesh``, a ``file://`` rendezvous
in ``tmp_path``) runs ``torch_dist_workers.collectives_checks``, which
asserts on every rank: the row-major layout with ``model`` innermost and
each axis's group; ``psum_chunked`` with 1, 3 and 36 chunks of a
35-element payload equal to one all-reduce, f32 and int64;
``sharded_embedding_lookup`` with ``-1`` ids equal to a plain take, its
gradient the plain gradient's local rows; each autograd collective's
forward and backward against the plain collectives, with rank-specific
upstream gradients; ``shard_tree`` then ``unshard_tree`` of an LM
training state (ZeRO moment specs) bit-equal to the state, and
``convert.shard_lm_tree`` then ``gather_lm_tree`` of the reference's
numpy tree equal to it on rank 0; and a ``(pod, data, model)`` mesh
whose data axes fold into one group.
"""
from __future__ import annotations

from repro_torch.launch.mesh import run_on_mesh
from torch_dist_workers import collectives_checks


def test_collectives_on_four_cpu_ranks(tmp_path):
    seen = run_on_mesh(collectives_checks, 4, str(tmp_path / "rendezvous"),
                       timeout_s=300)
    assert all(s["psum"] and s["pairs"] and s["pod"] for s in seen)
    # granite-moe smoke: wq [2, 48, 48] column-sharded over model 2;
    # its moments ZeRO-sharded over data 2 on the layer axis
    assert seen[0]["local_wq"] == (2, 48, 24)
    assert seen[0]["local_mu_wq"] == (1, 48, 24)
    # each model rank's gradient reaches only its own 6 rows
    assert all(0 < s["lookup_rows"] <= 6 for s in seen)
    assert not (tmp_path / "rendezvous").exists()
