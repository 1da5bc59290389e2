"""Multi-device serving over ``torch.distributed``.

The port serves SPMD: one process per rank, each holding its shard of the
weights (``sharding.shard_params``, the reference's rule table) and running
the same steps on the same requests. The model code reads the ambient mesh
(``mesh.current_mesh``) and calls the explicit collectives of
``collectives`` where a layer's output is partial: a vocab-sharded
embedding, a row-parallel projection, the LM head's vocab shards, the
expert-parallel MoE layer.
"""
from .collectives import CollectiveStats, all_gather, all_reduce
from .mesh import (AXES, Mesh, choose_backend, current_mesh, init_mesh, mesh_for,
                   run_ranks, shutdown, use_mesh, world_mesh)

__all__ = ["AXES", "Mesh", "CollectiveStats", "all_gather", "all_reduce",
           "choose_backend", "current_mesh", "init_mesh", "mesh_for", "run_ranks",
           "shutdown", "use_mesh", "world_mesh"]
