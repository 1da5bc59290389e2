"""Multi-device serving and training over ``torch.distributed``.

The port runs SPMD: one process per rank, each holding its shard of the
weights (``sharding.shard_params``, the reference's rule table) and running
the same steps. The model code reads the ambient mesh
(``mesh.current_mesh``) and calls the explicit collectives of
``collectives`` where a layer's output is partial: a vocab-sharded
embedding, a row-parallel projection, the LM head's vocab shards, the
expert-parallel MoE layer. In training the collectives are differentiable
(Megatron's *f* and *g*), ZeRO-3 shards over "data" are gathered at use
(``sharding.gather_param`` under ``sharding.use_placement``) and
reduce-scattered in backward, and ``compression`` gives the int8-compressed
data-parallel mean.
"""
from .collectives import CollectiveStats, all_gather, all_reduce, copy_to_axis, reduce_scatter
from .mesh import (AXES, Mesh, choose_backend, current_mesh, init_mesh, make_local_mesh,
                   make_production_mesh, mesh_for, run_ranks, shutdown, use_mesh, world_mesh)

__all__ = ["AXES", "Mesh", "CollectiveStats", "all_gather", "all_reduce", "copy_to_axis",
           "reduce_scatter", "choose_backend", "current_mesh", "init_mesh",
           "make_local_mesh", "make_production_mesh", "mesh_for", "run_ranks", "shutdown",
           "use_mesh", "world_mesh"]
