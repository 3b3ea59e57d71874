"""Mesh plans and placement rules (``sharding``: parameters, train
states, batches, dense and paged caches), the collectives of
tensor-parallel serving and of the sharded train step (``hints``), and
the GPipe schedule (``pipeline``)."""
from .sharding import (MeshPlan, auto_batch_sharding, cache_shardings,
                       param_shardings, plan_for_mesh)

__all__ = ["MeshPlan", "auto_batch_sharding", "cache_shardings",
           "param_shardings", "plan_for_mesh"]
