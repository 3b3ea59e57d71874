"""Mesh plans, placement rules and the tensor-parallel collectives of
the serving path (``sharding``, ``hints``). The reference's
``state_shardings`` / ``cache_shardings`` / ``auto_batch_sharding`` and
``pipeline`` come with distributed training (ROADMAP queue A item 13)."""
from .sharding import (MeshPlan, auto_batch_sharding, cache_shardings,
                       param_shardings, plan_for_mesh)

__all__ = ["MeshPlan", "auto_batch_sharding", "cache_shardings",
           "param_shardings", "plan_for_mesh"]
