"""Elastic scaling: restore a checkpoint onto a DIFFERENT mesh (the
reference's ``runtime/elastic.py``).

Checkpoints are global-shape (mesh-agnostic, see ``checkpoint.ckpt``), so
re-scaling is: build the mesh at the new rank count, lay the state out by
the same logical rules (``parallel.sharding.state_specs``) and keep each
rank's shard of every global leaf. The only constraints are divisibility
(handled by the rules' fallbacks) and the global batch, which the caller
owns (a batch is a pure function of the step).
"""
from __future__ import annotations

from typing import List, Tuple

from ..checkpoint.ckpt import restore_checkpoint
from ..parallel.sharding import plan_for_mesh


def divisor_meshes(n_devices: int) -> List[Tuple[int, int]]:
    """All (data, model) factorizations of a device count: the shapes an
    elastic job can land on."""
    out = []
    for m in range(1, n_devices + 1):
        if n_devices % m == 0:
            out.append((n_devices // m, m))
    return out


def elastic_restore(ckpt_dir: str, template, mesh) -> tuple:
    """Restore the latest checkpoint under ``ckpt_dir`` resharded for
    ``mesh`` (a ``DeviceMesh``; every rank of it calls this).

    ``template`` is a WHOLE train state of the target's layout
    (``launch.steps.init_train_state``: its model's config, its moments'
    kind and residuals, its device); it is sharded for ``mesh``'s plan
    (``launch.steps.shard_train_state``) and filled with this rank's
    shard of every leaf of the checkpoint. Returns (step, state,
    extra)."""
    from ..launch.steps import (load_train_state, shard_train_state,
                                train_state_tree)
    cfg = template["params"].cfg
    plan = plan_for_mesh(mesh)
    tree_tmpl = train_state_tree(template, cfg, device="meta")
    state = shard_train_state(template, cfg, plan)
    step, tree, extra = restore_checkpoint(ckpt_dir, tree_tmpl)
    load_train_state(state, tree, cfg, plan=plan)
    return step, state, extra
