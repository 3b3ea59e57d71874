"""The data pipeline of the trainer (the reference's ``data/pipeline.py``).

* Stateless batches: a batch is a pure function of (config, step) (see
  ``data.lm``), so the pipeline's whole state is the step, and restore is
  exact.
* Placement: each batch is moved to ``device`` when it is produced (the
  reference places it with the train step's input sharding); under a
  mesh plan it is first cut to this rank's rows of the global batch
  (``parallel.sharding.shard_batch``), which the sharded train step
  takes as they are.
* Prefetch: a queue of ``prefetch`` placed batches ahead of the consumer.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class PipelineConfig:
    prefetch: int = 2


class DataPipeline:
    def __init__(self, batch_fn: Callable[[int], dict], *, device=None,
                 cfg: Optional[PipelineConfig] = None, start_step: int = 0,
                 plan=None):
        self._batch_fn = batch_fn
        self._device = device
        self._plan = plan
        self._cfg = cfg or PipelineConfig()
        self._step = start_step
        self._queue: collections.deque = collections.deque()

    # -- checkpointable state -------------------------------------------------
    @property
    def state(self) -> dict:
        return {"step": self._step}

    def restore(self, state: dict):
        self._step = int(state["step"])
        self._queue.clear()

    # -- iteration --------------------------------------------------------------
    def _produce(self):
        batch = self._batch_fn(self._step)
        if self._plan is not None:
            from ..parallel.sharding import shard_batch
            batch = shard_batch(batch, self._plan)
        if self._device is not None:
            moved = {k: v.to(self._device, non_blocking=True)
                     for k, v in batch.items()}
            batch = (batch.__class__(moved, batch.axes)
                     if hasattr(batch, "axes") else moved)
        self._queue.append(batch)
        self._step += 1

    def __next__(self):
        while len(self._queue) <= self._cfg.prefetch:
            self._produce()
        return self._queue.popleft()

    def __iter__(self):
        return self
