"""Learning-rate schedules as functions of the step, computed in float32
as the reference computes them (``jnp.float32`` arithmetic, its python
constants folded first). Each returns a numpy float32 scalar."""
from __future__ import annotations

import numpy as np

_F = np.float32


def _step(step) -> np.float32:
    return _F(int(step))


def constant_lr(lr: float):
    return lambda step: _F(lr)


def linear_warmup(lr: float, warmup: int):
    def f(step):
        s = _step(step)
        return _F(lr) * np.minimum(_F(1.0), (s + _F(1.0)) / _F(max(warmup, 1)))
    return f


def cosine_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def f(step):
        s = _step(step)
        warm = np.minimum(_F(1.0), (s + _F(1.0)) / _F(max(warmup, 1)))
        t = np.clip((s - _F(warmup)) / _F(max(total - warmup, 1)),
                    _F(0.0), _F(1.0))
        cos = _F(final_frac) + _F((1.0 - final_frac) * 0.5) * (
            _F(1.0) + np.cos(_F(np.pi) * t))
        return _F(lr) * warm * cos
    return f
