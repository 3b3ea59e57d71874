"""Range calibration: pick integer bits from observed dynamic range.

The paper finds the needed integer bits empirically via accuracy sweeps
(Fig. 2b / 3 middle column). Calibration gives the same answer cheaply: run a
few batches, record per-layer max|x| (or a high percentile for outlier
robustness), and set I = required_int_bits(range). The search in
``core.search`` then only has to descend, never grow, formats.

Host arithmetic on float32 numpy copies, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from .fixedpoint import FixedPointFormat, required_int_bits
from .policy import LayerPolicy, PrecisionPolicy


@dataclasses.dataclass
class RangeStats:
    """Streaming per-layer absolute-range statistics."""

    max_abs: Dict[str, float] = dataclasses.field(default_factory=dict)
    pctl_abs: Dict[str, float] = dataclasses.field(default_factory=dict)

    def update(self, name: str, values, pctl: float = 99.9):
        """Fold in ``values`` (a tensor on any device, or an array)."""
        if isinstance(values, torch.Tensor):
            values = values.detach().to("cpu", torch.float32).numpy()
        v = np.abs(np.asarray(values, np.float32)).reshape(-1)
        if v.size == 0:
            return
        m = float(v.max())
        p = float(np.percentile(v, pctl))
        self.max_abs[name] = max(self.max_abs.get(name, 0.0), m)
        self.pctl_abs[name] = max(self.pctl_abs.get(name, 0.0), p)


def int_bits_for(stats: RangeStats, name: str, *, use_percentile: bool = False,
                 margin_bits: int = 0) -> int:
    src = stats.pctl_abs if use_percentile else stats.max_abs
    r = src.get(name, 1.0)
    return int(required_int_bits(r)) + margin_bits


def calibrated_policy(names: Sequence[str],
                      weight_ranges: Dict[str, float],
                      data_ranges: Dict[str, float],
                      *, frac_bits_weight: int = 10,
                      frac_bits_data: int = 2,
                      weightless: Sequence[str] = ()) -> PrecisionPolicy:
    """Initial policy: calibrated I, generous F (paper's <0.1%-error start)."""
    layers = []
    for n in names:
        if n in weightless or n not in weight_ranges:
            w = None
        else:
            wi = int(required_int_bits(weight_ranges[n]))
            w = FixedPointFormat(wi, frac_bits_weight)
        di = int(required_int_bits(data_ranges.get(n, 1.0)))
        d = FixedPointFormat(di, frac_bits_data)
        layers.append(LayerPolicy(w, d))
    return PrecisionPolicy(tuple(names), tuple(layers))
