"""Per-layer precision policies (the paper's central object).

A network is a sequence of named layers; each layer carries independent
fixed-point formats for its weights and its output data. The JSON form is
the reference's, so a policy file round-trips between the two packages.
The search-side API of ``repro.core.policy`` (``decrement``,
``candidate_moves``) is still to port (ROADMAP queue A item 1).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

from .fixedpoint import FixedPointFormat


@dataclasses.dataclass(frozen=True)
class LayerPolicy:
    """Q(I,F) formats for one layer's weights and output data (``None``:
    kept at full precision)."""

    weight: Optional[FixedPointFormat]
    data: Optional[FixedPointFormat]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """An ordered mapping layer-name -> LayerPolicy."""

    names: tuple
    layers: tuple  # tuple[LayerPolicy]

    def __post_init__(self):
        if len(self.names) != len(self.layers):
            raise ValueError(f"{len(self.names)} names for "
                             f"{len(self.layers)} layers")

    @staticmethod
    def uniform(names: Sequence[str],
                weight: Optional[FixedPointFormat],
                data: Optional[FixedPointFormat]) -> "PrecisionPolicy":
        return PrecisionPolicy(tuple(names),
                               tuple(LayerPolicy(weight, data) for _ in names))

    def __len__(self):
        return len(self.names)

    def to_json(self) -> str:
        def enc(fmt):
            return None if fmt is None else [fmt.int_bits, fmt.frac_bits]
        return json.dumps({
            "names": list(self.names),
            "layers": [{"weight": enc(lp.weight), "data": enc(lp.data)}
                       for lp in self.layers],
        })

    @staticmethod
    def from_json(s: str) -> "PrecisionPolicy":
        obj = json.loads(s)

        def dec(v):
            return None if v is None else FixedPointFormat(v[0], v[1])
        layers = tuple(LayerPolicy(dec(lp["weight"]), dec(lp["data"]))
                       for lp in obj["layers"])
        return PrecisionPolicy(tuple(obj["names"]), layers)
