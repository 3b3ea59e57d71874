"""Per-layer precision policies (the paper's central object).

A network is a sequence of named layers; each layer carries independent
fixed-point formats for its **weights** and its output **data** (paper
§2.1 "Values Studied"). ``PrecisionPolicy`` is what the precision search
mutates (``decrement``, ``candidate_moves``), what the traffic model
prices, and what ``quant.apply`` installs into a model. The JSON form is
the reference's, so a policy file round-trips between the two packages.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional, Sequence

import torch

from .fixedpoint import FixedPointFormat

FIELDS = ("weight_int", "weight_frac", "data_int", "data_frac")

# the stand-in format ``stacked_arrays`` gives a layer without one: Q16.14,
# whose 2^-14 grid still moves values below about 2^-7 in bf16 or float32
SENTINEL_FORMAT = (16, 14)


@dataclasses.dataclass(frozen=True)
class LayerPolicy:
    """Q(I,F) formats for one layer's weights and output data (``None``:
    kept at full precision; for the weight, a weight-less layer)."""

    weight: Optional[FixedPointFormat]
    data: Optional[FixedPointFormat]

    def with_field(self, field: str, value: int) -> "LayerPolicy":
        """This layer with one of :data:`FIELDS` set to ``value``; a field
        of an absent format is left absent."""
        w, d = self.weight, self.data
        if field == "weight_int" and w:
            w = FixedPointFormat(value, w.frac_bits)
        elif field == "weight_frac" and w:
            w = FixedPointFormat(w.int_bits, value)
        elif field == "data_int" and d:
            d = FixedPointFormat(value, d.frac_bits)
        elif field == "data_frac" and d:
            d = FixedPointFormat(d.int_bits, value)
        return LayerPolicy(w, d)

    def get_field(self, field: str) -> Optional[int]:
        w, d = self.weight, self.data
        return {
            "weight_int": w.int_bits if w else None,
            "weight_frac": w.frac_bits if w else None,
            "data_int": d.int_bits if d else None,
            "data_frac": d.frac_bits if d else None,
        }[field]

    def short(self) -> str:
        ws = self.weight.short() if self.weight else "-"
        ds = self.data.short() if self.data else "-"
        return f"W:{ws}/D:{ds}"


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """An ordered mapping layer-name -> LayerPolicy."""

    names: tuple
    layers: tuple  # tuple[LayerPolicy]

    def __post_init__(self):
        if len(self.names) != len(self.layers):
            raise ValueError(f"{len(self.names)} names for "
                             f"{len(self.layers)} layers")

    # -- constructors -------------------------------------------------------
    @staticmethod
    def uniform(names: Sequence[str],
                weight: Optional[FixedPointFormat],
                data: Optional[FixedPointFormat]) -> "PrecisionPolicy":
        return PrecisionPolicy(tuple(names),
                               tuple(LayerPolicy(weight, data) for _ in names))

    @staticmethod
    def fp32_baseline(names: Sequence[str]) -> "PrecisionPolicy":
        """The 'no quantization' marker policy (None formats everywhere)."""
        return PrecisionPolicy(tuple(names),
                               tuple(LayerPolicy(None, None) for _ in names))

    # -- access / update ----------------------------------------------------
    def __len__(self):
        return len(self.names)

    def __getitem__(self, name: str) -> LayerPolicy:
        return self.layers[self.names.index(name)]

    def replace_layer(self, idx: int, lp: LayerPolicy) -> "PrecisionPolicy":
        layers = list(self.layers)
        layers[idx] = lp
        return PrecisionPolicy(self.names, tuple(layers))

    def with_field(self, idx: int, field: str,
                   value: int) -> "PrecisionPolicy":
        return self.replace_layer(idx,
                                  self.layers[idx].with_field(field, value))

    def decrement(self, idx: int, field: str) -> Optional["PrecisionPolicy"]:
        """One step of the paper's search: remove one bit from (layer,
        field). None if the field is absent or already at its floor (1
        integer bit, the sign, or 0 fractional bits)."""
        cur = self.layers[idx].get_field(field)
        if cur is None:
            return None
        floor = 1 if field.endswith("_int") else 0
        if cur <= floor:
            return None
        return self.with_field(idx, field, cur - 1)

    def candidate_moves(self, fields: Iterable[str] = FIELDS):
        """All single-bit decrements (the paper's 'delta configurations'):
        a list of ((layer index, field), policy)."""
        out = []
        for i in range(len(self)):
            for f in fields:
                p = self.decrement(i, f)
                if p is not None:
                    out.append(((i, f), p))
        return out

    # -- per-layer views ----------------------------------------------------
    def stacked_arrays(self, field_prefix: str):
        """(int_bits, frac_bits, enabled) as (L,) float32, float32 and bool
        tensors on the CPU, ``field_prefix`` "weight" or "data". A layer
        without that format gets :data:`SENTINEL_FORMAT` and
        ``enabled=False``; the model still fake-quantizes it on that grid
        whenever any layer is enabled, as the reference does."""
        ints, fracs, enabled = [], [], []
        for lp in self.layers:
            fmt = lp.weight if field_prefix == "weight" else lp.data
            if fmt is None:
                ints.append(SENTINEL_FORMAT[0])
                fracs.append(SENTINEL_FORMAT[1])
                enabled.append(False)
            else:
                ints.append(fmt.int_bits)
                fracs.append(fmt.frac_bits)
                enabled.append(True)
        return (torch.tensor(ints, dtype=torch.float32),
                torch.tensor(fracs, dtype=torch.float32),
                torch.tensor(enabled, dtype=torch.bool))

    # -- serialization ------------------------------------------------------
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

    def short(self) -> str:
        return " | ".join(f"{n}={lp.short()}"
                          for n, lp in zip(self.names, self.layers))

    def table(self) -> str:
        rows = ["layer            weight   data", "-" * 34]
        for n, lp in zip(self.names, self.layers):
            w = lp.weight.short() if lp.weight else "fp32"
            d = lp.data.short() if lp.data else "fp32"
            rows.append(f"{n:<16} {w:<8} {d}")
        return "\n".join(rows)
