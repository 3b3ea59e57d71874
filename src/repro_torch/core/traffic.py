"""Per-layer memory-traffic accounting (paper §2.4, Fig. 4, the TR column
of Table 2).

The paper counts each datum as transferred once per layer execution
(infinite on-chip reuse) and prices it at that layer's bit width:

    traffic_bits = sum_layers  accesses(layer, field) * bits(layer, field)

Two use cases (paper Fig. 4): ``single``, where weights are re-read per
image, and ``batch``, where weights are read once per layer per batch. TR
(traffic ratio) is reported against a 32-bit-everywhere baseline. For the
transformer archs the same model prices weight bytes, boundary activation
bytes and KV bytes per token (``quant.apply.transformer_traffic_model``).

Host arithmetic only. The open-loop request-trace generator of the
reference module is still to port (ROADMAP queue A item 9).
"""
from __future__ import annotations

import dataclasses

from .policy import PrecisionPolicy

BASELINE_BITS = 32


@dataclasses.dataclass(frozen=True)
class LayerTraffic:
    """Access counts for one layer, in element units (not bytes)."""

    name: str
    weight_elems: int      # model parameters touched by the layer
    data_in_elems: int     # activations read (per image / per sequence)
    data_out_elems: int    # activations written

    @property
    def data_elems(self) -> int:
        return self.data_in_elems + self.data_out_elems


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    layers: tuple  # tuple[LayerTraffic]

    @property
    def names(self):
        return tuple(lt.name for lt in self.layers)

    def accesses(self, batch_size: int = 1, mode: str = "batch"):
        """(weight accesses, data accesses) summed over layers."""
        w = sum(lt.weight_elems for lt in self.layers)
        d = sum(lt.data_elems for lt in self.layers) * batch_size
        if mode == "single":
            w = w * batch_size  # weights re-read for every image
        elif mode != "batch":
            raise ValueError(mode)
        return w, d

    def traffic_bits(self, policy: PrecisionPolicy, batch_size: int = 1,
                     mode: str = "batch") -> float:
        if policy.names != self.names:
            raise ValueError("policy/traffic layer mismatch")
        total = 0.0
        for lt, lp in zip(self.layers, policy.layers):
            wbits = lp.weight.total_bits if lp.weight else BASELINE_BITS
            dbits = lp.data.total_bits if lp.data else BASELINE_BITS
            w = lt.weight_elems * (batch_size if mode == "single" else 1)
            total += w * wbits + lt.data_elems * batch_size * dbits
        return total

    def baseline_bits(self, batch_size: int = 1,
                      mode: str = "batch") -> float:
        w, d = self.accesses(batch_size, mode)
        return (w + d) * BASELINE_BITS

    def traffic_ratio(self, policy: PrecisionPolicy, batch_size: int = 1,
                      mode: str = "batch") -> float:
        """TR: priced traffic / 32-bit baseline (paper Table 2)."""
        return (self.traffic_bits(policy, batch_size, mode)
                / self.baseline_bits(batch_size, mode))

    def footprint_bytes(self, policy: PrecisionPolicy) -> float:
        """Static storage: weights once + one live copy of boundary data."""
        total = 0.0
        for lt, lp in zip(self.layers, policy.layers):
            wbits = lp.weight.total_bits if lp.weight else BASELINE_BITS
            dbits = lp.data.total_bits if lp.data else BASELINE_BITS
            total += (lt.weight_elems * wbits
                      + lt.data_out_elems * dbits) / 8.0
        return total
