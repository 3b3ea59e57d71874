"""Traffic: one general generator reading the mixes beside it."""
