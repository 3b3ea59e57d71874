"""Tools run once when a cell is defined: the knee sweep and the control."""
