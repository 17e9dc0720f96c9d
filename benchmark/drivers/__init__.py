"""Drivers: one general loop per kind of traffic, named by a traffic file's
"driver" key. `run(cell, seed, seconds, trace, device, t0)` runs the cell
once and returns a drivers.common.Outcome."""
