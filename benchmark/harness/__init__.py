"""Shared code of the benchmark: traffic generation, the run loop, the
capture at the encoder's entry points, the plain reference, the profiler
reduction and the roofline arithmetic. No cell is named here."""
