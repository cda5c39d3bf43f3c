"""Frozen copies of the port's plain dynamics, the benchmark's reference."""
