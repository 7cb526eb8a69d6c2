"""Simulation drivers: traces, the system registry, the runner."""
