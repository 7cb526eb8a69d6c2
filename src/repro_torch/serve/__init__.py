"""The serving engine and its load harness; port of ``repro.serve``."""
