"""The train step and the fault-tolerant training loop."""
