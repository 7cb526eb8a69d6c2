"""Core MMU model: primitives, stages, the step and its drivers."""
