"""The deterministic token data pipeline."""
