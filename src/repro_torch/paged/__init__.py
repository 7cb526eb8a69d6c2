"""Paged-KV block tables and the Victima Translation Cache; port of
``repro.paged``."""
