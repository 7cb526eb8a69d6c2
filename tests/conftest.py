import os

# smoke tests and benches must see ONE device — the 512-device override is
# strictly dryrun.py-local (assignment requirement).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402  (env vars above must be set before jax imports)

jax.config.update("jax_compilation_cache_dir",
                  os.environ.get("JAX_CACHE", "/root/repo/.jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tests (multi-device lowering subprocesses); "
        "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "multidev: tests that need a sharded ('sys', 'wl') device mesh; "
        "they self-skip below 4 devices — run them under "
        "XLA_FLAGS=--xla_force_host_platform_device_count=4 (the "
        "multidev CI job does)")
    config.addinivalue_line(
        "markers", "gpu: tests that need a CUDA card; they skip without one")

