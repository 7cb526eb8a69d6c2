"""Static analysis of the port: the repo's invariants as checkable
passes; the port's counterpart of ``repro.analysis``.

Four passes (see ``python -m repro_torch.analysis --list``):

- ``contracts`` — stage-contract checker (C00x): signatures, gating
  tables, sized-1-when-off state, Stats fold and surface discipline.
- ``ladder`` — ladder equivalence over every discovered family (LE00x,
  in place of the reference's jaxpr pass): each member maps to the
  family's one kernel instantiation and differs from its base config
  only in what reaches the kernel as the member's row of per-lane
  parameters.
- ``obs`` — observability contract (OB001): every BENCH_sweep and
  BENCH_serve field derives from a span, event or counter the
  instrumentation emits, and ``runner.LADDER_PERF`` and
  ``load.SERVE_PERF`` records come only from ``obs.report``.
- ``recompile`` — runs a tiny ladder fill and bounds the loads of its
  kernel library (RC001).  It runs the simulator, so the CLI runs it
  only under ``--all`` or ``--pass recompile``.

The reference's ``lint`` pass (JAX tracer hygiene and Pallas BlockSpec
rules) has no counterpart: the port's step is eager torch and its kernels
are CUDA C++.
"""
from repro_torch.analysis import (contracts, ladder_equiv, obs_contract,
                                  recompile)

PASSES = ("contracts", "ladder", "obs", "recompile")
STATIC_PASSES = ("contracts", "ladder", "obs")


def run_pass(name: str, progress=None, device=None) -> list:
    """The findings of one pass (``device``: the recompile guard's)."""
    if name == "contracts":
        return contracts.run()
    if name == "ladder":
        _, findings = ladder_equiv.check_all(progress=progress)
        return findings
    if name == "obs":
        return obs_contract.run()
    if name == "recompile":
        return recompile.check_ladder_dispatch(device=device)
    raise ValueError(f"unknown analysis pass {name!r} (know {PASSES})")


__all__ = ["PASSES", "STATIC_PASSES", "contracts", "ladder_equiv",
           "obs_contract", "recompile", "run_pass"]
