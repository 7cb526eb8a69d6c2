"""Recompile guard (RC001): a ladder fill loads its kernel library at
most once; the port's counterpart of ``repro.analysis.recompile``.

The reference bounds the ``run_systems`` jit-cache misses of a ladder
fill.  The port runs eagerly and compiles nothing per shape: its one
build per fill is the ``mmu_step`` kernel library, which
``kernels.build.load`` builds or loads and announces with one
``EV_COMPILE`` event (``fn`` = the library) under the current span.  A
fill's ``LADDER_PERF`` record counts those events for the dispatch
library inside its span tree (``dispatch_compiles``, the reference's
field).  This guard runs a tiny two-member ladder fill over two
same-shape chunks and reports a finding when that count passes one.  On
the CPU the plain path builds nothing and the count is 0; on the card,
in a fresh process, it is 1.  No name is matched against a log: the
count is the events' own.
"""
from __future__ import annotations

EXPECTED_MAX = 1


def check_ladder_dispatch(n: int = 256, device=None):
    """Fill the first two members of the largest discovered family over
    two same-shape chunks (``rnd`` and ``bc``, one a chunk) of ``n``
    accesses through ``runner.run_ladder``, without the result cache, and
    return findings if its record counts more than ``EXPECTED_MAX``
    loads of the dispatch library.  ``device`` is ``run_ladder``'s (the
    card unless the caller names another).  This runs the simulator, so
    the CLI runs it only when asked (``--pass recompile`` or ``--all``)."""
    from repro_torch.sim import runner, systems

    fam, ms = max(systems.discover_ladders().items(),
                  key=lambda kv: len(kv[1]))
    members = ms[:2]
    runner.run_ladder(fam, workloads=["rnd", "bc"], n=n, members=members,
                      chunk=1, cache=False, device=device)
    rec = runner.LADDER_PERF[-1]
    got = rec["dispatch_compiles"]
    if got <= EXPECTED_MAX:
        return []
    return [f"RC001 recompile guard: a {len(members)}-member ladder fill "
            f"({fam}: {', '.join(members)}; backend {rec['backend']}) "
            f"loaded its dispatch library '{runner.DISPATCH_LIB}' {got}x "
            f"over {rec['n_chunks']} same-shape chunks; the one-compile "
            f"invariant allows at most {EXPECTED_MAX} (the fill's "
            f"EV_COMPILE events, in its obs trace {rec['trace_file']})"]
