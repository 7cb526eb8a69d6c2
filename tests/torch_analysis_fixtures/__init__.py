"""Deliberately broken copies of the port's code for the
``repro_torch.analysis`` passes; the reference's ``analysis_fixtures``
(numpy only) are read as they are beside these.

- ``broken_make_state.py`` — the port's ``make_state`` with the gate
  dropped from a hoisted local (``rev_sets``): C004.
- ``broken_fold.py`` — an in-place ``accum_stats`` (the port's form)
  that overwrites, drops, double-folds and double-writes fields: C005,
  C006; a local reassigned between two folds is not a second writer.
- ``broken_stage.py`` — a stage whose fill writes into another stage's
  result slot: C008.
- ``broken_runner.py`` — a fill that appends a hand-set dict to
  ``LADDER_PERF``: OB001.
- ``broken_names.py`` — an ``obs.names`` with one name declared twice:
  OB001.

The passes read these as AST or as plain modules; nothing here runs the
simulator.
"""
