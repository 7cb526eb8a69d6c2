"""OB001: the BENCH_sweep record is fully derivable from the obs trace;
the port's counterpart of ``repro.analysis.obs_contract``, over the
port's ``obs`` tables, ``sim/runner.py`` and ``serve/load.py``.

The schema-6 contract (mirroring the C007 orphan-Stats discipline): no
``LADDER_PERF`` field may be hand-set in ``sim.runner`` — every field
must flow through ``obs.report.FIELD_SOURCES``, and every source must
reference something the instrumentation actually emits.  Three checks:

- the ``FIELD_SOURCES`` table and ``SCHEMA6_FIELDS`` are mutually
  closed (no orphan field, no dangling source), and each source is
  well-formed: span sums name a declared span, attr sources name an
  attribute the ``ladder_fill`` span in ``sim/runner.py`` actually sets
  (``obs.span(...)`` keywords or a later ``fill.set(...)``), derived
  sources name another field;
- ``sim/runner.py`` appends to ``LADDER_PERF`` ONLY values produced by
  ``fill_record`` — a hand-assembled dict literal is exactly the
  regression this pass exists to block;
- every name constant declared in ``obs.names`` tuples is unique (a
  duplicated string would silently merge two metrics).

The serving-side BENCH_serve record (``report.SERVE_FIELDS``, produced
by ``serve/load.py``) gets the same treatment: table closure against
``SERVE_FIELD_SOURCES``, attr sources must be set on the
``serve.load_run`` span (open keywords or a later ``.set(...)``), count
sums must name declared counters, duration quantiles must name declared
spans, and ``SERVE_PERF.append`` may only receive ``serve_record``
output.

Pure AST and table inspection, nothing executed: one of the CLI's
default (static) passes.
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.obs import names as obs_names
from repro_torch.obs import report

RUNNER_PATH = Path(__file__).resolve().parents[1] / "sim" / "runner.py"
LOAD_PATH = Path(__file__).resolve().parents[1] / "serve" / "load.py"

_SOURCE_KINDS = ("attr", "sum_span_dur", "count_compiles", "derived",
                 "trace_path")
_SERVE_SOURCE_KINDS = ("attr", "sum_counts", "dur_quantile", "span_dur",
                       "derived", "trace_path")


def _span_attrs(path, span_const: str) -> set:
    """Attribute names a span opened as ``obs.span(<span_const>, ...)``
    in `path` carries: the open call's keywords plus every later
    ``<handle>.set(...)`` keyword (the handle being whatever name the
    span call — or a `with ... as` clause — bound)."""
    tree = ast.parse(Path(path).read_text())

    def _is_span_call(call):
        return (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "span"
                and call.args
                and isinstance(call.args[0], ast.Attribute)
                and call.args[0].attr == span_const)

    attrs: set = set()
    handles: set = set()
    for node in ast.walk(tree):
        if _is_span_call(node):
            attrs |= {kw.arg for kw in node.keywords if kw.arg}
        # `fill = obs.span(X, ...)` -> track fill.set(...)
        if (isinstance(node, ast.Assign)
                and _is_span_call(node.value)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    handles.add(t.id)
        # `with obs.span(X, ...) as run:` -> track run.set(...)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if (_is_span_call(item.context_expr)
                        and isinstance(item.optional_vars, ast.Name)):
                    handles.add(item.optional_vars.id)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "set"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in handles):
            attrs |= {kw.arg for kw in node.keywords if kw.arg}
    return attrs


def check_field_sources() -> list:
    """Table closure + source well-formedness (the core OB001 check)."""
    findings = []
    fields = set(report.SCHEMA6_FIELDS)
    sources = set(report.FIELD_SOURCES)
    for f in sorted(fields - sources):
        findings.append(
            f"OB001 schema-6 field {f!r} has no FIELD_SOURCES entry — "
            f"it cannot be derived from the trace (orphan hand-set "
            f"field)")
    for f in sorted(sources - fields):
        findings.append(
            f"OB001 FIELD_SOURCES entry {f!r} is not a schema-6 field "
            f"(dangling source)")

    # the runner's ladder_fill span: keywords of its obs.span(...) call
    # plus every fill.set(...) keyword
    span_attrs = _span_attrs(RUNNER_PATH, "SPAN_LADDER_FILL")
    for f in sorted(fields & sources):
        kind, arg = report.FIELD_SOURCES[f]
        if kind not in _SOURCE_KINDS:
            findings.append(
                f"OB001 field {f!r}: unknown source kind {kind!r} "
                f"(know {_SOURCE_KINDS})")
        elif kind == "sum_span_dur" and arg not in obs_names.SPAN_NAMES:
            findings.append(
                f"OB001 field {f!r} sums spans named {arg!r}, which is "
                f"not declared in obs.names.SPAN_NAMES — nothing emits "
                f"it")
        elif kind == "attr" and arg not in span_attrs:
            findings.append(
                f"OB001 field {f!r} reads ladder_fill attr {arg!r}, but "
                f"sim/runner.py never sets it on the fill span "
                f"(sets: {sorted(span_attrs)})")
        elif kind == "count_compiles" and arg not in span_attrs:
            findings.append(
                f"OB001 field {f!r} filters compile events by fill attr "
                f"{arg!r}, which the fill span never sets")
        elif kind == "derived" and arg not in sources:
            findings.append(
                f"OB001 field {f!r} derives from {arg!r}, which has no "
                f"FIELD_SOURCES entry")
    return findings


def check_runner_appends(runner_path=None) -> list:
    """``LADDER_PERF.append(...)`` must receive a ``fill_record`` call."""
    tree = ast.parse(Path(runner_path or RUNNER_PATH).read_text())
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "LADDER_PERF"):
            continue
        arg = node.args[0] if node.args else None
        ok = (isinstance(arg, ast.Call)
              and isinstance(arg.func, ast.Attribute)
              and arg.func.attr == "fill_record")
        if not ok:
            findings.append(
                f"OB001 sim/runner.py:{node.lineno}: LADDER_PERF.append "
                f"receives a hand-assembled value; records must come "
                f"from obs.report.fill_record so the artifact stays "
                f"derivable from the trace")
    return findings


def check_serve_field_sources() -> list:
    """SERVE_FIELDS ↔ SERVE_FIELD_SOURCES closure + well-formedness."""
    findings = []
    fields = set(report.SERVE_FIELDS)
    sources = set(report.SERVE_FIELD_SOURCES)
    for f in sorted(fields - sources):
        findings.append(
            f"OB001 serve field {f!r} has no SERVE_FIELD_SOURCES entry — "
            f"it cannot be derived from the trace (orphan hand-set "
            f"field)")
    for f in sorted(sources - fields):
        findings.append(
            f"OB001 SERVE_FIELD_SOURCES entry {f!r} is not a serve "
            f"field (dangling source)")

    span_attrs = _span_attrs(LOAD_PATH, "SPAN_SERVE_RUN")
    for f in sorted(fields & sources):
        kind, arg = report.SERVE_FIELD_SOURCES[f]
        if kind not in _SERVE_SOURCE_KINDS:
            findings.append(
                f"OB001 serve field {f!r}: unknown source kind {kind!r} "
                f"(know {_SERVE_SOURCE_KINDS})")
        elif kind == "attr" and arg not in span_attrs:
            findings.append(
                f"OB001 serve field {f!r} reads serve.load_run attr "
                f"{arg!r}, but serve/load.py never sets it on the run "
                f"span (sets: {sorted(span_attrs)})")
        elif kind == "sum_counts" and arg not in obs_names.COUNTER_NAMES:
            findings.append(
                f"OB001 serve field {f!r} sums counts named {arg!r}, "
                f"which is not declared in obs.names.COUNTER_NAMES — "
                f"nothing emits it")
        elif kind == "dur_quantile" and arg[0] not in obs_names.SPAN_NAMES:
            findings.append(
                f"OB001 serve field {f!r} takes quantiles of spans named "
                f"{arg[0]!r}, which is not declared in "
                f"obs.names.SPAN_NAMES — nothing emits it")
        elif kind == "derived":
            for a in (arg if isinstance(arg, tuple) else (arg,)):
                if a not in sources:
                    findings.append(
                        f"OB001 serve field {f!r} derives from {a!r}, "
                        f"which has no SERVE_FIELD_SOURCES entry")
    return findings


def check_load_appends() -> list:
    """``SERVE_PERF.append(...)`` must receive a ``serve_record`` call."""
    tree = ast.parse(Path(LOAD_PATH).read_text())
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "SERVE_PERF"):
            continue
        arg = node.args[0] if node.args else None
        ok = ((isinstance(arg, ast.Call)
               and isinstance(arg.func, ast.Attribute)
               and arg.func.attr == "serve_record")
              or (isinstance(arg, ast.Name)
                  and _assigned_from_serve_record(tree, arg.id)))
        if not ok:
            findings.append(
                f"OB001 serve/load.py:{node.lineno}: SERVE_PERF.append "
                f"receives a hand-assembled value; records must come "
                f"from obs.report.serve_record so BENCH_serve stays "
                f"derivable from the trace")
    return findings


def _assigned_from_serve_record(tree, name: str) -> bool:
    """True when every ``name = ...`` assignment is a serve_record call
    (the `rec = serve_record(...); SERVE_PERF.append(rec)` idiom)."""
    assigns = [n for n in ast.walk(tree)
               if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == name
                       for t in n.targets)]
    return bool(assigns) and all(
        isinstance(a.value, ast.Call)
        and isinstance(a.value.func, ast.Attribute)
        and a.value.func.attr == "serve_record"
        for a in assigns)


def check_name_uniqueness(names_mod=None) -> list:
    """Declared span/event/metric names must be globally unique
    (`names_mod`: a module laid out as ``obs.names``, by default it)."""
    names_mod = names_mod or obs_names
    findings = []
    all_names: list = []
    for tup in (names_mod.SPAN_NAMES,
                getattr(names_mod, "PORT_SPAN_NAMES", ()),
                names_mod.EVENT_NAMES, names_mod.COUNTER_NAMES,
                getattr(names_mod, "PORT_COUNTER_NAMES", ()),
                names_mod.GAUGE_NAMES, names_mod.HIST_NAMES):
        all_names += list(tup)
    seen: set = set()
    for n in all_names:
        if n in seen:
            findings.append(
                f"OB001 obs.names declares {n!r} more than once — "
                f"distinct metrics would silently merge")
        seen.add(n)
    return findings


def run() -> list:
    return (check_field_sources()
            + check_runner_appends()
            + check_serve_field_sources()
            + check_load_appends()
            + check_name_uniqueness())
