"""Stage-contract checker: introspection and AST over the port's
``core/stages/*``; the port's counterpart of ``repro.analysis.contracts``
(the same codes, C001-C008).

Checked invariants (each finding is prefixed with its code):

- C001 every registered stage exposes ``lookup(self, cfg, st, req,
  need)`` and ``fill(self, cfg, st, req, out)`` with exactly those
  parameters, a non-placeholder ``name`` matching its registry key, and
  a bool ``past_l2`` declaration.
- C002 every registry system composition validates (flags agree with
  the stage list) and ends in a walker stage.
- C003 the dyn-gating tables are closed: every ``DYN_GATED_STAGES``
  entry names a real stage, SimConfig field and Dyn gate, and every
  ``DYN_FIELDS`` entry is a SimConfig field.
- C004 sized-1-when-off: state for a gated stage is allocated with the
  ``<expr> if cfg.<flag> else 1`` (or ``max(<expr>, 1)``) convention in
  ``make_state``, so that an off lane carries a 1-entry structure and
  the ladder base state stays shape-shared.  The port's ``make_state``
  hoists some gated sizes into locals (``rev_sets = cfg.rev_sets if
  cfg.revelator else 1``) and nests the allocation in another call
  (``RevTable(tab=mk(rev_sets, rev_ways), ...)``): a local assigned once
  in the function is read through to its value, and every such local a
  gated keyword reads must carry the keyword's gate itself.
- C005/C006 every ``Stats`` field follows the ``n_*/sum_*/hist_*``
  naming convention and is folded accumulatively in exactly one place of
  ``fold.accum_stats``, with at most one *stage* source feeding it
  (single-writer).  The accumulator is the function's first parameter
  (``s`` in the port, ``s0`` in the reference).  Two forms are read: a
  ``Stats(...)`` return whose keyword for a field reads
  ``<acc>.<field>`` (the reference's), and the port's in-place fold,
  ``<acc>.<field>.add_(...)`` or ``<acc>.<field>[...] += ...``, that
  returns the accumulator; any other write to ``<acc>.<field>`` is not
  accumulative.
- C007 every ``Stats`` field is surfaced: read as an attribute somewhere
  in ``core/metrics.py`` or ``core/timing.py``.
- C008 stage code writes only into its OWN result slot:
  ``out[...].info[...] = ...`` targets must be ``out[self.name]``.

Every check takes explicit inputs (objects or file paths) so the tests
can aim it at deliberately broken copies; ``run()`` wires the port's
own.  No framework is imported beyond what the port's stage registry
imports.
"""
from __future__ import annotations

import ast
import inspect
import re
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
STAGES_DIR = PKG / "core" / "stages"
METRIC_PATHS = (PKG / "core" / "metrics.py", PKG / "core" / "timing.py")

LOOKUP_PARAMS = ("self", "cfg", "st", "req", "need")
FILL_PARAMS = ("self", "cfg", "st", "req", "out")

STATS_FIELD_RE = re.compile(r"^(n_|sum_|hist_)")

# state fields allocated per gated feature: cfg gate flag -> MMUState
# keywords that must follow the sized-1-when-off convention.  The L3 TLB
# gates on a size (l3tlb_sets > 0), hence the max(x, 1) variant.
STATE_GATES = {
    "pom": ("pom",),
    "utopia": ("restseg4", "restseg2"),
    "revelator": ("rev",),
    "virt": ("ntlb", "pch"),
    "collect": ("feats",),
}
STATE_MAX_GATES = ("l3tlb",)  # sized via max(cfg.*_sets, 1)
# size-gated allocations nested inside another keyword's call: state
# keyword -> cfg size fields that must each appear as max(cfg.<f>, 1).
# The die-stacked DRAM cache rides make_hier, so its guard lives inside
# the hier= expression.
STATE_NESTED_MAX_GATES = {"hier": ("dram_cache_sets",)}

# in-place folds that accumulate into a tensor of the accumulator
ACCUM_METHODS = ("add_",)


# --------------------------------------------------------------- C001


def check_stage_objects(stages=None) -> list:
    from repro_torch.core import stages as stage_mod

    stages = stage_mod.STAGES if stages is None else stages
    findings = []
    for key, stg in stages.items():
        cls = type(stg).__name__
        if getattr(stg, "name", "?") in ("?", "", None):
            findings.append(
                f"C001 stage {cls}: placeholder/missing 'name' attribute")
        elif stg.name != key:
            findings.append(
                f"C001 stage {cls}: name {stg.name!r} != registry key "
                f"{key!r}")
        if not isinstance(getattr(stg, "past_l2", None), bool):
            findings.append(
                f"C001 stage {cls}: 'past_l2' must be declared as a bool "
                f"(got {getattr(stg, 'past_l2', None)!r})")
        for meth, want in (("lookup", LOOKUP_PARAMS), ("fill", FILL_PARAMS)):
            fn = getattr(type(stg), meth, None)
            if fn is None:
                findings.append(f"C001 stage {cls}: missing {meth}()")
                continue
            got = tuple(inspect.signature(fn).parameters)
            if got != want:
                findings.append(
                    f"C001 stage {cls}: {meth}{got} violates the stage "
                    f"contract {meth}{want}")
    return findings


# --------------------------------------------------------------- C002


def check_registry() -> list:
    from repro_torch.core import stages as stage_mod
    from repro_torch.sim import systems

    findings = []
    for name, sys_ in systems.REGISTRY.items():
        unknown = [s for s in sys_.stages if s not in stage_mod.STAGES]
        if unknown:
            findings.append(
                f"C002 system {name!r}: unknown stages {unknown}")
            continue
        if sys_.stages[-1] not in stage_mod.WALK_STAGES:
            findings.append(
                f"C002 system {name!r}: composition must end in a walker "
                f"stage {stage_mod.WALK_STAGES}, ends in "
                f"{sys_.stages[-1]!r}")
        try:
            stage_mod.validate_stages(sys_.config(), sys_.stages)
        except ValueError as e:
            findings.append(f"C002 system {name!r}: {e}")
    return findings


# --------------------------------------------------------------- C003


def check_dyn_tables() -> list:
    import dataclasses

    from repro_torch.core import stages as stage_mod
    from repro_torch.core.stages.base import DYN_FIELDS, Dyn, SimConfig
    from repro_torch.sim import systems

    cfg_fields = {f.name for f in dataclasses.fields(SimConfig)}
    findings = []
    for stage, (cfg_field, gate) in systems.DYN_GATED_STAGES.items():
        if stage not in stage_mod.STAGES:
            findings.append(
                f"C003 DYN_GATED_STAGES[{stage!r}]: not a registered stage")
        if cfg_field not in cfg_fields:
            findings.append(
                f"C003 DYN_GATED_STAGES[{stage!r}]: {cfg_field!r} is not "
                f"a SimConfig field")
        if gate not in Dyn._fields:
            findings.append(
                f"C003 DYN_GATED_STAGES[{stage!r}]: gate {gate!r} is not "
                f"a Dyn field")
    for f in DYN_FIELDS:
        if f not in cfg_fields:
            findings.append(f"C003 DYN_FIELDS entry {f!r}: not a "
                            f"SimConfig field")
    return findings


# --------------------------------------------------------------- C004


def _is_cfg_attr(node, field: str) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == field
            and isinstance(node.value, ast.Name) and node.value.id == "cfg")


def _locals_once(fn: ast.FunctionDef) -> dict:
    """Names assigned exactly once in `fn` (``name = expr``) -> expr; a
    name assigned more than once is not read through."""
    seen: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    seen.setdefault(t.id, []).append(node.value)
    return {k: v[0] for k, v in seen.items() if len(v) == 1}


def _reads(node: ast.expr, env: dict, seen=()) -> list:
    """`node` and the values of the locals it reads, transitively."""
    out = [node]
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in env \
                and sub.id not in seen:
            seen = seen + (sub.id,)
            out += _reads(env[sub.id], env, seen)
    return out


def _gate_in(node: ast.expr, flag: str) -> bool:
    """Does ``node`` itself contain ``<x> if cfg.<flag> else 1``?"""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.IfExp)
                and isinstance(sub.orelse, ast.Constant)
                and sub.orelse.value == 1
                and any(_is_cfg_attr(t, flag) for t in ast.walk(sub.test))):
            return True
    return False


def _gated_ok(node: ast.expr, flag: str, env: dict) -> str | None:
    """None when ``node`` follows the sized-1-when-off convention for
    ``cfg.<flag>``, else why not.  The gate may sit in a local the node
    reads (``env``: the function's locals assigned once); every such
    local must then carry the gate itself."""
    ungated = sorted({sub.id for sub in ast.walk(node)
                      if isinstance(sub, ast.Name) and sub.id in env
                      and not any(_gate_in(x, flag)
                                  for x in _reads(env[sub.id], env))})
    if ungated:
        return (f"reads the local(s) {ungated}, sized without "
                f"'if cfg.{flag} else 1'")
    if not any(_gate_in(x, flag) for x in _reads(node, env)):
        return f"has no '<sets> if cfg.{flag} else 1'"
    return None


def _max1_ok(node: ast.expr, env: dict) -> bool:
    """Does ``node`` (or a local it reads) contain ``max(<x>, 1)``?"""
    for x in _reads(node, env):
        for sub in ast.walk(x):
            if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                    and sub.func.id == "max"
                    and any(isinstance(a, ast.Constant) and a.value == 1
                            for a in sub.args)):
                return True
    return False


def _max1_of(node: ast.expr, field: str, env: dict) -> bool:
    """Does ``node`` (or a local it reads) contain ``max(<x involving
    cfg.field>, 1)``?"""
    for x in _reads(node, env):
        for sub in ast.walk(x):
            if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                    and sub.func.id == "max"
                    and any(isinstance(a, ast.Constant) and a.value == 1
                            for a in sub.args)
                    and any(_is_cfg_attr(t, field)
                            for a in sub.args for t in ast.walk(a))):
                return True
    return False


def check_make_state(path=None) -> list:
    path = Path(path) if path else STAGES_DIR / "base.py"
    tree = ast.parse(path.read_text())
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef) and n.name == "make_state"),
              None)
    if fn is None:
        return [f"C004 {path.name}: no make_state() found"]
    call = next((n for n in ast.walk(fn)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                 and n.func.id == "MMUState"), None)
    if call is None:
        return [f"C004 {path.name}: make_state() does not build MMUState"]
    kwargs = {kw.arg: kw.value for kw in call.keywords if kw.arg}
    env = _locals_once(fn)

    findings = []
    for flag, state_fields in STATE_GATES.items():
        for sf in state_fields:
            if sf not in kwargs:
                findings.append(
                    f"C004 make_state: expected state field {sf!r} "
                    f"(gated by cfg.{flag}) is not allocated")
                continue
            why = _gated_ok(kwargs[sf], flag, env)
            if why:
                findings.append(
                    f"C004 make_state: state field {sf!r} must follow the "
                    f"sized-1-when-off convention "
                    f"('<sets> if cfg.{flag} else 1') so off lanes carry "
                    f"a 1-entry structure; it {why}")
    for sf in STATE_MAX_GATES:
        if sf not in kwargs:
            findings.append(
                f"C004 make_state: expected state field {sf!r} is not "
                f"allocated")
        elif not _max1_ok(kwargs[sf], env):
            findings.append(
                f"C004 make_state: state field {sf!r} gates on a size and "
                f"must be allocated via max(<sets>, 1)")
    for sf, cfg_fields in STATE_NESTED_MAX_GATES.items():
        for cf in cfg_fields:
            if sf not in kwargs:
                findings.append(
                    f"C004 make_state: expected state field {sf!r} is not "
                    f"allocated")
            elif not _max1_of(kwargs[sf], cf, env):
                findings.append(
                    f"C004 make_state: state field {sf!r} must size its "
                    f"cfg.{cf} region via max(cfg.{cf}, 1) so off lanes "
                    f"carry a 1-entry structure")
    return findings


# ---------------------------------------------------------- C005/C006


def _stage_sources(node: ast.expr, env: dict) -> set:
    """Stage names feeding an accumulation expression.

    ``out["x"]`` / ``_hit32(out, "x")`` attribute to stage x;
    ``walk_res`` to the walker; locals resolve through ``env`` (the
    name -> sources map built while walking accum_stats's body).
    """
    src: set = set()
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Subscript) and isinstance(sub.value, ast.Name)
                and sub.value.id == "out"
                and isinstance(sub.slice, ast.Constant)):
            src.add(str(sub.slice.value))
        elif isinstance(sub, ast.Name):
            if sub.id == "walk_res":
                src.add("<walker>")
            elif sub.id in env:
                src |= env[sub.id]
        elif (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id == "_hit32" and len(sub.args) >= 2
                and isinstance(sub.args[1], ast.Constant)):
            src.add(str(sub.args[1].value))
    return src


def _acc_field(node, acc: str) -> str | None:
    """``<acc>.<f>`` or ``<acc>.<f>[...]`` -> f."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == acc):
        return node.attr
    return None


def _simple_stmts(stmts):
    """The statements of a body in source order, compound statements
    (if, for, while, with) opened."""
    for st in stmts:
        if isinstance(st, (ast.If, ast.For, ast.While, ast.With)):
            yield from _simple_stmts(st.body)
            yield from _simple_stmts(getattr(st, "orelse", []))
        else:
            yield st


def _writes_in(stmt, acc: str) -> list:
    """(field, accumulative, expressions feeding it) for every write to a
    field of the accumulator in one simple statement: ``<acc>.<f>.add_(x)``
    (and the other ACCUM_METHODS) and ``<acc>.<f>[i] += x`` accumulate;
    ``<acc>.<f> = x``, ``<acc>.<f>[i] = x`` and any other in-place method
    (``copy_``, ``fill_``, ...) do not."""
    writes = []
    for node in ast.walk(stmt):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.endswith("_")):
            f = _acc_field(node.func.value, acc)
            if f is not None:
                writes.append((f, node.func.attr in ACCUM_METHODS,
                               list(node.args)))
        elif isinstance(node, ast.AugAssign):
            f = _acc_field(node.target, acc)
            if f is not None:
                parts = [node.value]
                if isinstance(node.target, ast.Subscript):
                    parts.append(node.target.slice)
                writes.append((f, isinstance(node.op, ast.Add), parts))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                f = _acc_field(t, acc)
                if f is not None:
                    writes.append((f, False, [node.value]))
    return writes


def check_stats_fold(stats_fields=None, fold_path=None) -> list:
    """C005: every Stats field folded accumulatively in accum_stats;
    C006: at most one stage source per field (single-writer)."""
    if stats_fields is None:
        from repro_torch.core.stages.base import Stats

        stats_fields = Stats._fields
    fold_path = Path(fold_path) if fold_path else STAGES_DIR / "fold.py"
    tree = ast.parse(fold_path.read_text())
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)
               and n.name == "accum_stats"), None)
    if fn is None:
        return [f"C005 {fold_path.name}: no accum_stats() found"]
    if not fn.args.args:
        return [f"C005 {fold_path.name}: accum_stats takes no accumulator"]
    acc = fn.args.args[0].arg

    findings = []
    for f in stats_fields:
        if not STATS_FIELD_RE.match(f):
            findings.append(
                f"C005 Stats.{f}: violates the n_*/sum_*/hist_* naming "
                f"convention")

    # in statement order: the in-place writes, each with the stage
    # sources of what feeds it at that point, and the taint map (local
    # name -> stage sources; a name assigned again takes its new sources)
    env: dict = {}
    inplace: dict = {}   # field -> [(accumulative, sources, line)]
    ret = None
    for stmt in _simple_stmts(fn.body):
        if isinstance(stmt, ast.Return):
            ret = stmt.value
        for f, accum, parts in _writes_in(stmt, acc):
            srcs = set().union(*[_stage_sources(p, env) for p in parts])
            inplace.setdefault(f, []).append((accum, srcs, stmt.lineno))
        if isinstance(stmt, ast.Assign):
            srcs = _stage_sources(stmt.value, env)
            for tgt in stmt.targets:
                for t in ast.walk(tgt):
                    if isinstance(t, ast.Name):
                        env[t.id] = srcs

    if (isinstance(ret, ast.Call) and isinstance(ret.func, ast.Name)
            and ret.func.id == "Stats"):
        folded = {}
        for kw in ret.keywords:
            if kw.arg:
                reads = any(_acc_field(sub, acc) == kw.arg
                            for sub in ast.walk(kw.value))
                folded.setdefault(kw.arg, []).append(
                    (reads, _stage_sources(kw.value, env), ret.lineno))
    elif isinstance(ret, ast.Name) and ret.id == acc:
        folded = inplace
    else:
        return findings + [
            f"C005 {fold_path.name}: accum_stats must return Stats(...) "
            f"or its accumulator {acc!r}"]

    for f in stats_fields:
        if f not in folded:
            findings.append(
                f"C005 Stats.{f}: not folded — accum_stats never "
                f"accumulates into {f} (orphan field: the accumulator "
                f"silently drops it)")
            continue
        writes = folded[f]
        bad = [line for accum, _, line in writes if not accum]
        if bad:
            findings.append(
                f"C005 Stats.{f}: fold is not accumulative (line "
                f"{bad[0]}) — it never adds to {acc}.{f}, so per-step "
                f"values overwrite instead of accumulate")
        if len(writes) > 1:
            findings.append(
                f"C005 Stats.{f}: folded in {len(writes)} places (lines "
                f"{[line for _, _, line in writes]}); fold each field in "
                f"exactly one")
        stage_srcs = set().union(*[s for _, s, _ in writes]) - {"_walk"}
        if len(stage_srcs) > 1:
            findings.append(
                f"C006 Stats.{f}: written by {len(stage_srcs)} stages "
                f"({sorted(stage_srcs)}); every Stats field must have "
                f"exactly one writer")
    for extra in sorted(set(folded) - set(stats_fields)):
        findings.append(
            f"C005 accum_stats folds unknown field {extra!r} (not a "
            f"Stats field)")
    return findings


# --------------------------------------------------------------- C007


def check_stats_surfaced(stats_fields=None, metric_paths=None) -> list:
    if stats_fields is None:
        from repro_torch.core.stages.base import Stats

        stats_fields = Stats._fields
    metric_paths = [Path(p) for p in (metric_paths or METRIC_PATHS)]

    read: set = set()
    for p in metric_paths:
        for sub in ast.walk(ast.parse(p.read_text())):
            if isinstance(sub, ast.Attribute):
                read.add(sub.attr)
    return [
        f"C007 Stats.{f}: orphan — accumulated every step but never read "
        f"by {'/'.join(p.name for p in metric_paths)}; surface it as a "
        f"metric or delete it"
        for f in stats_fields if f not in read
    ]


# --------------------------------------------------------------- C008


def check_stage_info_writes(stage_dir=None) -> list:
    stage_dir = Path(stage_dir) if stage_dir else STAGES_DIR
    findings = []
    for path in sorted(stage_dir.glob("*.py")):
        if path.name in ("base.py", "fold.py", "__init__.py"):
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Assign, ast.AugAssign)):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                # match out[<X>].info[...] = ...
                if not (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Attribute)
                        and tgt.value.attr == "info"
                        and isinstance(tgt.value.value, ast.Subscript)
                        and isinstance(tgt.value.value.value, ast.Name)
                        and tgt.value.value.value.id == "out"):
                    continue
                key = tgt.value.value.slice
                own = (isinstance(key, ast.Attribute)
                       and key.attr == "name"
                       and isinstance(key.value, ast.Name)
                       and key.value.id == "self")
                if not own:
                    findings.append(
                        f"C008 {path.name}:{node.lineno}: stage writes "
                        f"into a foreign result slot "
                        f"(out[{ast.unparse(key)}].info); stages may only "
                        f"publish into out[self.name].info")
    return findings


# ---------------------------------------------------------------- run


def run() -> list:
    """All contract checks against the port; returns findings."""
    findings = []
    findings += check_stage_objects()
    findings += check_registry()
    findings += check_dyn_tables()
    findings += check_make_state()
    findings += check_stats_fold()
    findings += check_stats_surfaced()
    findings += check_stage_info_writes()
    return findings
