"""Derive BENCH_sweep fill records from span traces — live and offline.

The port's copy of ``repro.obs.report``: the same schemas, field sources
and derivations, so a record means the same in both packages.

The contract that makes ``BENCH_sweep.json`` trustworthy: the producer
(``sim.runner.run_ladder``) does NOT hand-assemble its ``LADDER_PERF``
record.  It closes the fill's span tree and calls :func:`fill_record`
on the tracer's in-memory events — the SAME function the CLI
(``python -m repro_torch.obs report``) applies to the JSONL file.  Because
span records are JSON-sanitized at emission (``tracer._jsonable``) and
events are replayed in emission order, the offline reconstruction is
**bit-exact**, which ``report --check`` (and the round-trip test)
asserts against a written artifact.

:data:`FIELD_SOURCES` is the field→source table the derivation walks;
the reference's OB001 analyzer pass checks its copy of this table stays
closed over :data:`SCHEMA6_FIELDS` and only references declared
names — no orphan hand-set fields can reappear.
"""
from __future__ import annotations

import json

from repro_torch.obs import names

# BENCH_sweep.json ladder-fill record schemas.  Schema 5 = schema 4 plus
# the producer-side generation truth and the trace pointer; the schema-4
# fields stay bit-compatible (same names, same rounding).
SCHEMA4_FIELDS = (
    "ladder", "n_systems", "n_members", "n_workloads", "sim_n",
    "dispatch_compiles", "one_compile", "devices", "mesh",
    "chunk", "chunk_auto", "n_chunks", "backend", "block",
    "t_shards", "t_rounds", "trace_gen_wall_s", "compile_plus_sim_wall_s",
)
SCHEMA5_FIELDS = SCHEMA4_FIELDS + ("trace_gen_true_wall_s", "trace_file")
# Schema 6 = schema 5 plus the fill's core count (1 for single-core
# ladders; C for multicore families running multiprogrammed mixes).
# Schema-5 fields stay bit-compatible — same names, same rounding.
SCHEMA6_FIELDS = SCHEMA5_FIELDS + ("cores",)

# field -> (kind, arg) derivation source, all rooted at one ladder_fill
# span subtree:
#   attr            fill-span attribute `arg`
#   sum_span_dur    round(sum of dur_s over descendant spans named `arg`, 3)
#   count_compiles  number of descendant EV_COMPILE events whose fn attr
#                   equals the fill's `arg` attribute (run_systems vs the
#                   per-chunk round_fn of the time-shard path)
#   derived         computed from other derived fields (`arg` names them)
#   trace_path      the JSONL file the events came from
FIELD_SOURCES = {
    "ladder": ("attr", "ladder"),
    "n_systems": ("attr", "n_systems"),
    "n_members": ("attr", "n_members"),
    "n_workloads": ("attr", "n_workloads"),
    "sim_n": ("attr", "sim_n"),
    "dispatch_compiles": ("count_compiles", "dispatch_fn"),
    "one_compile": ("derived", "dispatch_compiles"),
    "devices": ("attr", "devices"),
    "mesh": ("attr", "mesh"),
    "chunk": ("attr", "chunk"),
    "chunk_auto": ("attr", "chunk_auto"),
    "n_chunks": ("attr", "n_chunks"),
    "backend": ("attr", "backend"),
    "block": ("attr", "block"),
    "t_shards": ("attr", "t_shards"),
    "t_rounds": ("attr", "t_rounds"),
    "trace_gen_wall_s": ("sum_span_dur", names.SPAN_CHUNK_WAIT),
    "compile_plus_sim_wall_s": ("sum_span_dur", names.SPAN_DISPATCH),
    # a sum over the pool threads' trace_gen spans: thread time, not the
    # wall time generation took (threads overlap); kept so, for parity
    # with the reference, whose FIELD_SOURCES this table must equal
    "trace_gen_true_wall_s": ("sum_span_dur", names.SPAN_TRACE_GEN),
    "trace_file": ("trace_path", None),
    "cores": ("attr", "cores"),
}


# BENCH_serve.json serving-run record schema — the load harness's
# analogue of the ladder-fill record, rooted at one serve.load_run span
# subtree.  Same discipline: the producer (serve.load.run_trace) does
# not hand-assemble its SERVE_PERF record; it closes the run span and
# calls serve_record on the tracer's in-memory events — the same
# function the CLI applies to the JSONL, so `report --check` is
# bit-exact for BENCH_serve exactly like BENCH_sweep.
SERVE_FIELDS = (
    "run", "arrival", "rate", "lanes", "mesh", "devices",
    "n_slots", "n_pool_pages", "gate", "n_ticks", "n_arrivals",
    "admitted", "rejected", "retired", "pool_stall", "invalidated",
    "decode_p50_s", "decode_p99_s", "decode_mean_s", "wall_s",
    "throughput_rps", "vtc_hit_tc", "vtc_hit_cluster", "vtc_walk",
    "vtc_hit_rate", "trace_file",
)

# field -> (kind, arg) sources for SERVE_FIELDS, all rooted at one
# serve.load_run span subtree:
#   attr           run-span attribute `arg`
#   sum_counts     sum of `n` over descendant count records named `arg`
#   dur_quantile   `arg` = (span_name, p): quantile of descendant span
#                  durations named span_name, the registry's hist
#                  formula (p in {50, 99}; "mean" = sum/len), round 6
#   span_dur       the run span's own dur_s, round 3
#   derived        computed from other derived fields (`arg` names them)
#   trace_path     the JSONL file the events came from
SERVE_FIELD_SOURCES = {
    "run": ("attr", "run"),
    "arrival": ("attr", "arrival"),
    "rate": ("attr", "rate"),
    "lanes": ("attr", "lanes"),
    "mesh": ("attr", "mesh"),
    "devices": ("attr", "devices"),
    "n_slots": ("attr", "n_slots"),
    "n_pool_pages": ("attr", "n_pool_pages"),
    "gate": ("attr", "gate"),
    "n_ticks": ("attr", "n_ticks"),
    "n_arrivals": ("attr", "n_arrivals"),
    "admitted": ("sum_counts", names.CTR_REQS_ADMITTED),
    "rejected": ("sum_counts", names.CTR_POOL_EXHAUSTED),
    "retired": ("sum_counts", names.CTR_REQS_RETIRED),
    "pool_stall": ("attr", "pool_stall"),
    "invalidated": ("sum_counts", names.CTR_VTC_INVALIDATE),
    "decode_p50_s": ("dur_quantile", (names.SPAN_DECODE_STEP, 50)),
    "decode_p99_s": ("dur_quantile", (names.SPAN_DECODE_STEP, 99)),
    "decode_mean_s": ("dur_quantile", (names.SPAN_DECODE_STEP, "mean")),
    "wall_s": ("span_dur", None),
    "throughput_rps": ("derived", ("retired", "wall_s")),
    "vtc_hit_tc": ("attr", "vtc_hit_tc"),
    "vtc_hit_cluster": ("attr", "vtc_hit_cluster"),
    "vtc_walk": ("attr", "vtc_walk"),
    "vtc_hit_rate": ("derived",
                     ("vtc_hit_tc", "vtc_hit_cluster", "vtc_walk")),
    "trace_file": ("trace_path", None),
}


def read_trace(path: str) -> list[dict]:
    """Parse a JSONL trace back into the tracer's event-list form."""
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") != "meta":
                events.append(rec)
    return events


def _descendants(events: list[dict], root_id: int) -> set[int]:
    """Ids of `root_id` and everything transitively parented under it."""
    kids: dict[int, list[int]] = {}
    for e in events:
        p = e.get("parent")
        if p is not None and "id" in e:
            kids.setdefault(p, []).append(e["id"])
    out, todo = {root_id}, [root_id]
    while todo:
        for c in kids.get(todo.pop(), ()):
            if c not in out:
                out.add(c)
                todo.append(c)
    return out


def fill_spans(events: list[dict]) -> list[dict]:
    """All closed ladder_fill spans, in emission (= completion) order."""
    return [e for e in events
            if e.get("kind") == "span"
            and e.get("name") == names.SPAN_LADDER_FILL]


def fill_record(events: list[dict], fill_id: int | None = None,
                trace_file: str | None = None) -> dict:
    """Derive one schema-6 ladder-fill record from a fill's span subtree.

    `events` is either ``tracer().events`` (live) or
    :func:`read_trace` output (offline) — identical by construction.
    `fill_id` picks the fill span (default: the only/last one).
    """
    fills = fill_spans(events)
    if fill_id is not None:
        fills = [f for f in fills if f["id"] == fill_id]
    if not fills:
        raise ValueError(
            f"no closed '{names.SPAN_LADDER_FILL}' span"
            + (f" with id {fill_id}" if fill_id is not None else "")
            + " in trace")
    fill = fills[-1]
    sub = _descendants(events, fill["id"])
    attrs = fill["attrs"]

    # duration sums accumulate in emission order over full-precision
    # dur_s values, then round once — bit-identical live and offline
    sums: dict[str, float] = {}
    for e in events:
        if (e.get("kind") == "span" and e.get("id") in sub
                and e["id"] != fill["id"]):
            sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur_s"]

    dispatch_fn = attrs.get("dispatch_fn")
    n_compiles = sum(
        1 for e in events
        if e.get("kind") == "event" and e.get("name") == names.EV_COMPILE
        and e.get("id") in sub and e["attrs"].get("fn") == dispatch_fn)

    rec: dict = {}
    for field in SCHEMA6_FIELDS:
        kind, arg = FIELD_SOURCES[field]
        if kind == "attr":
            rec[field] = attrs.get(arg)
        elif kind == "sum_span_dur":
            rec[field] = round(sums.get(arg, 0.0), 3)
        elif kind == "count_compiles":
            rec[field] = n_compiles
        elif kind == "derived":
            rec[field] = rec[arg] <= 1  # one_compile
        elif kind == "trace_path":
            rec[field] = trace_file
        else:  # pragma: no cover - FIELD_SOURCES is closed by OB001
            raise ValueError(f"unknown source kind {kind!r} for {field!r}")
    return rec


def ladder_records(events: list[dict],
                   trace_file: str | None = None) -> list[dict]:
    """One derived record per closed ladder_fill span, in order."""
    return [fill_record(events, f["id"], trace_file)
            for f in fill_spans(events)]


def fill_counters(events: list[dict]) -> list[dict]:
    """For each closed fill (a ``ladder_fill`` or ``batch_fill`` span at
    the root), in order: its name and id, and the count records under it
    summed by name (a job's counters, where a job is one fill)."""
    roots = [e for e in events if e.get("kind") == "span"
             and e.get("parent") is None
             and e.get("name") in (names.SPAN_LADDER_FILL,
                                   names.SPAN_BATCH_FILL)]
    out = []
    for r in roots:
        sub = _descendants(events, r["id"])
        counts: dict[str, float] = {}
        for e in events:
            if e.get("kind") == "count" and e.get("id") in sub:
                counts[e["name"]] = counts.get(e["name"], 0) + e.get("n", 1)
        out.append({"fill": r["name"], "id": r["id"], "counters": counts})
    return out


# ----------------------------------------------------- serve records

def serve_spans(events: list[dict]) -> list[dict]:
    """All closed serve.load_run spans, in emission order."""
    return [e for e in events
            if e.get("kind") == "span"
            and e.get("name") == names.SPAN_SERVE_RUN]


def _quantile(samples: list[float], p) -> float | None:
    """The registry's hist-stats quantile on a sorted copy (round 6)."""
    if not samples:
        return None
    s = sorted(samples)
    if p == "mean":
        return round(sum(s) / len(s), 6)
    return round(s[min(len(s) - 1, int(len(s) * p / 100))], 6)


def serve_record(events: list[dict], run_id: int | None = None,
                 trace_file: str | None = None) -> dict:
    """Derive one BENCH_serve record from a serve.load_run span subtree.

    Mirrors :func:`fill_record`: `events` is ``tracer().events`` (live)
    or :func:`read_trace` output (offline) — identical by construction,
    so the offline reconstruction is bit-exact.
    """
    runs = serve_spans(events)
    if run_id is not None:
        runs = [r for r in runs if r["id"] == run_id]
    if not runs:
        raise ValueError(
            f"no closed '{names.SPAN_SERVE_RUN}' span"
            + (f" with id {run_id}" if run_id is not None else "")
            + " in trace")
    run = runs[-1]
    sub = _descendants(events, run["id"])
    attrs = run["attrs"]

    count_sums: dict[str, int] = {}
    durs: dict[str, list[float]] = {}
    for e in events:
        if e.get("id") not in sub or e["id"] == run["id"]:
            continue
        if e.get("kind") == "count":
            count_sums[e["name"]] = count_sums.get(e["name"], 0) \
                + e.get("n", 1)
        elif e.get("kind") == "span":
            durs.setdefault(e["name"], []).append(e["dur_s"])

    rec: dict = {}
    for field in SERVE_FIELDS:
        kind, arg = SERVE_FIELD_SOURCES[field]
        if kind == "attr":
            rec[field] = attrs.get(arg)
        elif kind == "sum_counts":
            rec[field] = count_sums.get(arg, 0)
        elif kind == "dur_quantile":
            rec[field] = _quantile(durs.get(arg[0], []), arg[1])
        elif kind == "span_dur":
            rec[field] = round(run["dur_s"], 3)
        elif kind == "derived":
            if field == "throughput_rps":
                rec[field] = (round(rec["retired"] / rec["wall_s"], 3)
                              if rec["wall_s"] else None)
            elif field == "vtc_hit_rate":
                hit = (rec["vtc_hit_tc"] or 0) \
                    + (rec["vtc_hit_cluster"] or 0)
                tot = hit + (rec["vtc_walk"] or 0)
                rec[field] = round(hit / max(tot, 1), 6)
            else:  # pragma: no cover - closed by OB001
                raise ValueError(f"unknown derived field {field!r}")
        elif kind == "trace_path":
            rec[field] = trace_file
        else:  # pragma: no cover - SERVE_FIELD_SOURCES is closed by OB001
            raise ValueError(f"unknown source kind {kind!r} for {field!r}")
    return rec


def serve_records(events: list[dict],
                  trace_file: str | None = None) -> list[dict]:
    """One derived record per closed serve.load_run span, in order."""
    return [serve_record(events, r["id"], trace_file)
            for r in serve_spans(events)]


# ----------------------------------------------------------- CLI verbs

def rollup(events: list[dict], trace_file: str | None = None) -> dict:
    """Human-oriented trace summary: fills, span totals, counters."""
    span_totals: dict[str, dict] = {}
    for e in events:
        if e.get("kind") == "span":
            t = span_totals.setdefault(e["name"], {"count": 0, "dur_s": 0.0})
            t["count"] += 1
            t["dur_s"] += e["dur_s"]
    for t in span_totals.values():
        t["dur_s"] = round(t["dur_s"], 6)
    ev_counts: dict[str, int] = {}
    for e in events:
        if e.get("kind") == "event":
            ev_counts[e["name"]] = ev_counts.get(e["name"], 0) + 1
    counters: dict[str, float] = {}
    for e in events:
        if e.get("kind") == "count":
            counters[e["name"]] = counters.get(e["name"], 0) + e.get("n", 1)
    metrics = [e["data"] for e in events if e.get("kind") == "metrics"]
    return {
        "trace_file": trace_file,
        "n_events": len(events),
        "fills": ladder_records(events, trace_file),
        "serve_runs": serve_records(events, trace_file),
        "spans": span_totals,
        "events": ev_counts,
        "counters": counters,
        "metrics": metrics[-1] if metrics else None,
    }


def check(events: list[dict], bench: dict,
          trace_file: str | None = None) -> list[str]:
    """Verify a BENCH_sweep artifact against its trace, field by field.

    Every ``ladder_fills`` record must be reproduced bit-exactly by the
    trace-derived record at the same position — schema-4 fields always;
    schema-5/6 extras when the artifact carries them.  A BENCH_serve
    artifact's ``serve_runs`` records get the identical positional
    treatment against :func:`serve_records`.  Returns a list of
    mismatch strings (empty = pass).
    """
    problems: list[str] = []
    want = bench.get("ladder_fills", [])
    got = ladder_records(events, trace_file)
    if len(want) != len(got):
        problems.append(
            f"artifact has {len(want)} ladder_fills but trace derives "
            f"{len(got)} fill records")
    for i, (w, g) in enumerate(zip(want, got)):
        for field in SCHEMA6_FIELDS:
            if field not in w:
                continue  # schema-4 artifact: extras absent, fine
            if field == "trace_file":
                continue  # path differs across machines by design
            if w[field] != g[field]:
                problems.append(
                    f"fill[{i}] field {field!r}: artifact has "
                    f"{w[field]!r}, trace derives {g[field]!r}")
    want_s = bench.get("serve_runs", [])
    got_s = serve_records(events, trace_file) if want_s else []
    if want_s and len(want_s) != len(got_s):
        problems.append(
            f"artifact has {len(want_s)} serve_runs but trace derives "
            f"{len(got_s)} serve records")
    for i, (w, g) in enumerate(zip(want_s, got_s)):
        for field in SERVE_FIELDS:
            if field not in w:
                continue
            if field == "trace_file":
                continue  # path differs across machines by design
            if w[field] != g[field]:
                problems.append(
                    f"serve_run[{i}] field {field!r}: artifact has "
                    f"{w[field]!r}, trace derives {g[field]!r}")
    return problems


def diff(old: dict, new: dict, warn_pct: float = 20.0) -> dict:
    """Compare two BENCH_sweep artifacts' wall times, fill by fill.

    Fills are matched on their configuration key (ladder, sim_n,
    workload count, backend, chunk, time shards); unmatched fills are
    listed, not errors.  A matched fill whose wall time grew more than
    `warn_pct` percent lands in ``regressions``.
    """
    def keyed(art):
        out = {}
        for r in art.get("ladder_fills", []):
            k = (r.get("ladder"), r.get("sim_n"), r.get("n_workloads"),
                 r.get("backend"), r.get("chunk"), r.get("t_shards"))
            out.setdefault(k, []).append(r)
        return out

    ko, kn = keyed(old), keyed(new)
    rows, regressions = [], []
    for k in kn:
        for i, r_new in enumerate(kn[k]):
            r_old = ko.get(k, [])[i] if i < len(ko.get(k, [])) else None
            if r_old is None:
                rows.append({"key": list(k), "status": "new-only"})
                continue
            row = {"key": list(k), "status": "matched"}
            for field in ("compile_plus_sim_wall_s", "trace_gen_wall_s"):
                a, b = r_old.get(field), r_new.get(field)
                row[field] = {"old": a, "new": b}
                if a and b is not None and a > 0:
                    pct = 100.0 * (b - a) / a
                    row[field]["pct"] = round(pct, 1)
                    if pct > warn_pct:
                        regressions.append(
                            f"{k}: {field} {a} -> {b} (+{pct:.1f}% > "
                            f"{warn_pct:g}% threshold)")
            rows.append(row)
    only_old = [list(k) for k in ko if k not in kn]
    return {"fills": rows, "old_only": only_old,
            "regressions": regressions, "warn_pct": warn_pct}
