"""The five readers of the program's spans (``bench/lib/spans.py``) on
synthetic jobs: overlapping trace_gen spans read as a union, a scan span
that straddles two kernels, the move onto the profiler's clock, and
nothing to read where the spans are absent (all on the CPU)."""
from types import SimpleNamespace

import pytest

from bench.lib import manifest, spans

K = "void (anonymous namespace)::mmu_step_kernel<true, true, 1, false>(Params)"
READERS = ("runner.trace_wait_ms_per_job", "runner.trace_gen_busy_ms_per_job",
           "runner.stage_ms_per_job", "runner.fold_ms_per_job",
           "mmu_step.scan_gap_ms_per_job")


def _span(name, t0, dur_s):
    return {"kind": "span", "name": name, "t0": t0, "dur_s": dur_s}


def _job(w, t0_us):
    """A job whose annotation opened at `w` (host seconds), `t0_us` on
    the trace's clock."""
    return {"wall0": w, "t0": t0_us, "t1": t0_us + 2e6,
            "span_events": [
                _span("chunk_wait", w + 0.001, 0.2),
                # three generating threads: 0.001-0.101 and 0.05-0.15
                # overlap, 0.2-0.25 stands alone
                _span("trace_gen", w + 0.001, 0.1),
                _span("trace_gen", w + 0.05, 0.1),
                _span("trace_gen", w + 0.2, 0.05),
                _span("stage", w + 0.21, 0.01),
                _span("scan", w + 0.22, 0.5),
                _span("fold", w + 0.72, 0.02)]}


def _ctx(jobs, device=()):
    return SimpleNamespace(setup_s=4.0, window_s=2.0, jobs=jobs,
                           device=list(device), window=(0.0, 1e9))


def _read(name, ctx):
    return manifest.reader(name)(ctx)


def test_on_trace_clock_moves_a_span_by_the_job_s_offset():
    job = _job(1000.0, 5e6)
    assert spans.offset_us(job) == pytest.approx(5e6 - 1e9)
    a, b = spans.on_trace_clock(job, job["span_events"][5])  # scan
    assert (a, b) == (pytest.approx(5.22e6), pytest.approx(5.72e6))


def test_sums_and_the_union_of_overlapping_trace_gen_spans():
    jobs = [_job(1000.0, 5e6), _job(2000.0, 9e6)]
    jobs[1]["span_events"][0]["dur_s"] = 0.4  # job 1 waits 0.4 s
    ctx = _ctx(jobs)
    assert _read("runner.trace_wait_ms_per_job", ctx) == pytest.approx(300.0)
    # union 0.001-0.15 and 0.2-0.25: 0.199 s, where the sum is 0.25
    assert _read("runner.trace_gen_busy_ms_per_job", ctx) == \
        pytest.approx(199.0)
    assert _read("runner.stage_ms_per_job", ctx) == pytest.approx(10.0)
    assert _read("runner.fold_ms_per_job", ctx) == pytest.approx(20.0)


def test_scan_gap_of_a_scan_that_straddles_two_kernels():
    # job 0's scan lies at 5.22e6-5.72e6 on the trace's clock; one
    # kernel runs over its start, one over its end, and a copy (no
    # kernel of the scan's) in between
    jobs = [_job(1000.0, 5e6)]
    device = [(K, 5.1e6, 5.3e6), ("Memcpy HtoD", 5.31e6, 5.35e6),
              (K, 5.4e6, 5.8e6)]
    ctx = _ctx(jobs, device)
    # 0.5 s of scan less 0.08 + 0.32 s of kernel
    assert _read("mmu_step.scan_gap_ms_per_job", ctx) == pytest.approx(100.0)
    # no kernel in the window: the whole scan is gap
    assert _read("mmu_step.scan_gap_ms_per_job", _ctx(jobs)) == \
        pytest.approx(500.0)
    # a second job with a kernel over its whole scan halves the mean
    jobs.append(_job(2000.0, 9e6))
    device.append((K, 9.0e6, 9.9e6))
    assert _read("mmu_step.scan_gap_ms_per_job", _ctx(jobs, device)) == \
        pytest.approx(50.0)


def test_nothing_to_read_without_the_spans():
    bare = [dict(_job(1000.0, 5e6), span_events=[])]
    for name in READERS:
        assert _read(name, _ctx(bare, [(K, 5.1e6, 5.3e6)])) is None, name
        assert _read(name, _ctx([])) is None, name
    # a program whose ladder fill has only trace_gen and chunk_wait spans
    # reports those two and nothing of the phases it lacks
    old = _job(1000.0, 5e6)
    old["span_events"] = [e for e in old["span_events"]
                          if e["name"] in ("chunk_wait", "trace_gen")]
    got = {name: _read(name, _ctx([old])) for name in READERS}
    assert got == {"runner.trace_wait_ms_per_job": pytest.approx(200.0),
                   "runner.trace_gen_busy_ms_per_job": pytest.approx(199.0),
                   "runner.stage_ms_per_job": None,
                   "runner.fold_ms_per_job": None,
                   "mmu_step.scan_gap_ms_per_job": None}


def test_every_reader_is_in_the_manifest_for_every_cell():
    for w in manifest.load_json(manifest.MANIFEST)["workloads"]:
        names = {m["name"] for m in manifest.cell(w["name"]).per_layer}
        assert set(READERS) <= names, w["name"]
