"""The port's serving engine (``repro_torch.paged``, ``repro_torch.serve``)
against the JAX package's, on the CPU.

The engine's state is all integer, so every comparison is exact: each
state leaf of every lane equals the reference's after every operation.

- the block tables and the VTC (``translate``/``translate_batch``) over
  seeded sequences of operations: pressure on and off, gates (1,1),
  (0,0) and (3,2), ``n_clusters=1``, masked entries and masked lanes;
- the engine's lifecycle, tick by tick over 100 ticks on two lanes,
  with pool exhaustion, stalls, retirements and pressure epochs;
- ``poisson_trace`` and ``diurnal_trace`` equal the reference's lists;
- ``run_load`` records equal the reference's, timing fields aside, for
  1 and 2 lanes (and 2 lanes split over two ``cpu`` devices), with the
  offline round trip and the ``report --check`` CLI's exit codes;
- ``tune_gate`` under the reference test's monkeypatches.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as j_obs
import repro_torch.obs as t_obs
from repro.paged import block_table as j_bt
from repro.paged import translation_cache as j_vtc
from repro.serve import engine as j_eng
from repro.serve import load as j_load
from repro_torch.obs import report as t_report
from repro_torch.obs.__main__ import main as t_obs_main
from repro_torch.paged import block_table as t_bt
from repro_torch.paged import translation_cache as t_vtc
from repro_torch.serve import engine as t_eng
from repro_torch.serve import load as t_load
from repro_torch.sim import parallel as t_par

CPU = torch.device("cpu")


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def assert_lane_equal(ref_tree, port_tree, lane: int, what):
    """Every leaf of the reference's (unbatched) tree equals lane `lane`
    of the port's, dtype and value."""
    ref = _leaves(ref_tree)
    got = [x[lane].numpy() for x in t_par.tree_leaves(port_tree)]
    assert len(ref) == len(got), what
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), (what, i, a, b)


def _cfgs():
    return {
        "small": t_eng.EngineConfig(n_slots=4, max_blocks_per_req=8,
                                    n_pool_pages=24, n_leaf_rows=16,
                                    tc_sets=4, tc_ways=2, n_clusters=16,
                                    pressure_epoch=8, pressure_thresh=0.15),
    }


# ------------------------------------------------------- block tables

def test_block_table_ops_equal_the_reference():
    """map_block / unmap_request / note_walk / walk on 2 lanes, each lane
    against its own reference tables, with lanes masked out at random."""
    rng = np.random.default_rng(0)
    R, maxb, rows, L = 3, 130, 6, 2       # 3 directory slots, few rows
    refs = [j_bt.make(R, maxb, rows) for _ in range(L)]
    bt = t_bt.make(R, maxb, rows, lanes=L, device="cpu")
    for step in range(80):
        op = rng.choice(["map", "map", "unmap", "note", "walk"])
        req = rng.integers(0, R, L).astype(np.int32)
        blk = rng.integers(0, maxb + 70, L).astype(np.int32)
        val = rng.integers(0, 500, L).astype(np.int32)
        fault = rng.random(L) < 0.5
        where = rng.random(L) < 0.8
        w_t = torch.from_numpy(where)
        r_t, b_t = torch.from_numpy(req), torch.from_numpy(blk)
        if op == "map":
            t_bt.map_block(bt, r_t, b_t, torch.from_numpy(val), where=w_t)
            refs = [j_bt.map_block(refs[i], jnp.int32(req[i]),
                                   jnp.int32(blk[i]), jnp.int32(val[i]))
                    if where[i] else refs[i] for i in range(L)]
        elif op == "unmap":
            t_bt.unmap_request(bt, r_t, where=w_t)
            refs = [j_bt.unmap_request(refs[i], jnp.int32(req[i]))
                    if where[i] else refs[i] for i in range(L)]
        elif op == "note":
            row = rng.integers(0, rows, L)
            t_bt.note_walk(bt, torch.from_numpy(row),
                           torch.from_numpy(fault), where=w_t)
            refs = [j_bt.note_walk(refs[i], jnp.int32(row[i]),
                                   jnp.bool_(fault[i]))
                    if where[i] else refs[i] for i in range(L)]
        else:
            got = t_bt.walk(bt, r_t, b_t)
            for i in range(L):
                want = j_bt.walk(refs[i], jnp.int32(req[i]),
                                 jnp.int32(blk[i]))
                for a, b in zip(want, got):
                    assert int(a) == int(b[i]), (step, i)
        for i in range(L):
            assert_lane_equal(refs[i], bt, i, (step, op))


# -------------------------------------------------------------- the VTC

def _mapped_tables(rng, L, R=4, maxb=64, rows=16):
    """Reference tables per lane and the port's, with most blocks of
    every request mapped (some left FREE, so walks fault)."""
    refs = [j_bt.make(R, maxb, rows) for _ in range(L)]
    bt = t_bt.make(R, maxb, rows, lanes=L, device="cpu")
    for i in range(L):
        for r in range(R):
            for b in range(24):
                if rng.random() < 0.85:
                    p = int(rng.integers(0, 1000))
                    refs[i] = j_bt.map_block(refs[i], jnp.int32(r),
                                             jnp.int32(b), jnp.int32(p))
                    lane = torch.zeros(L, dtype=torch.bool)
                    lane[i] = True
                    t_bt.map_block(bt, r, b, p, where=lane)
    return refs, bt


@pytest.mark.parametrize("gate,n_clusters,pressure", [
    ((1, 1), 16, (False, True)), ((0, 0), 16, (True, True)),
    ((3, 2), 8, (False, False)), ((1, 1), 1, (True, False)),
    ((0, 0), 1, (False, False))])
def test_translate_batch_equals_the_reference(gate, n_clusters, pressure):
    rng = np.random.default_rng(sum(gate) + n_clusters)
    L, n = 2, 12
    refs, bt = _mapped_tables(rng, L)
    rv = [j_vtc.make(tc_sets=4, tc_ways=2, n_clusters=n_clusters)
          for _ in range(L)]
    vtc = t_vtc.make(tc_sets=4, tc_ways=2, n_clusters=n_clusters, lanes=L,
                     device="cpu")
    pr = torch.tensor(pressure)
    j_tb = jax.jit(j_vtc.translate_batch, static_argnames="gate")
    for it in range(6):
        reqs = rng.integers(0, 4, (L, n)).astype(np.int32)
        # hot blocks (TC and cluster hits) and a cold tail (walks)
        blks = np.where(rng.random((L, n)) < 0.6,
                        rng.integers(0, 6, (L, n)),
                        rng.integers(0, 30, (L, n))).astype(np.int32)
        valid = rng.random((L, n)) < 0.8
        if it == 3:
            valid[:, 5] = False                  # masked in every lane
        _, _, phys, src = t_vtc.translate_batch(
            vtc, bt, torch.from_numpy(reqs), torch.from_numpy(blks), pr,
            valid=torch.from_numpy(valid), gate=gate)
        for i in range(L):
            rv[i], refs[i], jp, js = j_tb(
                rv[i], refs[i], jnp.asarray(reqs[i]), jnp.asarray(blks[i]),
                jnp.bool_(pressure[i]), valid=jnp.asarray(valid[i]),
                gate=gate)
            assert np.array_equal(np.asarray(jp), phys[i].numpy()), it
            assert np.array_equal(np.asarray(js), src[i].numpy()), it
            assert_lane_equal(rv[i], vtc, i, ("vtc", it))
            assert_lane_equal(refs[i], bt, i, ("bt", it))
    # every tier was reached, so the comparison is not vacuous
    st = t_vtc.stats(vtc)
    assert st["n_hit_tc"] > 0 and st["n_walk"] > 0
    if n_clusters > 1 and gate != (3, 2):
        assert st["n_hit_cluster"] > 0


def test_translate_single_and_shootdown_equal_the_reference():
    rng = np.random.default_rng(5)
    refs, bt = _mapped_tables(rng, 1)
    rv = j_vtc.make(tc_sets=8, tc_ways=2, n_clusters=16)
    vtc = t_vtc.make(tc_sets=8, tc_ways=2, n_clusters=16, device="cpu")
    ref = refs[0]
    j_tr = jax.jit(j_vtc.translate)
    for it in range(40):
        r, b = int(rng.integers(0, 4)), int(rng.integers(0, 10))
        p = bool(it % 3 == 0)
        rv, ref, jp, js = j_tr(rv, ref, jnp.int32(r), jnp.int32(b),
                               jnp.bool_(p))
        _, _, tp, ts = t_vtc.translate(vtc, bt, r, b, torch.tensor([p]))
        assert (int(jp), int(js)) == (int(tp[0]), int(ts[0]))
        if it % 10 == 9:
            want = j_vtc.invalidation_counts(rv, jnp.int32(r))
            got = t_vtc.invalidation_counts(vtc, r)
            assert [int(x) for x in want] == [int(x[0]) for x in got]
            rv = j_vtc.invalidate_request(rv, jnp.int32(r))
            t_vtc.invalidate_request(vtc, r)
        assert_lane_equal(rv, vtc, 0, it)
        assert_lane_equal(ref, bt, 0, it)
    assert t_vtc.stats(vtc) == pytest.approx(j_vtc.stats(rv))


def test_vtc_and_engine_config_checks_are_the_reference_s():
    for kw in (dict(tc_sets=12, tc_ways=2, n_clusters=16),
               dict(tc_sets=8, tc_ways=2, n_clusters=3),
               dict(tc_sets=8, tc_ways=0, n_clusters=16)):
        with pytest.raises(ValueError) as want:
            j_vtc.make(**kw)
        with pytest.raises(ValueError) as got:
            t_vtc.make(**kw, device="cpu")
        assert str(got.value) == str(want.value)
    for kw in (dict(tc_sets=12), dict(n_clusters=24),
               dict(pressure_epoch=0), dict(gate_freq_min=-1)):
        with pytest.raises(ValueError) as want:
            j_eng.EngineConfig(**kw)
        with pytest.raises(ValueError) as got:
            t_eng.EngineConfig(**kw)
        assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():  # no silent CPU fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_eng.init(t_eng.EngineConfig())


def test_cluster_slot_is_the_wrapped_int32_hash():
    ck = torch.tensor([0, 1, 7, 12345, (3 << 17) | 5, 2**28 - 1],
                      dtype=torch.int32)
    for n_cl in (1, 2, 64, 256, 4096):
        nbits = (n_cl - 1).bit_length()
        want = [0 if nbits == 0 else
                ((int(np.int64(c) * -1640531535) & 0xFFFFFFFF)
                 >> (32 - nbits)) & (n_cl - 1) for c in ck.tolist()]
        if nbits:
            jw = jax.lax.shift_right_logical(
                jnp.asarray(ck.numpy()) * jnp.int32(-1640531535),
                32 - nbits) & (n_cl - 1)
            assert np.asarray(jw).tolist() == want
        assert t_vtc.cluster_slot(ck, n_cl).tolist() == want


# ------------------------------------------------- the engine, tick by tick

def _ref_ops(cfg):
    j_cfg = j_eng.EngineConfig(**{f: getattr(cfg, f) for f in
                                  cfg.__dataclass_fields__})
    adm = jax.jit(j_eng.admit_where)
    dec = jax.jit(lambda s: j_eng.decode_translate(s, j_cfg))
    ret = jax.jit(j_eng.retire_where)
    return j_cfg, adm, dec, ret


def test_engine_lifecycle_tick_by_tick():
    """100 ticks on 2 lanes of a small pool: bursts of admissions (some
    rejected on an exhausted pool), page growth that stalls, retirements
    of random subsets, pressure epochs of 8 ticks; every state leaf of
    each lane equals that lane's reference engine after every call."""
    cfg = _cfgs()["small"]
    j_cfg, adm, dec, ret = _ref_ops(cfg)
    L, n = 2, cfg.n_slots
    refs = [j_eng.init(j_cfg) for _ in range(L)]
    st = t_eng.init(cfg, lanes=L, device="cpu")
    rng = np.random.default_rng(11)
    seen = {"reject": 0, "stall": 0, "pressure": 0, "retire": 0}
    for tick in range(100):
        blocks = np.where(rng.random((L, n)) < 0.35,
                          rng.integers(1, 8, (L, n)), 0).astype(np.int32)
        st, oks = t_eng.admit_where(st, torch.from_numpy(blocks))
        for i in range(L):
            refs[i], jo = adm(refs[i], jnp.asarray(blocks[i]))
            assert np.array_equal(np.asarray(jo), oks[i].numpy()), tick
            seen["reject"] += int(((blocks[i] > 0) & ~np.asarray(jo)).sum())
            assert_lane_equal(refs[i], st, i, ("admit", tick))
        st, phys, src = t_eng.decode_translate(st, cfg)
        for i in range(L):
            refs[i], jp, js = dec(refs[i])
            assert np.array_equal(np.asarray(jp), phys[i].numpy()), tick
            assert np.array_equal(np.asarray(js), src[i].numpy()), tick
            assert_lane_equal(refs[i], st, i, ("decode", tick))
        mask = (rng.random((L, n)) < 0.25) & st.slot_live.numpy()
        st, n_inval = t_eng.retire_where(st, torch.from_numpy(mask))
        for i in range(L):
            refs[i], jn = ret(refs[i], jnp.asarray(mask[i]))
            assert int(jn) == int(n_inval[i]), tick
            assert_lane_equal(refs[i], st, i, ("retire", tick))
        seen["retire"] += int(mask.sum())
        seen["stall"] = int(st.n_pool_stall.sum())
        seen["pressure"] += int(st.pressure.sum())
    assert all(v > 0 for v in seen.values()), seen


def test_single_admit_retire_and_stats_equal_the_reference():
    cfg = t_eng.EngineConfig(n_slots=4, max_blocks_per_req=130,
                             n_pool_pages=200, n_leaf_rows=8, tc_sets=8,
                             tc_ways=2, n_clusters=16)
    j_cfg = j_eng.EngineConfig(**{f: getattr(cfg, f) for f in
                                  cfg.__dataclass_fields__})
    ref = j_eng.init(j_cfg)
    st = t_eng.init(cfg, device="cpu")
    adm = jax.jit(j_eng.admit)
    # 130 blocks span three directory slots; the last admission finds
    # the pool short and is refused whole
    for slot, nb in ((0, 70), (1, 129), (2, 0), (3, 131), (2, 60)):
        ref, jo = adm(ref, slot, nb)
        st, ok = t_eng.admit(st, slot, nb)
        assert bool(jo) == bool(ok[0]), (slot, nb)
        assert_lane_equal(ref, st, 0, (slot, nb))
    dec = jax.jit(lambda s_: j_eng.decode_translate(s_, j_cfg))
    for _ in range(3):
        ref, _, _ = dec(ref)
        st, _, _ = t_eng.decode_translate(st, cfg)
    ref = j_eng.retire(ref, 0, scope="ref_t")
    st = t_eng.retire(st, 0, scope="port_t")
    assert_lane_equal(ref, st, 0, "retire")
    want = j_eng.stats(ref, scope="ref_t")
    got = t_eng.stats(st, scope="port_t")
    assert got == pytest.approx(want)


# -------------------------------------------------------- arrival traces

def test_arrival_traces_equal_the_reference():
    cfg = t_eng.EngineConfig(n_pool_pages=192)
    j_cfg = j_eng.EngineConfig(n_pool_pages=192)
    assert t_load.length_mix(cfg) == j_load.length_mix(j_cfg)
    assert t_load.MIX_WEIGHTS == j_load.MIX_WEIGHTS
    for rate, seed in ((0.5, 17), (2.0, 17), (4.0, 17), (6.0, 3)):
        want = j_load.poisson_trace(rate, 120, j_cfg, seed=seed)
        got = t_load.poisson_trace(rate, 120, cfg, seed=seed)
        assert [vars(r) for r in got] == [vars(r) for r in want]
    want = j_load.diurnal_trace(4.0, 200, j_cfg, seed=23)
    got = t_load.diurnal_trace(4.0, 200, cfg, seed=23)
    assert [vars(r) for r in got] == [vars(r) for r in want] and got


# ------------------------------------------------------------- run_load

@pytest.fixture
def traces_to(tmp_path):
    j = j_obs.configure(str(tmp_path / "ref.jsonl"))
    t = t_obs.configure(str(tmp_path / "port.jsonl"))
    yield j, t
    j_obs.configure()
    t_obs.configure()


def _untimed(rec):
    return {k: v for k, v in rec.items()
            if k not in t_load.TIMING_FIELDS + ("trace_file",)}


@pytest.mark.parametrize("lanes", [1, 2])
def test_run_load_records_equal_the_reference(traces_to, tmp_path, lanes,
                                              monkeypatch):
    """A pool-starved load (rejections and re-queues) on 1 and 2 lanes:
    the port's record equals the reference's but for the timing fields;
    2 lanes split over two `cpu` devices give the same record."""
    j_tr, t_tr = traces_to
    kw = dict(n_slots=4, max_blocks_per_req=8, n_pool_pages=10,
              n_leaf_rows=16, tc_sets=4, tc_ways=2, n_clusters=16,
              pressure_epoch=8)
    j_cfg, cfg = j_eng.EngineConfig(**kw), t_eng.EngineConfig(**kw)
    reqs = t_load.poisson_trace(1.5 * lanes, 20, cfg, seed=lanes)
    want = j_load.run_load(
        [j_load.Request(**vars(r)) for r in reqs], j_cfg, lanes=lanes,
        run=f"rt{lanes}", arrival="poisson", rate=1.5 * lanes)
    got = t_load.run_load(reqs, cfg, lanes=lanes, run=f"rt{lanes}",
                          arrival="poisson", rate=1.5 * lanes,
                          device="cpu")
    assert set(got) == set(t_report.SERVE_FIELDS)
    assert _untimed(got) == _untimed(want)
    assert got["rejected"] > 0 and got["retired"] == len(reqs)
    assert got["decode_p50_s"] > 0 and got["throughput_rps"] > 0
    assert t_load.SERVE_PERF[-1] is got
    # the offline record from the JSONL file equals the live one
    t_tr.flush()
    assert t_report.serve_record(t_report.read_trace(t_tr.path),
                                 trace_file=t_tr.path) == got
    if lanes == 2:
        monkeypatch.setattr(t_par, "_visible_devices", lambda: [CPU, CPU])
        split = t_load.run_load(reqs, cfg, lanes=2, run="rt2s",
                                arrival="poisson", rate=3.0, device="cpu")
        assert split["mesh"] == 2
        assert _untimed(dict(split, run="rt2", mesh=1)) == _untimed(got)
        return
    art = tmp_path / "BENCH_serve.json"
    art.write_text(json.dumps({"schema": 1, "serve_runs": [got]}))
    assert t_obs_main(["report", t_tr.path, "--check", str(art)]) == 0
    bad = dict(got, retired=got["retired"] + 1)
    art.write_text(json.dumps({"schema": 1, "serve_runs": [bad]}))
    assert t_obs_main(["report", t_tr.path, "--check", str(art)]) == 1


# ------------------------------------------------------- gate tuning

def test_run_load_tick_hook_replays_on_a_copy(traces_to):
    """Replaying every tick through the hook leaves the record as it was,
    and each replay returns the state after that tick's step."""
    cfg = t_eng.EngineConfig(n_slots=4, max_blocks_per_req=8,
                             n_pool_pages=10, n_leaf_rows=16, tc_sets=4,
                             tc_ways=2, n_clusters=16, pressure_epoch=8)
    reqs = t_load.poisson_trace(1.5, 20, cfg, seed=1)
    plain = t_load.run_load(reqs, cfg, run="hook0", device="cpu")
    ticks = []

    def hook(t, replay):
        after = replay()
        ticks.append((t, int(after.tick[0])))

    hooked = t_load.run_load(reqs, cfg, run="hook0", device="cpu",
                             tick_hook=hook)
    assert _untimed(hooked) == _untimed(plain)
    assert [t for t, _ in ticks] == list(range(plain["n_ticks"]))
    assert all(after == t + 1 for t, after in ticks)


def test_tune_gate_maps_box_lower_edges(monkeypatch):
    from repro_torch.core import ptwcp_nn
    from repro_torch.sim import runner
    monkeypatch.setattr(
        runner, "run_batch",
        lambda system, workloads, n, device=None: {
            w: (None, {"feat": w}, None) for w in workloads})
    monkeypatch.setattr(
        ptwcp_nn, "build_dataset",
        lambda extras: (np.zeros((4, 2)), np.zeros(4)))
    monkeypatch.setattr(ptwcp_nn, "fit_box",
                        lambda X, y: (3, 12, 2, 9))  # clo, chi, flo, fhi
    assert t_load.tune_gate(n=10) == (2, 3)
    # refit edges beyond the counters' saturation range are clamped
    monkeypatch.setattr(ptwcp_nn, "fit_box",
                        lambda X, y: (99, 120, 50, 90))
    assert t_load.tune_gate(n=10) == (7, 15)
