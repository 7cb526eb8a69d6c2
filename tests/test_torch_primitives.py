"""The port's MMU primitives (ptwcp, assoc, caches, page_table) against
their JAX twins, on random states made with numpy.

Every property draws a seed, builds a random lane-batched state and
inputs with numpy, runs the reference function under ``jax.vmap`` (on
the CPU) and the port's function on torch CPU tensors, and requires
every output and every state leaf to be equal, dtype included.  The
port updates its state in place, so the leaves compared are those of
the port's state after the call.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro.core import assoc as j_assoc
from repro.core import caches as j_caches
from repro.core import page_table as j_pt
from repro.core import ptwcp as j_ptwcp
from repro_torch.core import assoc as t_assoc
from repro_torch.core import caches as t_caches
from repro_torch.core import page_table as t_pt
from repro_torch.core import ptwcp as t_ptwcp

W = 3  # lanes per example
SEEDS = hst.integers(0, 2**32 - 1)
CHEAP = settings(max_examples=30, deadline=None)
COSTLY = settings(max_examples=12, deadline=None)

# reference NamedTuple type -> the port's counterpart
PORT = {j_assoc.Assoc: t_assoc.Assoc, j_caches.L2Cache: t_caches.L2Cache,
        j_caches.Hier: t_caches.Hier, j_pt.PWCs: t_pt.PWCs,
        j_ptwcp.PageCounters: t_ptwcp.PageCounters}


def to_port(x):
    """A numpy tree (reference NamedTuples) as the port's torch tree."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    return PORT[type(x)](*[to_port(y) for y in x])


def to_jax(x):
    return jax.tree.map(jnp.asarray, x)


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if isinstance(x, (tuple, list)):
        return [leaf for y in x for leaf in leaves(y)]
    return [np.asarray(x)]


def assert_same(ref, got, index=False):
    """Leaf-for-leaf equality; `index` outputs compare values only
    (jnp.argmax gives int32 where torch gives int64)."""
    a = [np.asarray(v) for v in jax.tree.leaves(ref)]
    b = leaves(got)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape, (i, x.shape, y.shape)
        if not index:
            assert x.dtype == y.dtype, (i, x.dtype, y.dtype)
        assert np.array_equal(x, y), (i, x, y)


# ------------------------------------------------------- random states

def i32(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape).astype(np.int32)


def bools(rng, shape, p=0.5):
    return rng.random(shape) < p


def r_assoc(rng, sets, ways, tags, meta_hi):
    """Tags drawn from `tags` (so probes hit), meta in [0, meta_hi)."""
    shape = (W, sets, ways)
    return j_assoc.Assoc(tags=rng.choice(tags, shape).astype(np.int32),
                         valid=bools(rng, shape, 0.7),
                         meta=i32(rng, 0, meta_hi, shape))


def r_l2(rng, sets, ways, tags):
    shape = (W, sets, ways)
    return j_caches.L2Cache(
        tags=rng.choice(tags, shape).astype(np.int32),
        valid=bools(rng, shape, 0.8),
        rrpv=i32(rng, 0, 4, shape),
        btype=rng.choice(np.array([0, 0, 0, 1, 2, 3], np.int32), shape),
        reuse=i32(rng, 0, 26, shape),
        hist_reuse_data=i32(rng, 0, 100, (W, 22)),
        hist_reuse_tlb=i32(rng, 0, 100, (W, 22)),
        n_tlb4=i32(rng, 0, 50, (W,)), n_tlb2=i32(rng, 0, 50, (W,)),
        n_ntlb=i32(rng, 0, 50, (W,)))


# line ids a small vpn range touches, so walks hit cached PTE lines
VPNS = np.arange(0, 4096, 37, dtype=np.int32)
_WALK_LINES = np.unique(np.concatenate(
    [np.asarray(x).reshape(-1) for x in
     j_pt._level_lines_4k(VPNS) + j_pt._level_lines_2m(VPNS >> 9)]))
LINES = np.concatenate([np.arange(64, dtype=np.int32), _WALK_LINES])


def r_hier(rng):
    return j_caches.Hier(
        l1d=r_assoc(rng, 4, 8, LINES[:64], 1000),
        l2=r_l2(rng, 8, 16, LINES),
        l3=r_assoc(rng, 8, 16, LINES, 4),
        dramc=r_assoc(rng, 1, 16, LINES, 4),
        **{f: i32(rng, 0, 1000, (W,)) for f in
           ("n_l2_access", "n_l2_miss", "n_l3_access", "n_l3_trans",
            "n_dramc_access", "n_dramc_hit")})


def r_counters(rng, n):
    return j_ptwcp.PageCounters(freq=i32(rng, 0, 8, (W, n)).astype(np.uint8),
                                cost=i32(rng, 0, 16, (W, n)).astype(np.uint8))


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


@functools.lru_cache(maxsize=None)
def vjit(fn, **static):
    """jit(vmap(fn)) with `static` keyword arguments bound."""
    return jax.jit(jax.vmap(functools.partial(fn, **static)))


# ------------------------------------------------------------- ptwcp

@CHEAP
@given(seed=SEEDS)
def test_update_counters_and_predict(seed):
    rng = np.random.default_rng(seed)
    pc = r_counters(rng, 16)
    page, dram, en = i32(rng, 0, 16, (W,)), bools(rng, (W,)), bools(rng, (W,))
    ref = vjit(j_ptwcp.update_counters)(to_jax(pc), page, dram, en)
    got = t_ptwcp.update_counters(to_port(pc), t(page), t(dram), t(en))
    assert_same(ref, got)
    assert_same(vjit(j_ptwcp.predict_page)(to_jax(pc), page),
                t_ptwcp.predict_page(to_port(pc), t(page)))
    assert_same(jax.vmap(j_ptwcp.predict)(pc.freq, pc.cost),
                t_ptwcp.predict(t(pc.freq), t(pc.cost)))


# ------------------------------------------------------------- assoc

@CHEAP
@given(seed=SEEDS)
def test_lookup_touch_and_lru(seed):
    rng = np.random.default_rng(seed)
    a = r_assoc(rng, 4, 4, np.arange(12), 6)  # few stamps: LRU ties
    key, now = i32(rng, 0, 12, (W,)), i32(rng, 0, 2**31 - 1, (W,))
    hit, way, s = vjit(j_assoc.lookup)(to_jax(a), key)
    ta = to_port(a)
    thit, tway, ts = t_assoc.lookup(ta, t(key))
    assert_same(hit, thit)
    assert_same((way, s), (tway, ts), index=True)
    assert_same(vjit(j_assoc.lru_victim)(to_jax(a), s),
                t_assoc.lru_victim(ta, ts), index=True)
    ref = vjit(j_assoc.touch_lru)(to_jax(a), s, way, now)
    assert_same(ref, t_assoc.touch_lru(ta, ts, tway, t(now)))


@CHEAP
@given(seed=SEEDS)
def test_insert_lru(seed):
    rng = np.random.default_rng(seed)
    a = r_assoc(rng, 4, 4, np.arange(12), 6)
    key, now = i32(rng, 0, 12, (W,)), i32(rng, 0, 2**31 - 1, (W,))
    en = bools(rng, (W,))
    ref = vjit(j_assoc.insert_lru)(to_jax(a), key, now, en)
    got = t_assoc.insert_lru(to_port(a), t(key), t(now), t(en))
    assert_same(ref, got)


@CHEAP
@given(seed=SEEDS)
def test_srrip_victims(seed):
    rng = np.random.default_rng(seed)
    rrpv, valid = i32(rng, 0, 4, (W, 16)), bools(rng, (W, 16), 0.85)
    is_tlb, pressure = bools(rng, (W, 16), 0.4), bools(rng, (W,))
    aged, v = jax.vmap(j_assoc.srrip_age_and_pick)(rrpv, valid)
    taged, tv = t_assoc.srrip_age_and_pick(t(rrpv), t(valid))
    assert_same(aged, taged)
    assert_same(v, tv, index=True)
    aged, v = jax.vmap(j_assoc.srrip_victim_tlb_aware)(rrpv, valid, is_tlb,
                                                      pressure)
    taged, tv = t_assoc.srrip_victim_tlb_aware(t(rrpv), t(valid), t(is_tlb),
                                               t(pressure))
    assert_same(aged, taged)
    assert_same(v, tv, index=True)


# ------------------------------------------------------------ caches

@CHEAP
@given(seed=SEEDS, tlb_aware=hst.booleans())
def test_l2_lookup_and_touch(seed, tlb_aware):
    rng = np.random.default_rng(seed)
    l2 = r_l2(rng, 8, 16, np.arange(40))
    key, bt = i32(rng, 0, 40, (W,)), i32(rng, 0, 4, (W,))
    pressure, en = bools(rng, (W,)), bools(rng, (W,), 0.8)
    hit, way, s = vjit(j_caches.l2_lookup)(to_jax(l2), key, bt)
    tl2 = to_port(l2)
    thit, tway, ts = t_caches.l2_lookup(tl2, t(key), t(bt))
    assert_same(hit, thit)
    assert_same((way, s), (tway, ts), index=True)
    ref = vjit(j_caches.l2_touch, tlb_aware=tlb_aware)(
        to_jax(l2), s, way, pressure, enable=en)
    got = t_caches.l2_touch(tl2, ts, tway, t(pressure), tlb_aware, t(en))
    assert_same(ref, got)


@functools.lru_cache(maxsize=None)
def _j_insert(retag, typed, tlb_aware):
    fn = j_caches.l2_retag_to_tlb if retag else j_caches.l2_insert
    if typed:
        return jax.jit(jax.vmap(
            lambda c, k, b, p, e: fn(c, k, b, p, tlb_aware, e)))
    return jax.jit(jax.vmap(
        lambda c, k, p, e: fn(c, k, j_caches.BT_DATA, p, tlb_aware, e)))


@CHEAP
@given(seed=SEEDS, tlb_aware=hst.booleans(), typed=hst.booleans(),
       retag=hst.booleans())
def test_l2_insert_and_retag(seed, tlb_aware, typed, retag):
    """Inserts with a per-lane block type ([W] tensor) or a constant."""
    rng = np.random.default_rng(seed)
    l2 = r_l2(rng, 8, 16, np.arange(40))
    key = i32(rng, 0, 40, (W,))
    pressure, en = bools(rng, (W,)), bools(rng, (W,), 0.8)
    tfn = t_caches.l2_retag_to_tlb if retag else t_caches.l2_insert
    jfn = _j_insert(retag, typed, tlb_aware)
    if typed:
        bt = i32(rng, 1, 3, (W,))
        ref = jfn(to_jax(l2), key, bt, pressure, en)
        got = tfn(to_port(l2), t(key), t(bt), t(pressure), tlb_aware, t(en))
    else:
        ref = jfn(to_jax(l2), key, pressure, en)
        got = tfn(to_port(l2), t(key), t_caches.BT_DATA, t(pressure),
                  tlb_aware, t(en))
    assert_same(ref, got)


@CHEAP
@given(seed=SEEDS)
def test_l3_access(seed):
    rng = np.random.default_rng(seed)
    l3 = r_assoc(rng, 8, 16, np.arange(40), 4)
    key, en = i32(rng, 0, 40, (W,)), bools(rng, (W,), 0.8)
    ref = vjit(j_caches.l3_access)(to_jax(l3), key, en)
    got = t_caches.l3_access(to_port(l3), t(key), t(en))
    assert_same(ref, got)


@COSTLY
@given(seed=SEEDS, tlb_aware=hst.booleans())
def test_access_data(seed, tlb_aware):
    """The data path with its prefetch and background lines; `now` spans
    the int32 range, so the background hash wraps around."""
    rng = np.random.default_rng(seed)
    h = r_hier(rng)
    line = rng.choice(LINES[:64], W).astype(np.int32)
    now, pressure = i32(rng, 0, 2**31 - 1, (W,)), bools(rng, (W,))
    ref = vjit(j_caches.access_data, tlb_aware=tlb_aware,
               lat=j_caches.Lat())(to_jax(h), line, now, pressure)
    got = t_caches.access_data(to_port(h), t(line), t(now), t(pressure),
                               tlb_aware, t_caches.Lat())
    assert_same(ref, got)


@COSTLY
@given(seed=SEEDS, tlb_aware=hst.booleans())
def test_access_pte(seed, tlb_aware):
    rng = np.random.default_rng(seed)
    h = r_hier(rng)
    line = rng.choice(LINES, W).astype(np.int32)
    pressure, en = bools(rng, (W,)), bools(rng, (W,), 0.8)
    ref = vjit(j_caches.access_pte, tlb_aware=tlb_aware,
               lat=j_caches.Lat())(to_jax(h), line, pressure, enable=en)
    got = t_caches.access_pte(to_port(h), t(line), t(pressure), tlb_aware,
                              t_caches.Lat(), t(en))
    assert_same(ref, got)


# -------------------------------------------------------- page_table

@COSTLY
@given(seed=SEEDS, tlb_aware=hst.booleans())
def test_walk(seed, tlb_aware):
    """4K and 2M walks, with PWC hits at every depth."""
    rng = np.random.default_rng(seed)
    h = r_hier(rng)
    pwcs = j_pt.PWCs(*[r_assoc(rng, 8, 4, np.arange(3), 100)
                       for _ in range(3)])
    vpn, is2m = rng.choice(VPNS, W).astype(np.int32), bools(rng, (W,), 0.3)
    now, pressure = i32(rng, 0, 2**31 - 1, (W,)), bools(rng, (W,))
    en = bools(rng, (W,), 0.8)
    ref = vjit(j_pt.walk, tlb_aware=tlb_aware, lat=j_caches.Lat())(
        to_jax(h), to_jax(pwcs), vpn, is2m, now, pressure, enable=en)
    got = t_pt.walk(to_port(h), to_port(pwcs), t(vpn), t(is2m), t(now),
                    t(pressure), tlb_aware, t_caches.Lat(), t(en))
    assert_same(ref, got)


def test_set_index_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        t_assoc.set_index(torch.zeros(1, dtype=torch.int32), 6)
