"""The port's Utopia (RestSeg) and Revelator stages (``repro_torch``)
against the JAX package, on the CPU, natively and under nested paging.

Each system runs on its ``_TINY`` structures (``test_systems_registry``:
RestSegs 16 and 8 sets of at most 8 ways, a 16 x 4 signature table with
10-bit signatures, so that migrations conflict and signatures alias)
over ``golden_trace(N)``; the reference side is ``repro.core.mmu``'s
own scan, as in tests/test_torch_stages.py.  Every Stats leaf, extra and
final state leaf must be exactly equal, and every new counter must have
fired (under nested paging the nested TLB too: the RestSeg probe and
Revelator's verification walk go through the 2-D walk's machinery).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_trace import golden_trace
from repro.core import stages as j_stages
from repro.core.stages import base as j_base
from repro.core.stages import revelator as j_rev
from repro.sim import systems as j_systems
from repro_torch.core import mmu as t_mmu
from repro_torch.core.stages import base as t_base
from repro_torch.core.stages import default_stages, fill_order
from repro_torch.core.stages import revelator as t_rev
from repro_torch.sim import systems as t_systems
from test_systems_registry import _tiny_config
from test_torch_mmu import port_cfg
from test_torch_stages import (_reference_runner, assert_runs_equal,
                               port_run, reference_run)

N = 1000

# system -> the Stats counters its stages must have moved
_RS = ("n_restseg_hit", "n_restseg_miss", "n_restseg_mig",
       "n_restseg_conflict")
_RV = ("n_rev_hit", "n_rev_mispred", "n_rev_enroll")
FIRED = {"utopia": _RS, "utopia_rs8": _RS, "utopia_rs32": _RS,
         "utopia_victima": _RS + ("n_victima_hit", "n_bg_ptw"),
         "revelator": _RV,
         "revelator_victima": _RV + ("n_victima_hit", "n_bg_ptw"),
         "utopia_virt": _RS + ("n_ntlb_hit", "n_host_ptw"),
         "revelator_virt": _RV + ("n_ntlb_hit", "n_host_ptw")}


def _jax_trace(tr):
    return {k: jnp.asarray(v) for k, v in tr.items()}


def _port_trace(tr):
    return {k: torch.from_numpy(np.ascontiguousarray(v))[:, None]
            for k, v in tr.items()}


def port_from(cfg, leaves, tr, name):
    """The port's final state leaves after running ``tr`` from the
    reference state ``leaves``."""
    tcfg = port_cfg(cfg)
    st = t_base.state_from_numpy(leaves, tcfg)
    names = t_systems.get(name).stages
    st = t_mmu.scan_accesses(t_mmu.make_step(tcfg, names), st,
                             _port_trace(tr), tcfg, names)
    return [x[0] for x in t_base.state_to_numpy(st)]


def assert_leaves_equal(want, got, what):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, i)


@pytest.mark.parametrize("name", sorted(FIRED))
def test_system_matches_reference_on_tiny_structures(name, monkeypatch):
    cfg = _tiny_config(name)
    tr = golden_trace(N)
    got = port_run(cfg, tr, monkeypatch)
    assert_runs_equal(reference_run(cfg, tr), got, name)
    stats = got[1]
    for field in FIRED[name]:
        assert int(getattr(stats, field)) > 0, (name, field)
    hist = stats.hist_restseg if name.startswith("utopia") \
        else stats.hist_rev_verify
    assert int(hist.sum()) > 0


def test_restseg_of_32_ways_matches_reference(monkeypatch):
    """utopia_rs32's RestSeg ways in full (32, a whole warp in the
    kernel), on 4 and 2 sets so that they fill and conflict."""
    cfg = dataclasses.replace(_tiny_config("utopia"), restseg_ways=32,
                              restseg4_sets=4, restseg2_sets=2)
    tr = golden_trace(N)
    got = port_run(cfg, tr, monkeypatch)
    assert_runs_equal(reference_run(cfg, tr), got, "rs32")
    assert int(got[1].n_restseg_conflict) > 0


@pytest.mark.parametrize("name", sorted(FIRED))
def test_system_is_registered_as_in_the_reference(name):
    ref, got = j_systems.get(name), t_systems.get(name)
    assert (got.stages, got.overrides, got.tags, got.desc) == \
        (ref.stages, ref.overrides, ref.tags, ref.desc)
    assert default_stages(got.config()) == got.stages


@pytest.mark.parametrize("name", sorted(FIRED))
def test_fill_order_matches_reference(name):
    names = t_systems.get(name).stages
    assert fill_order(names) == j_stages.fill_order(names)


@pytest.mark.parametrize("name", ["utopia", "utopia_rs32", "revelator",
                                  "revelator_victima"])
def test_state_mirrors_the_reference(name):
    """RestSeg and signature-table leaves at the registered sizes."""
    cfg = j_systems.config(name)
    ref = jax.tree.leaves(j_base.make_state(cfg))
    got = t_base.state_leaves(t_base.make_state(port_cfg(cfg)))
    assert [(x.shape, np.dtype(x.dtype)) for x in ref] == \
        [(tuple(x.shape[1:]), x.numpy().dtype) for x in got]


@pytest.mark.parametrize("x", [0, 1, -1, np.iinfo(np.int32).min,
                               np.iinfo(np.int32).max,
                               np.iinfo(np.int32).min + 1, 123456789])
@pytest.mark.parametrize("bits", [10, 20])
def test_rev_sig_wraps_as_the_reference(x, bits):
    want = np.asarray(j_rev.rev_sig(jnp.asarray([x], jnp.int32), bits))
    got = t_rev.rev_sig(torch.tensor([x], dtype=torch.int32), bits)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()


@functools.lru_cache(maxsize=None)
def reference_halves(name: str):
    """(reference state after N/2 accesses, final leaves after N)."""
    cfg = _tiny_config(name)
    tr = golden_trace(N)
    run = _reference_runner(cfg)
    mid, _ = run(j_base.make_state(cfg),
                 _jax_trace({k: v[:N // 2] for k, v in tr.items()}))
    st, _ = run(mid, _jax_trace({k: v[N // 2:] for k, v in tr.items()}))
    return mid, [np.asarray(x) for x in jax.tree.leaves(st)]


@pytest.mark.parametrize("name", ["utopia_victima", "revelator_victima"])
def test_carried_state_continues_the_reference_run(name):
    cfg = _tiny_config(name)
    mid, want = reference_halves(name)
    tr = {k: v[N // 2:] for k, v in golden_trace(N).items()}
    got = port_from(cfg, [np.asarray(x) for x in jax.tree.leaves(mid)], tr,
                    name)
    assert_leaves_equal(want, got, name)


@pytest.mark.parametrize("name", ["revelator", "revelator_victima"])
def test_lowest_way_wins_on_a_duplicate_signature(name):
    """Enrollment can leave one signature in two ways of a set: the probe
    takes the lowest matching way (``jnp.argmax``).  The next access's
    signature is planted in ways 1 (another page: a misprediction) and 3
    (the page itself); both packages must mispredict and repair way 1."""
    cfg = _tiny_config(name)
    mid, _ = reference_halves(name)
    tr = {k: v[N // 2:N // 2 + 8] for k, v in golden_trace(N).items()}
    # the first access that misses the L2 TLB in the reference
    run = _reference_runner(cfg)
    vpn, is2m = int(tr["vpn"][0]), bool(tr["is2m"][0])
    key2 = ((vpn >> 9 if is2m else vpn) << 1) | int(is2m)
    sig = int(j_rev.rev_sig(jnp.int32(key2), cfg.rev_sig_bits))
    s = sig & (cfg.rev_sets - 1)
    rev = mid.rev
    tags = rev.tab.tags.at[s, 1].set(sig).at[s, 3].set(sig)
    valid = rev.tab.valid.at[s, 1].set(True).at[s, 3].set(True)
    vpns = rev.vpn.at[s, 1].set(key2 ^ 2).at[s, 3].set(key2)
    # the L1 and L2 TLBs cleared so that the access reaches the probe
    clear = mid.l2tlb._replace(valid=jnp.zeros_like(mid.l2tlb.valid))
    st0 = mid._replace(
        rev=j_base.RevTable(tab=rev.tab._replace(tags=tags, valid=valid),
                            vpn=vpns),
        l2tlb=clear,
        l1d4=mid.l1d4._replace(valid=jnp.zeros_like(mid.l1d4.valid)),
        l1d2=mid.l1d2._replace(valid=jnp.zeros_like(mid.l1d2.valid)))
    one = {k: v[:1] for k, v in tr.items()}
    st, _ = run(st0, _jax_trace(one))
    want = [np.asarray(x) for x in jax.tree.leaves(st)]
    assert int(st.stats.n_rev_mispred) == int(mid.stats.n_rev_mispred) + 1
    assert int(st.rev.vpn[s, 1]) == key2 and int(st.rev.vpn[s, 3]) == key2
    got = port_from(cfg, [np.asarray(x) for x in jax.tree.leaves(st0)], one,
                    name)
    assert_leaves_equal(want, got, name)


@pytest.mark.parametrize("field", ["utopia", "revelator"])
def test_config_takes_nested_paging(field):
    """Utopia and Revelator under nested paging: the config, its stages
    and its state's leaves are the reference's."""
    over = {field: True, "virt": True}
    got, want = t_base.SimConfig(**over), j_base.SimConfig(**over)
    assert default_stages(got) == j_stages.default_stages(want)
    ref = jax.tree.leaves(j_base.make_state(want))
    leaves = t_base.state_leaves(t_base.make_state(got))
    assert [(x.shape, np.dtype(x.dtype)) for x in ref] == \
        [(tuple(x.shape[1:]), x.numpy().dtype) for x in leaves]


@pytest.mark.parametrize("name", ["utopia_virt", "revelator_virt"])
def test_virtualized_systems_are_registered(name):
    """Both run the 2-D walk with their stage in front of it, as the
    reference registers them, and join the nested family's ladder."""
    ref, got = j_systems.get(name), t_systems.get(name)
    assert got.stages[-1] == "ptw2d" and got.config().virt
    assert (got.stages, got.overrides, got.tags) == \
        (ref.stages, ref.overrides, ref.tags)
    assert name in t_systems.LADDERS["np"]
