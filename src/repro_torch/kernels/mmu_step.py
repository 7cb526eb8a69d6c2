"""The blocked access scan: the MMU step run over a trace, as a CUDA
kernel written by hand for Hopper (``csrc/mmu_step.cu``).

Replaces the TPU kernel ``src/repro/kernels/mmu_step.py:105``
(``_blocked_scan_impl``, entered by ``blocked_scan`` at :177).  The
Pallas kernel keeps the whole ``MMUState`` resident in VMEM across a
sequential grid of trace blocks; here ``blocked_scan`` launches the
kernel once per trace block on PyTorch's current stream, one warp per
lane, and each launch keeps the lane's state resident in the block's
shared memory: it copies the state in from the tensors ``make_state``
allocated (one per leaf, lane axis first, bools as bytes), packing the
L2 cache, and writes it back at its end.  Which structures go to shared
memory is ``placement(cfg)``, a pure function of the geometry; launches
are counted per placement in ``LAUNCHES_BY_PLACEMENT`` and per
composition (``COMPOSITIONS``: radix, Victima, the L3 TLB, the POM-TLB,
Utopia and Revelator, natively and under nested paging where the
reference has them, Utopia and Revelator with Victima, and radix,
Victima and the POM-TLB over the multicore shared tier, Victima with the
DRAM cache too; and
``radix_collect``, the radix composition with the Table-2 feature
stream) in ``LAUNCHES_BY_COMPOSITION``.  A ladder of systems
(``sim.systems.LADDERS``) runs its base composition in a ladder
instantiation (``LADDER_COMPOSITIONS``: ``ladder_native``, the union of
every gated stage, ``ladder_np``, the nested family's, and
``ladder_mc``, the three multicore families'), one launch a trace block
for every (member, workload, core) lane, each lane reading its own
geometry views and stage gates (``stages.base.Dyn``) from a row of
per-lane parameters.

The kernel is bound by latency, not by bytes or operations: each access
is a chain of dependent row reads (see the source's note).

``blocked_scan`` picks the path from the device of the state it is
given: on a CUDA tensor it launches the kernel (or raises); on a CPU
tensor it runs ``plain_scan``, the plain PyTorch version — the port's
stage pipeline (``repro_torch.core.mmu.make_step``) stepped access by
access.  No flag or environment variable chooses the path.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.stages import Feats, Stats, default_stages
from repro_torch.kernels import build

# kernel launches made by blocked_scan since import (the launch count
# that shows a run went through the kernel)
LAUNCHES = 0

# trace rows per launch when the caller gives no block size
BLOCK = 8192

MAX_WAYS = 32  # one warp per lane: thread w owns way w

# dynamic shared memory one block may take on Hopper (227 KiB)
SMEM_LIMIT = 232_448
PWC_SETS, PWC_WAYS = 8, 4  # page_table.make_pwcs's geometry, each level
_HIST_BYTES = 4 * (64 + 2 * 22)  # hist_walk, hist_reuse_data / _tlb
_LRU_BYTES = 9  # an LRU entry: tag and stamp (int32), valid (byte)
_L2_BYTES = 6   # an L2-cache way: tag (int32), packed byte, reuse shadow

# placement name -> (L2 cache in shared memory, L2 TLB in shared memory)
PLACEMENTS = {"shared": (True, True), "l2tlb_device": (True, False),
              "l2_device": (False, True), "device": (False, False)}

# kernel launches per placement since import
LAUNCHES_BY_PLACEMENT = dict.fromkeys(PLACEMENTS, 0)


class Placement(NamedTuple):
    name: str           # a key of PLACEMENTS
    l2_shared: bool     # the L2 cache (tags, packed bytes, reuse shadow)
    l2tlb_shared: bool  # the L2 TLB
    smem_bytes: int     # dynamic shared memory of one block


def placement(cfg, want: str | None = None) -> Placement:
    """Where the kernel keeps a lane of ``cfg``, from its geometry alone
    (or, given `want`, a key of ``PLACEMENTS``, that placement, which
    must fit: a ladder instantiation is built in one placement only).

    Shared memory takes, in this order and while they fit in
    ``SMEM_LIMIT``: the histograms and the small LRU arrays (L1 TLBs,
    PWCs, L1D, and the nested TLB when ``cfg.virt``; always, or this
    raises); the L2 cache, packed to 6 bytes a way; the L2 TLB, 9 bytes an
    entry.  What does not fit stays in device memory, and so do the L3,
    the L3 TLB, the POM-TLB's shadow, the PTW-CP and host-page counters,
    Utopia's RestSegs (8192 x 16 and 256 x 16 at the defaults, up to 32
    ways), Revelator's signature table and its enrolled-page shadow
    (4096 x 16), the DRAM cache, the Table-2 feature table (2^20 entries
    of 13 bytes), and the RestSeg-probe and verification-walk histograms.
    The kernel checks the byte count against its own layout at every
    launch.
    """
    small = (cfg.l1d4_sets * cfg.l1d4_ways + cfg.l1d2_sets * cfg.l1d2_ways
             + 3 * PWC_SETS * PWC_WAYS + cfg.l1_sets * cfg.l1_ways)
    if cfg.virt:
        small += cfg.ntlb_sets * cfg.ntlb_ways
    nbytes = _HIST_BYTES + _LRU_BYTES * small
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"the L1 TLBs, PWCs and L1D"
                         f"{' (and nested TLB)' if cfg.virt else ''} take "
                         f"{nbytes} bytes, more than a block's {SMEM_LIMIT}")
    l2 = _L2_BYTES * cfg.l2_sets * cfg.l2_ways
    tlb = _LRU_BYTES * cfg.l2tlb_sets * cfg.l2tlb_ways
    if want is not None:
        l2_shared, tlb_shared = PLACEMENTS[want]
        nbytes += l2 * l2_shared + tlb * tlb_shared
        if nbytes > SMEM_LIMIT:
            raise ValueError(f"placement {want} takes {nbytes} bytes of "
                             f"shared memory, more than a block's "
                             f"{SMEM_LIMIT}")
        return Placement(want, l2_shared, tlb_shared, nbytes)
    l2_shared = nbytes + l2 <= SMEM_LIMIT
    nbytes += l2 if l2_shared else 0
    tlb_shared = nbytes + tlb <= SMEM_LIMIT
    nbytes += tlb if tlb_shared else 0
    name = next(k for k, v in PLACEMENTS.items()
                if v == (l2_shared, tlb_shared))
    return Placement(name, l2_shared, tlb_shared, nbytes)

# the compositions the kernel writes out: (stage names, the
# configuration's ``tier_bits``) -> (name, code).  The code's bits
# (csrc/mmu_step.cu's C_*): 1 Victima, 2 the L3 TLB, 4 the POM-TLB, 8 the
# nested (2-D) walk, 16 the Table-2 feature stream (``COLLECTED``: a
# configuration with ``collect`` set), 32 Utopia's RestSegs, 64
# Revelator, 128 the multicore shared tier (the trace's ``core`` leaf and
# the shared-port contention term), 256 the DRAM cache below the L3 (with
# 128)
C_VICTIMA, C_L3TLB, C_POM, C_NESTED = 1, 2, 4, 8
C_COLLECT, C_RESTSEG, C_REV = 16, 32, 64
C_SHARED, C_DRAMC = 128, 256
_RADIX = ("l1_tlb", "l2_tlb", "ptw")
_VICTIMA = ("l1_tlb", "l2_tlb", "victima", "ptw")
_POM = ("l1_tlb", "l2_tlb", "pom", "ptw")
COMPOSITIONS = {
    (_RADIX, 0): ("radix", 0),
    (_VICTIMA, 0): ("victima", C_VICTIMA),
    (("l1_tlb", "l2_tlb", "l3_tlb", "ptw"), 0): ("l3tlb", C_L3TLB),
    (_POM, 0): ("pom", C_POM),
    (("l1_tlb", "l2_tlb", "ptw2d"), 0): ("np", C_NESTED),
    (("l1_tlb", "l2_tlb", "victima", "ptw2d"), 0): (
        "victima_np", C_NESTED | C_VICTIMA),
    (("l1_tlb", "l2_tlb", "pom", "ptw2d"), 0): ("pom_np", C_NESTED | C_POM),
    (("l1_tlb", "l2_tlb", "restseg", "ptw"), 0): ("utopia", C_RESTSEG),
    (("l1_tlb", "l2_tlb", "victima", "restseg", "ptw"), 0): (
        "utopia_victima", C_RESTSEG | C_VICTIMA),
    (("l1_tlb", "l2_tlb", "rev", "ptw"), 0): ("revelator", C_REV),
    (("l1_tlb", "l2_tlb", "rev", "victima", "ptw"), 0): (
        "revelator_victima", C_REV | C_VICTIMA),
    (("l1_tlb", "l2_tlb", "restseg", "ptw2d"), 0): (
        "utopia_np", C_NESTED | C_RESTSEG),
    (("l1_tlb", "l2_tlb", "rev", "ptw2d"), 0): (
        "revelator_np", C_NESTED | C_REV),
    # over the multicore shared tier
    (_RADIX, C_SHARED): ("radix_mc", C_SHARED),
    (_VICTIMA, C_SHARED): ("victima_mc", C_VICTIMA | C_SHARED),
    (_POM, C_SHARED): ("pom_mc", C_POM | C_SHARED),
    (_VICTIMA, C_SHARED | C_DRAMC): (
        "victima_dramc", C_VICTIMA | C_SHARED | C_DRAMC),
}
# the compositions with the feature stream, keyed as COMPOSITIONS
COLLECTED = {(_RADIX, 0): ("radix_collect", C_COLLECT)}
# compositions built in every placement; the others only in "shared",
# the placement of every system the port registers with them
EVERY_PLACEMENT = ("radix", "victima")
# the ladders' base compositions (sim.systems.ladder_base_config), keyed
# as COMPOSITIONS -> (name, code), each built in one placement, that of
# its ladder's geometry: the native family's union of the gated stages
# at the ladder maximum (8192 x 16 L2 cache and L2 TLB), the nested
# family's and the multicore families' (one instantiation for 1, 2 and 4
# cores: their L3, POM-TLB and DRAM-cache sizes are parameters) at
# Table 3
LADDER_COMPOSITIONS = {
    (("l1_tlb", "l2_tlb", "rev", "victima", "l3_tlb", "pom", "restseg",
      "ptw"), 0): ("ladder_native", C_VICTIMA | C_L3TLB | C_POM
                   | C_RESTSEG | C_REV),
    (("l1_tlb", "l2_tlb", "rev", "victima", "pom", "restseg", "ptw2d"),
     0): ("ladder_np", C_NESTED | C_VICTIMA | C_POM | C_RESTSEG | C_REV),
    (("l1_tlb", "l2_tlb", "victima", "pom", "ptw"), C_SHARED | C_DRAMC): (
        "ladder_mc", C_VICTIMA | C_POM | C_SHARED | C_DRAMC),
}
LADDER_PLACEMENT = {"ladder_native": "device", "ladder_np": "shared",
                    "ladder_mc": "shared"}


def ladder_placement(cfg, stage_names) -> Placement:
    """The placement of a ladder launch on base config ``cfg``: its
    instantiation's, whatever the geometry (it raises where that does not
    fit)."""
    comp, _ = composition(cfg, stage_names, dyn=True)
    return placement(cfg, LADDER_PLACEMENT[comp])
# a ladder lane's row of parameters, in csrc/mmu_step.cu's DYN_* order:
# stages.base.Dyn's fields
DYN_PARAMS = ("l2tlb_set_mask", "l2tlb_ways", "l2tlb_lat", "l3tlb_lat",
              "l2_set_mask", "l2_ways", "restseg_ways", "victima_en",
              "utopia_en", "l3tlb_en", "pom_en", "rev_en", "dramc_en")

# kernel launches per composition since import
LAUNCHES_BY_COMPOSITION = dict.fromkeys(
    [n for n, _ in (*COMPOSITIONS.values(), *COLLECTED.values(),
                    *LADDER_COMPOSITIONS.values())], 0)


def tier_bits(cfg) -> int:
    """The shared-tier bits of a configuration's composition code:
    ``C_SHARED`` for more than one core or a DRAM cache (the contention
    term is 0 at one core), and ``C_DRAMC`` with a DRAM cache.  0 for every
    single-core system without one (the ``*_1c`` systems but
    ``victima_dramc_1c`` run the single-core instantiations)."""
    dramc = cfg.dram_cache_sets > 0
    return (C_SHARED if cfg.n_cores > 1 or dramc else 0) | (
        C_DRAMC if dramc else 0)


def composition(cfg, stage_names, dyn: bool = False) -> tuple[str, int]:
    """The kernel's (name, code) for ``stage_names`` under ``cfg`` (with
    `dyn`, a ladder's base composition); raises for a composition it does
    not write out."""
    key = (tuple(stage_names), tier_bits(cfg))
    table = (LADDER_COMPOSITIONS if dyn else COLLECTED if cfg.collect
             else COMPOSITIONS)
    got = table.get(key)
    if got is None:
        what = " for a ladder" if dyn else " with collect" if cfg.collect \
            else ""
        raise ValueError(f"the mmu_step kernel runs the compositions "
                         f"{list(table)}{what}, not {key}")
    return got

_p = ctypes.c_void_p
_i = ctypes.c_int32
_f = ctypes.c_float


class _AssocP(ctypes.Structure):
    _fields_ = [("tags", _p), ("valid", _p), ("meta", _p), ("sets", _i),
                ("ways", _i)]


class _L2P(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("tags", "valid", "rrpv", "btype",
                                  "reuse", "hist_data", "hist_tlb",
                                  "n_tlb4", "n_tlb2", "n_ntlb")] + [
        ("sets", _i), ("ways", _i)]


class _CountersP(ctypes.Structure):
    _fields_ = [("freq", _p), ("cost", _p), ("n", _i), ("pad", _i)]


# the hierarchy's counters the kernel carries in registers
HIER_COUNTS = ("n_l2_access", "n_l2_miss", "n_l3_access", "n_l3_trans",
               "n_dramc_access", "n_dramc_hit")


class _HierCountP(ctypes.Structure):
    _fields_ = [(n, _p) for n in HIER_COUNTS]


class _StatsP(ctypes.Structure):
    _fields_ = [(n, _p) for n in Stats._fields]


class _FeatsP(ctypes.Structure):
    _fields_ = [(n, _p) for n in Feats._fields] + [("n", _i), ("pad", _i)]


class _TraceP(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("vpn", "is2m", "line", "ipa", "core")]


class _PlanP(ctypes.Structure):  # filled in by the C launch function
    _fields_ = [(n, _i) for n in (
        "hist", *[f"lru_i32_{k}" for k in range(8)], "l2_tag",
        *[f"lru_u8_{k}" for k in range(8)], "l2_pk", "l2_r8", "total")]


class _Params(ctypes.Structure):
    _fields_ = (
        [(n, _AssocP) for n in ("l1d4", "l1d2", "l2tlb", "pml4", "pdp",
                                "pd", "l1d", "l3", "l3tlb", "pom", "ntlb")]
        + [("l2", _L2P), ("pc4", _CountersP), ("pc2", _CountersP),
           ("pch", _CountersP), ("hier", _HierCountP), ("stats", _StatsP),
           ("trace", _TraceP), ("now", _p)]
        + [(n, _i) for n in ("lanes", "t0", "t1", "comp", "virt",
                             "tlb_aware", "use_ptwcp")]
        + [("pressure_mpki", _f), ("bypass_l2mpki", _f)]
        + [(n, _i) for n in ("l1tlb_lat", "l2tlb_lat", "l3tlb_lat",
                             "pom_mask", "lat_l1d", "lat_l2", "lat_l3",
                             "lat_dram", "pad0")]
        + [("prof", _p), ("l2_pack", _p)]
        + [(n, _i) for n in ("l2_shared", "l2tlb_shared", "smem_bytes",
                             "pad")]
        + [(n, _AssocP) for n in ("restseg4", "restseg2", "rev")]
        + [("rev_vpn", _p), ("feats", _FeatsP), ("rev_lat", _i),
           ("rev_sig_bits", _i), ("dyn", _p), ("dramc", _AssocP)]
        + [(n, _i) for n in ("lat_dramc", "n_cores", "shared_port_cyc",
                             "pad2")]
        + [("plan", _PlanP)])


# the profiled build's per-lane slots: cycles of each stage (thread 0's
# clock64, summed over accesses), then the loop's cycles and the accesses
STAGES = ("tlb", "probe", "walk", "fill", "data", "stats")
PROF_SLOTS = 8

_LIBS: dict = {}


def _lib(name: str = "mmu_step") -> ctypes.CDLL:
    """The compiled kernel library (built at first use): ``mmu_step``, or
    ``mmu_step_prof``, the same source with its stage stamps."""
    if name not in _LIBS:
        lib = build.load(name)
        lib.mmu_step_params_size.argtypes = []
        lib.mmu_step_params_size.restype = ctypes.c_int
        lib.mmu_step_launch.argtypes = [_Params, ctypes.c_void_p]
        lib.mmu_step_launch.restype = ctypes.c_int
        lib.mmu_step_error_string.argtypes = [ctypes.c_int]
        lib.mmu_step_error_string.restype = ctypes.c_char_p
        lib.mmu_step_instantiations.argtypes = []
        lib.mmu_step_instantiations.restype = ctypes.c_int
        lib.mmu_step_instantiation.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mmu_step_instantiation.restype = ctypes.c_int
        got = lib.mmu_step_params_size()
        if got != ctypes.sizeof(_Params):
            raise RuntimeError(f"mmu_step Params is {got} bytes in C, "
                               f"{ctypes.sizeof(_Params)} in ctypes")
        _LIBS[name] = lib
    return _LIBS[name]


def _ptr(x: torch.Tensor, dtype, shape, what: str, device) -> int:
    """Check one tensor the kernel reads or writes; return its address."""
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, want {device}")
    if x.dtype != dtype:
        raise TypeError(f"{what} is {x.dtype}, want {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(x.shape)}, want "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return x.data_ptr()


def _assoc(a, sets, ways, lanes, what, device) -> _AssocP:
    if ways > MAX_WAYS:
        raise ValueError(f"{what} has {ways} ways; the kernel takes at "
                         f"most {MAX_WAYS}")
    if sets & (sets - 1):
        raise ValueError(f"{what} has {sets} sets, not a power of two")
    shape = (lanes, sets, ways)
    return _AssocP(_ptr(a.tags, torch.int32, shape, what + ".tags", device),
                   _ptr(a.valid, torch.bool, shape, what + ".valid", device),
                   _ptr(a.meta, torch.int32, shape, what + ".meta", device),
                   sets, ways)


def _dyn_rows(dyn, cfg, lanes: int, dev) -> torch.Tensor:
    """A ladder launch's per-lane parameters, int32 ``[lanes, NDYN]`` on
    `dev`, after checking each lane's view against the allocation."""
    for f in dyn._fields:
        x = getattr(dyn, f)
        if x.device != dev or tuple(x.shape) != (lanes,):
            raise ValueError(f"dyn.{f} is {tuple(x.shape)} on {x.device}, "
                             f"want ({lanes},) on {dev}")
    d = dyn.to("cpu")
    views = [("L2-TLB", d.l2tlb_set_mask + 1, d.l2tlb_ways, cfg.l2tlb_sets,
              cfg.l2tlb_ways),
             ("L2-cache", d.l2_set_mask + 1, d.l2_ways, cfg.l2_sets,
              cfg.l2_ways)]
    if cfg.utopia:  # the RestSegs' set counts are static
        views.append(("RestSeg", torch.ones(1, dtype=torch.int32),
                      d.restseg_ways, 1, cfg.restseg_ways))
    for what, sets, ways, sets_max, ways_max in views:
        if ((sets < 1) | (sets > sets_max) | ((sets & (sets - 1)) != 0)
                | (ways < 1) | (ways > ways_max)).any():
            raise ValueError(f"a lane's {what} view lies outside its "
                             f"{sets_max} x {ways_max} allocation")
    if d.dramc_en.any() and cfg.dram_cache_sets <= 0:
        raise ValueError("a lane gates a DRAM cache on; the base config "
                         "allocates none")
    return torch.stack([getattr(dyn, f).to(torch.int32) for f in DYN_PARAMS],
                       dim=1).contiguous()


def _params(st, trace: dict, cfg, stage_names, dyn=None) -> _Params:
    """The kernel's parameter struct, checking every tensor it touches
    (device, dtype, shape, contiguity) against the state's device; with
    the L2 cache outside shared memory it also holds the scratch tensor
    of its packed bytes (``torch.empty``, filled by the kernel), and for
    a ladder (`dyn`, the lanes' ``stages.base.Dyn``) the tensor of the
    lanes' parameters."""
    names = tuple(stage_names)
    comp, code = composition(cfg, names, dyn is not None)
    if names != default_stages(cfg):
        raise ValueError(f"composition {names} disagrees with the "
                         f"configuration's {default_stages(cfg)}")
    pl = placement(cfg) if dyn is None else ladder_placement(cfg, names)
    if dyn is None and comp not in EVERY_PLACEMENT and pl.name != "shared":
        raise ValueError(f"the mmu_step kernel runs composition {comp} "
                         f"only with the lane in shared memory; this "
                         f"geometry takes placement {pl.name}")
    dev = st.now.device
    W = st.now.shape[0]
    T = trace["vpn"].shape[0]
    tr_dtypes = {"vpn": torch.int32, "is2m": torch.bool,
                 "line": torch.int32, "ipa": torch.float32}
    if not set(tr_dtypes) <= set(trace) <= {*tr_dtypes, "core"}:
        raise ValueError(f"trace leaves {sorted(trace)}, want "
                         f"{sorted(tr_dtypes)} and maybe 'core'")
    if cfg.n_cores < 1:
        raise ValueError(f"n_cores={cfg.n_cores}: want 1 or more")
    tr = _TraceP(*[_ptr(trace[k], d, (T, W), f"trace[{k!r}]", dev)
                   for k, d in tr_dtypes.items()],
                 _ptr(trace["core"], torch.int32, (T, W), "trace['core']",
                      dev) if "core" in trace else None)
    l2 = st.hier.l2
    if cfg.l2_ways > MAX_WAYS:
        raise ValueError(f"L2 cache has {cfg.l2_ways} ways; the kernel "
                         f"takes at most {MAX_WAYS}")
    if cfg.l2_sets & (cfg.l2_sets - 1):
        raise ValueError(f"L2 cache has {cfg.l2_sets} sets, not a power "
                         f"of two")
    row = (W, cfg.l2_sets, cfg.l2_ways)

    def i32(x, shape, what):
        return _ptr(x, torch.int32, shape, what, dev)

    l2p = _L2P(
        i32(l2.tags, row, "l2.tags"),
        _ptr(l2.valid, torch.bool, row, "l2.valid", dev),
        i32(l2.rrpv, row, "l2.rrpv"), i32(l2.btype, row, "l2.btype"),
        i32(l2.reuse, row, "l2.reuse"),
        i32(l2.hist_reuse_data, (W, 22), "l2.hist_reuse_data"),
        i32(l2.hist_reuse_tlb, (W, 22), "l2.hist_reuse_tlb"),
        i32(l2.n_tlb4, (W,), "l2.n_tlb4"), i32(l2.n_tlb2, (W,), "l2.n_tlb2"),
        i32(l2.n_ntlb, (W,), "l2.n_ntlb"), cfg.l2_sets, cfg.l2_ways)

    def counters(pc, n, what):
        if n & (n - 1):
            raise ValueError(f"{what} has {n} entries, not a power of two")
        return _CountersP(_ptr(pc.freq, torch.uint8, (W, n), what + ".freq",
                               dev),
                          _ptr(pc.cost, torch.uint8, (W, n), what + ".cost",
                               dev), n, 0)

    s = st.stats
    stats = _StatsP(*[
        _ptr(getattr(s, f),
             torch.float32 if f.startswith("sum_") else torch.int32,
             (W, 64) if f.startswith("hist_") else (W,), f"stats.{f}", dev)
        for f in Stats._fields])
    n_feat = cfg.n_feat if cfg.collect else 1
    if n_feat & (n_feat - 1):
        raise ValueError(f"the feature table has {n_feat} entries, not a "
                         f"power of two")
    feats = _FeatsP(*[
        _ptr(getattr(st.feats, f),
             {"walk_cyc": torch.float32, "is2m": torch.uint8}.get(
                 f, torch.uint16), (W, n_feat), f"feats.{f}", dev)
        for f in Feats._fields], n_feat, 0)
    if not 0 < cfg.rev_sig_bits < 32:
        raise ValueError(f"rev_sig_bits={cfg.rev_sig_bits}: the kernel "
                         f"takes 1..31")
    rs_ways = cfg.restseg_ways if cfg.utopia else 1
    rev_sets = cfg.rev_sets if cfg.revelator else 1
    rev_ways = cfg.rev_ways if cfg.revelator else 1
    h = st.hier
    lat = cfg.lat
    params = _Params(
        l1d4=_assoc(st.l1d4, cfg.l1d4_sets, cfg.l1d4_ways, W, "l1d4", dev),
        l1d2=_assoc(st.l1d2, cfg.l1d2_sets, cfg.l1d2_ways, W, "l1d2", dev),
        l2tlb=_assoc(st.l2tlb, cfg.l2tlb_sets, cfg.l2tlb_ways, W, "l2tlb",
                     dev),
        pml4=_assoc(st.pwcs.pml4, PWC_SETS, PWC_WAYS, W, "pwcs.pml4", dev),
        pdp=_assoc(st.pwcs.pdp, PWC_SETS, PWC_WAYS, W, "pwcs.pdp", dev),
        pd=_assoc(st.pwcs.pd, PWC_SETS, PWC_WAYS, W, "pwcs.pd", dev),
        l1d=_assoc(h.l1d, cfg.l1_sets, cfg.l1_ways, W, "hier.l1d", dev),
        l3=_assoc(h.l3, cfg.l3_sets, cfg.l3_ways, W, "hier.l3", dev),
        l3tlb=_assoc(st.l3tlb, max(cfg.l3tlb_sets, 1), cfg.l3tlb_ways, W,
                     "l3tlb", dev),
        pom=_assoc(st.pom, cfg.pom_sets if cfg.pom else 1, cfg.pom_ways, W,
                   "pom", dev),
        ntlb=_assoc(st.ntlb, cfg.ntlb_sets if cfg.virt else 1,
                    cfg.ntlb_ways, W, "ntlb", dev),
        l2=l2p,
        pc4=counters(st.pc4, cfg.n_pages4, "pc4"),
        pc2=counters(st.pc2, cfg.n_pages2, "pc2"),
        pch=counters(st.pch, cfg.n_pagesh if cfg.virt else 1, "pch"),
        hier=_HierCountP(*[i32(getattr(h, n), (W,), "hier." + n)
                           for n in HIER_COUNTS]),
        stats=stats, trace=tr,
        now=i32(st.now, (W,), "now"),
        lanes=W, t0=0, t1=0, comp=code, virt=int(cfg.virt),
        tlb_aware=int(cfg.tlb_aware), use_ptwcp=int(cfg.use_ptwcp),
        pressure_mpki=cfg.pressure_mpki, bypass_l2mpki=cfg.bypass_l2mpki,
        l1tlb_lat=cfg.l1tlb_lat, l2tlb_lat=cfg.l2tlb_lat,
        l3tlb_lat=cfg.l3tlb_lat, pom_mask=cfg.pom_sets * cfg.pom_ways - 1,
        lat_l1d=lat.l1d, lat_l2=lat.l2, lat_l3=lat.l3, lat_dram=lat.dram,
        l2_shared=int(pl.l2_shared), l2tlb_shared=int(pl.l2tlb_shared),
        smem_bytes=pl.smem_bytes,
        restseg4=_assoc(st.restseg4, cfg.restseg4_sets if cfg.utopia else 1,
                        rs_ways, W, "restseg4", dev),
        restseg2=_assoc(st.restseg2, cfg.restseg2_sets if cfg.utopia else 1,
                        rs_ways, W, "restseg2", dev),
        rev=_assoc(st.rev.tab, rev_sets, rev_ways, W, "rev.tab", dev),
        rev_vpn=i32(st.rev.vpn, (W, rev_sets, rev_ways), "rev.vpn"),
        feats=feats, rev_lat=cfg.rev_lat, rev_sig_bits=cfg.rev_sig_bits,
        dramc=_assoc(h.dramc, max(cfg.dram_cache_sets, 1),
                     cfg.dram_cache_ways, W, "hier.dramc", dev),
        lat_dramc=lat.dramc, n_cores=cfg.n_cores,
        shared_port_cyc=cfg.shared_port_cyc)
    params.placement = pl.name
    params.composition = comp
    if dyn is not None:
        params.dyn_rows = _dyn_rows(dyn, cfg, W, dev)
        params.dyn = params.dyn_rows.data_ptr()
    if not pl.l2_shared:
        params.scratch = torch.empty((W, 2, cfg.l2_sets * cfg.l2_ways),
                                     dtype=torch.uint8, device=dev)
        params.l2_pack = params.scratch.data_ptr()
    return params


def instantiations() -> list[tuple[str, str]]:
    """Every instantiation the library builds, in its dense order:
    (composition name, placement name)."""
    lib = _lib()
    names = {(code, False): n for n, code in (*COMPOSITIONS.values(),
                                               *COLLECTED.values())}
    names.update({(code, True): n
                  for n, code in LADDER_COMPOSITIONS.values()})
    places = {2 * l2 + t: k for k, (l2, t) in PLACEMENTS.items()}
    out = []
    for i in range(lib.mmu_step_instantiations()):
        comp, place, dyn = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.mmu_step_instantiation(i, ctypes.byref(comp),
                                      ctypes.byref(place),
                                      ctypes.byref(dyn)) != 0:
            raise RuntimeError(f"no instantiation {i}")
        out.append((names[comp.value, bool(dyn.value)],
                    places[place.value]))
    return out


def plain_scan(step, st, trace: dict):
    """The plain PyTorch version: ``step`` applied access by access
    (updates ``st`` in place and returns it).  Runs on any device; it is
    what ``blocked_scan`` runs for CPU tensors, and what the card's
    kernel is held against."""
    # no autograd bookkeeping: the step only reads and updates state
    with torch.inference_mode():
        for t in range(trace["vpn"].shape[0]):
            step(st, {k: v[t] for k, v in trace.items()})
    return st


def _launches(lib, params, st, trace: dict, block):
    """Launch ``lib``'s kernel once per ``block`` trace rows; yields after
    each launch.  Raises when a launch is refused."""
    block = BLOCK if block is None else int(block)
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    dev = st.now.device
    T = trace["vpn"].shape[0]
    # the state's device is current only for these launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for t0 in range(0, T, block):
            params.t0, params.t1 = t0, min(T, t0 + block)
            err = lib.mmu_step_launch(params, stream)
            if err != 0:
                raise RuntimeError(
                    f"mmu_step kernel launch failed: CUDA error {err} "
                    f"({lib.mmu_step_error_string(err).decode()})")
            yield


def _check_cuda(st):
    if st.now.device.type != "cuda":
        raise ValueError(f"the mmu_step kernel runs on CUDA tensors, the "
                         f"state is on {st.now.device}")


def launch(st, trace: dict, cfg, stage_names, block: int | None = None,
           dyn=None):
    """Run the CUDA kernel over ``trace`` (leaves ``[T, W]``), one launch
    per ``block`` rows, updating ``st`` in place; with `dyn` (the lanes'
    ``stages.base.Dyn``, ``cfg`` their ladder's base config) in the
    ladder instantiation.  Raises on anything the kernel does not take,
    and when a launch is refused."""
    global LAUNCHES
    _check_cuda(st)
    params = _params(st, trace, cfg, stage_names, dyn)
    for _ in _launches(_lib(), params, st, trace, block):
        LAUNCHES += 1
        LAUNCHES_BY_PLACEMENT[params.placement] += 1
        LAUNCHES_BY_COMPOSITION[params.composition] += 1
    return st


def stage_cycles(st, trace: dict, cfg, stage_names,
                 block: int | None = None) -> torch.Tensor:
    """Run the profiled build of the kernel (``mmu_step_prof``) as
    ``launch`` runs the kernel, and return its clock64() stamps: int64
    ``[lanes, PROF_SLOTS]``, the cycles of each of ``STAGES`` summed over
    the accesses, then the loops' cycles and the accesses.  Not counted in
    ``LAUNCHES``: nothing on the main path calls it."""
    _check_cuda(st)
    params = _params(st, trace, cfg, stage_names)
    prof = torch.zeros((st.now.shape[0], PROF_SLOTS), dtype=torch.int64,
                       device=st.now.device)
    params.prof = prof.data_ptr()
    for _ in _launches(_lib("mmu_step_prof"), params, st, trace, block):
        pass
    return prof


def blocked_scan(step, st0, trace: dict, cfg, stage_names, dyn=None):
    """Scan the MMU step over ``trace`` (time axis 0, lanes axis 1).

    Updates ``st0`` in place and returns it.  On the card this launches
    the CUDA kernel (``BLOCK`` rows per launch; with `dyn`, the per-lane
    ``Dyn`` that `step` was built with, a ladder instantiation); on the
    CPU it runs ``plain_scan(step, ...)``.
    """
    dev = st0.now.device
    if dev.type == "cuda":
        return launch(st0, trace, cfg, stage_names, dyn=dyn)
    if dev.type == "cpu":
        return plain_scan(step, st0, trace)
    raise ValueError(f"no mmu_step path for device {dev}")
