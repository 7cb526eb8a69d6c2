"""The blocked access scan: the MMU step run over a trace, as a CUDA
kernel written by hand for Hopper (``csrc/mmu_step.cu``).

Replaces the TPU kernel ``src/repro/kernels/mmu_step.py:105``
(``_blocked_scan_impl``, entered by ``blocked_scan`` at :177).  The
Pallas kernel keeps the whole ``MMUState`` resident across a sequential
grid of trace blocks; here the state stays in device memory, in the
tensors ``make_state`` allocated (one per leaf, lane axis first, bools as
bytes), and ``blocked_scan`` launches the kernel once per trace block on
PyTorch's current stream, one warp per lane.  The state persists between
launches because it is never copied out.

The kernel is bound by latency, not by bytes or operations: each access
is a chain of dependent row loads (see the source's note).

``blocked_scan`` picks the path from the device of the state it is
given: on a CUDA tensor it launches the kernel (or raises); on a CPU
tensor it runs ``plain_scan``, the plain PyTorch version — the port's
stage pipeline (``repro_torch.core.mmu.make_step``) stepped access by
access.  No flag or environment variable chooses the path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches made by blocked_scan since import (the launch count
# that shows a run went through the kernel)
LAUNCHES = 0

# trace rows per launch when the caller gives no block size
BLOCK = 8192

MAX_WAYS = 32  # one warp per lane: thread w owns way w

# the compositions the kernel writes out
COMPOSITIONS = {("l1_tlb", "l2_tlb", "ptw"): False,
                ("l1_tlb", "l2_tlb", "victima", "ptw"): True}

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


class _HierCountP(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("n_l2_access", "n_l2_miss",
                                  "n_l3_access", "n_l3_trans")]


_STATS_FIELDS = ("n_access", "n_l1tlb_hit", "n_l2tlb_hit", "n_l2tlb_miss",
                 "n_victima_hit", "n_demand_ptw", "n_bg_ptw",
                 "sum_trans_cyc", "sum_l2miss_cyc", "sum_data_cyc",
                 "sum_walk_cyc", "hist_walk", "sum_tlb4_live",
                 "sum_tlb2_live")


class _StatsP(ctypes.Structure):
    _fields_ = [(n, _p) for n in _STATS_FIELDS]


class _TraceP(ctypes.Structure):
    _fields_ = [(n, _p) for n in ("vpn", "is2m", "line", "ipa")]


class _Params(ctypes.Structure):
    _fields_ = (
        [(n, _AssocP) for n in ("l1d4", "l1d2", "l2tlb", "pml4", "pdp",
                                "pd", "l1d", "l3")]
        + [("l2", _L2P), ("pc4", _CountersP), ("pc2", _CountersP),
           ("hier", _HierCountP), ("stats", _StatsP), ("trace", _TraceP),
           ("now", _p)]
        + [(n, _i) for n in ("lanes", "t0", "t1", "victima",
                             "tlb_aware", "use_ptwcp")]
        + [("pressure_mpki", _f), ("bypass_l2mpki", _f)]
        + [(n, _i) for n in ("l1tlb_lat", "l2tlb_lat", "lat_l1d", "lat_l2",
                             "lat_l3", "lat_dram")])


_LIB = None


def _lib() -> ctypes.CDLL:
    """The compiled kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load("mmu_step")
        lib.mmu_step_params_size.argtypes = []
        lib.mmu_step_params_size.restype = ctypes.c_int
        lib.mmu_step_launch.argtypes = [_Params, ctypes.c_void_p]
        lib.mmu_step_launch.restype = ctypes.c_int
        lib.mmu_step_error_string.argtypes = [ctypes.c_int]
        lib.mmu_step_error_string.restype = ctypes.c_char_p
        got = lib.mmu_step_params_size()
        if got != ctypes.sizeof(_Params):
            raise RuntimeError(f"mmu_step Params is {got} bytes in C, "
                               f"{ctypes.sizeof(_Params)} in ctypes")
        _LIB = lib
    return _LIB


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


def _params(st, trace: dict, cfg, stage_names) -> _Params:
    """The kernel's parameter struct, checking every tensor it touches
    (device, dtype, shape, contiguity) against the state's device."""
    names = tuple(stage_names)
    if names not in COMPOSITIONS:
        raise ValueError(f"the mmu_step kernel runs the compositions "
                         f"{list(COMPOSITIONS)}, not {names}")
    if COMPOSITIONS[names] != cfg.victima:
        raise ValueError(f"composition {names} disagrees with "
                         f"cfg.victima={cfg.victima}")
    dev = st.now.device
    W = st.now.shape[0]
    T = trace["vpn"].shape[0]
    tr_dtypes = {"vpn": torch.int32, "is2m": torch.bool,
                 "line": torch.int32, "ipa": torch.float32}
    if set(trace) != set(tr_dtypes):
        raise ValueError(f"trace leaves {sorted(trace)}, want "
                         f"{sorted(tr_dtypes)}")
    tr = _TraceP(*[_ptr(trace[k], d, (T, W), f"trace[{k!r}]", dev)
                   for k, d in tr_dtypes.items()])
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
        for f in _STATS_FIELDS])
    h = st.hier
    lat = cfg.lat
    return _Params(
        l1d4=_assoc(st.l1d4, cfg.l1d4_sets, cfg.l1d4_ways, W, "l1d4", dev),
        l1d2=_assoc(st.l1d2, cfg.l1d2_sets, cfg.l1d2_ways, W, "l1d2", dev),
        l2tlb=_assoc(st.l2tlb, cfg.l2tlb_sets, cfg.l2tlb_ways, W, "l2tlb",
                     dev),
        pml4=_assoc(st.pwcs.pml4, 8, 4, W, "pwcs.pml4", dev),
        pdp=_assoc(st.pwcs.pdp, 8, 4, W, "pwcs.pdp", dev),
        pd=_assoc(st.pwcs.pd, 8, 4, W, "pwcs.pd", dev),
        l1d=_assoc(h.l1d, cfg.l1_sets, cfg.l1_ways, W, "hier.l1d", dev),
        l3=_assoc(h.l3, cfg.l3_sets, cfg.l3_ways, W, "hier.l3", dev),
        l2=l2p,
        pc4=counters(st.pc4, cfg.n_pages4, "pc4"),
        pc2=counters(st.pc2, cfg.n_pages2, "pc2"),
        hier=_HierCountP(*[i32(getattr(h, n), (W,), "hier." + n)
                           for n in ("n_l2_access", "n_l2_miss",
                                     "n_l3_access", "n_l3_trans")]),
        stats=stats, trace=tr,
        now=i32(st.now, (W,), "now"),
        lanes=W, t0=0, t1=0, victima=int(cfg.victima),
        tlb_aware=int(cfg.tlb_aware), use_ptwcp=int(cfg.use_ptwcp),
        pressure_mpki=cfg.pressure_mpki, bypass_l2mpki=cfg.bypass_l2mpki,
        l1tlb_lat=cfg.l1tlb_lat, l2tlb_lat=cfg.l2tlb_lat,
        lat_l1d=lat.l1d, lat_l2=lat.l2, lat_l3=lat.l3, lat_dram=lat.dram)


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


def launch(st, trace: dict, cfg, stage_names, block: int | None = None):
    """Run the CUDA kernel over ``trace`` (leaves ``[T, W]``), one launch
    per ``block`` rows, updating ``st`` in place.  Raises on anything the
    kernel does not take, and when a launch is refused."""
    global LAUNCHES
    block = BLOCK if block is None else int(block)
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    dev = st.now.device
    if dev.type != "cuda":
        raise ValueError(f"the mmu_step kernel runs on CUDA tensors, the "
                         f"state is on {dev}")
    params = _params(st, trace, cfg, stage_names)
    lib = _lib()
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
            LAUNCHES += 1
    return st


def blocked_scan(step, st0, trace: dict, cfg, stage_names):
    """Scan the MMU step over ``trace`` (time axis 0, lanes axis 1).

    Updates ``st0`` in place and returns it.  On the card this launches
    the CUDA kernel (``BLOCK`` rows per launch); on the CPU it runs
    ``plain_scan(step, ...)``.
    """
    dev = st0.now.device
    if dev.type == "cuda":
        return launch(st0, trace, cfg, stage_names)
    if dev.type == "cpu":
        return plain_scan(step, st0, trace)
    raise ValueError(f"no mmu_step path for device {dev}")
