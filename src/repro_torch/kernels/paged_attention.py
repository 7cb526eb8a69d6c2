"""GQA decode attention over a paged KV pool, as a CUDA kernel written by
hand for Hopper (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py:73``
(``paged_attention``; body ``_kernel`` at :28).  The decode attention of
the port's transformer runs through it, one launch per layer and step,
over the layer's cache viewed as pages.

Each (request, kv head) is split over ``plan(...).splits`` CTAs, whose
partial softmaxes are merged in one of two forms, as ``plan`` picks from
the shapes alone: a thread-block cluster merging through distributed
shared memory (one launch), or a second launch over partials in a
float32 scratch.  ``plan`` is mirrored by the kernel library's own
query, which the wrapper checks.

``paged_attention`` picks the path from the device of the tensors it is
given: on CUDA tensors it launches the kernel (or raises); on CPU
tensors it runs the plain PyTorch version,
``ref.paged_attention_reference``.  No flag chooses the path.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

# kernel launches made by paged_attention since import, in all and by
# form
LAUNCHES = 0
LAUNCHES_BY_FORM = {"cluster": 0, "two_pass": 0}

HEAD_DIMS = (16, 32, 64, 128, 256)  # head widths the kernel is built for
MAX_GROUP = 16      # query heads per kv head: 4 warps of at most 4 rows
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the planner's constants, as csrc/paged_attention.cu has them
SMS = 132           # H100 SXM: two CTAs an SM is the planner's aim
CHUNK = 64          # tokens: the unit of a CTA's share of a context
MAX_SPLITS = 16     # CTAs of a cluster (above 8 a non-portable size)
STAGES = 3          # depth of the K/V ring in shared memory
STAGE_BYTES = 16384  # K and V rows of one stage of the ring
# after the ring: the warps' and the CTA's (m, l), 16 rows each, and each
# of the 4 warps' tensor-core weights (4 rows x 16 tokens) and
# corrections (4 rows)
TAIL_BYTES = 4 * (4 * MAX_GROUP + 4 * (4 * 16 + 4))
# clusters of s CTAs an H100 holds at once at four CTAs an SM
# (cudaOccupancyMaxActiveClusters on the card): from 4 CTAs a cluster is
# placed within a GPC, and the SMs a GPC has beyond a multiple of its
# span go unused
CLUSTER_SLOTS = {1: 4 * SMS, 2: 2 * SMS, 4: 124, 8: 62, 16: 28}
# a CTA's share of the capacity, at most, in the cluster form (``plan``)
TWO_PASS_TOKENS = 512

_p, _i = ctypes.c_void_p, ctypes.c_int32


class _Args(ctypes.Structure):
    _fields_ = ([(n, _p) for n in ("q", "k_pages", "v_pages", "tables",
                                   "lens", "o")]
                + [(n, _i) for n in ("B", "H", "K", "page", "nb")]
                + [("scale", ctypes.c_float)])


class Plan(NamedTuple):
    splits: int       # CTAs per (request, kv head)
    smem_bytes: int   # dynamic shared memory a CTA
    clustered: bool   # the cluster form (else the two-pass form)


def plan(B: int, K: int, nb: int, page: int, hd: int, G: int,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The launch plan for B requests, K kv heads, a table of nb pages of
    ``page`` tokens, head width hd, G query heads per kv head and K/V in
    ``dtype``; raises on a width or group the kernel does not take.

    The split count is the smallest power of 2 that makes two CTAs an SM
    over the B * K (request, kv head) pairs, at most MAX_SPLITS and at most
    the table's CHUNK-token chunks.  The cluster form takes it no larger
    than lets all B * K clusters stay on the card at once (CLUSTER_SLOTS:
    64 pairs, as at granite-3-2b's and qwen3-32b's decode, get 4, since
    only 62 clusters of 8 fit), and is the plan where those CTAs fill the
    card (one an SM or more) and each takes at most TWO_PASS_TOKENS of the
    capacity, or where the count is 1.  Elsewhere the plan is the two-pass
    form at the uncapped count.  On an H100 (PERF.md) granite's
    decode ran faster in the cluster form, qwen3-32b's at 4096 tokens and
    recurrentgemma-2b's in the two-pass form.  The plan reads the table's
    capacity nb * page, never the context lengths, so planning needs
    nothing from the card; the kernel divides the live tokens among the
    CTAs.
    ``smem_bytes`` is the K/V ring (STAGES stages of at most CHUNK tokens
    and STAGE_BYTES) and the tail."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head widths {HEAD_DIMS}, not "
                         f"{hd}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"the kernel holds 1 to {MAX_GROUP} query heads "
                         f"per kv head, not {G}")
    if dtype not in DTYPES:
        raise TypeError(f"the kernel takes K/V in {list(DTYPES)}, not "
                        f"{dtype}")
    esize = torch.empty((), dtype=dtype).element_size()
    stage_tokens = min(CHUNK, STAGE_BYTES // (2 * hd * esize))
    smem = STAGES * 2 * stage_tokens * hd * esize + TAIL_BYTES
    capped = _splits(B, K, nb, page, clustered=True)
    if capped == 1 or (B * K * capped >= SMS
                       and nb * page <= TWO_PASS_TOKENS * capped):
        return Plan(capped, smem, True)
    return Plan(_splits(B, K, nb, page, clustered=False), smem, False)


def _splits(B, K, nb, page, clustered):
    """``plan``'s split count; without ``clustered``, the cap on clusters
    the card holds at once is left out (the two-pass form has none)."""
    chunks = max(1, -(-nb * page // CHUNK))
    want = -(-2 * SMS // max(1, B * K))
    splits = 1
    while (splits < want and 2 * splits <= min(MAX_SPLITS, chunks)
           and (not clustered or B * K <= CLUSTER_SLOTS[2 * splits])):
        splits *= 2
    return splits


_LIB = None
_CHECKED = set()   # plans the library's own query has confirmed


def _lib() -> ctypes.CDLL:
    """The compiled kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load("paged_attention")
        lib.paged_attention_args_size.restype = ctypes.c_int
        lib.paged_attention_max_group.restype = ctypes.c_int
        lib.paged_attention_plan.argtypes = [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int)] * 4
        lib.paged_attention_plan.restype = ctypes.c_int
        lib.paged_attention_launch.argtypes = [_Args, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p,
                                               ctypes.c_void_p]
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        got = lib.paged_attention_args_size()
        if got != ctypes.sizeof(_Args):
            raise RuntimeError(f"PagedArgs is {got} bytes in C, "
                               f"{ctypes.sizeof(_Args)} in ctypes")
        if lib.paged_attention_max_group() != MAX_GROUP:
            raise RuntimeError("MAX_GROUP disagrees with the kernel's GMAX")
        lib.paged_attention_cluster_slots.argtypes = [ctypes.c_int]
        lib.paged_attention_cluster_slots.restype = ctypes.c_int
        lib.paged_attention_clusters_on_card.argtypes = [ctypes.c_int] * 2
        lib.paged_attention_clusters_on_card.restype = ctypes.c_int
        table = {s: lib.paged_attention_cluster_slots(s)
                 for s in CLUSTER_SLOTS}
        if table != CLUSTER_SLOTS:
            raise RuntimeError(f"CLUSTER_SLOTS {CLUSTER_SLOTS} disagrees with "
                               f"the kernel's {table}")
        _LIB = lib
    return _LIB


def _confirm(lib, key, want: Plan):
    """Holds ``want``, ``plan(*key)``, to the library's own query, once
    per key (B, K, nb, page, hd, G, dtype)."""
    if key in _CHECKED:
        return
    B, K, nb, page, hd, G, dtype = key
    out = [ctypes.c_int() for _ in range(4)]
    err = lib.paged_attention_plan(B, K, nb, page, hd, G, DTYPES[dtype],
                                   *map(ctypes.byref, out))
    splits, smem, clustered, free = (x.value for x in out)
    got = Plan(splits, smem, bool(clustered))
    if err != 0 or got != want or \
            free != _splits(B, K, nb, page, clustered=False):
        raise RuntimeError(f"the kernel plans {got} (error {err}) where "
                           f"plan() gives {want} for {key}")
    _CHECKED.add(key)


def clusters_on_card(hd: int = 64) -> dict:
    """Clusters of each size in CLUSTER_SLOTS that the current card holds
    at once for the bf16 kernel at width hd (64 or 128), as
    cudaOccupancyMaxActiveClusters reports them: what the planner's table
    assumes."""
    got = {s: _lib().paged_attention_clusters_on_card(hd, s)
           for s in CLUSTER_SLOTS}
    if min(got.values()) < 0:
        raise RuntimeError(f"the occupancy query failed: {got}")
    return got


def check(q, k_pages, v_pages, tables, lens):
    """Shapes the function takes (both paths): (B, H, hd, P, page, K, nb)."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [B,H,hd] and the pages [P,page,K,hd]")
    B, H, hd = q.shape
    P, page, K, khd = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or khd != hd:
        raise ValueError(f"q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)} and v_pages "
                         f"{tuple(v_pages.shape)} do not fit together")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv "
                         f"heads")
    if tables.dim() != 2 or tables.shape[0] != B \
            or tuple(lens.shape) != (B,):
        raise ValueError(f"tables must be [B, nb] and lens [B] with B={B}")
    return B, H, hd, P, page, K, tables.shape[1]


def launch(q, k_pages, v_pages, tables, lens, *, clustered=None):
    """The CUDA kernel on CUDA tensors; raises on anything it does not
    take, and when the launch is refused.  Page ids in ``tables`` must lie
    in [0, P); ``lens`` above nb * page count as nb * page.

    ``clustered`` forces a form (its own split count) in place of the
    plan's, for comparing the two; the model never passes it."""
    global LAUNCHES
    B, H, hd, P, page, K, nb = check(q, k_pages, v_pages, tables, lens)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the paged_attention kernel runs on CUDA tensors, "
                         f"q is on {dev}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lens", lens)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("tables", tables), ("lens", lens)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} is {x.dtype}, want torch.int32")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"v_pages is {v_pages.dtype}, k_pages "
                        f"{k_pages.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q: the kernel takes {list(DTYPES)}, not {q.dtype}")
    if B > 65535 or K > 65535:
        raise ValueError(f"B={B} and K={K} must each be at most 65535")
    if nb * page >= 2 ** 31:
        raise ValueError(f"a table of {nb} pages of {page} tokens is past "
                         f"the kernel's 32-bit token index")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernel loads 16 bytes at a time)")
    G = H // K
    key = (B, K, nb, page, hd, G, k_pages.dtype)
    pl = planned = plan(*key)
    if clustered is not None and clustered != pl.clustered:
        pl = Plan(_splits(B, K, nb, page, clustered), pl.smem_bytes,
                  clustered)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    args = _Args(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), o.data_ptr(),
                 B, H, K, page, nb, 1.0 / (hd ** 0.5))
    lib = _lib()
    _confirm(lib, key, planned)
    scratch = None if pl.clustered else torch.empty(
        B * K * pl.splits * (G * hd + 2 * G), dtype=torch.float32,
        device=dev)
    with torch.cuda.device(dev):
        err = lib.paged_attention_launch(
            args, DTYPES[q.dtype], DTYPES[k_pages.dtype], hd, pl.splits,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: error {err} "
            f"({lib.paged_attention_error_string(err).decode()})")
    LAUNCHES += 1
    LAUNCHES_BY_FORM["cluster" if pl.clustered else "two_pass"] += 1
    return o


def paged_attention(q, k_pages, v_pages, tables, lens):
    """q [B,H,hd]; k_pages/v_pages [P,page,K,hd]; tables [B,nb] int32
    physical page ids; lens [B] context lengths.  Returns [B,H,hd].

    On the card this launches the CUDA kernel; on the CPU it runs
    ``ref.paged_attention_reference``."""
    if q.device.type == "cuda":
        return launch(q, k_pages, v_pages, tables, lens)
    if q.device.type == "cpu":
        check(q, k_pages, v_pages, tables, lens)
        return ref.paged_attention_reference(q, k_pages, v_pages, tables,
                                             lens)
    raise ValueError(f"no paged_attention path for device {q.device}")
