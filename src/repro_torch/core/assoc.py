"""Set-associative structure primitives, lane-batched (port of
``repro.core.assoc``).

Every structure carries a leading lane axis, the reference's ``vmap``
written out:

    tags  : int32 [W, n_sets, n_ways]
    valid : bool  [W, n_sets, n_ways]
    meta  : int32 [W, n_sets, n_ways]   (LRU stamp or RRPV)

Keys, set indices, ways and enables are ``[W]`` tensors.  Updates are
made IN PLACE on the state tensors, where the reference is functional: a
Table-3 lane holds megabytes of state, and a copy per access would
dominate.  Each function reads what it needs before it writes, so the
in-place order reproduces the reference's semantics (pinned by
tests/test_torch_primitives.py).

Victims are chosen as in the reference: LRU takes the first argmin stamp
(invalid ways count as -1); SRRIP ages the row and takes the first
argmax, with the TLB-aware re-roll of the paper's Listing 1.  ``argmax``
of a bool mask runs on a uint8 cast (torch rejects bool) and, like
``jnp.argmax``, returns the first hit, or 0 when there is none.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

RRIP_BITS = 2
RRIP_MAX = (1 << RRIP_BITS) - 1  # 3


class Assoc(NamedTuple):
    """A lane-batched set-associative array structure."""

    tags: torch.Tensor   # int32 [W, S, ways]
    valid: torch.Tensor  # bool  [W, S, ways]
    meta: torch.Tensor   # int32 [W, S, ways] — LRU stamp or RRPV

    @property
    def n_sets(self) -> int:
        return self.tags.shape[1]

    @property
    def n_ways(self) -> int:
        return self.tags.shape[2]


def make(n_sets: int, n_ways: int, lanes: int = 1, device="cpu") -> Assoc:
    shape = (lanes, n_sets, n_ways)
    return Assoc(
        tags=torch.zeros(shape, dtype=torch.int32, device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
        meta=torch.zeros(shape, dtype=torch.int32, device=device),
    )


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)


def lane_ids(x: torch.Tensor) -> torch.Tensor:
    """Lane indices ``[W]`` for a lane-leading tensor (read-only)."""
    return _arange(x.shape[0], x.device)


@functools.lru_cache(maxsize=None)
def _lane_offsets(n: int, stride: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device) * stride


def lane_offsets(x: torch.Tensor) -> torch.Tensor:
    """Flat offset of each lane's first element in `x` (read-only)."""
    return _lane_offsets(x.shape[0], x.numel() // x.shape[0], x.device)


def row_offsets(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Flat offset of row `s` of each lane in a ``[W, S, ways]`` array;
    add a way to address one element with ``take``/``put_``."""
    return lane_offsets(x) + s * x.shape[2]


def as_mask(enable, like: torch.Tensor) -> torch.Tensor:
    """A ``[W]`` bool mask from a Python bool or a bool tensor."""
    if isinstance(enable, torch.Tensor):
        return enable
    return torch.full(like.shape, bool(enable), dtype=torch.bool,
                      device=like.device)


def idle(en: torch.Tensor) -> bool:
    """True when no lane is enabled and the tensors lie on the CPU.

    A disabled update writes nothing (every store is ``where(en, new,
    old)``), so callers skip it whole: exact, and on the CPU, where the
    check costs no stall, it saves most of the step's ops.  On the card
    the check would synchronize the stream, so there it is never taken.
    """
    return en.device.type == "cpu" and not bool(en.any())


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a bool ``[W, n]`` mask: first True, 0 if none."""
    return mask.to(torch.uint8).argmax(1)


def set_index(key: torch.Tensor, n_sets: int) -> torch.Tensor:
    """Low-order-bit set indexing (n_sets must be a power of two)."""
    if n_sets & (n_sets - 1):
        raise ValueError(f"n_sets must be a power of two, got {n_sets}")
    return (key & (n_sets - 1)).long()


def lookup(a: Assoc, key: torch.Tensor):
    """Probe. Returns (hit [W] bool, way [W], set_idx [W])."""
    s = set_index(key, a.n_sets)
    ln = lane_ids(key)
    hits = a.valid[ln, s] & (a.tags[ln, s] == key[:, None])
    return hits.any(1), first_true(hits), s


# ---------------------------------------------------------------- LRU


def touch_lru(a: Assoc, s, way, now) -> Assoc:
    a.meta[lane_ids(s), s, way] = now
    return a


def lru_victim(a: Assoc, s: torch.Tensor) -> torch.Tensor:
    ln = lane_ids(s)
    stamps = torch.where(a.valid[ln, s], a.meta[ln, s], -1)
    return stamps.argmin(1)


def insert_lru(a: Assoc, key, now, enable=True):
    """Insert `key` at set(key), evicting LRU. Returns (assoc, evicted_tag,
    evicted_valid)."""
    s = set_index(key, a.n_sets)
    e = row_offsets(a.tags, s) + lru_victim(a, s)
    ev_tag = a.tags.take(e)
    ev_valid = a.valid.take(e)
    en = as_mask(enable, key)
    if idle(en):
        return a, ev_tag, ev_valid & en
    a.tags.put_(e, torch.where(en, key, ev_tag))
    a.valid.put_(e, ev_valid | en)
    a.meta.put_(e, torch.where(en, now, a.meta.take(e)))
    return a, ev_tag, ev_valid & en


# ---------------------------------------------------------------- SRRIP

def srrip_age_and_pick(rrpv_row: torch.Tensor, valid_row: torch.Tensor):
    """Age the row so at least one way reaches RRIP_MAX and pick a victim.

    Invalid ways are preferred (treated as RRPV=+inf).  Returns
    (aged_row, victim_way) for ``[W, ways]`` rows.
    """
    eff = torch.where(valid_row, rrpv_row, RRIP_MAX + 1)
    bump = (RRIP_MAX - eff.amax(1)).clamp_min(0)
    aged = torch.where(valid_row, rrpv_row + bump[:, None], rrpv_row)
    pick = torch.where(valid_row, aged, RRIP_MAX + 1)
    return aged, pick.argmax(1)


def srrip_victim_tlb_aware(rrpv_row, valid_row, is_tlb_row, pressure):
    """Paper Listing 1 `chooseReplacementCandidate`.

    If the SRRIP victim is a TLB block and translation pressure is high,
    make ONE more attempt: choose a non-TLB way at RRIP_MAX (post-aging).
    If none exists the TLB block is evicted after all.
    Returns (aged_row, victim_way).
    """
    aged, v0 = srrip_age_and_pick(rrpv_row, valid_row)
    non_tlb_max = valid_row & ~is_tlb_row & (aged >= RRIP_MAX)
    have_alt = non_tlb_max.any(1)
    v1 = first_true(non_tlb_max)
    ln = lane_ids(v0)
    reroll = pressure & valid_row[ln, v0] & is_tlb_row[ln, v0] & have_alt
    return aged, torch.where(reroll, v1, v0)
