"""Paged-KV block tables — the serving stack's page-table analogue; port
of ``repro.paged.block_table``.

Logical KV block (request r, block index b) → physical page in the KV
pool, resolved through a 2-level radix table:

    directory[r, b >> FANOUT_BITS] → leaf row id
    leaf[leaf_row, b & FANOUT-1]   → physical KV page

Two chained gathers per translation — the "page table walk" of the
serving stack.  The Victima layer (``translation_cache``) shortens this
chain for hot, costly translations.

The tables are lane-batched tensors: every leaf leads with ``[lanes]``,
one independent engine a lane, and every operation takes one request and
block per lane (``[lanes]`` tensors) and updates the tables IN PLACE.
An optional per-lane mask (``where``) leaves the lanes where it is False
exactly as they were.  Gathers clamp their indices and the directory
write drops an out-of-range slot, as the reference's jax indexing does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

FANOUT_BITS = 6
FANOUT = 1 << FANOUT_BITS          # 64 leaf entries per directory slot
TOKENS_PER_PAGE = 128
FREE = -1


class BlockTables(NamedTuple):
    directory: torch.Tensor  # int32 [L, R, max_dir]     → leaf row (FREE)
    leaves: torch.Tensor     # int32 [L, n_leaf_rows, FANOUT] → page (FREE)
    leaf_free: torch.Tensor  # int32 [L, n_leaf_rows]    1 = row free
    # walk-cost counters for the PTW-CP analogue (per leaf row)
    walk_freq: torch.Tensor  # uint8 [L, n_leaf_rows]
    walk_cost: torch.Tensor  # uint8 [L, n_leaf_rows]


def make(n_requests: int, max_blocks_per_req: int, n_leaf_rows: int,
         lanes: int = 1, device=None) -> BlockTables:
    """Empty tables for `lanes` engines on `device` (default: the card)."""
    from repro_torch.core.mmu import resolve_device
    dev = resolve_device(device)
    max_dir = (max_blocks_per_req + FANOUT - 1) // FANOUT

    def full(shape, v, dtype):
        return torch.full((lanes,) + shape, v, dtype=dtype, device=dev)

    return BlockTables(
        directory=full((n_requests, max_dir), FREE, torch.int32),
        leaves=full((n_leaf_rows, FANOUT), FREE, torch.int32),
        leaf_free=full((n_leaf_rows,), 1, torch.int32),
        walk_freq=full((n_leaf_rows,), 0, torch.uint8),
        walk_cost=full((n_leaf_rows,), 0, torch.uint8),
    )


def _lane(like: torch.Tensor) -> torch.Tensor:
    """Lane indices [L, 1, ...] broadcastable against `like` ([L, ...])."""
    return torch.arange(like.shape[0], device=like.device).view(
        (-1,) + (1,) * (like.dim() - 1))


def lane_arg(v, lanes: int, device) -> torch.Tensor:
    """An int or a ``[lanes]`` tensor as an int32 ``[lanes]`` tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(lanes)
    return torch.full((lanes,), int(v), dtype=torch.int32, device=device)


def walk(bt: BlockTables, req: torch.Tensor, block: torch.Tensor):
    """Radix walk: 2 dependent gathers. Returns (phys_page, hops,
    leaf_row), shaped like `block` ([L] or [L, k]; `req` broadcasts
    against it).  hops = 2 normally; 1 if the directory slot is dead
    (fault path)."""
    lane = _lane(block)
    req = req.long()
    dslot = (block >> FANOUT_BITS).long().clamp(
        0, bt.directory.shape[2] - 1)
    leaf_row = bt.directory[lane, req, dslot]
    ok = leaf_row >= 0
    row = leaf_row.clamp_min(0)
    phys = torch.where(
        ok, bt.leaves[lane, row.long(), (block & (FANOUT - 1)).long()],
        FREE)
    hops = torch.where(ok, 2, 1).to(torch.int32)
    return phys, hops, row


def walk_batch(bt: BlockTables, reqs: torch.Tensor, blocks: torch.Tensor):
    """`walk` over ``[L, k]`` requests and blocks."""
    return walk(bt, reqs, blocks)


def map_block(bt: BlockTables, req, block, phys_page,
              where: torch.Tensor | None = None) -> BlockTables:
    """Map (req, block) → phys_page in each lane, allocating the first
    free leaf row where the directory slot has none.  In place; lanes
    where `where` is False are left as they were."""
    L = bt.directory.shape[0]
    dev = bt.directory.device
    req, block, phys_page = (lane_arg(x, L, dev)
                             for x in (req, block, phys_page))
    take = (torch.ones(L, dtype=torch.bool, device=dev) if where is None
            else where)
    lane = torch.arange(L, device=dev)
    max_dir = bt.directory.shape[2]
    dslot = (block >> FANOUT_BITS).long()
    inb = dslot < max_dir
    dslot = dslot.clamp_max(max_dir - 1)
    r = req.long()
    leaf_row = bt.directory[lane, r, dslot]
    need_alloc = leaf_row < 0
    fresh = bt.leaf_free.argmax(1)              # first free row
    row = torch.where(need_alloc, fresh.to(torch.int32), leaf_row)
    bt.directory[lane, r, dslot] = torch.where(take & inb, row, leaf_row)
    bt.leaf_free[lane, fresh] = torch.where(
        take & need_alloc, 0, bt.leaf_free[lane, fresh])
    col = (block & (FANOUT - 1)).long()
    bt.leaves[lane, row.long(), col] = torch.where(
        take, phys_page, bt.leaves[lane, row.long(), col])
    return bt


def unmap_request(bt: BlockTables, req,
                  where: torch.Tensor | None = None) -> BlockTables:
    """Release a finished request (the 'TLB shootdown' trigger): its leaf
    rows become free, their entries FREE, its directory row FREE.

    Invalid directory slots clamp to row 0, so the row updates are
    order-independent reductions (max/min over duplicates), never plain
    writes.  In place; lanes where `where` is False are untouched."""
    L = bt.directory.shape[0]
    dev = bt.directory.device
    r = lane_arg(req, L, dev).long()
    lane = torch.arange(L, device=dev)
    rows = bt.directory[lane, r]                       # [L, max_dir]
    valid = rows >= 0
    if where is not None:
        valid = valid & where[:, None]
    rc = rows.clamp_min(0).long()
    bt.leaf_free.scatter_reduce_(1, rc, valid.to(torch.int32), "amax")
    big = torch.where(valid, FREE, 1 << 30).to(torch.int32)
    bt.leaves.scatter_reduce_(
        1, rc[:, :, None].expand(-1, -1, FANOUT),
        big[:, :, None].expand(-1, -1, FANOUT).contiguous(), "amin")
    keep = (torch.zeros(L, dtype=torch.bool, device=dev) if where is None
            else ~where)
    bt.directory[lane, r] = torch.where(keep[:, None], rows, FREE)
    return bt


def note_walk(bt: BlockTables, leaf_row, had_fault,
              where: torch.Tensor | None = None) -> BlockTables:
    """PTW-CP counter update (3-bit freq, 4-bit cost, saturating —
    identical bit-budget to the paper's PTE-embedded counters).  In
    place; lanes where `where` is False are untouched."""
    L = bt.walk_freq.shape[0]
    lane = torch.arange(L, device=bt.walk_freq.device)
    row = leaf_row.long()
    f0 = bt.walk_freq[lane, row]
    c0 = bt.walk_cost[lane, row]
    f = (f0.to(torch.int32) + 1).clamp_max(7).to(torch.uint8)
    c = (c0.to(torch.int32) + had_fault.to(torch.int32)).clamp_max(15) \
        .to(torch.uint8)
    if where is not None:
        f = torch.where(where, f, f0)
        c = torch.where(where, c, c0)
    bt.walk_freq[lane, row] = f
    bt.walk_cost[lane, row] = c
    return bt
