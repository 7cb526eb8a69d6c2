"""Device-mesh planning and lane dispatch over torch devices; port of
``repro.sim.parallel``.

A batched ladder run is an [S]-system x [W]-workload grid of mutually
independent lanes (``mmu.simulate_systems``).  This module spreads that
grid over a ``("sys", "wl"[, "core"])`` grid of devices:

- ``plan_mesh`` factorizes the visible devices into mesh dims (the
  reference's arithmetic, checks and messages unchanged).  The workload
  dim must divide W exactly; the system dim may be anything, because
  ``shard_wrap`` PADS the system axis up to a mesh multiple.
- ``shard_wrap``/``shard_systems`` cut the inputs into one block per
  mesh cell (Dyn leaves along the system axis, trace leaves along the
  workload, and core, axes), run the caller's per-block function on the
  cell's device, gather the outputs back in lane order and slice the
  padding off.  A 1x1 mesh (one card) is one block: the identity.
- ``shard_lanes`` does the same over a 1-D ``("lane",)`` list of devices
  for the serving load harness, whose arguments and outputs all lead
  with the lane axis.
- ``time_shard_scan`` splits one scan's time axis into ``t`` blocks that
  run as ``t`` lanes of one call (one ``mmu_step`` launch a round on the
  card) and resolves the carry hand-off to the exact serial result.

Every lane's computation is independent, so the mesh factorization
cannot change results: a split run equals the single-device one.

Pytrees here are tensors or numpy arrays nested in tuples, NamedTuples,
lists and dicts.  The module imports nothing of ``repro_torch.core`` or
its ``sim`` siblings (``repro_torch.obs`` is a stdlib-only leaf), so the
core layer may import it without a cycle.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

import repro_torch.obs as obs

AXIS_SYS = "sys"
AXIS_WL = "wl"
AXIS_CORE = "core"
AXIS_T = "t"
AXIS_LANE = "lane"

__all__ = ["AXIS_SYS", "AXIS_WL", "AXIS_CORE", "AXIS_T", "AXIS_LANE",
           "MeshPlan", "plan_mesh", "build_mesh", "shard_wrap",
           "shard_systems", "pick_t_shards", "time_shard_scan",
           "plan_lane_dim", "shard_lanes", "local_device_count",
           "tree_map", "tree_leaves"]


# ------------------------------------------------------------ pytrees

def tree_map(fn, tree, *rest):
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the containers; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map`` order (None dropped)."""
    out = []
    tree_map(out.append, tree)
    return out


def _concat(parts: list, axis: int):
    if isinstance(parts[0], torch.Tensor):
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts], dim=axis)
    return np.concatenate([np.asarray(p) for p in parts], axis=axis)


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def local_device_count() -> int:
    """The devices a plan may spread over: the visible CUDA cards, or
    the CPU alone (1) on a host that has none."""
    return len(_visible_devices())


# ------------------------------------------------------- mesh planning

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A (sys x wl [x core]) device-mesh factorization of a sweep grid.

    ``core_dim > 1`` adds a third mesh axis over the per-core trace
    lanes of a multicore run ([T, W, C] traces); ``core_dim == 1``
    (every single-core plan) keeps the 2-D mesh — the core axis, when
    present, then rides inside each block's lanes instead.
    """

    sys_dim: int       # mesh extent along the system axis
    wl_dim: int        # mesh extent along the workload axis (divides W)
    n_systems: int     # unpadded S
    n_workloads: int   # W
    pad_systems: int   # S padded up to a sys_dim multiple
    core_dim: int = 1  # mesh extent along the core axis (divides C)
    n_cores: int = 1   # C (1 = single-core: traces have no core axis)

    @property
    def n_devices(self) -> int:
        return self.sys_dim * self.wl_dim * self.core_dim

    def describe(self) -> str:
        if self.core_dim > 1:
            return f"{self.sys_dim}x{self.wl_dim}x{self.core_dim}"
        return f"{self.sys_dim}x{self.wl_dim}"


def plan_mesh(n_systems: int, n_workloads: int, n_devices: int | None = None,
              force: tuple[int, ...] | None = None,
              n_cores: int = 1) -> MeshPlan:
    """Factorize the device count into a ("sys", "wl"[, "core"]) mesh.

    Policy: the workload dim takes the largest divisor of W that also
    divides the device count (traces shard without padding); the system
    dim takes the remaining devices, capped at S (an 8-device host never
    runs a 2-system ladder 4x redundantly).  The system axis is then
    padded up to a ``sys_dim`` multiple — divisibility of S is never
    required.  ``force=(sys, wl)`` or ``(sys, wl, core)`` overrides the
    factorization; ``n_devices`` defaults to ``local_device_count()``.
    ``n_cores > 1`` declares a multicore run ([T, W, C] traces): the
    core axis defaults to lanes inside each block (``core_dim=1``), and
    a 3-tuple ``force`` promotes it to a third mesh dim (``core_dim``
    must divide C exactly — core lanes, like workloads, are never
    padded).  Empty grids are rejected up front.
    """
    if n_systems <= 0:
        raise ValueError(
            f"empty ladder: no systems to simulate (n_systems={n_systems})")
    if n_workloads <= 0:
        raise ValueError(
            f"empty ladder: no workloads to simulate "
            f"(n_workloads={n_workloads})")
    if n_cores < 1:
        raise ValueError(f"n_cores must be >= 1, got {n_cores}")
    core_dim = 1
    if force is not None:
        if len(force) not in (2, 3):
            raise ValueError(
                f"mesh force must be (sys, wl) or (sys, wl, core), "
                f"got {force}")
        sys_dim, wl_dim = int(force[0]), int(force[1])
        core_dim = int(force[2]) if len(force) == 3 else 1
        if sys_dim < 1 or wl_dim < 1 or core_dim < 1:
            raise ValueError(f"mesh dims must be >= 1, got {force}")
        if n_workloads % wl_dim != 0:
            raise ValueError(
                f"mesh wl dim {wl_dim} does not divide the workload axis "
                f"({n_workloads}); traces are never padded — pick a "
                f"divisor (the system axis is the padded one)")
        if core_dim > 1 and n_cores % core_dim != 0:
            raise ValueError(
                f"mesh core dim {core_dim} does not divide the core axis "
                f"({n_cores}); core lanes are never padded — pick a "
                f"divisor")
    else:
        d = n_devices if n_devices is not None else local_device_count()
        wl_dim = max(k for k in range(1, min(d, n_workloads) + 1)
                     if n_workloads % k == 0 and d % k == 0)
        sys_dim = min(d // wl_dim, n_systems)
    pad = math.ceil(n_systems / sys_dim) * sys_dim
    return MeshPlan(sys_dim=sys_dim, wl_dim=wl_dim, n_systems=n_systems,
                    n_workloads=n_workloads, pad_systems=pad,
                    core_dim=core_dim, n_cores=n_cores)


def _visible_devices() -> list[torch.device]:
    n = torch.cuda.device_count()
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def build_mesh(plan: MeshPlan, devices=None) -> list:
    """The plan's grid of devices, ``grid[s][w]`` (``grid[s][w][c]`` with
    a core dim), over the first ``plan.n_devices`` of `devices` (default:
    the visible cards)."""
    devs = list(devices) if devices is not None else _visible_devices()
    if len(devs) < plan.n_devices:
        raise ValueError(
            f"mesh {plan.describe()} needs {plan.n_devices} devices but "
            f"only {len(devs)} are visible")
    it = iter(devs[: plan.n_devices])
    if plan.core_dim > 1:
        return [[[next(it) for _ in range(plan.core_dim)]
                 for _ in range(plan.wl_dim)] for _ in range(plan.sys_dim)]
    return [[next(it) for _ in range(plan.wl_dim)]
            for _ in range(plan.sys_dim)]


def _pad_sys(x, pad: int):
    # replicate the last lane: a valid config, so padded lanes simulate
    # harmlessly (their outputs are sliced off, never stored)
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return np.concatenate([x, np.broadcast_to(x[-1:],
                                              (pad,) + x.shape[1:])])


def shard_wrap(fn, plan: MeshPlan, devices=None):
    """Wrap ``fn`` for the mesh ONCE; returns ``call(dyns, traces)``.

    ``fn`` is a per-block function: Dyn leaves arrive ``[S_blk]``-shaped
    on the block's device and trace leaves ``[T, W_blk, ...]`` (tensors
    moved there, numpy arrays as they are); every output leaf must lead
    with ``[S_blk, W_blk]`` (``[S_blk, W_blk, C_blk]`` with a core dim).
    The system axis is padded to the mesh (see ``plan_mesh``) and sliced
    back before returning, so callers always see exactly [S, W] outputs,
    gathered on the first block's device.  The blocks run one after the
    other from this thread; a 1x1 mesh is one block on one device.
    """
    grid = build_mesh(plan, devices)

    def call(dyns, traces):
        S = tree_leaves(dyns)[0].shape[0]
        leaf = tree_leaves(traces)[0]
        W = leaf.shape[1]
        if (plan.n_systems, plan.n_workloads) != (S, W):
            raise ValueError(
                f"mesh plan is for a {plan.n_systems}x{plan.n_workloads} "
                f"grid but the inputs are {S}x{W}")
        pad = plan.pad_systems - S
        if pad:
            dyns = tree_map(lambda x: _pad_sys(x, pad), dyns)
        sb = plan.pad_systems // plan.sys_dim
        wb = W // plan.wl_dim
        cb = leaf.shape[2] // plan.core_dim if plan.core_dim > 1 else None
        rows = []
        for i in range(plan.sys_dim):
            d_i = tree_map(lambda x: x[i * sb:(i + 1) * sb], dyns)
            cols = []
            for j in range(plan.wl_dim):
                t_j = tree_map(lambda x: x[:, j * wb:(j + 1) * wb], traces)
                if cb is None:
                    dev = grid[i][j]
                    cols.append(fn(tree_map(lambda x: _to(x, dev), d_i),
                                   tree_map(lambda x: _to(x, dev), t_j)))
                    continue
                cores = []
                for k in range(plan.core_dim):
                    dev = grid[i][j][k]
                    t_k = tree_map(lambda x: x[:, :, k * cb:(k + 1) * cb],
                                   t_j)
                    cores.append(fn(tree_map(lambda x: _to(x, dev), d_i),
                                    tree_map(lambda x: _to(x, dev), t_k)))
                cols.append(tree_map(lambda *xs: _concat(list(xs), 2),
                                     *cores))
            rows.append(tree_map(lambda *xs: _concat(list(xs), 1), *cols))
        out = tree_map(lambda *xs: _concat(list(xs), 0), *rows)
        return tree_map(lambda x: x[:S], out) if pad else out

    return call


def shard_systems(fn, dyns, traces, plan: MeshPlan | None = None,
                  devices=None):
    """One-shot form of ``shard_wrap``: plan (if needed), wrap, call."""
    S = tree_leaves(dyns)[0].shape[0]
    W = tree_leaves(traces)[0].shape[1]
    n = None if devices is None else len(devices)
    return shard_wrap(fn, plan or plan_mesh(S, W, n_devices=n),
                      devices)(dyns, traces)


# ------------------------------------------------------ time sharding

def pick_t_shards(n: int, requested: int) -> int:
    """Largest divisor of the trace length ``n`` that is <= ``requested``.

    Time blocks must tile the trace exactly — padding the time axis
    would simulate phantom accesses and break bit-identity with the
    serial scan — so a requested shard count that does not divide ``n``
    is rounded DOWN to the nearest divisor (worst case 1: no sharding).
    """
    if n <= 0:
        raise ValueError(f"cannot time-shard an empty trace (n={n})")
    if requested < 1:
        raise ValueError(f"time-shard count must be >= 1, got {requested}")
    return max(t for t in range(1, min(requested, n) + 1) if n % t == 0)


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def _block_eq(a, b, t: int) -> np.ndarray:
    """Per-block (``t`` blocks of lanes on axis 0) equality of two state
    pytrees, as a host bool array."""
    eq = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        e = (x == y).reshape(t, -1).all(dim=1)
        eq = e if eq is None else eq & e
    return eq.cpu().numpy()


def time_shard_scan(block_fn, st0, trace, t_shards: int,
                    batch: str = "vmap"):
    """Run ``block_fn`` over ``t_shards`` trace blocks speculatively and
    resolve the carry hand-off to the exact serial result.

    ``block_fn(state, trace) -> state`` is one serial segment of a scan
    over lane-batched state: state leaves lead with the lane axis
    ``[L, ...]`` and trace leaves are ``[T, L]`` (time first); it may
    update the state in place.  The trace's time axis is split into
    ``t`` contiguous blocks that run as ``t * L`` lanes of ONE call
    (lane ``b * L + l`` is block ``b`` of lane ``l``; on the card one
    ``mmu_step`` launch a round), every block from a GUESSED carry
    (``st0`` in round 1).  After each round the hand-off chain is
    re-seeded (``start[i+1] = end[i]``) and re-run until the exact
    prefix covers every block: block 0's start is exact by definition,
    and block ``i``'s end is exact once its start matched the exact end
    of block ``i-1``.  The prefix grows by >= 1 block per round, so the
    loop ends in <= ``t`` rounds with the state EQUAL to the serial
    scan's.  ``st0`` is not modified.

    ``batch`` keeps the reference's two values, ``"vmap"`` and
    ``"map"``; both run the blocks as lanes here, and any other raises.

    Returns ``(final_state, info)`` with ``info = {"t_shards", "rounds",
    "requested"}``; ``t_shards`` is the requested count rounded down to
    a divisor of the trace length (see ``pick_t_shards``).  Each round
    emits an ``EV_TIME_SHARD_ROUND`` event with the exact prefix.
    """
    if batch not in ("vmap", "map"):
        raise ValueError(f"unknown batch mode {batch!r}")
    n = tree_leaves(trace)[0].shape[0]
    t = pick_t_shards(n, t_shards)
    if t == 1:
        return block_fn(_clone(st0), trace), {
            "t_shards": 1, "rounds": 1, "requested": int(t_shards)}

    L = tree_leaves(st0)[0].shape[0]

    def blockify(x):  # [n, L, ...] -> [n/t, t*L, ...], block-major lanes
        x = x.reshape((t, n // t) + tuple(x.shape[1:]))
        x = x.transpose(0, 1) if isinstance(x, torch.Tensor) \
            else np.swapaxes(x, 0, 1)
        return x.reshape((n // t, t * L) + tuple(x.shape[3:]))

    blocks = tree_map(lambda x: blockify(x).contiguous()
                      if isinstance(x, torch.Tensor)
                      else np.ascontiguousarray(blockify(x)), trace)
    starts = tree_map(
        lambda x: x.repeat((t,) + (1,) * (x.ndim - 1)), st0)

    rounds = 0
    known = 0
    while known < t:
        ends = block_fn(_clone(starts), blocks)
        rounds += 1
        new_starts = tree_map(lambda s0, e: torch.cat([s0, e[:-L]]),
                              st0, ends)
        eq = _block_eq(new_starts, starts, t)
        # ends[0] came from the true st0, so it is exact; end i is exact
        # iff its start was, i.e. iff the start we USED equals the exact
        # end of block i-1 (eq[i]) and that end itself is exact
        known = 1
        while known < t and eq[known]:
            known += 1
        starts = new_starts
        # per-round hand-off telemetry: how far the exact prefix grew
        obs.event(obs.names.EV_TIME_SHARD_ROUND, round=rounds,
                  known_prefix=int(known), t_shards=t)
    final = tree_map(lambda e: e[-L:].clone(), ends)
    return final, {"t_shards": t, "rounds": rounds,
                   "requested": int(t_shards)}


# ------------------------------------------------------ lane sharding

def plan_lane_dim(n_lanes: int, n_devices: int | None = None) -> int:
    """Mesh extent for a 1-D ``("lane",)`` mesh over ``n_lanes`` lanes.

    Largest divisor of ``n_lanes`` that fits the device count (default
    ``local_device_count()``) — lanes, like workloads, are never padded
    (each lane is an independent engine whose state must round-trip
    exactly).  1 device → 1 (the identity partitioning).
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    d = n_devices if n_devices is not None else local_device_count()
    if d < 1:
        raise ValueError(f"n_devices must be >= 1, got {d}")
    return max(k for k in range(1, min(d, n_lanes) + 1) if n_lanes % k == 0)


def shard_lanes(fn, n_lanes: int, n_devices: int | None = None,
                devices=None):
    """Wrap a lane-batched ``fn`` for a 1-D ``("lane",)`` list of devices.

    The serving load harness's mesh: every pytree argument and output of
    ``fn`` leads with the lane axis ``[L, ...]`` (one engine per lane —
    its slot pool, KV page pool and VTC all ride that leading axis).
    The lanes split into ``mesh_dim`` equal blocks, block ``k`` runs on
    ``devices[k]`` (default: the visible cards), and the outputs gather
    back in lane order on the first block's device.  With ``mesh_dim``
    1 the call is ``fn`` itself, on the arguments as given.

    Returns ``call(*args)`` with attribute ``mesh_dim`` (the lane-mesh
    extent actually used).  Lanes must stay divisible: ``n_lanes`` is
    never padded, so the mesh dim comes from ``plan_lane_dim``.
    """
    devs = list(devices) if devices is not None else None
    if n_devices is None and devs is not None:
        n_devices = len(devs)
    dim = plan_lane_dim(n_lanes, n_devices)
    if dim > 1 and devs is None:
        devs = _visible_devices()
    if dim > 1 and len(devs) < dim:
        raise ValueError(f"lane mesh of {dim} needs {dim} devices but "
                         f"only {len(devs)} are given")
    blk = n_lanes // dim

    def call(*args):
        if dim == 1:
            return fn(*args)
        outs = [fn(*tree_map(
            lambda x, k=k: _to(x[k * blk:(k + 1) * blk], devs[k]), args))
            for k in range(dim)]
        return tree_map(lambda *xs: _concat(list(xs), 0), *outs)

    call.mesh_dim = dim
    return call
