"""Fill the port's simulation result cache for the selected systems; the
port of ``repro.sim.sweep``.  Run as ``python -m repro_torch.sim.sweep``
(results land in ``.sim_cache_torch/``, or ``REPRO_TORCH_SIM_CACHE``).

The registry's ladders (``systems.LADDERS``: the 28-system native
family, the nested one, the multicore ones) are filled member by member
through ``run_ladder`` (one batched scan a chunk of workloads, each fill
under its ``ladder_fill`` span tree); the other systems run through
``run_batch``.  The cells are the same either way, byte for byte.

CLI: positional system names and/or ``--tags native,ablation`` to
select registry subsets by tag, e.g.

    python -m repro_torch.sim.sweep --tags utopia
    python -m repro_torch.sim.sweep radix --tags sensitivity

``--device cpu|cuda`` (default ``cuda``; ``cuda:1`` names a card) picks
where the scans run: the mmu_step kernel on a card, its plain version on
the CPU.  It takes the place of the reference's ``--backend
{scan,pallas}`` and ``--devices N`` (XLA's virtual host devices), which
mean nothing here and are refused as unknown options.
``--mesh SxW`` (or ``SxWxC`` for multicore families) spreads each ladder
fill's (sys, wl) grid over the visible cards in that factorization
(``parallel.plan_mesh``; ``CUDA_VISIBLE_DEVICES`` picks the cards) or,
on the CPU, runs every cell on the one device; it shapes ladder fills
only, so a selection with no ladder member refuses it.

Multicore: ``--cores C`` selects the registered C-core systems and
``--mix bc+rnd+xs`` names a multiprogrammed co-schedule for them --
repeatable, checked against the workload registry BEFORE anything runs,
and applied to multicore families only:

    python -m repro_torch.sim.sweep --cores 4 --mix bc+rnd+xs --mix dlrm+gen

``--time-shards N`` splits each ladder trace's time axis into N
speculative blocks resolved to the exact serial carry; it needs a 1x1
mesh.  ``--obs-trace PATH`` points the obs tracer at PATH, so every
ladder fill's span tree lands there (``python -m repro_torch.obs report
PATH``; the same as ``REPRO_OBS_TRACE=PATH``).
"""
from __future__ import annotations

import os
import sys
import time

import repro_torch.obs as obs
from repro_torch.sim import systems, trace_gen
from repro_torch.sim.runner import run_batch, run_ladder

N = int(os.environ.get("REPRO_SIM_N", 150_000))

# priority order: paper-headline systems first so partial sweeps are useful
SYSTEMS = [
    "radix", "victima", "utopia", "revelator", "utopia_victima",
    "revelator_victima", "pom", "l2tlb_64k", "l2tlb_128k", "np",
    "victima_virt", "isp", "pom_virt", "l2tlb_3k", "l2tlb_8k", "l2tlb_16k",
    "l2tlb_32k", "l3tlb_64k_15", "l3tlb_64k_24", "l3tlb_64k_39",
    "l2tlb_8k_real", "l2tlb_16k_real", "l2tlb_32k_real", "l2tlb_64k_real",
    "victima_agnostic", "victima_noptwcp", "radix_collect", "victima_l2_1m",
    "victima_l2_4m", "victima_l2_8m", "radix_l2_1m", "radix_l2_4m",
    "radix_l2_8m", "utopia_rs8", "utopia_rs32", "utopia_virt",
    "revelator_virt",
]


def parse_args(args):
    """Split a CLI arg list into (system names, tags, opts); every value
    is checked here, before anything runs.

    ``opts``: ``device`` (``"cuda"``, ``"cpu"``, ``"cuda:1"``),
    ``mesh`` (a tuple or None), ``time_shards``, ``obs_trace``,
    ``cores`` and ``mix`` (a list of mix specs)."""
    def _value(val, flag, what="a comma-separated value"):
        # a flag-like value is always a CLI mistake ("--tags --foo")
        if val is None or val.startswith("-"):
            raise SystemExit(
                f"{flag} needs {what}"
                + (f", got {val!r}" if val is not None else ""))
        return val

    def _mesh(val, flag):
        parts = _value(val, flag, "a SYSxWL[xCORE] value").split("x")
        if len(parts) not in (2, 3) or not all(p.isdigit() for p in parts):
            raise SystemExit(f"{flag} wants SYSxWL or SYSxWLxCORE "
                             f"(e.g. 2x2 or 1x2x2), got {val!r}")
        return tuple(int(p) for p in parts)

    def _count(val, flag, what):
        if not _value(val, flag, what).isdigit() or int(val) < 1:
            raise SystemExit(f"{flag} wants a positive integer, got {val!r}")
        return int(val)

    def _device(val, flag):
        kind, _, idx = _value(val, flag, "cpu, cuda or cuda:N").partition(":")
        if kind not in ("cpu", "cuda") or (idx and not idx.isdigit()) \
                or (kind == "cpu" and idx):
            raise SystemExit(f"{flag} wants cpu, cuda or cuda:N, got "
                             f"{val!r}")
        return val

    def _mix(val, flag):
        val = _value(val, flag, "a workload mix like bc+rnd+xs")
        try:
            trace_gen.parse_mix(val)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        return val

    names, tags = [], []
    opts = {"mesh": None, "device": "cuda", "time_shards": 1,
            "obs_trace": None, "cores": None, "mix": []}
    it = iter(args or [])
    for a in it:
        flag, eq, val = a.partition("=")
        if flag not in ("--tags", "--mesh", "--device", "--time-shards",
                        "--obs-trace", "--cores", "--mix"):
            if a.startswith("-"):
                raise SystemExit(
                    f"unknown option {a!r} (only --tags/--mesh/--device/"
                    f"--time-shards/--obs-trace/--cores/--mix)")
            names.append(a)
            continue
        val = val if eq else next(it, None)
        if flag == "--tags":
            tags += [t for t in _value(val, a).split(",") if t]
        elif flag == "--mesh":
            opts["mesh"] = _mesh(val, a)
        elif flag == "--device":
            opts["device"] = _device(val, a)
        elif flag == "--time-shards":
            opts["time_shards"] = _count(val, a, "a shard count")
        elif flag == "--obs-trace":
            opts["obs_trace"] = _value(val, a, "a file path")
        elif flag == "--cores":
            opts["cores"] = _count(val, a, "a core count")
        else:
            opts["mix"].append(_mix(val, a))
    if opts["time_shards"] > 1 and opts["mesh"] is not None \
            and any(d != 1 for d in opts["mesh"]):
        raise SystemExit(
            f"--time-shards needs a 1x1 ('sys', 'wl') mesh (devices go "
            f"to the 't' axis), got --mesh "
            f"{'x'.join(str(d) for d in opts['mesh'])}")
    return names, tags, opts


def select(selected, tags, cores) -> list[str]:
    """The systems to run: the named ones, every system carrying one of
    ``tags``, and with ``cores`` the registered multicore systems of that
    many cores; the default list when nothing is selected.  Raises
    (SystemExit) on an unknown name, tag or core count."""
    unknown = sorted(set(selected) - set(systems.REGISTRY))
    if unknown:
        raise SystemExit(
            f"unknown system(s): {', '.join(unknown)}; registered: "
            f"{', '.join(sorted(systems.REGISTRY))}")
    all_tags = {t for s in systems.REGISTRY.values() for t in s.tags}
    bad_tags = sorted(set(tags) - all_tags)
    if bad_tags:
        raise SystemExit(
            f"unknown tag(s): {', '.join(bad_tags)}; known: "
            f"{', '.join(sorted(all_tags))}")
    selected = list(selected)
    for t in tags:
        selected += [n for n in systems.names(t) if n not in selected]
    if cores is not None:
        mc = [n for n, s in systems.REGISTRY.items()
              if "multicore" in s.tags and s.config().n_cores == cores]
        if not mc:
            known = sorted({s.config().n_cores
                            for s in systems.REGISTRY.values()
                            if "multicore" in s.tags})
            raise SystemExit(
                f"no registered multicore systems with n_cores={cores}; "
                f"registered core counts: {', '.join(map(str, known))}")
        selected += [n for n in mc if n not in selected]
    return selected or list(SYSTEMS)


def main(selected=None):
    selected, tags, opts = parse_args(selected)
    selected = select(selected, tags, opts["cores"])
    in_ladder = {m for ms in systems.LADDERS.values() for m in ms}
    if opts["mesh"] is not None and not in_ladder & set(selected):
        raise SystemExit("--mesh shapes a ladder fill's (sys, wl) grid "
                         "(sim.parallel.plan_mesh), and none of the selected "
                         "systems is a ladder member")
    if opts["obs_trace"]:
        obs.configure(opts["obs_trace"])
    t00 = time.time()
    done: set[str] = set()
    # ladders first: one batched scan covers many systems.  A selected
    # subset only simulates the selected members.
    for ladder, members in systems.LADDERS.items():
        todo = [s for s in members if s in selected]
        if not todo:
            continue
        t0 = time.time()
        # --mix co-schedules apply to multicore families only
        wl = (opts["mix"] or None) if systems.mix_cores(todo) > 1 else None
        run_ladder(ladder, n=N, members=todo, workloads=wl,
                   device=opts["device"], mesh=opts["mesh"],
                   time_shards=opts["time_shards"])
        done.update(todo)
        print(f"[sweep] ladder:{ladder:>11s} x all  {time.time()-t0:7.1f}s "
              f"({len(todo)} systems; total {time.time()-t00:7.0f}s)",
              flush=True)
    for sysname in selected:
        if sysname in done:
            continue
        t0 = time.time()
        wl = ((opts["mix"] or None)
              if systems.config(sysname).n_cores > 1 else None)
        run_batch(sysname, n=N, workloads=wl, device=opts["device"])
        print(f"[sweep] {sysname:>18s} x all  {time.time()-t0:7.1f}s "
              f"(total {time.time()-t00:7.0f}s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or None)
