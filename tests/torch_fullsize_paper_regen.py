"""Regenerate tests/golden/torch_fullsize_paper_stats.json.

The snapshot holds what chip_smoke.py's paper-table phase and its
phase 3 hold the port's ``repro_torch.sim.paper`` against, all made on
the CPU from the JAX package at the Table-3 defaults over all 11
workloads, seed 0, n = 20,000 accesses a workload:

- ``systems``: the Stats and extras of every system the paper's figures
  use that neither torch_fullsize_stats.json nor
  torch_fullsize_stages_stats.json holds (``repro.sim.runner.run_batch``,
  which stacks the traces as the port's run_batch does);
  ``radix_collect``'s ``feats`` and ``pc4`` extras are given as sha256
  digests (``feats_sha256``: every Feats leaf's bytes in field order;
  ``pc4_sha256``: freq then cost);
- ``table2``: the Table-2 dataset's ``X``/``y`` digests and shape, the
  ``fit_box`` result, both comparator rows, and for each MLP its initial
  weights as ``repro.core.ptwcp_nn.train_mlp`` draws them (``jax.random``
  cannot be reproduced in torch) and its result;
- ``figures``: the ``(name, derived)`` rows of every function of
  ``benchmarks/paper.py:ALL`` but ``multicore_scaling``, from that file's
  own functions.  Its ladder warm-up is bypassed (``_LADDER_OF = {}``):
  every system goes straight to ``run_batch``.  The systems the two
  older snapshots hold are loaded from them into the reference's
  result cache first, not simulated again.

Usage:  PYTHONPATH=src:tests python tests/torch_fullsize_paper_regen.py \
            [system ...]

``REPRO_SIM_CACHE`` (a fresh temporary directory when unset) is the
reference's result cache; with system names, only those are recomputed
(their cache entries dropped) and merged into the existing file.  The
file is written after each system.
"""
import hashlib
import importlib.util
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("REPRO_SIM_CACHE",
                      tempfile.mkdtemp(prefix="paper_regen_cache_"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from golden_trace import stats_to_jsonable  # noqa: E402
from repro.core import ptwcp_nn  # noqa: E402
from repro.core.stages import Stats  # noqa: E402
from repro.sim import runner, trace_gen  # noqa: E402

N = 20_000
SEED = 0
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "golden", "torch_fullsize_paper_stats.json")
OLDER = ("torch_fullsize_stats.json", "torch_fullsize_stages_stats.json")
PAPER = os.path.join(HERE, "..", "benchmarks", "paper.py")

# every system the ported figure functions fetch, in first-use order
FIG_SYSTEMS = (
    "radix", "l2tlb_3k", "l2tlb_8k", "l2tlb_16k", "l2tlb_32k", "l2tlb_64k",
    "l2tlb_128k", "l2tlb_8k_real", "l2tlb_16k_real", "l2tlb_32k_real",
    "l2tlb_64k_real", "l3tlb_64k_15", "l3tlb_64k_24", "l3tlb_64k_39", "pom",
    "np", "pom_virt", "radix_collect", "victima", "victima_l2_1m",
    "radix_l2_1m", "victima_l2_4m", "radix_l2_4m", "victima_l2_8m",
    "radix_l2_8m", "victima_agnostic", "victima_noptwcp", "utopia",
    "utopia_victima", "utopia_rs8", "utopia_rs32", "revelator",
    "revelator_victima", "isp", "victima_virt")
# (name, feature columns, hidden width) of ptwcp_nn.run_study's MLPs
MLPS = (("NN-6", [0, 1, 2, 3, 4, 5], 16), ("NN-4", [1, 2, 3, 5], 8),
        ("NN-2", [1, 2], 4))


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def older_snapshots() -> dict:
    """system -> {workload: {"stats", "extras"}} of the older snapshots."""
    out = {}
    for fname in OLDER:
        with open(os.path.join(HERE, "golden", fname)) as f:
            snap = json.load(f)
        assert snap["seed"] == SEED
        for name, entry in snap["systems"].items():
            per = entry.get("workloads", entry)
            assert entry.get("n", snap.get("n")) == N, (fname, name)
            out[name] = per
    return out


def seed_cache(older: dict) -> None:
    """Store the older snapshots' systems as the reference's run_batch
    would (Stats of numpy leaves, extras, spec)."""
    for name, per in older.items():
        if name not in FIG_SYSTEMS:
            continue
        for w, e in per.items():
            st = Stats(**{
                k: np.asarray(v, np.float32 if k.startswith("sum_")
                              else np.int32)
                for k, v in e["stats"].items()})
            ex = {"l2_access": int(e["extras"]["l2_access"]),
                  "l2_miss": int(e["extras"]["l2_miss"]),
                  "hist_reuse_data": np.asarray(
                      e["extras"]["hist_reuse_data"], np.int32),
                  "hist_reuse_tlb": np.asarray(
                      e["extras"]["hist_reuse_tlb"], np.int32)}
            runner._store(runner._path(name, w, N, SEED, None),
                          (st, ex, trace_gen.WORKLOADS[w]))


def mlp_init(n_in: int, hidden: int, layers: int = 2, seed: int = 0):
    """train_mlp's initial draw, as (w, b) lists."""
    key = jax.random.PRNGKey(seed)
    dims = [n_in] + [hidden] * layers + [1]
    ws = []
    for i in range(len(dims) - 1):
        key, k = jax.random.split(key)
        w = jax.random.normal(k, (dims[i], dims[i + 1])) / np.sqrt(dims[i])
        ws.append([np.asarray(w, np.float32).tolist(),
                   np.zeros(dims[i + 1], np.float32).tolist()])
    return ws


def result_dict(r) -> dict:
    return {"name": r.name, "params_bytes": r.params_bytes,
            "accuracy": r.accuracy, "precision": r.precision,
            "recall": r.recall, "f1": r.f1}


def table2(out: dict) -> dict:
    extras = [out[w][1] for w in trace_gen.all_workloads()]
    X, y = ptwcp_nn.build_dataset(extras)
    box = ptwcp_nn.fit_box(X, y)
    study = ptwcp_nn.run_study(extras)
    mlps = {}
    for (name, idx, hidden), r in zip(MLPS, study[:3]):
        assert r.name == name
        mlps[name] = {"feat_idx": idx, "hidden": hidden,
                      "init": mlp_init(len(idx), hidden),
                      "result": result_dict(r)}
    return {"X_sha256": sha(X), "y_sha256": sha(y),
            "X_shape": list(X.shape), "fit_box": list(box), "mlps": mlps,
            "comparators": [result_dict(r) for r in study[3:]]}


def system_entry(name: str, out: dict) -> dict:
    per = {}
    for w in trace_gen.all_workloads():
        st, ex, _ = out[w]
        e = {k: np.asarray(v).tolist() for k, v in ex.items()
             if k not in ("feats", "pc4")}
        if "feats" in ex:
            e["feats_sha256"] = sha(*ex["feats"])
            e["pc4_sha256"] = sha(ex["pc4"].freq, ex["pc4"].cost)
        per[w] = {"stats": stats_to_jsonable(st), "extras": e}
    return per


def load_paper():
    spec = importlib.util.spec_from_file_location("paper_ref", PAPER)
    paper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(paper)
    # run_ladder fails on this tree: every system goes to run_batch
    paper._LADDER_OF = {}
    paper.N = N
    paper.WLS = trace_gen.all_workloads()
    return paper


def write(snap):
    with open(OUT, "w") as f:
        json.dump(snap, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


def main(argv):
    older = older_snapshots()
    new = [s for s in FIG_SYSTEMS if s not in older]
    todo = argv or new
    unknown = sorted(set(todo) - set(new))
    if unknown:
        raise SystemExit(f"unknown system(s) {unknown}; known: {new}")
    names = trace_gen.all_workloads()
    snap = {"n": N, "seed": SEED, "workloads": names, "systems": {},
            "trace_sha256": {}}
    if argv and os.path.exists(OUT):
        with open(OUT) as f:
            snap = json.load(f)
    seed_cache(older)
    for name in todo:
        for w in names:
            p = runner._path(name, w, N, SEED, None)
            if argv and os.path.exists(p):
                os.unlink(p)
        t0 = time.perf_counter()
        out = runner.run_batch(name, workloads=names, n=N, seed=SEED)
        snap["systems"][name] = system_entry(name, out)
        if name == "radix_collect":
            snap["table2"] = table2(out)
        print(f"[paper] {name}: {time.perf_counter() - t0:.0f} s, "
              f"n_demand_ptw={[int(out[w][0].n_demand_ptw) for w in names]}",
              flush=True)
        write(snap)
    gens = trace_gen.generate_many(names, n=N, seed=SEED)
    snap["trace_sha256"] = {
        w: sha(g["trace"]["vpn"], g["trace"]["is2m"], g["trace"]["line"])
        for w, g in zip(names, gens)}
    paper = load_paper()
    figures = {}
    for fn in paper.ALL:
        if fn.__name__ == "multicore_scaling":
            continue
        t0 = time.perf_counter()
        figures[fn.__name__] = [[r[0], r[2]] for r in fn()]
        print(f"[paper] {fn.__name__}: {time.perf_counter() - t0:.0f} s",
              flush=True)
    snap["figures"] = figures
    write(snap)
    print(f"[paper] wrote {OUT}")


if __name__ == "__main__":
    main(sys.argv[1:])
