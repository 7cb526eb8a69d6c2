"""Ladder-equivalence pass: every ladder family runs as ONE kernel
instantiation; the port's counterpart of ``repro.analysis.jaxpr_equiv``
(JX001-JX003), whose place it takes.

The reference proves a family one-compile by tracing every member's step
to a jaxpr and comparing them.  The port has no jaxpr: a ladder fill runs
the ``mmu_step`` kernel's ladder instantiation for the family's base
composition, and each member is a lane that reads its geometry and stage
gates from its row of per-lane parameters (``mmu_step.DYN_PARAMS``, built
from ``stages.base.Dyn``).  So a family is one instantiation when, for
every member:

- LE001 (JX001) the member maps to the family's composition:
  ``mmu_step.composition(base, stages, dyn=True)``, an entry of
  ``mmu_step.LADDER_COMPOSITIONS``, where ``base`` is the family's base
  config (``systems.dyn_base_config`` of the members' configs, what
  ``systems.ladder_base_config(members=...)`` returns once its checks
  pass) and the member's own composition is that of its config with the
  ``DYN_FIELDS`` set to the base's;
- LE002 (JX002) the member differs from the base config only in
  ``DYN_FIELDS``;
- LE003 (JX003) each ``DYN_FIELDS`` value in which the member differs
  from the base reaches the kernel: the member's row of ``DYN_PARAMS``
  changes when that field is set back to the base's value, and the row
  lies inside the base's allocation (``mmu_step._dyn_rows`` takes it).
  ``DYN_PARAMS`` names ``Dyn``'s fields.

A finding names the family, the member and the field or composition that
differs.  Nothing is traced or executed: the pass reads the registry and
the kernel's tables, and is one of the CLI's default (static) passes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class FamilyReport:
    family: str
    members: list
    n_members: int = 0
    composition: str | None = None
    equivalent: bool = False
    findings: list = field(default_factory=list)


def _row(cfg, base):
    """The member's row of DYN_PARAMS against the base's allocation."""
    import torch

    from repro_torch.core.stages import dyn_of
    from repro_torch.kernels import mmu_step

    return mmu_step._dyn_rows(dyn_of(cfg), base, 1, torch.device("cpu"))


def check_family(fam_name: str, members, config=None) -> FamilyReport:
    """Prove (or refute, naming the member and what differs) that one
    discovered ladder family runs as one kernel instantiation.
    ``config`` maps a member's name to its SimConfig (default
    ``systems.config``)."""
    from repro_torch.core.stages import DYN_FIELDS, SimConfig, default_stages
    from repro_torch.kernels import mmu_step
    from repro_torch.sim import systems

    config = config or systems.config
    members = list(members)
    rep = FamilyReport(family=fam_name, members=members,
                       n_members=len(members))
    cfgs = {m: config(m) for m in members}
    base = systems.dyn_base_config(list(cfgs.values()))
    try:
        comp = mmu_step.composition(base, default_stages(base), dyn=True)[0]
    except ValueError as e:
        rep.findings.append(f"LE001 family '{fam_name}': its base "
                            f"composition has no ladder instantiation: {e}")
        return rep
    rep.composition = comp
    dyn_fields = set(DYN_FIELDS)
    for m, cfg in cfgs.items():
        pinned = dataclasses.replace(
            cfg, **{f: getattr(base, f) for f in DYN_FIELDS})
        try:
            got = mmu_step.composition(pinned, default_stages(pinned),
                                       dyn=True)[0]
        except ValueError as e:
            got = f"none ({e})"
        if got != comp:
            rep.findings.append(
                f"LE001 family '{fam_name}': member '{m}' maps to "
                f"composition {got}, the family's is {comp}")
        for f in dataclasses.fields(SimConfig):
            if f.name not in dyn_fields and \
                    getattr(cfg, f.name) != getattr(base, f.name):
                rep.findings.append(
                    f"LE002 family '{fam_name}': member '{m}' differs from "
                    f"the base config in {f.name} ({getattr(cfg, f.name)!r}"
                    f" vs {getattr(base, f.name)!r}), which is not one of "
                    f"DYN_FIELDS")
        try:
            row = _row(cfg, base)
        except ValueError as e:
            rep.findings.append(
                f"LE003 family '{fam_name}': member '{m}''s row of "
                f"DYN_PARAMS does not fit the base config: {e}")
            continue
        for f in DYN_FIELDS:
            if getattr(cfg, f) == getattr(base, f):
                continue
            back = dataclasses.replace(cfg, **{f: getattr(base, f)})
            try:
                same = bool((_row(back, base) == row).all())
            except ValueError:
                same = False
            if same:
                rep.findings.append(
                    f"LE003 family '{fam_name}': member '{m}' differs from "
                    f"the base config in {f} ({getattr(cfg, f)!r} vs "
                    f"{getattr(base, f)!r}), but its row of DYN_PARAMS "
                    f"does not: the kernel would run it at the base's "
                    f"value")
    rep.equivalent = not rep.findings
    return rep


def check_tables() -> list:
    """DYN_PARAMS, the kernel's per-lane parameters, are Dyn's fields."""
    from repro_torch.core.stages import Dyn
    from repro_torch.kernels import mmu_step

    if sorted(mmu_step.DYN_PARAMS) != sorted(Dyn._fields):
        return [f"LE003 mmu_step.DYN_PARAMS {mmu_step.DYN_PARAMS} are not "
                f"the fields of Dyn {Dyn._fields}"]
    return []


def check_all(progress=None):
    """Run the pass over every discovered family.  Returns ``(reports,
    findings)``; findings is empty when every family is one
    instantiation."""
    from repro_torch.sim import systems

    reports, findings = [], check_tables()
    for fam, members in sorted(systems.discover_ladders().items()):
        if progress:
            progress(f"  family {fam}: {len(members)} members")
        rep = check_family(fam, members)
        reports.append(rep)
        findings.extend(rep.findings)
    return reports, findings
