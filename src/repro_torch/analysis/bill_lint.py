"""Verb-bill conservation lint over the port (port of
``repro.analysis.bill_lint``; analysis pass 2, DESIGN.md §11).

The paper's whole argument is a *bill* argument: CIDER wins because its
verb bill is smaller where it counts (MN NIC IOPS).  That argument breaks
silently the day someone adds an ``IOMetrics`` counter that the cost model
never prices or the docs never explain — the new verb "vanishes" from
``modeled_mops`` while still being claimed as metered.  This AST-based lint
makes that impossible:

* every ``IOMetrics`` field *written* in the port's ``core/engine.py`` /
  ``stores/*``
  (keyword or positional constructor argument) must be
* *documented* — a row in the §1 table of the repository's
  ``docs/METRICS.md``, which both packages share — and
* *consumed* by the cost model — read (directly or through the ``mn_iops``
  derived property) inside ``runner.modeled_throughput`` /
  ``runner.modeled_latency`` — **or** whitelisted in
  ``CONSUMED_WHITELIST`` with a stated reason (observable-only counters:
  rates, recovery diagnostics, client-NIC traffic that is free at the MN
  by design).

The whitelist is the honesty mechanism, not an escape hatch: each entry
says *why* the field is deliberately outside the priced bill, and the lint
fails if a whitelist entry goes stale (names a field that no longer
exists) so the list cannot rot.

Satellite enforcement: capability rejections in ``stores/*`` must raise
the shared typed ``UnsupportedOpError`` (``core/types.py``), never a bare
``NotImplementedError`` — callers distinguish "wrong index for this
workload" from an unimplemented code path.

All lint logic takes sources/markdown as *strings* (``lint_sources``), so
the tests inject violating fixtures without touching the real tree;
``run()`` binds the port's files (``src/repro_torch/core/{engine,runner,
types}.py``, ``src/repro_torch/stores/*``) and ``docs/METRICS.md``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from repro_torch.analysis import Violation
from repro_torch.core.types import IOMetrics

__all__ = ["CONSUMED_WHITELIST", "documented_fields", "written_fields",
           "consumed_fields", "derived_field_map", "bad_rejections",
           "lint_sources", "run"]

# IOMetrics fields that are deliberately NOT priced by modeled_throughput/
# modeled_latency.  Every entry needs a reason; the lint fails on a stale
# entry (field gone) and on any written field that is neither consumed nor
# listed here.  docs/METRICS.md §1 marks these as observable-only.
CONSUMED_WHITELIST: dict[str, str] = {
    "cn_msgs": "client<->client messages ride CN NICs, free at the MN by "
               "design (ShiftLock's point, §2.3); CN hops are priced in "
               "modeled_latency via the per-mode chain terms, not the bill",
    "retries": "waste diagnostic (paper Fig 1); every failed CAS is also "
               "folded into `cas`, so mn_iops already prices it",
    "combined": "WC-rate numerator (Fig 21) — a rate observable; the "
                "surviving writes are priced through `writes`",
    "executed": "post-combining write count (WC-rate denominator's "
                "complement); priced through `writes`",
    "repair_cas": "recovery-bill observable gated by BENCH_recovery; each "
                  "repair verb is also folded into `reads`/`cas`, so "
                  "mn_iops prices it",
    "orphan_windows": "time-to-repair observable (slot-windows, not "
                      "verbs); feeds `windows_to_repair`, no NIC cost",
}

_MD_ROW = re.compile(r"^\|\s*`(\w+)`\s*\|")


def iometrics_fields() -> set[str]:
    return {f.name for f in dataclasses.fields(IOMetrics)}


def documented_fields(metrics_md: str) -> set[str]:
    """Field rows of the §1 IOMetrics table in docs/METRICS.md."""
    section = metrics_md.split("## 1.", 1)
    body = section[1].split("\n## ", 1)[0] if len(section) > 1 else ""
    return {m.group(1) for line in body.splitlines()
            if (m := _MD_ROW.match(line.strip()))}


def _ctor_fields(call: ast.Call, field_order: list[str]) -> set[str]:
    out = {kw.arg for kw in call.keywords if kw.arg}
    for i, arg in enumerate(call.args):
        if i < len(field_order) and not isinstance(arg, ast.Starred):
            out.add(field_order[i])
    return out


def written_fields(source: str) -> set[str]:
    """Fields assigned by any ``IOMetrics(...)`` constructor call in
    ``source`` (keyword or positional), plus fields replaced via
    ``dataclasses.replace(<io>, field=...)`` on an IOMetrics value."""
    order = [f.name for f in dataclasses.fields(IOMetrics)]
    out: set[str] = set()
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        if name == "IOMetrics":
            out |= _ctor_fields(node, order)
    return out


def derived_field_map(types_source: str) -> dict[str, set[str]]:
    """Map each ``IOMetrics`` property (derived metric) to the concrete
    fields its body reads — e.g. ``mn_iops -> {reads, writes, cas, faa}`` —
    so consumption through a derived metric credits its inputs."""
    tree = ast.parse(types_source)
    fields = iometrics_fields()
    out: dict[str, set[str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) or node.name != "IOMetrics":
            continue
        for item in node.body:
            if not isinstance(item, ast.FunctionDef):
                continue
            is_prop = any(isinstance(d, ast.Name) and d.id == "property"
                          for d in item.decorator_list)
            if not is_prop:
                continue
            reads = {n.attr for n in ast.walk(item)
                     if isinstance(n, ast.Attribute) and n.attr in fields}
            out[item.name] = reads
    return out


def consumed_fields(runner_source: str, fn_names: tuple[str, ...] = (
        "modeled_throughput", "modeled_latency"),
        derived: dict[str, set[str]] | None = None) -> set[str]:
    """Fields the cost model reads: attribute accesses inside ``fn_names``
    on parameters *annotated* ``IOMetrics`` (so a same-named ``Results``
    field cannot masquerade as bill consumption); derived properties
    expand to the fields they read."""
    fields = iometrics_fields()
    derived = derived if derived is not None else {}
    names = fields | set(derived)
    tree = ast.parse(runner_source)
    direct: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.FunctionDef) and node.name in fn_names):
            continue
        io_params = {a.arg for a in (node.args.args + node.args.kwonlyargs)
                     if a.annotation is not None
                     and "IOMetrics" in ast.unparse(a.annotation)}
        for n in ast.walk(node):
            if (isinstance(n, ast.Attribute) and n.attr in names
                    and isinstance(n.value, ast.Name)
                    and n.value.id in io_params):
                direct.add(n.attr)
    out = set()
    for name in direct:
        out |= derived.get(name, {name} & fields)
        if name in fields:
            out.add(name)
    return out


def bad_rejections(source: str, path: str) -> list[tuple[str, int]]:
    """``raise NotImplementedError`` sites — capability rejections must use
    the shared typed ``UnsupportedOpError`` instead."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        name = ""
        if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
            name = exc.func.id
        elif isinstance(exc, ast.Name):
            name = exc.id
        if name == "NotImplementedError":
            out.append((path, exc.lineno))
    return out


def lint_sources(writer_sources: dict[str, str], metrics_md: str,
                 runner_source: str, types_source: str,
                 store_sources: dict[str, str] | None = None,
                 whitelist: dict[str, str] | None = None) -> list[Violation]:
    """The conservation lint over in-memory sources (fixture-injectable).

    ``writer_sources``: path -> source for every file allowed to construct
    ``IOMetrics``; ``store_sources``: the subset additionally subject to
    the UnsupportedOpError rule (defaults to paths containing ``stores/``).
    """
    wl = CONSUMED_WHITELIST if whitelist is None else whitelist
    fields = iometrics_fields()
    documented = documented_fields(metrics_md)
    derived = derived_field_map(types_source)
    consumed = consumed_fields(runner_source, derived=derived)
    out = []

    for name in sorted(set(wl) - fields):
        out.append(Violation(
            "bill_lint", "CONSUMED_WHITELIST",
            f"stale whitelist entry '{name}': no such IOMetrics field — "
            f"remove it so the list cannot rot"))

    for path, src in sorted(writer_sources.items()):
        written = written_fields(src)
        for name in sorted(written - fields):
            out.append(Violation(
                "bill_lint", path,
                f"IOMetrics(...) constructed with unknown field '{name}'"))
        written &= fields
        for name in sorted(written - documented):
            out.append(Violation(
                "bill_lint", path,
                f"IOMetrics field '{name}' is written here but has no row "
                f"in docs/METRICS.md §1 — every metered verb counter must "
                f"be documented"))
        for name in sorted(written - consumed - set(wl)):
            out.append(Violation(
                "bill_lint", path,
                f"IOMetrics field '{name}' is written here but never "
                f"consumed by modeled_throughput/modeled_latency and not "
                f"whitelisted — the verb would vanish from the cost model"))

    if store_sources is None:
        store_sources = {p: s for p, s in writer_sources.items()
                        if "stores/" in p.replace("\\", "/")}
    for path, src in sorted(store_sources.items()):
        for where, line in bad_rejections(src, path):
            out.append(Violation(
                "bill_lint", f"{where}:{line}",
                "capability rejection raises bare NotImplementedError — "
                "stores must raise the shared typed UnsupportedOpError "
                "(core/types.py)"))
    return out


def run(notes: list[str] | None = None,
        repo_root: Path | None = None) -> list[Violation]:
    """The lint over the port's tree: engine + every store vs docs +
    runner."""
    root = repo_root or Path(__file__).resolve().parents[3]
    src = root / "src" / "repro_torch"
    writers = {"src/repro_torch/core/engine.py":
               (src / "core" / "engine.py").read_text()}
    stores = {}
    for p in sorted((src / "stores").glob("*.py")):
        rel = f"src/repro_torch/stores/{p.name}"
        stores[rel] = p.read_text()
        writers[rel] = stores[rel]
    out = lint_sources(
        writers,
        metrics_md=(root / "docs" / "METRICS.md").read_text(),
        runner_source=(src / "core" / "runner.py").read_text(),
        types_source=(src / "core" / "types.py").read_text(),
        store_sources=stores)
    if notes is not None:
        notes.append(f"bill_lint: {len(writers)} writer files, "
                     f"{len(iometrics_fields())} IOMetrics fields, "
                     f"{len(CONSUMED_WHITELIST)} whitelisted")
    return out
