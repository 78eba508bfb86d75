"""planlint command line.

::

    python -m repro_torch.analysis --all                 # every seeded scenario
    python -m repro_torch.analysis --scenario fig3b      # one scenario
    python -m repro_torch.analysis --table plan.npz      # a saved routing table
    python -m repro_torch.analysis --list-rules          # the rule catalog

Exit status is nonzero iff any **error**-severity finding fired —
warnings and infos print but pass, so CI can gate on hard invariants
while padding-waste trends stay visible.  ``--stats`` additionally
prints the informational metrics (round counts, padding waste) that
``benchmarks/run.py`` re-emits into its JSON.

Routing tables round-trip through ``.npz`` via :func:`save_table_npz` /
:func:`load_table_npz` so out-of-process planners (the paper-scale
per-pod-shard pipeline, ROADMAP) can hand their plans to the linter.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["main", "save_table_npz", "load_table_npz", "plan_stats"]


def save_table_npz(tb, path: str) -> None:
    """Serialize a :class:`~repro_torch.core.routing.RoutingTable` (with its
    sparse device traffic) to ``path``."""
    tm = tb.device_traffic
    if not hasattr(tm, "rows"):
        raise ValueError("only sparse-traffic tables serialize to npz")
    payload = {
        "group_of": tb.group_of,
        "n_groups": np.int64(tb.n_groups),
        "bridge": tb.bridge,
        "method": np.str_(tb.method),
        "tm_indptr": tm.indptr,
        "tm_indices": tm.indices,
        "tm_data": tm.data,
    }
    if tb.share_coo is not None:
        dev, grp, frac = tb.share_coo
        payload.update(share_dev=dev, share_grp=grp, share_frac=frac)
    np.savez_compressed(path, **payload)


def load_table_npz(path: str):
    """Inverse of :func:`save_table_npz`."""
    from repro_torch.core.routing import RoutingTable
    from repro_torch.core.traffic import TrafficMatrix

    z = np.load(path, allow_pickle=False)
    tm = TrafficMatrix(
        indptr=z["tm_indptr"], indices=z["tm_indices"], data=z["tm_data"]
    )
    share = None
    if "share_dev" in z:
        share = (z["share_dev"], z["share_grp"], z["share_frac"])
    return RoutingTable(
        group_of=z["group_of"],
        n_groups=int(z["n_groups"]),
        bridge=z["bridge"],
        device_traffic=tm,
        method=str(z["method"]),
        share_coo=share,
    )


def plan_stats(ctx) -> dict[str, float]:
    """Informational planlint metrics for one context — the ungated
    numbers ``benchmarks/run.py`` emits (round counts, padding waste)."""
    out: dict[str, float] = {}
    if ctx.schedule is not None:
        live = [pairs for pairs in ctx.schedule if pairs]
        out["rounds_scheduled"] = len(live)
        out["pairs_scheduled"] = sum(len(p) for p in live)
    plan = ctx.ragged_plan
    if plan is not None:
        out["ragged_rounds_live"] = sum(1 for r in plan.rounds if r.pairs)
        out["ragged_bytes_per_step"] = plan.bytes_per_step
        if plan.bytes_per_step:
            out["ragged_padding_waste"] = round(
                1.0 - plan.packed_bytes_per_step / plan.bytes_per_step, 4
            )
    return out


def _lint_contexts(contexts, *, stats: bool) -> int:
    from repro_torch.analysis.rules import run_lints

    n_err = n_warn = 0
    for ctx in contexts:
        findings = run_lints(ctx)
        for f in findings:
            print(f)
        n_err += sum(1 for f in findings if f.severity == "error")
        n_warn += sum(1 for f in findings if f.severity == "warning")
        if stats:
            for k, v in plan_stats(ctx).items():
                print(f"# {ctx.name or 'context'}: {k} = {v}")
        if not findings:
            print(f"ok [{ctx.name or 'context'}]")
    if n_err or n_warn:
        print(f"{n_err} error(s), {n_warn} warning(s)")
    return 1 if n_err else 0


def _print_catalog() -> None:
    from repro_torch.analysis.rules import catalog

    for r in catalog():
        layer = "traced" if r.check is None else "artifact"
        print(f"{r.id}  {r.severity:<7}  [{layer}]  {r.summary}")


def rules_markdown() -> str:
    """The ``docs/RULES.md`` content, generated from the rule registry.

    Deterministic (catalog order) so CI can diff the committed file
    against ``python -m repro_torch.analysis --rules-md`` and fail on drift —
    the registry is the single source of truth, the markdown is a view.
    """
    from repro_torch.analysis.rules import catalog

    # the header keeps the reference's module names: the catalog is the
    # reference's rule for rule, so the output equals docs/RULES.md
    lines = [
        "# planlint rule catalog",
        "",
        "<!-- GENERATED — do not edit.  Regenerate with:",
        "     PYTHONPATH=src python -m repro.analysis --rules-md > docs/RULES.md -->",
        "",
        "Generated from the rule registry (`repro.analysis.rules.RULES`).",
        "`artifact` rules lint a `PlanContext` (run them with"
        " `python -m repro.analysis --all`); `traced` rules run against a"
        " live engine through `repro.analysis.traced`.  Error-severity"
        " findings fail CI; warnings and infos print but pass.",
        "",
        "| id | severity | layer | what it checks |",
        "|----|----------|-------|----------------|",
    ]
    rules = catalog()
    for r in rules:
        layer = "traced" if r.check is None else "artifact"
        lines.append(f"| {r.id} | {r.severity} | {layer} | {r.summary} |")
    lines += ["", "## Fix hints", ""]
    for r in rules:
        lines.append(f"- **{r.id}** — {r.fix_hint}")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="planlint — static verifier for plans, schedules, "
        "and compiled SPMD steps",
    )
    gx = ap.add_mutually_exclusive_group()
    gx.add_argument(
        "--scenario",
        action="append",
        metavar="NAME",
        help="lint one seeded benchmark scenario (repeatable)",
    )
    gx.add_argument(
        "--all", action="store_true", help="lint every seeded scenario"
    )
    gx.add_argument(
        "--table", metavar="NPZ", help="lint a routing table saved as .npz"
    )
    gx.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    gx.add_argument(
        "--rules-md",
        action="store_true",
        help="print the rule catalog as markdown (the docs/RULES.md source)",
    )
    ap.add_argument(
        "--stats",
        action="store_true",
        help="also print informational plan metrics",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        _print_catalog()
        return 0

    if args.rules_md:
        print(rules_markdown(), end="")
        return 0

    if args.table:
        from repro_torch.analysis.context import PlanContext

        tb = load_table_npz(args.table)
        ctx = PlanContext.from_table(tb, name=args.table)
        return _lint_contexts([ctx], stats=args.stats)

    from repro_torch.analysis.scenarios import build_scenario, scenario_names

    names = scenario_names() if (args.all or not args.scenario) else args.scenario
    rc = 0
    for name in names:
        rc |= _lint_contexts(build_scenario(name), stats=args.stats)
    return rc


if __name__ == "__main__":
    sys.exit(main())
