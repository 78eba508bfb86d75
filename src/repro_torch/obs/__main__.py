"""CLI for exported traces: ``python -m repro_torch.obs validate|summarize``.

    python -m repro_torch.obs validate out.json    # schema check, exit = #errors
    python -m repro_torch.obs summarize out.json   # lane/span/category counts
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.export import validate_chrome_trace


def _load(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _summarize(payload: dict) -> str:
    evs = payload.get("traceEvents", [])
    by_ph: dict[str, int] = {}
    by_cat: dict[str, int] = {}
    names: dict[str, int] = {}
    t_min = t_max = None
    for e in evs:
        ph = str(e.get("ph", "?"))
        by_ph[ph] = by_ph.get(ph, 0) + 1
        if ph == "M":
            if e.get("name") == "process_name":
                names[e["args"]["name"]] = 0
            continue
        by_cat[str(e.get("cat", "?"))] = by_cat.get(str(e.get("cat", "?")), 0) + 1
        ts = float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0))
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = end if t_max is None else max(t_max, end)
    lines = [
        f"events: {len(evs)}",
        "by phase: " + ", ".join(f"{k}={v}" for k, v in sorted(by_ph.items())),
        "by category: " + ", ".join(f"{k}={v}" for k, v in sorted(by_cat.items())),
        f"processes: {', '.join(sorted(names)) or '(none)'}",
    ]
    if t_min is not None:
        lines.append(f"span: [{t_min:.1f}, {t_max:.1f}] us "
                     f"({(t_max - t_min) / 1e3:.3f} ms)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect Chrome-trace JSON exported by repro_torch.obs "
                    "(--trace PATH on the launchers and benchmarks).",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="schema-check a trace file")
    v.add_argument("path")
    s = sub.add_parser("summarize", help="print lane/event statistics")
    s.add_argument("path")
    args = ap.parse_args(argv)

    payload = _load(args.path)
    if args.cmd == "validate":
        errors = validate_chrome_trace(payload)
        for e in errors:
            print(e, file=sys.stderr)
        print(f"{args.path}: {'OK' if not errors else f'{len(errors)} problems'}")
        return min(len(errors), 255)
    print(_summarize(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
