"""Render the roofline and collective tables from a ledger JSON
(counterpart of ``repro.launch.report``, which imports no JAX: its
functions are copied here).

  PYTHONPATH=src python -m repro_torch.launch.report build/ledger.json

It renders the port's records (``launch.ledger``: the fit as a bound read
from the record, ``fit_bound_gb``; the count's seconds, ``count_s``;
collectives by the port's kinds) and the reference's (``fits_16gb``,
``compile_s``, the HLO's kinds) alike: on a ledger in the reference's
format its tables are the reference's, character for character.
"""
from __future__ import annotations

import json
import sys

#: the reference's collective columns, then the port's
_REF_KINDS = (("AG", "all-gather"), ("AR", "all-reduce"),
              ("RS", "reduce-scatter"), ("A2A", "all-to-all"),
              ("CP", "collective-permute"))
_PORT_KINDS = (("AG", "all-gather"), ("AR", "all-reduce"),
               ("RS", "reduce-scatter"), ("BC", "broadcast"),
               ("G", "gather"))


def fmt_b(x):
    if x >= 1e12:
        return f"{x/1e12:.2f}T"
    if x >= 1e9:
        return f"{x/1e9:.2f}G"
    if x >= 1e6:
        return f"{x/1e6:.2f}M"
    return f"{x:.0f}"


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def _bound_gb(r) -> float:
    """The fit bound of a roofline record: ``fit_bound_gb``, or 16 for the
    reference's ``fits_16gb``."""
    return 16.0 if "fits_16gb" in r else float(r["fit_bound_gb"])


def _fits(r) -> bool:
    if "fits_16gb" in r:
        return bool(r["fits_16gb"])
    return r["peak_hbm_gb"] <= r["fit_bound_gb"]


def roofline_table(ledger) -> str:
    bounds = {_bound_gb(rec["roofline"]) for rec in ledger.values()
              if rec.get("status") == "ok"}
    head = (f"fits {bounds.pop():g}GB" if len(bounds) == 1 else "fits")
    rows = ["| arch | shape | kind | compute | memory | collective | "
            f"dominant | useful | HBM/dev | {head} |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(ledger):
        rec = ledger[key]
        arch, shape = key.split("|")
        if rec.get("status") == "skipped":
            rows.append(f"| {arch} | {shape} | — | — | — | — | — | — | — | "
                        f"skip: {rec['reason'].split(':')[-1].strip()} |")
            continue
        if rec.get("status") != "ok":
            rows.append(f"| {arch} | {shape} | — | ERROR | | | | | | |")
            continue
        r = rec["roofline"]
        dom = r["dominant"].replace("_s", "")
        fits = "yes" if _fits(r) else "no"
        if head == "fits":
            fits += f" ({_bound_gb(r):g}GB)"
        rows.append(
            f"| {arch} | {shape} | {rec['production']['kind']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{dom}** | "
            f"{r['useful_ratio']:.2f} | {r['peak_hbm_gb']:.1f}GB | "
            f"{fits} |")
    return "\n".join(rows)


def dryrun_table(ledger) -> str:
    ok = [k for k in sorted(ledger) if ledger[k].get("status") == "ok"]
    if any("compile_s" in ledger[k]["production"] for k in ok):
        return _reference_dryrun_table(ledger, ok)
    rows = ["| arch | shape | count | coll ops | "
            + " | ".join(h for h, _ in _PORT_KINDS) + " |",
            "|---|---|---|---|" + "---|" * len(_PORT_KINDS)]
    for key in ok:
        rec = ledger[key]
        arch, shape = key.split("|")
        p = rec["production"]
        c = p.get("collectives", {})
        rows.append(f"| {arch} | {shape} | {p['count_s']}s | "
                    f"{p['per_device']['collective_ops']} | "
                    + " | ".join(fmt_b(c.get(k, 0)) for _, k in _PORT_KINDS)
                    + " |")
    return "\n".join(rows)


def _reference_dryrun_table(ledger, ok) -> str:
    rows = ["| arch | shape | pod compile | multipod compile | coll ops | "
            "AG | AR | RS | A2A | CP |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for key in ok:
        rec = ledger[key]
        arch, shape = key.split("|")
        p = rec["production"]
        c = rec.get("production", {}).get("collectives", {})
        mp = rec.get("multipod", {})
        mp_s = (f"{mp.get('compile_s', '—')}s"
                if "compile_s" in mp else "ERR")
        rows.append(
            f"| {arch} | {shape} | {p['compile_s']}s | {mp_s} | "
            f"{p['per_device']['collective_ops']} | "
            + " | ".join(fmt_b(c.get(k, 0)) for _, k in _REF_KINDS) + " |")
    return "\n".join(rows)


def perf_table(perf) -> str:
    rows = ["| variant | compute | memory | collective | dominant | "
            "HBM/dev | useful |",
            "|---|---|---|---|---|---|---|"]
    for rec in perf:
        if rec.get("status") != "ok":
            rows.append(f"| {rec['label']} | ERROR: "
                        f"{rec.get('error', '')[:60]} | | | | | |")
            continue
        r = rec["roofline"]
        rows.append(
            f"| {rec['label']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{rec['peak_hbm_gb']:.1f}GB | {rec['useful_ratio']:.2f} |")
    return "\n".join(rows)


def render(data) -> str:
    """The report of a ledger (a dict keyed ``arch|shape``) or of a perf
    record list, as ``main`` prints it."""
    if isinstance(data, list):
        return perf_table(data)
    return ("## Roofline\n\n" + roofline_table(data)
            + "\n\n## Dry-run collectives\n\n" + dryrun_table(data))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "build/ledger.json"
    with open(path) as f:
        print(render(json.load(f)))


if __name__ == "__main__":
    main()
