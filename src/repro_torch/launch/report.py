"""Aggregate the port's dry-run records into tables (the port of
`repro.launch.report`).

    PYTHONPATH=src python -m repro_torch.launch.report [--tag baseline]

prints markdown; `--write` refreshes the section between the
AUTO-GENERATED markers of EXPERIMENTS.md (appending it where the markers
are missing). The records are `launch.dryrun`'s, under
experiments/dryrun_torch/: fake traces, not measurements.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
DRYRUN = ROOT / "experiments" / "dryrun_torch"
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _gb(x) -> str:
    return f"{(x or 0) / 1e9:.2f}"


def load(tag: str = "baseline", directory: Path = DRYRUN):
    recs = []
    for f in sorted(Path(directory).glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("tag", "baseline") != tag:
            continue
        r["_file"] = f.name
        recs.append(r)
    return recs


def dryrun_table(recs) -> str:
    out = ["| arch | shape | mesh | trace s | resident GB/dev | fits 80G | "
           "collectives (full program) |",
           "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | "
                       f"SKIP: {r['reason']} |")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh', '?')} "
                       f"| - | - | - | ERROR {r['error'][:60]} |")
            continue
        m = r["memory"]
        cc = r.get("census_full", {})
        coll = ",".join(f"{k}:{v}" for k, v in sorted(cc.items())
                        if k in COLLECTIVE_KINDS)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['trace_s']} "
            f"| {_gb(m['resident_bytes_per_dev'])} "
            f"| {'Y' if m['fits_80g'] else 'N'} | {coll} |")
    return "\n".join(out)


def _streaming(r):
    """The record's streaming memory term (None without the core pair).
    Every record of the port's dry run that has a roofline has it, so the
    reference's backfill for older records has nothing to do here."""
    return r.get("roofline_streaming")


def roofline_table(recs) -> str:
    out = ["| arch | shape | compute s | memory s raw→kernel-adj→streaming | "
           "collective s | bound* | step* s | MFU* | useful-FLOPs |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("skipped") or "roofline" not in r:
            continue
        if r.get("multi_pod"):
            continue
        a = r["roofline"]
        k = r.get("roofline_kernel_adjusted", a)
        s = _streaming(r) or k
        out.append(
            f"| {r['arch']} | {r['shape']} | {k['compute_s']:.3f} "
            f"| {a['memory_s']:.2f}→{k['memory_s']:.3f}→{s['memory_s']:.3f} "
            f"| {k['collective_s']:.3f} | {s['bound']} "
            f"| {s['step_time_s']:.3f} | {s['mfu']:.3f} "
            f"| {k['useful_flops_ratio']:.2f} |")
    out.append("")
    out.append("(*) bound/step/MFU at the streaming memory estimate; the raw "
               "and kernel-adjusted columns bracket it (core/roofline.py). "
               "A fake trace on one H100 SXM's data-sheet rates, not a "
               "measurement.")
    return "\n".join(out)


def summary(recs) -> str:
    cells = [r for r in recs if not r.get("skipped") and "error" not in r]
    skips = [r for r in recs if r.get("skipped")]
    errs = [r for r in recs if "error" in r]
    sp = [r for r in cells if not r.get("multi_pod")]
    mp = [r for r in cells if r.get("multi_pod")]
    fits = sum(1 for r in cells if r.get("memory", {}).get("fits_80g"))
    return (f"cells traced: {len(cells)} (single-pod {len(sp)}, "
            f"multi-pod {len(mp)}), skipped-by-rule: {len(skips)}, "
            f"errors: {len(errs)}; fit in 80 GB/dev: {fits}/{len(cells)}")


def render(recs, tag: str) -> str:
    return (f"### Summary ({tag})\n\n{summary(recs)}\n\n"
            f"### Dry-run table\n\n{dryrun_table(recs)}\n\n"
            f"### Roofline table (single-pod 16x16, kernel-adjusted)\n\n"
            f"{roofline_table(recs)}\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    md = render(load(args.tag), args.tag)
    if args.write:
        path = ROOT / "EXPERIMENTS.md"
        text = path.read_text() if path.exists() else ""
        start, end = "<!-- AUTO-DRYRUN-START -->", "<!-- AUTO-DRYRUN-END -->"
        if start in text:
            pre = text.split(start)[0]
            post = text.split(end)[1]
            path.write_text(pre + start + "\n" + md + "\n" + end + post)
        else:
            path.write_text(text + "\n" + start + "\n" + md + "\n" + end + "\n")
        print(f"wrote {path}")
    else:
        print(md)


if __name__ == "__main__":
    main()
