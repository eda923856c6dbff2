"""Render the dry run's tables from its records: the port of
`repro/launch/report.py`, over `launch/dryrun.py`'s records (JAX's read
alike). The roofline table's "fits" column is the H100's 80 GB against
the bytes a rank holds (`peak_bytes_per_device`: its blocks of the
parameters, moments, caches and batch; activations not counted).

    PYTHONPATH=src python -m repro_torch.launch.report [--out experiments/torch_artifacts]

prints markdown tables for the dry run and the roofline.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.roofline import build_table, load_all

#: an H100's memory, GiB (80 GB)
CARD_GIB = 80e9 / 2**30


def _f(v, fmt="{:.3g}"):
    return fmt.format(v) if isinstance(v, (int, float)) else (v or "")


def dryrun_table(out_dir: str, mesh_tag: str) -> str:
    lines = ["| arch | shape | flops/dev | bytes/dev (floor) | held GiB/dev | "
             "collective bytes/dev | count s |",
             "|---|---|---|---|---|---|---|"]
    for rec in load_all(out_dir):
        if rec.get("mesh_tag") != mesh_tag:
            continue
        if rec.get("status") == "skipped":
            lines.append(f"| {rec['arch']} | {rec['shape']} | SKIP | | | | |")
            continue
        if rec.get("status") != "ok":
            lines.append(f"| {rec['arch']} | {rec['shape']} | ERROR | | | | |")
            continue
        coll = rec.get("corrected_collectives") or rec.get("collectives") or {}
        cb = sum(e["bytes"] for e in coll.values())
        lines.append(
            f"| {rec['arch']} | {rec['shape']} "
            f"| {_f(rec.get('corrected_flops') or rec.get('flops'), '{:.3e}')} "
            f"| {_f(rec.get('corrected_bytes') or rec.get('bytes_accessed'), '{:.3e}')} "
            f"| {_f((rec.get('peak_bytes_per_device') or 0) / 2**30, '{:.2f}')} "
            f"| {_f(cb, '{:.3e}')} | {_f(rec.get('lower_s'), '{:.1f}')} |")
    return "\n".join(lines)


def roofline_table(out_dir: str, mesh_tag: str) -> str:
    lines = ["| arch | shape | t_comp s | t_mem s | t_coll s | bottleneck | "
             "useful (6ND/counted) | MFU@roofline | fits 80G |",
             "|---|---|---|---|---|---|---|---|---|"]
    for row in build_table(out_dir):
        if row.get("mesh") != mesh_tag:
            continue
        if row["status"] == "skipped":
            lines.append(f"| {row['arch']} | {row['shape']} | SKIP | | | | | | |")
            continue
        if row["status"] != "ok":
            lines.append(f"| {row['arch']} | {row['shape']} | ERR | | | | | | |")
            continue
        fits = ("yes" if row.get("peak_gib", 1e9) <= CARD_GIB
                else f"NO ({row['peak_gib']:.0f}G)")
        lines.append(
            f"| {row['arch']} | {row['shape']} | {_f(row.get('t_compute_s'), '{:.2e}')} "
            f"| {_f(row.get('t_memory_s'), '{:.2e}')} | {_f(row.get('t_collective_s'), '{:.2e}')} "
            f"| {row.get('bottleneck', '')} | {_f(row.get('useful_ratio'), '{:.2f}')} "
            f"| {_f(row.get('mfu_at_roofline'), '{:.2f}')} | {fits} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/torch_artifacts")
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args(argv)
    print("## Dry-run (" + args.mesh + ")\n")
    print(dryrun_table(args.out, args.mesh))
    print("\n## Roofline (" + args.mesh + ")\n")
    print(roofline_table(args.out, args.mesh))


if __name__ == "__main__":
    main()
