"""Perf hill-climb runner, the port of `repro/launch/hillclimb.py`: counts
a named VARIANT of a dry-run cell (config fields, sharding-rule and
microbatch overrides) on the production mesh with no process group
(`dryrun.spec_mesh`), computes its roofline terms on H100 constants, and
writes the hypothesis -> result record to
experiments/torch_perf/<arch>__<shape>__<variant>.json.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell deepseek_7b:train_4k \\
        --variant dense_attn --set attn_dense_max=4096
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.launch.dryrun import lower_cell, spec_mesh
from repro_torch.launch.roofline import roofline_terms


def run_variant(arch: str, shape: str, name: str, overrides: dict, out_dir: str,
                multi_pod: bool = False) -> dict:
    """Count `arch` x `shape` under `overrides` ({"cfg", "rules",
    "microbatches"}), add its roofline terms, write and return the
    record."""
    t0 = time.perf_counter()
    rec = lower_cell(arch, shape, spec_mesh(multi_pod), opt_overrides=overrides)
    rec["variant"] = name
    rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    rec["status"] = "ok"
    rec["wall_s"] = round(time.perf_counter() - t0, 1)
    rec.update(roofline_terms(rec))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summarize(rec: dict) -> str:
    return (f"t_comp={rec.get('t_compute_s') or 0:.3g}s "
            f"t_mem={rec.get('t_memory_s') or 0:.3g}s "
            f"t_coll={rec.get('t_collective_s') or 0:.3g}s "
            f"bottleneck={rec.get('bottleneck')} "
            f"held={rec.get('peak_bytes_per_device', 0) / 2**30:.1f}GiB")


def _parse_set(pairs: list) -> dict:
    cfg_over = {}
    for pair in pairs:
        k, v = pair.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        cfg_over[k] = v
    return cfg_over


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--set", nargs="*", default=[], help="cfg field overrides k=v")
    ap.add_argument("--rule", nargs="*", default=[], help="sharding rule overrides k=v|none")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--out", default="experiments/torch_perf")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    overrides: dict = {"cfg": _parse_set(args.set)}
    if args.rule:
        overrides["rules"] = {k: (None if v == "none" else v)
                              for k, v in (r.split("=", 1) for r in args.rule)}
    if args.microbatches:
        overrides["microbatches"] = args.microbatches
    rec = run_variant(arch, shape, args.variant, overrides, args.out)
    print(f"[hillclimb] {args.cell} variant={args.variant}: {summarize(rec)}")


if __name__ == "__main__":
    main()
