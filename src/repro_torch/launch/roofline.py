"""Roofline analysis over the dry-run records, on NVIDIA H100 constants.

The port of `repro/launch/roofline.py`: the same terms, read from either
package's records (`launch/dryrun.py`'s, or JAX's), per device:

    t_compute = flops_dev / PEAK_FLOPS
    t_memory  = bytes_dev / HBM_BW
    t_coll    = sum_k  wire_bytes_k(dev) / LINK_BW

H100 SXM5 (datasheet, one card): PEAK_FLOPS = 989e12 (BF16 dense tensor
cores), HBM_BW = 3.35e12 (HBM3), LINK_BW = 450e9 a direction (NVLink 4,
900 GB/s both ways). A 16-wide mesh axis spans two 8-GPU nodes, whose
link between them (InfiniBand) is slower than NVLink, so the collective
term is a floor. Every term is computed from these datasheet constants,
not measured.

Collective wire-byte models (ring algorithms; R the bytes the record
holds, per device):
    all-gather:        R * (n-1)/n   (R = gathered result)
    reduce-scatter:    R * (n-1)     (R = scattered result; input n*R)
    all-reduce:        2R * (n-1)/n
    all-to-all:        R * (n-1)/n
    collective-permute R
    broadcast:         R             (any other kind, as JAX's default)

MODEL_FLOPS = 6 * N_active * tokens (train), 2 * N_active * tokens
(prefill), 2 * N_active * batch (one decode token): the useful-work
yardstick; MODEL_FLOPS / counted FLOPs exposes remat and attention.

    PYTHONPATH=src python -m repro_torch.launch.roofline --out experiments/torch_artifacts
"""
from __future__ import annotations

import argparse
import glob
import json
import os

PEAK_FLOPS = 989e12        # bf16 dense / H100 SXM5
HBM_BW = 3.35e12           # B/s / H100 SXM5 (HBM3)
LINK_BW = 450e9            # B/s a direction / NVLink 4
#: the dense peak by working type (the same datasheet): FP32 outside the
#: tensor cores, TF32 and BF16 on them, FP64 on the FP64 tensor cores
PEAK_FLOPS_BY_TYPE = {"f32": 67e12, "tf32": 495e12, "bf16": PEAK_FLOPS, "f64": 67e12}

_WIRE_FACTOR = {
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1),
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def model_flops(arch_meta, shape: dict, kind: str) -> float:
    """6*N_active*D for train, 2*N_active*D for single forward (prefill),
    2*N_active*B for one decode token (D = tokens processed)."""
    n_act = arch_meta.active_params_b * 1e9
    if kind == "train":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 6 * n_act * tokens
    if kind == "prefill":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 2 * n_act * tokens
    return 2 * n_act * shape["global_batch"]


def roofline_terms(rec: dict, *, mesh_axis_for_coll: str = "model") -> dict:
    """The per-device compute, memory and collective terms of a record, its
    bottleneck and roofline step (the largest term)."""
    chips = rec["chips"]
    flops_dev = rec.get("corrected_flops") or rec.get("flops")
    bytes_dev = rec.get("corrected_bytes") or rec.get("bytes_accessed")
    colls = rec.get("corrected_collectives") or rec.get("collectives") or {}
    # collective ring size: LM cells collect along the model axis (16); the
    # sven cells' collectives span the flat mesh (all chips)
    if rec.get("kind") == "sven":
        n_ring = chips
    else:
        n_ring = rec.get("mesh", {}).get(mesh_axis_for_coll, 16)
    t_comp = flops_dev / PEAK_FLOPS if flops_dev else None
    t_mem = bytes_dev / HBM_BW if bytes_dev else None
    t_coll = 0.0
    coll_bytes = 0
    for kind, e in colls.items():
        f = _WIRE_FACTOR.get(kind, lambda n: 1.0)(n_ring)
        t_coll += e["bytes"] * f / LINK_BW
        coll_bytes += e["bytes"]
    out = {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "collective_bytes_dev": coll_bytes,
    }
    terms = {k: v for k, v in out.items() if k.startswith("t_") and v}
    if terms:
        dom = max(terms, key=lambda k: terms[k])
        out["bottleneck"] = dom.replace("t_", "").replace("_s", "")
        t_bound = max(terms.values())
        out["roofline_step_s"] = t_bound
        if t_comp:
            out["compute_fraction"] = t_comp / t_bound
    return out


def load_all(out_dir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def build_table(out_dir: str) -> list[dict]:
    from repro_torch.configs import SHAPES, get_meta

    rows = []
    for rec in load_all(out_dir):
        if rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh_tag"), "status": "skipped",
                         "note": rec.get("reason", "")})
            continue
        if rec.get("status") != "ok":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh_tag"), "status": "error",
                         "note": rec.get("error", "")[:200]})
            continue
        row = {"arch": rec["arch"], "shape": rec["shape"],
               "mesh": rec.get("mesh_tag"), "status": "ok",
               "chips": rec["chips"],
               "peak_gib": (rec.get("peak_bytes_per_device") or 0) / 2**30}
        row.update(roofline_terms(rec))
        if rec["shape"] in SHAPES and rec.get("kind") != "sven":
            mf = model_flops(get_meta(rec["arch"]), SHAPES[rec["shape"]], rec["kind"])
            mf_dev = mf / rec["chips"]
            row["model_flops_dev"] = mf_dev
            counted = rec.get("corrected_flops") or rec.get("flops")
            if counted:
                row["useful_ratio"] = mf_dev / counted
                row["mfu_at_roofline"] = (mf_dev / PEAK_FLOPS) / row["roofline_step_s"]
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/torch_artifacts")
    ap.add_argument("--csv", default="")
    args = ap.parse_args(argv)
    rows = build_table(args.out)
    cols = ["arch", "shape", "mesh", "status", "t_compute_s", "t_memory_s",
            "t_collective_s", "bottleneck", "compute_fraction", "useful_ratio",
            "mfu_at_roofline", "peak_gib"]
    print(",".join(cols))
    for r in rows:
        print(",".join(_fmt(r.get(c)) for c in cols))
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(",".join(cols) + "\n")
            for r in rows:
                f.write(",".join(_fmt(r.get(c)) for c in cols) + "\n")


def _fmt(v):
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


if __name__ == "__main__":
    main()
