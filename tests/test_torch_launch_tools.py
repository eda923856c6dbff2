"""The port's launch tools (`repro_torch/launch/{dryrun,roofline,report,
hillclimb}.py`) on the CPU: the roofline's arithmetic against JAX's on the
same records (JAX's three constants set to the port's), the report's
tables, a hill-climb variant's record, the counting mode of a mesh that no
process group backs against executed steps on 2 and 4 gloo ranks, the
counted FLOPs of a train step against a count by hand, and the dry run's
CLI on internlm2-1.8b and the sven cells."""
import json

import pytest
import torch

import repro.launch.roofline as JR
from repro_torch import dist
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb as H
from repro_torch.launch import report as R
from repro_torch.launch import roofline as TR

#: the record of tests/test_roofline_tools.py::test_roofline_terms_math
JAX_RECORD = {
    "chips": 256,
    "mesh": {"data": 16, "model": 16},
    "kind": "train",
    "corrected_flops": 197e12,
    "corrected_bytes": 819e9,
    "corrected_collectives": {"all-reduce": {"count": 1, "bytes": 50e9}},
}


def _port_constants(monkeypatch):
    monkeypatch.setattr(JR, "PEAK_FLOPS", TR.PEAK_FLOPS)
    monkeypatch.setattr(JR, "HBM_BW", TR.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", TR.LINK_BW)


@pytest.mark.parametrize("kind", ["train", "sven"])
def test_roofline_terms_match_jax_on_port_constants(monkeypatch, kind):
    _port_constants(monkeypatch)
    rec = dict(JAX_RECORD, kind=kind)
    rec["corrected_collectives"] = {
        "all-reduce": {"count": 3, "bytes": 50e9},
        "all-gather": {"count": 2, "bytes": 7e9},
        "reduce-scatter": {"count": 1, "bytes": 1e9},
        "all-to-all": {"count": 1, "bytes": 3e9},
        "collective-permute": {"count": 1, "bytes": 2e9}}
    got, want = TR.roofline_terms(rec), JR.roofline_terms(rec)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-15), k
    assert TR.model_flops(D.get_meta("internlm2_1_8b"), {"global_batch": 8, "seq_len": 4},
                          "train") == JR.model_flops(D.get_meta("internlm2_1_8b"),
                                                     {"global_batch": 8, "seq_len": 4},
                                                     "train")


def test_roofline_h100_terms():
    t = TR.roofline_terms(dict(JAX_RECORD, corrected_flops=989e12, corrected_bytes=3.35e12,
                               corrected_collectives={"all-reduce": {"count": 1,
                                                                     "bytes": 450e9}}))
    assert t["t_compute_s"] == pytest.approx(1.0) and t["t_memory_s"] == pytest.approx(1.0)
    assert t["t_collective_s"] == pytest.approx(2 * 15 / 16)
    assert t["bottleneck"] == "collective"
    assert t["roofline_step_s"] == pytest.approx(2 * 15 / 16)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The dry run's CLI on internlm2-1.8b, every shape, both meshes, and
    the sven cells: its exit code, output and records."""
    out = tmp_path_factory.mktemp("dryrun")
    code = D.main(["--arch", "internlm2_1_8b", "--shape", "all", "--mesh", "both",
                   "--include-sven", "--out", str(out)])
    return code, out, {(r["arch"], r["shape"], r["mesh_tag"]): r
                       for r in TR.load_all(str(out))}


def test_dryrun_cli_counts_internlm2_and_the_sven_cells(records):
    code, _, recs = records
    assert code == 0
    for tag, chips in (("pod16x16", 256), ("pod2x16x16", 512)):
        assert recs[("internlm2_1_8b", "long_500k", tag)]["status"] == "skipped"
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            r = recs[("internlm2_1_8b", shape, tag)]
            assert r["status"] == "ok" and r["chips"] == chips
            assert r["flops"] > 0 and r["bytes_accessed"] > 0 and r["collectives"]
            assert r["corrected_flops"] == r["flops"]
        for cell in D.SVEN_CELLS:
            r = recs[(cell, "paper", tag)]
            assert r["status"] == "ok" and r["kind"] == "sven"
            assert r["collectives"]["all-reduce"]["count"] == 1
            assert r["flops"] == D.sven_floor(cell, chips)["flops"]
    gram = recs[("sven_gram_nggp", "paper", "pod16x16")]
    q = 8192 + 1
    assert gram["flops"] == (1 << 20) // 256 * q * (q + 1)
    # the plain product counts the full A^T A: twice the floor's symmetric half
    assert gram["flops_counted_plain"] > 1.9 * gram["flops"]
    # the all-reduce of (G, u, s): p^2 + p + 1 float32
    assert gram["collectives"]["all-reduce"]["bytes"] == 4 * (8192 ** 2 + 8192 + 1)
    hess = recs[("sven_hess_pggn", "paper", "pod16x16")]
    assert hess["collectives"]["all-reduce"]["bytes"] == 4 * 4096
    # resumable: a second run finds every record
    assert D.main(["--arch", "internlm2_1_8b", "--shape", "decode_32k", "--out",
                   str(records[1])]) == 0


def test_report_tables_and_roofline_rows(records):
    _, out, recs = records
    dry = R.dryrun_table(str(out), "pod16x16")
    roof = R.roofline_table(str(out), "pod16x16")
    # the header's 2 lines, internlm2-1.8b's 4 shapes (long_500k skipped), 2 sven cells
    assert dry.count("\n") + 1 == 2 + 4 + 2 and "SKIP" in dry
    assert "internlm2_1_8b | decode_32k" in roof and "fits 80G" in roof
    rows = {(r["arch"], r["shape"], r["mesh"]): r for r in TR.build_table(str(out))}
    train = rows[("internlm2_1_8b", "train_4k", "pod16x16")]
    assert train["status"] == "ok" and 0 < train["useful_ratio"] <= 1
    assert 0 < train["mfu_at_roofline"] <= 1 and train["roofline_step_s"] > 0


def test_hillclimb_variant_record(tmp_path):
    rec = H.run_variant("internlm2_1_8b", "decode_32k", "no_fsdp",
                        {"cfg": {}, "rules": {"fsdp": None}}, str(tmp_path))
    saved = json.loads((tmp_path / "internlm2_1_8b__decode_32k__no_fsdp.json").read_text())
    assert saved["variant"] == "no_fsdp" and saved["bottleneck"] == rec["bottleneck"]
    # decode_32k's FSDP gathers a layer's "data" blocks; without it, only
    # the logits' rows are gathered over "data"
    by_axis = saved["collectives_by_axis"]["all-reduce"]["by_axis"]
    base = D.lower_cell("internlm2_1_8b", "decode_32k", D.spec_mesh())
    assert by_axis["data"] == 1 < base["collectives_by_axis"]["all-reduce"]["by_axis"]["data"]
    assert saved["param_bytes"] > base["param_bytes"]   # a rank holds more


def test_meta_collectives_count_and_real_ones_raise():
    mesh = D.spec_mesh()
    view = mesh.view("model")
    dist.reset_counts()
    x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    assert dist.all_reduce(view, x).shape == (3, 5)
    assert dist.broadcast(mesh.view("data"), x, 1) is x
    parts = dist.all_gather(view, x)
    assert len(parts) == 16 and all(p.is_meta and p.shape == (3, 5) for p in parts)
    got = dist.counts()
    assert got["all-reduce"] == {"count": 1, "bytes": 30, "by_axis": {"model": 1},
                                 "bytes_by_axis": {"model": 30}}
    assert got["broadcast"]["by_axis"] == {"data": 1}
    assert got["all-gather"]["bytes_by_axis"] == {"model": 30}
    for fn in (lambda: dist.all_reduce(view, torch.ones(2)),
               lambda: dist.broadcast(view, torch.ones(2), 0),
               lambda: dist.all_gather(view, torch.ones(2))):
        with pytest.raises(RuntimeError, match="resolves specs only"):
            fn()
    dist.reset_counts()


def _hand_train_flops(cfg, B, S) -> float:
    """6 x the matmul parameters (the head in, the embedding lookup out) x
    tokens, plus the layers' forward again under remat, plus the attention
    scores and values (forward, remat and backward: 4 x 4 B H S^2 hd)."""
    d, hd, H, kv, ff = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    layer = d * H * hd * 2 + d * kv * hd * 2 + 3 * d * ff
    head = cfg.vocab_size * d
    T = B * S
    return (6 * (cfg.n_layers * layer + head) * T + 2 * cfg.n_layers * layer * T
            + cfg.n_layers * 16 * B * H * S * S * hd)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "deepseek_7b"])
def test_counted_train_flops_match_a_count_by_hand(arch):
    cfg = get_config(arch, smoke=True)
    B, S = 4, 64
    rec = D._lower_one(cfg, "train_4k", D.spec_mesh(sizes=(1, 1)), D._rules_for(cfg, "train_4k"),
                       microbatches=1, global_batch=B, seq_len=S)
    want = _hand_train_flops(cfg, B, S)
    assert abs(rec["flops"] - want) <= 0.05 * want, (rec["flops"], want)
    assert rec["collectives"] == {}


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    """Executed steps of SMOKE configs on gloo ranks: (1, 2) and (2, 1) on 2
    ranks, (2, 2) on 4."""
    import _torch_lm_ranks as RK

    two = {f"{arch}-{m}": (arch, m, (4, 16), 2) for arch in ("internlm2_1_8b", "mamba2_130m")
           for m in (1, 2)}
    four = {"internlm2_1_8b-2x2": ("internlm2_1_8b", 2, (4, 16), 1),
            "mixtral_8x7b-2x2": ("mixtral_8x7b", 2, (4, 16), 1)}
    out = {}
    for world, runs in ((2, two), (4, four)):
        got = dist.launch(RK.executed_counts_cases, world, args=(runs,), device="cpu",
                          timeout=600, threads=1)
        out.update({k: (world, runs[k], v) for k, v in got.items()})
    return out


@pytest.mark.parametrize("key", ["internlm2_1_8b-1", "internlm2_1_8b-2", "mamba2_130m-1",
                                 "mamba2_130m-2", "internlm2_1_8b-2x2", "mixtral_8x7b-2x2"])
def test_counted_collectives_equal_executed_ones(executed, key):
    world, (arch, model_axis, (B, S), mb), got = executed[key]
    sizes = (world // model_axis, model_axis)
    cfg = get_config(arch, smoke=True)
    mesh = D.spec_mesh(sizes=sizes)
    for kind, shape in (("train", "train_4k"), ("prefill", "prefill_32k"),
                        ("decode", "decode_32k")):
        rec = D._lower_one(cfg, shape, mesh, D._rules_for(cfg, shape),
                           microbatches=mb if kind == "train" else 1, global_batch=B,
                           seq_len=S)
        assert rec["collectives_by_axis"] == got[kind], (kind, sizes)
        if kind == "train":
            held = got["held"][0]
            assert rec["param_bytes"] == held[0] and rec["moment_bytes"] == held[1]


def test_ssm_heads_whole_when_the_view_divides_only_the_channels():
    """The dry run's mamba2-130m cells at 16 "model" ranks (24 heads)
    exercise this layout: here at 3 heads over 2 gloo ranks, against one
    process on the same weights."""
    import _torch_lm_ranks as RK

    got = dist.launch(RK.ssm_odd_heads, 2, args=(3,), device="cpu", timeout=300, threads=1)
    # AdamW's first step moves each parameter by about lr (1e-3) x the sign
    # of its gradient, so gradients apart by rounding leave the parameters
    # well inside 1e-2 x lr (without the view's sum of a whole leaf's
    # gradient, `w_in` moved 2 x lr apart)
    assert got["loss"] <= 1e-5 and got["params"] <= 1e-5
    assert got["logits"] <= 1e-5 * max(got["scale"], 1.0), got
