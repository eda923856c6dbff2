"""The port's package rules: it imports neither JAX nor the JAX package
(nor triton), its entry points do not drop to the CPU on their own, and its
kernel registry raises rather than falling back."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.convert import (carry_from_jax, config_from_jax, path_config_from_jax,
                                 problem_from_numpy, warm_from_jax)
from repro_torch.core.sven import SvenConfig, resolve_backend, sven
from repro_torch.data.synthetic import make_regression
from repro_torch.kernels import ops, registry

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_import_leaves_jax_repro_and_triton_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.convert, repro_torch.data, repro_torch.obs, repro_torch.runtime, "
            "repro_torch.serve, repro_torch.utils, repro_torch.launch.serve_en, "
            "repro_torch.dist, repro_torch.core.distributed, repro_torch.core.routing, "
            "repro_torch.baselines.shotgun, repro_torch.models, repro_torch.models.model, "
            "repro_torch.configs, repro_torch.launch.serve, repro_torch.optim, "
            "repro_torch.optim.adamw, repro_torch.optim.adafactor, repro_torch.optim.schedules, "
            "repro_torch.train, repro_torch.train.step, repro_torch.ckpt, "
            "repro_torch.ckpt.checkpoint, repro_torch.data.pipeline, repro_torch.launch.train, "
            "repro_torch.dist.shardings, repro_torch.dist.zero, repro_torch.dist.compress, "
            "repro_torch.dist.pipeline, repro_torch.launch.mesh, repro_torch.dist.tp, "
            "repro_torch.dist.fsdp, repro_torch.launch.dryrun\n"
            "from repro_torch.configs import ARCHS, get_config\n"
            "[get_config(a) for a in ARCHS]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton', 'ml_dtypes'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_file_imports_jax_or_repro():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro", "triton", "ml_dtypes"):
                    offenders.append(f"{path.relative_to(PKG)}:{node.lineno} {name}")
    assert offenders == []
    assert len(list(PKG.rglob("*.py"))) >= 15


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_regression(20, 5)
    X = np.ones((8, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sven(X, np.ones(8), 1.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        problem_from_numpy(X, np.ones(8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.resolve_kernel_backend(None)
    # told the CPU, or given CPU tensors, it runs there
    Xc, yc, _ = make_regression(20, 5, device="cpu")
    assert Xc.device.type == "cpu"
    assert sven(Xc, yc, 1.0, 1.0).beta.device.type == "cpu"


def test_lm_without_a_device_and_cuda_raises(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2-1.8b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.run(["--arch", "internlm2-1.8b", "--gen", "1"])
    # told the CPU, it runs there
    assert M.init_model(cfg, device="cpu")["embed"]["table"].device.type == "cpu"


def test_registry_resolves_from_the_operands_device():
    cpu_t = torch.zeros(3)
    assert registry.resolve_kernel_backend(None, cpu_t) == "ref"
    assert registry.resolve_kernel_backend("auto", cpu_t, cpu_t) == "ref"
    assert registry.resolve_kernel_backend("cuda", cpu_t) == "cuda"   # explicit wins
    assert resolve_backend(SvenConfig(), cpu_t).backend == "ref"
    assert resolve_backend(SvenConfig(backend="torch"), cpu_t).backend == "torch"
    with pytest.raises(ValueError, match="unknown backend"):
        registry.resolve_kernel_backend("tpu", cpu_t)


def test_registry_raises_on_mixed_devices_and_missing_bodies():
    cpu_t, meta_t = torch.zeros(3), torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        registry.resolve_kernel_backend(None, cpu_t, meta_t)
    with pytest.raises(ValueError, match="different devices"):
        ops.shifted_gram(torch.zeros(4, 2), torch.zeros(4, device="meta"), 1.0)
    with pytest.raises(ValueError, match="no kernel body for device"):
        registry.resolve_kernel_backend(None, meta_t)
    with pytest.raises(KeyError, match="no 'cuda' body"):
        registry.lookup("no_such_op", "cuda")
    for op in ("shifted_gram", "hinge_xtv", "hinge_xd", "hinge_stats"):
        assert registry.kernel_backends(op) == ("cuda", "ref")
    assert registry.kernel_backends("no_such_op") == ()


def test_config_from_jax_maps_backends_and_keeps_fields():
    from repro.core.sven import SvenConfig as JaxConfig
    for jax_backend, want in (("xla", "torch"), ("auto", "auto"), ("pallas", "auto"),
                              ("tpu", "auto"), ("gpu", "auto"),
                              ("tpu_interpret", "ref"), ("gpu_interpret", "ref"),
                              ("ref", "ref")):
        fields = dataclasses.asdict(JaxConfig(backend=jax_backend, mode="dual",
                                              precision="bf16", tol=1e-11))
        cfg = config_from_jax(fields)
        assert cfg.backend == want
        assert (cfg.mode, cfg.precision, cfg.tol) == ("dual", "bf16", 1e-11)
        assert cfg.max_newton == fields["max_newton"]
        assert cfg.lambda2_floor == fields["lambda2_floor"]
    interp = dataclasses.asdict(JaxConfig(backend="auto", interpret=True))
    assert config_from_jax(interp).backend == "ref"
    wa, ww = warm_from_jax(np.zeros(4), np.ones(3), device="cpu")
    assert wa.dtype == ww.dtype == torch.float64 and wa.shape == (4,)


def test_path_config_and_carry_from_jax():
    from repro.core.api import PathConfig as JaxPathConfig
    from repro.core.sven import SvenConfig as JaxConfig
    jcfg = JaxPathConfig(solver=JaxConfig(backend="tpu_interpret", tol=1e-9,
                                          precision="bf16"),
                         screen=False, max_evals=12, f_rtol=1e-8)
    cfg = path_config_from_jax(dataclasses.asdict(jcfg))
    assert (cfg.screen, cfg.max_evals, cfg.f_rtol) == (False, 12, 1e-8)
    assert cfg.t_floor_rel == jcfg.t_floor_rel
    assert (cfg.solver.backend, cfg.solver.tol, cfg.solver.precision) == \
        ("ref", 1e-9, "bf16")
    default = path_config_from_jax(dataclasses.asdict(JaxPathConfig()))
    assert default.solver.backend == "torch" and default.solver.tol == 1e-10
    carry = carry_from_jax(np.ones(3), np.zeros(6), np.ones(5), 2.5, 0.7, device="cpu")
    assert carry.beta.shape == (3,) and carry.alpha.shape == (6,) and carry.w.shape == (5,)
    assert carry.t.shape == carry.nu.shape == () and float(carry.nu) == 0.7
    assert carry.t.dtype == torch.float64 and carry.t.device.type == "cpu"
