"""The port's training launcher (`python -m repro_torch.launch.train`) on
the CPU: twins of `tests/test_fault_tolerance.py`'s launcher cases (the
supervisor survives an injected node failure; a run stopped at step 10
resumes from its checkpoint and lands within 1e-4 of an uninterrupted
20-step run's final loss, JAX's bound), with JAX's printed lines word for
word; the watchdog's line; JAX's flags and defaults; and, with no CUDA
and no device named, a raise rather than a CPU run. JAX's own launcher
cannot be run beside it: under its mesh it fails on this JAX (a reference
fault), so the contract of `tests/test_fault_tolerance.py` stands in."""
import os

import pytest
import torch

from _subprocess import run_python
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import train as launcher

BASE = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--batch", "4",
        "--seq", "64", "--ckpt-every", "5", "--log-every", "5"]


def _final_loss(out: str) -> float:
    last = out.strip().splitlines()[-1]
    assert last.startswith("[train] done at step"), last
    return float(last.split("loss")[-1])


def test_supervisor_recovers_from_injected_failure(tmp_path):
    r = run_python(["-m", "repro_torch.launch.train", *BASE, "--ckpt-dir",
                    str(tmp_path / "ckpt"), "--steps", "15", "--inject-fault-at", "8"],
                   timeout=300)
    assert "[supervisor] step 8 failed (injected node failure); retry 1" in r.stdout
    assert "[train] step 10 loss " in r.stdout
    assert "done at step 15" in r.stdout
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 15


def test_restart_resumes_from_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    launcher.run([*BASE, "--ckpt-dir", ckpt, "--steps", "10"])
    out1 = capsys.readouterr().out
    assert "done at step 10" in out1 and "resumed" not in out1
    resumed = launcher.train([*BASE, "--ckpt-dir", ckpt, "--steps", "20"])
    out2 = capsys.readouterr().out
    assert "[train] resumed from step 10" in out2
    assert "done at step 20" in out2
    assert resumed.step == 20 and len(resumed.losses) == 10
    assert int(resumed.opt_state.count) == 20

    # determinism: an uninterrupted 20-step run lands on the same loss
    straight = launcher.train([*BASE, "--ckpt-dir", str(tmp_path / "b"), "--steps", "20"])
    out3 = capsys.readouterr().out
    assert abs(_final_loss(out2) - _final_loss(out3)) < 1e-4, (out2, out3)
    assert abs(resumed.loss - straight.loss) < 1e-4
    assert sorted(os.listdir(ckpt)) == ["step_00000010", "step_00000015", "step_00000020"]


def test_watchdog_flags_a_slow_step(capsys):
    """With a factor of 0 every step past the fifth is over the factor
    times the median, so each is flagged."""
    res = launcher.train([*BASE, "--steps", "7", "--watchdog-factor", "0"])
    out = capsys.readouterr().out
    assert "[watchdog] step 5 took" in out and "— straggler suspected" in out
    assert "[watchdog] step 4 " not in out
    assert len(res.losses) == len(res.step_s) == 7 and res.metrics["loss"].shape == ()


def test_flags_and_defaults_are_jaxs():
    args = launcher._parser().parse_args([])
    assert (args.arch, args.smoke, args.steps, args.batch, args.seq, args.lr) == \
        ("internlm2-1.8b", False, 100, 8, 128, 3e-4)
    assert (args.microbatches, args.ckpt_dir, args.ckpt_every, args.max_retries) == \
        (1, "", 50, 3)
    assert (args.watchdog_factor, args.inject_fault_at, args.log_every, args.device) == \
        (5.0, -1, 10, None)


def test_without_a_device_and_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.run(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.build_state(get_config("internlm2-1.8b", smoke=True))
    params, opt = launcher.build_state(get_config("internlm2-1.8b", smoke=True), device="cpu")
    assert params["embed"]["table"].device.type == "cpu" and opt.count.device.type == "cpu"
