"""Probe gloo's all-reduce on CUDA tensors: 2 ranks on card 0, each dtype
refused or taken (bfloat16, float16, float32), and one cold all-reduce of
2^28 elements in bfloat16 and in float32, timed on the host clock.

    PYTHONPATH=src python3 tools/gloo_allreduce_probe.py

Needs a CUDA device. The LM's data-parallel step all-reduces its gradients
in their own dtype (`repro_torch/train/step.py`); this says whether gloo
takes bfloat16 there and what a byte costs before the pinned buffers are
warm.
"""
import time

import torch


def rank(mesh):
    from repro_torch import dist

    out = {}
    dev = mesh.device
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        x = torch.full((1 << 20,), 1.5, dtype=dt, device=dev)
        try:
            y = dist.all_reduce(mesh, x)
            torch.cuda.synchronize()
            out[str(dt)] = ("ok", float(y[0]))
        except RuntimeError as e:
            out[str(dt)] = ("error", repr(e)[:300])
    for dt, n in ((torch.bfloat16, 1 << 28), (torch.float32, 1 << 28)):
        if out[str(dt)][0] != "ok":
            continue
        x = torch.ones((n,), dtype=dt, device=dev)
        dist.all_reduce(mesh, torch.zeros(1, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = dist.all_reduce(mesh, x)
        torch.cuda.synchronize()
        out[f"{dt} {n * x.element_size() / 1e9:.3f} GB s"] = time.perf_counter() - t0
        del x, y
    return out


if __name__ == "__main__":
    from repro_torch import dist

    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    print(dist.launch(rank, 2, timeout=300))
