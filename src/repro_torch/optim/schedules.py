"""Learning-rate schedules as plain step -> lr callables: the port of
`repro/optim/schedules.py`. Each takes the step as a tensor (the
optimizer's `count`) and returns a float32 tensor on its device, as
JAX's do under jit, so a step reads nothing back to the host."""
from __future__ import annotations

import math

import torch


def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn
