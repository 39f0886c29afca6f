"""LR schedules (port of ``repro.optim.schedule``), in float32."""
import math

import torch


def cosine_schedule(peak_lr, warmup_steps, total_steps, min_ratio=0.1):
    """Linear warm-up from 0 (step 0 gets lr 0), then a cosine from
    ``peak_lr`` down to ``min_ratio * peak_lr``.  ``lr(step)`` takes an int
    or a tensor and returns a float32 scalar tensor on its device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return lr
