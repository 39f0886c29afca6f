"""LM-substrate serving helpers (port of ``repro.serve.lm``): prefill and
single-token decode steps, and a batched greedy generation loop.  The
decode step writes the new K/V or state into the cache it is given (the
port's form of the reference's donated cache).  ``repro_torch.serve``
proper is the DIFET tile-serving subsystem (``serve/api.py``)."""
from __future__ import annotations

import torch


def make_prefill_fn(model):
    def prefill(batch):
        return model.prefill(batch)
    return prefill


def make_decode_fn(model):
    def decode_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)
    return decode_step


@torch.inference_mode()
def greedy_generate(model, prompt_tokens, n_steps, cache_len=None):
    """prompt_tokens [B, S0] -> generated [B, n_steps] (greedy, batched).

    As in the reference, the prompt warms the cache token by token through
    ``decode_step`` (``prefill`` is not used), and ties in the argmax go to
    the lowest token id."""
    b, s0 = prompt_tokens.shape
    cache = model.init_cache(b, cache_len or (s0 + n_steps))
    logits = None
    for i in range(s0):
        logits, cache = model.decode_step(cache, prompt_tokens[:, i:i + 1], i)
    out = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(n_steps):
        out.append(tok)
        logits, cache = model.decode_step(cache, tok, s0 + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    return torch.cat(out, dim=1)
