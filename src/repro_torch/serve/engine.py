"""Serving engine: prefill + decode over a preallocated KV cache."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.model import LM


class ServeEngine:
    """Runs `model` (an `LM`, on its device) under inference mode.  The
    cache is written in place, so one cache serves a prefill and every
    decode step after it."""

    def __init__(self, model: LM, *, max_len: int = 1024):
        self.model = model
        self.max_len = max_len

    def new_cache(self, batch: int):
        with torch.inference_mode():
            return self.model.init_cache(batch=batch, max_len=self.max_len)

    def prefill(self, tokens, cache, patch_embeds=None):
        with torch.inference_mode():
            return self.model.prefill(tokens, cache, patch_embeds)

    def decode(self, tokens, cache):
        with torch.inference_mode():
            return self.model.decode_step(tokens, cache)

    def generate(self, prompt_tokens: torch.Tensor, n_steps: int, *,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 patch_embeds: Optional[torch.Tensor] = None,
                 on_logits: Optional[Callable[[int, torch.Tensor],
                                              None]] = None):
        """prompt [B, S(, n_cb)] -> generated [B, n_steps(, n_cb)], greedy
        or sampled from `generator`.  The codebook axis is kept (the
        reference reshapes it away and fails on a multi-codebook model).
        `on_logits(i, logits)`, where given, sees the prefill's last
        logits (i = 0) and each decode step's (i = 1..n_steps)."""
        if not greedy and generator is None:
            raise ValueError("sampling needs a seeded torch.Generator")

        def pick(logits):
            last = logits[:, -1:]                   # [B, 1, V] / [B, 1, cb, V]
            if greedy:
                return torch.argmax(last, dim=-1).to(torch.int32)
            probs = torch.softmax(last.float(), dim=-1)
            flat = probs.reshape(-1, probs.shape[-1])
            tok = torch.multinomial(flat, 1, generator=generator)
            return tok.reshape(last.shape[:-1]).to(torch.int32)

        cache = self.new_cache(prompt_tokens.shape[0])
        logits, cache = self.prefill(prompt_tokens, cache, patch_embeds)
        if on_logits is not None:
            on_logits(0, logits)
        out = []
        tok = pick(logits)
        for i in range(n_steps):
            out.append(tok)
            logits, cache = self.decode(tok, cache)
            if on_logits is not None:
                on_logits(i + 1, logits)
            tok = pick(logits)
        return torch.cat(out, dim=1)
