"""Serving engine: prefill + decode over a preallocated KV cache.

Over ranks, the engine's calls run inside `activation_sharding(rules,
serve=True)` on a model placed under the same rules (`models.model`,
`dist/tp.py`): each rank multiplies its share of every product and gets
the whole logits.  Where the rules' data axes split the batch, each data
group serves its rows: `generate` takes the whole prompt, serves this
group's rows (`batch_shardings`) and returns every row's tokens on every
rank; `prefill` and `decode` take the rows they are given.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.dist import act
from repro_torch.models.model import LM


def _data_axes(rules):
    return tuple(a for a in rules.mesh_axes("dp") if rules.mesh.shape[a] > 1)


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
        with torch.inference_mode(), self._rows():
            return self.model.prefill(tokens, cache, patch_embeds)

    def decode(self, tokens, cache):
        with torch.inference_mode(), self._rows():
            return self.model.decode_step(tokens, cache)

    def _rows(self, split: bool = True):
        """Within: the batch's rows are split over the active rules' data
        axes (`act.batch_split`, so the MoE ranks and caps each group's
        tokens as the reference's groups do), where there are such axes
        and `split`."""
        rules = act.current_rules()
        axes = () if rules is None or not split else _data_axes(rules)
        if not axes:
            return contextlib.nullcontext()
        return act.batch_split(rules.mesh, axes)

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
        logits (i = 0) and each decode step's (i = 1..n_steps): this data
        group's rows, where the rules split the batch."""
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

        rules = act.current_rules()
        grp = None
        if rules is not None and _data_axes(rules):
            from repro_torch.dist import comm
            from repro_torch.dist.sharding import (batch_shardings,
                                                   placement_of, reshard)
            prompt_tokens = reshard(prompt_tokens, batch_shardings(
                rules, prompt_tokens))
            if patch_embeds is not None:
                patch_embeds = reshard(patch_embeds, batch_shardings(
                    rules, patch_embeds))
            if placement_of(prompt_tokens) is not None:
                grp = comm.group(rules.mesh, _data_axes(rules))
        with torch.inference_mode(), self._rows(grp is not None):
            cache = self.model.init_cache(prompt_tokens.shape[0],
                                          self.max_len)
            logits, cache = self.model.prefill(prompt_tokens, cache,
                                               patch_embeds)
            if on_logits is not None:
                on_logits(0, logits)
            out = []
            tok = pick(logits)
            for i in range(n_steps):
                out.append(tok)
                logits, cache = self.model.decode_step(tok, cache)
                if on_logits is not None:
                    on_logits(i + 1, logits)
                tok = pick(logits)
            out = torch.cat(out, dim=1)
            if grp is not None:        # every data group's rows, in order
                out = comm.all_gather(out, 0, grp[0], len(grp[1]))
        return out
