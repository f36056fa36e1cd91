"""Int8 quantization with error feedback (the 1-bit-Adam family).

`quantize_ef` is the local half of the reference's compressed all-reduce
(`repro.dist.compression`): the 2D mesh's frontier exchange
(`dist.mesh2d`, ``compress_halo=True``) quantizes each owner's (job,
slot) delta rows with it and carries the residual into the next
selection of the same block, so the quantization bias telescopes away.
The gradient all-reduce built on it in the reference serves the LM
trainer and is not ported yet.
"""

from __future__ import annotations

import torch


def quantize_ef(t: torch.Tensor, bits: int = 8, axis=None):
    """Quantize `t` to a signed (2^bits - 1)-level grid, returning
    (dequantized, residual) with t == dequantized + residual exactly.

    `axis` selects the scale granularity: None shares one absmax scale
    across the whole tensor; an int or a tuple computes the scale per
    slice along the REMAINING axes (axis=-1 gives every leading-index
    row its own scale, as the frontier exchange uses per (job, slot)
    row).  Zero rows quantize to exact zeros (the 1e-30 floor only
    guards the division).  Rounding is half to even, as jnp.round's."""
    t = t.to(torch.float32)
    levels = float(2 ** (bits - 1) - 1)
    if axis is None:
        amax = t.abs().amax()
    else:
        amax = t.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / levels
    q = torch.clamp(torch.round(t / scale), -levels, levels)
    deq = q * scale
    return deq, t - deq
