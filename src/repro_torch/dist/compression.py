"""Int8 quantization with error feedback (the 1-bit-Adam family).

`quantize_ef` is the local half of the reference's compressed all-reduce
(`repro.dist.compression`): the 2D mesh's frontier exchange
(`dist.mesh2d`, ``compress_halo=True``) quantizes each owner's (job,
slot) delta rows with it and carries the residual into the next
selection of the same block, so the quantization bias telescopes away.

`make_compressed_grad_fn` is the data-parallel gradient all-reduce of
dense training built on the same grid, over `torch.distributed`: each
rank computes its batch shard's grads, adds the carried error-feedback
residual, quantizes to int8 against a scale shared by every rank (MAX of
the local absmax), averages the dequantized values, and carries the mean
residual into the next step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map, unflatten


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


def make_compressed_grad_fn(mesh, loss_fn: Callable[..., torch.Tensor], *,
                            axis_name: Optional[str] = None, bits: int = 8):
    """Returns fn(params, err, batch) -> (loss, grads, new_err).

    Every rank of the mesh axis (`axis_name`, default the mesh's first;
    its ranks are the whole world) calls fn with the
    same params and err trees (err: the error-feedback state, float32
    zeros at step 0) and its own shard of the batch.  loss_fn(params,
    batch) -> scalar.  Returns the loss averaged over the ranks, grads
    approximating the exact data-parallel mean gradient to within one
    quantization step, and the new residual (the ranks' mean), all
    float32.  Without an initialized process group the axis must have
    one device, and fn runs alone."""
    axis = axis_name or mesh.axis_names[0]
    levels = float(2 ** (bits - 1) - 1)
    n = mesh.shape[axis]
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"mesh axis {axis!r} has {n} devices, the "
                             f"world {dist.get_world_size()} ranks")
        collective = True
    elif n == 1:
        collective = False
    else:
        raise RuntimeError(f"mesh axis {axis!r} of {n} devices needs an "
                           f"initialized torch.distributed process group")

    def all_reduce(t, op):
        if collective:
            dist.all_reduce(t, op=op)
        return t

    def pmean(t):
        return all_reduce(t, dist.ReduceOp.SUM) / n

    def fn(params, err, batch):
        local = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(local, batch)
        g_leaves = torch.autograd.grad(loss, leaves(local))
        loss = pmean(loss.detach().float().clone())
        out_g, out_e = [], []
        for g, e in zip(g_leaves, leaves(err)):
            t = g.float() + e
            # shared scale: every rank quantizes into the same int8 grid,
            # so the reduction of quantized values is well defined
            amax = all_reduce(t.abs().amax().clone(), dist.ReduceOp.MAX)
            scale = torch.clamp(amax, min=1e-30) / levels
            q = torch.clamp(torch.round(t / scale), -levels, levels)
            deq = q * scale
            out_g.append(pmean(deq.clone()))
            # the residual averaged over the ranks keeps the state
            # replicated; exact on one rank
            out_e.append(pmean(t - deq))
        return loss, unflatten(params, out_g), unflatten(params, out_e)

    return fn
