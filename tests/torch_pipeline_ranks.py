"""Rank side of tests/test_torch_pipeline.py (imports no JAX): the GPipe
pipeline on a gloo world of CPU ranks, each rank holding its own stage."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.pipeline import make_pipelined_loss
from repro_torch.dist.sharding import Placement, reshard
from repro_torch.launch.mesh import make_mesh
from repro_torch.tree import leaves

#: tests/test_pipeline.py's problem
S, M, MB, D = 4, 4, 2, 16


def problem():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M * MB, D)).astype(np.float32)
    y = rng.standard_normal((M * MB, D)).astype(np.float32)
    return {"w": w, "b": b}, x, y


def stage_fn(p, h):
    return torch.tanh(h @ p["w"]) + p["b"]


def loss_fn(out, y):
    return torch.mean((out - y) ** 2)


def sequential(params, x, y):
    h = x
    for i in range(params["w"].shape[0]):
        h = stage_fn({k: v[i] for k, v in params.items()}, h)
    return loss_fn(h, y)


def _grads_of(params):
    return {k: v.grad.numpy().copy() for k, v in params.items()}


def _whole(params):
    return {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in params.items()}


def toy(rank: int, n_micro: int) -> dict:
    """The pipelined loss and every stage's gradient (summed over the
    ranks: each holds only its own stage's), with the parameters whole on
    every rank and placed P("pod"); the sequential loss and gradients
    beside them."""
    n = torch.distributed.get_world_size()
    mesh = make_mesh((n,), ("pod",), [torch.device("cpu")] * n)
    params, x, y = problem()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    pipe = make_pipelined_loss(mesh, stage_fn, loss_fn, axis_name="pod",
                               n_micro=n_micro)
    out = {}
    whole = _whole(params)
    loss = pipe(whole, xt, yt)
    loss.backward()
    g = _grads_of(whole)
    for k in g:
        t = torch.from_numpy(g[k])
        torch.distributed.all_reduce(t)
        g[k] = t.numpy()
    out["whole"] = (float(loss.detach()), g)
    # placed: each rank holds [1, ...], its own stage
    sh = {k: Placement(mesh, ("pod",) + (None,) * (v.ndim - 1))
          for k, v in params.items()}
    placed = reshard({k: torch.from_numpy(v) for k, v in params.items()}, sh)
    for v in placed.values():
        v.requires_grad_(True)
    loss_p = pipe(placed, xt, yt)
    loss_p.backward()
    gp = {k: v.grad.clone() for k, v in placed.items()}
    full = {k: [torch.empty_like(v) for _ in range(n)] for k, v in gp.items()}
    for k in gp:
        torch.distributed.all_gather(full[k], gp[k])
    out["placed"] = (float(loss_p.detach()),
                     {k: torch.cat(v).numpy() for k, v in full.items()})
    seq = _whole(params)
    ls = sequential(seq, xt, yt)
    ls.backward()
    out["sequential"] = (float(ls.detach()), _grads_of(seq))
    return out


def errors(rank: int) -> list:
    """The two ValueErrors, raised alike on every rank."""
    n = torch.distributed.get_world_size()
    mesh = make_mesh((n,), ("pod",), [torch.device("cpu")] * n)
    params, x, y = problem()
    msgs = []
    with pytest.raises(ValueError, match="not divisible") as e:
        make_pipelined_loss(mesh, stage_fn, loss_fn, n_micro=3)(
            _whole(params), torch.from_numpy(x), torch.from_numpy(y))
    msgs.append(str(e.value))
    with pytest.raises(ValueError, match="shape-homogeneous") as e:
        make_pipelined_loss(mesh, lambda p, h: h[:, :-1], loss_fn,
                            n_micro=2)(
            _whole(params), torch.from_numpy(x), torch.from_numpy(y))
    msgs.append(str(e.value))
    return msgs


def lm_stages(rank: int, cfg, device: str = "cpu") -> dict:
    """A 2-stage pipeline of a float32 smoke model's blocks (each block
    under a checkpoint, as the model's remat runs a cycle) with the final
    norm and the chunked cross-entropy as the loss, against the same
    blocks run in sequence: losses and every block parameter's
    gradient."""
    from repro_torch.models import LM
    from repro_torch.models import layers as L
    from repro_torch.models.model import ParamView, apply_block
    from repro_torch.tree import tree_map
    n = torch.distributed.get_world_size()
    dev = torch.device(device)
    mesh = make_mesh((n,), ("pod",), [dev] * n)
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    model = LM(cfg, device=dev, seed=0)
    per = cfg.n_layers // n
    kind = model.blocks[0].kind
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (4, 12), generator=gen).to(dev)
    labels = toks[:, 1:].long()
    x = model._embed(toks).detach()

    def run(p, h, j):
        pos = torch.arange(h.shape[1], dtype=torch.int32,
                           device=dev).expand(h.shape[0], h.shape[1])
        blk = ParamView(tree_map(lambda v: v[j], p))
        return apply_block(kind, h, blk, cfg, None, pos, None)[0]

    def stage_blocks(p, h):
        for j in range(per):
            h = checkpoint(run, p, h, j, use_reentrant=False)
        return h

    def loss(out, labels):
        hn = L.rmsnorm(out, model.final_norm, cfg.norm_eps)
        total, count = model.chunked_nll(hn[:, :-1], labels)
        return total / count

    trees = [model.blocks[i].tree() for i in range(cfg.n_layers)]
    stacked = tree_map(lambda *vs: torch.stack(vs).detach().reshape(
        (n, per) + tuple(vs[0].shape)), *trees)
    sh = tree_map(lambda v: Placement(mesh, ("pod",) + (None,) *
                                      (v.dim() - 1)), stacked)
    placed = reshard(stacked, sh)
    for v in leaves(placed):
        v.requires_grad_(True)
    pipe = make_pipelined_loss(mesh, stage_blocks, loss, n_micro=2)
    lp = pipe(placed, x, labels)
    lp.backward()
    got = []
    for v in leaves(placed):
        g = v.grad.cpu()
        parts = [torch.empty_like(g) for _ in range(n)]
        torch.distributed.all_gather(parts, g)
        got.append(torch.cat(parts).reshape(
            (cfg.n_layers,) + tuple(v.shape[2:])).numpy())
    whole = tree_map(lambda v: v.reshape((cfg.n_layers,) + tuple(v.shape[2:]))
                     .clone().requires_grad_(True), stacked)
    h = x
    for i in range(cfg.n_layers):
        h = run(whole, h, i)
    ls = loss(h, labels)
    ls.backward()
    return {"pipelined": float(lp.detach()), "sequential": float(ls.detach()),
            "grads": got,
            "want": [v.grad.cpu().numpy() for v in leaves(whole)]}


def world4(rank: int) -> dict:
    """Every 4-rank scenario of the test file in one world."""
    return {"toy": {n_micro: toy(rank, n_micro) for n_micro in (4, 1)},
            "errors": errors(rank)}
