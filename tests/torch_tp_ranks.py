"""Rank side of tests/test_torch_tp*.py and of the card's test in
tests/test_torch_cuda.py (imports no JAX): the LM served under the "tp"
rules on a world of ranks, each rank holding its slices of the weights
(`param_shardings(serve=True)`) and, on a mesh with a data axis, its
rows of the batch."""

import dataclasses

import numpy as np
import torch

from repro_torch import configs, convert
from repro_torch.dist import act, comm, tp
from repro_torch.dist.sharding import (ShardingRules, batch_shardings,
                                       gather, param_shardings,
                                       placement_of, reshard)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.serve import ServeEngine

from torch_multidev_ref import TP_S, TP_STEPS, tp_inputs  # noqa: E402


def _rules(model_axis: int, device: str) -> ShardingRules:
    return ShardingRules(make_host_mesh(model_axis=model_axis,
                                        device=device), "tp")


def _shardings(rules, cfg):
    return param_shardings(rules, LM(cfg, device="meta").param_tree(),
                           serve=True)


def _rows(rules, t):
    """This data group's rows of `t` (a numpy array or None)."""
    if t is None:
        return None
    t = torch.from_numpy(np.array(t)).to(rules.mesh.local_device)
    return reshard(t, batch_shardings(rules, t))


def _whole_rows(rules, t):
    """Every data group's rows of `t` (this group's), in order."""
    if rules.axis_size("dp") <= 1:
        return t
    g, members = comm.group(rules.mesh, ("data",))
    return comm.all_gather(t.contiguous(), 0, g, len(members))


def serve_case(rules, model, cfg):
    """Prefill of TP_S tokens and TP_STEPS decode steps fed the prompt's
    next tokens (every step's logits, whole batch, float32 numpy), then
    `ServeEngine.generate`'s greedy tokens (TP_STEPS of them), inside
    `activation_sharding(rules, serve=True)`."""
    toks, pe = tp_inputs(cfg)
    rows, pe_rows = _rows(rules, toks), _rows(rules, pe)
    engine = ServeEngine(model, max_len=32 + cfg.patch_prefix)
    logits = []
    with act.activation_sharding(rules, serve=True):
        cache = engine.new_cache(rows.shape[0])
        lg, cache = engine.prefill(rows[:, :TP_S], cache, pe_rows)
        logits.append(lg)
        for j in range(TP_STEPS):
            lg, cache = engine.decode(rows[:, TP_S + j:TP_S + j + 1], cache)
            logits.append(lg)
        logits = [_whole_rows(rules, lg.float()).cpu().numpy()
                  for lg in logits]
        pe_t = None if pe is None else torch.from_numpy(pe).to(
            rules.mesh.local_device)
        greedy = engine.generate(
            torch.from_numpy(toks[:, :TP_S]).to(rules.mesh.local_device),
            TP_STEPS, patch_embeds=pe_t)
    return {"logits": logits, "greedy": greedy.cpu().numpy()}


def serve_world(rank: int, cases: list, model_axis: int) -> dict:
    """Each case (name, dtype, the reference's init as numpy, config
    overrides) converted onto this world's "tp" placements
    (`convert.lm_params_from_repro(..., shardings=)`) and served
    (`serve_case`); keyed (name, dtype, sorted overrides)."""
    rules = _rules(model_axis, "cpu")
    out = {}
    for name, dtype, params, over in cases:
        cfg = dataclasses.replace(configs.get_smoke(name), param_dtype=dtype,
                                  **over)
        model = LM(cfg, device="meta").assign_params(
            convert.lm_params_from_repro(cfg, params, device="cpu",
                                         shardings=_shardings(rules, cfg)))
        out[(name, dtype) + tuple(sorted(over.items()))] = serve_case(
            rules, model, cfg)
    return out


def placement_world(rank: int, name: str) -> dict:
    """`name`'s bf16 smoke config drawn on this rank's slices
    (`LM(cfg, seed=0, shardings=)`): each parameter's resident bytes,
    whole bytes and split dim; the slices gathered against a whole
    `LM(cfg, seed=0)`; the collectives and weights gathered in one
    decode step (and in a prefill)."""
    rules = _rules(2, "cpu")
    cfg = configs.get_smoke(name)
    model = LM(cfg, device="cpu", seed=0, shardings=_shardings(rules, cfg))
    whole = LM(cfg, device="cpu", seed=0)
    ref = dict(whole.named_parameters())
    params = {}
    for k, p in model.named_parameters():
        pl = placement_of(p)
        params[k] = (p.numel() * p.element_size(),
                     ref[k].numel() * ref[k].element_size(),
                     None if pl is None else pl.spec)
    same = all(torch.equal(a, b) for a, b in zip(
        _leaves(gather(model.param_tree())), _leaves(whole.param_tree())))
    toks, _ = tp_inputs(cfg)
    engine = ServeEngine(model, max_len=32)
    with act.activation_sharding(rules, serve=True):
        cache = engine.new_cache(toks.shape[0])
        comm.reset_stats()
        tp.reset_gathered()
        engine.prefill(torch.from_numpy(toks[:, :TP_S]), cache)
        prefill = (dict(comm.STATS), dict(tp.GATHERED))
        comm.reset_stats()
        tp.reset_gathered()
        engine.decode(torch.from_numpy(toks[:, TP_S:TP_S + 1]), cache)
        decode = (dict(comm.STATS), dict(tp.GATHERED))
        kv = [tuple(c["k"].shape) for c in cache["layers"]]
    return {"params": params, "same": same, "prefill": prefill,
            "decode": decode, "cache_k": kv}


def _leaves(tree):
    from repro_torch.tree import leaves
    out = []
    for x in leaves(tree):
        out.extend(x if isinstance(x, tuple) else [x])
    return out


def cuda_world(rank: int) -> dict:
    """tests/test_torch_cuda.py's (1, 2) world of two ranks sharing the
    card: qwen2.5-14b's float32 smoke config drawn on the card as this
    rank's slices of `LM(cfg, seed=0)`, prefill and 2 decode steps under
    the "tp" rules; the logits of each step."""
    from repro_torch.launch import serve as lserve
    lserve.set_numerics()
    cfg = dataclasses.replace(configs.get_smoke("qwen2.5-14b"),
                              param_dtype="float32")
    rules = _rules(2, "cuda")
    model = LM(cfg, device="cuda", seed=0, shardings=_shardings(rules, cfg))
    toks, _ = tp_inputs(cfg)
    t = torch.from_numpy(toks).cuda()
    engine = ServeEngine(model, max_len=32)
    out = []
    with act.activation_sharding(rules, serve=True):
        cache = engine.new_cache(t.shape[0])
        lg, cache = engine.prefill(t[:, :TP_S], cache)
        out.append(lg.cpu().numpy())
        for j in range(2):
            lg, cache = engine.decode(t[:, TP_S + j:TP_S + j + 1], cache)
            out.append(lg.cpu().numpy())
    return {"logits": out, "calls": comm.STATS["calls"]}
