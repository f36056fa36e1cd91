"""Rank side of tests/test_torch_tp_train.py (imports no JAX): training
under the "tp" rules on a gloo world of CPU ranks on a ("data", "model")
mesh, each rank holding whole weights (bound from its FSDP slices over
"data"), its rows of the batch and its positions of the sequence."""

import dataclasses

import torch

import torch.distributed as dist

from repro_torch import configs, convert
from repro_torch.dist import act, comm
from repro_torch.dist.sharding import (ShardingRules, batch_shardings,
                                       param_shardings, reshard)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.models.config import ShapeConfig
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import (_batch_axes, _value_and_grad,
                                          bind_params, make_train_step)
from repro_torch.tree import Stacked, members, tree_map

from torch_multidev_ref import OPT, OVERRIDES, tp_train_inputs  # noqa: E402


#: cells whose collectives the (1, 2) world lists call for call (the
#: smoke configs; `launch.dryrun` predicts them in a fake world of 2)
DRYRUN_CELLS = (
    ("mixtral-8x7b", "train_4k", ShapeConfig("t", "train", 32, 2)),
    ("qwen2.5-14b", "decode_32k", ShapeConfig("d", "decode", 32, 2)))


def _rules(device="cpu"):
    return ShardingRules(make_host_mesh(model_axis=2, device=device), "tp")


def _model(name, dtype, params, over=(), device="cpu"):
    cfg = dataclasses.replace(configs.get_smoke(name), param_dtype=dtype,
                              **dict(over))
    model = LM(cfg, device="meta")
    model.load_state_dict(convert.lm_params_from_repro(
        cfg, params, device=device), assign=True)
    return model


def _state(model, rules):
    """A fresh train state placed under `rules` (the parameters copied:
    a step updates them in place)."""
    sh = param_shardings(rules, model.param_tree())
    params = reshard(tree_map(lambda p: Stacked(t.detach().clone()
                                                for t in members(p))
                              if isinstance(p, Stacked)
                              else p.detach().clone(), model.param_tree()),
                     sh)
    return {"params": params, "opt": adamw_init(params)}


def _batch(rules, cfg, device="cpu"):
    b = {k: torch.from_numpy(v).to(device)
         for k, v in tp_train_inputs(cfg).items()}
    return reshard(b, batch_shardings(rules, b))


def loss_grads(model, rules, device="cpu"):
    """(loss, the gathered gradients as numpy) of the case's batch."""
    state = _state(model, rules)
    batch = _batch(rules, model.cfg, device)
    bind_params(model, state["params"])
    with act.activation_sharding(rules):
        loss, grads = _value_and_grad(model, state["params"], batch,
                                      *_batch_axes(batch))
    return float(loss), convert.train_state_to_numpy(grads)


def step(model, rules, accum, device="cpu"):
    """One `make_train_step` step at `accum` from a fresh state: (loss,
    grad norm, the gathered state as numpy)."""
    state = _state(model, rules)
    fn = make_train_step(model, AdamWConfig(**OPT), accum_steps=accum)
    with act.activation_sharding(rules):
        state, m = fn(state, _batch(rules, model.cfg, device))
    return (float(m["loss"]), float(m["grad_norm"]),
            convert.train_state_to_numpy(state))


def one_by_two(rank: int, cases: list) -> dict:
    """A (1, 2) world: each case's (name, dtype, the reference's init as
    numpy) loss and gathered gradients (a bf16 case's also on one device,
    outside the rules); and the message of the error a sequence of odd
    length raises."""
    rules = _rules()
    out = {}
    for name, dtype, params in cases:
        model = _model(name, dtype, params)
        out[(name, dtype)] = loss_grads(model, rules)
        if dtype == "bfloat16":
            loss, grads = _value_and_grad(
                model, model.param_tree(),
                {k: torch.from_numpy(v)
                 for k, v in tp_train_inputs(model.cfg).items()})
            out[(name, "one device")] = (
                float(loss), convert.train_state_to_numpy(grads))
    name, dtype, params = cases[0]
    model = _model(name, dtype, params)
    batch = _batch(rules, model.cfg)
    try:
        with act.activation_sharding(rules):
            model.loss({"tokens": batch["tokens"][:, :-1]})
    except ValueError as e:
        out["odd"] = str(e)
    out["calls"] = cell_calls(rules.mesh)
    return out


def cell_calls(mesh) -> list:
    """Every rank's collectives ((op, bytes, ranks) a call, `comm.record`)
    in one run of each of DRYRUN_CELLS' cells placed by
    `dryrun.placed_cell` on the CPU, by rank."""
    mine = {}
    for arch, sname, shape in DRYRUN_CELLS:
        cell, args = dryrun.placed_cell(arch, sname, mesh, device="cpu",
                                        cfg=configs.get_smoke(arch),
                                        shape=shape)
        with comm.record() as calls:
            cell.fn(*args)
        mine[(arch, sname)] = [(c.op, c.nbytes, c.ranks) for c in calls]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def two_by_two(rank: int, params: dict) -> dict:
    """A (2, 2) world: per architecture (`params`: the reference's
    float32 init, numpy; the MoE at `OVERRIDES`' capacity factor) the
    loss and gathered gradients, and one step at accum 1 and 2."""
    rules = _rules()
    out = {}
    for name, p in params.items():
        model = _model(name, "float32", p, OVERRIDES.get(name, {}).items())
        res = {}
        res["loss"], res["grads"] = loss_grads(model, rules)
        for accum in (1, 2):
            res[f"step{accum}"] = step(model, rules, accum)
        out[name] = res
    return out


def cuda_world(rank: int) -> dict:
    """tests/test_torch_cuda.py's (1, 2) world of two ranks sharing the
    card: mixtral-8x7b (capacity factor 1) and qwen2.5-14b at their
    float32 smoke configs from `LM(cfg, seed=0)` drawn on the CPU, TF32
    off: the loss, the gathered gradients and one step at accum 2."""
    from repro_torch.launch import serve as lserve
    lserve.set_numerics()
    rules = _rules("cuda")
    out = {}
    for name in ("mixtral-8x7b", "qwen2.5-14b"):
        model = cuda_case(name)
        out[name] = loss_grads(model, rules, "cuda") + (
            step(model, rules, 2, "cuda"),)
    return out


def cuda_case(name: str) -> LM:
    """The CUDA test's model: `LM(cfg, seed=0)` drawn on the CPU (float32
    smoke config, the MoE at capacity factor 1), moved to the card."""
    cfg = dataclasses.replace(configs.get_smoke(name), param_dtype="float32",
                              **OVERRIDES.get(name, {}))
    init = LM(cfg, device="cpu", seed=0).state_dict()
    model = LM(cfg, device="meta")
    model.load_state_dict({k: v.cuda() for k, v in init.items()},
                          assign=True)
    return model
