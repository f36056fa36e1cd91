"""Rank side of tests/test_torch_train_fsdp.py (imports no JAX): FSDP-DP
training under the "dp" rules on a gloo world of CPU ranks, each rank
holding its slices of the parameters and moments and its rows of the
batch."""

import dataclasses
import os

import torch

from repro_torch import configs, convert
from repro_torch.dist import act
from repro_torch.dist.sharding import (ShardingRules, batch_shardings,
                                       param_shardings, placement_of, reshard)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.train import checkpoint as ck
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import (_batch_axes, _value_and_grad,
                                          bind_params, make_train_step)

from torch_multidev_ref import B, OPT, OVERRIDES, S, UNEVEN_B  # noqa: E402


def _world():
    mesh = make_host_mesh(device="cpu")
    return mesh, ShardingRules(mesh, "dp")


def _model(name, overrides, params):
    cfg = dataclasses.replace(configs.get_smoke(name), param_dtype="float32",
                              **overrides)
    model = LM(cfg, device="meta")
    model.load_state_dict(convert.lm_params_from_repro(
        cfg, params, device="cpu"), assign=True)
    return model


def _state(model, rules):
    sh = param_shardings(rules, model.param_tree())
    params = reshard(model.param_tree(), sh)
    state_sh = {"params": sh, "opt": {"mu": sh, "nu": sh,
                                      "step": rules.named((), [])}}
    return {"params": params, "opt": adamw_init(params)}, state_sh


def _batch(rules, tokens):
    b = {"tokens": torch.from_numpy(tokens)}
    return reshard(b, batch_shardings(rules, b))


def _step(model, rules, tokens, accum):
    state, state_sh = _state(model, rules)
    step = make_train_step(model, AdamWConfig(**OPT), accum_steps=accum)
    with act.activation_sharding(rules):
        state, m = step(state, _batch(rules, tokens))
    return state, state_sh, (float(m["loss"]), float(m["grad_norm"]))


def _tokens(cfg, batch, seed):
    from repro_torch.data import SyntheticTokens
    return SyntheticTokens(cfg.vocab_size, batch, S, seed=seed,
                           device="cpu")(0)["tokens"].numpy()


def parity(rank: int, params: dict, ckpt_in: str, ckpt_out: str,
           state_in: dict) -> dict:
    """Per architecture (`params`: the reference's init of each, numpy):
    the loss and gathered grads of one batch, one step at accum 1 and 2
    (loss, grad norm, the gathered state), for the MoE a step on a batch
    the dp axis does not divide.  Then checkpoints: minicpm-2b's stepped
    state saved from this world (rank 0 writes `ckpt_out`), `ckpt_in`
    (written on one device) restored onto this world's placements and
    gathered, and `state_in` (the state `ckpt_in` holds, numpy) placed
    through `convert.train_state_from_repro` and gathered."""
    mesh, rules = _world()
    out = {}
    for name, p in params.items():
        model = _model(name, OVERRIDES.get(name, {}), p)
        tokens = _tokens(model.cfg, B, 0)
        res = {"tokens": tokens}
        state, _ = _state(model, rules)
        batch = _batch(rules, tokens)
        bind_params(model, state["params"])
        with act.activation_sharding(rules):
            loss, grads = _value_and_grad(model, state["params"], batch,
                                          *_batch_axes(batch))
        res["loss"] = float(loss)
        res["grads"] = convert.train_state_to_numpy(grads)
        for accum in (1, 2):
            st, state_sh, met = _step(model, rules, tokens, accum)
            res[f"step{accum}"] = met + (convert.train_state_to_numpy(st),)
            if name == "minicpm-2b" and accum == 1:
                ck.save_checkpoint(ckpt_out, 1, st)
                like = ck.spec_of(st)
                got, step = ck.restore_checkpoint(ckpt_in, like, state_sh)
                res["restored"] = (step, convert.train_state_to_numpy(got))
                res["sliced"] = placement_of(got["params"]["embed"]) \
                    is not None
                res["converted"] = convert.train_state_to_numpy(
                    convert.train_state_from_repro(
                        model.cfg, state_in, device="cpu",
                        shardings=state_sh))
        if model.cfg.moe:
            uneven = _tokens(model.cfg, UNEVEN_B, 1)
            st, _, met = _step(model, rules, uneven, 1)
            res["uneven"] = (uneven,) + met + (
                convert.train_state_to_numpy(st),)
        out[name] = res
    return out


def first_grad_norm(argv: list) -> float:
    """The grad norm of the first step of launch.train's loop (its
    `setup`'s placed state, step and rows of batch 0) on the --arch smoke
    config in float32, where one rank's bar is 1e-5: in bf16 the ranks'
    gradients are summed in bf16 and round once more."""
    from repro_torch.launch import train as ltrain
    args = ltrain.build_parser().parse_args(argv)
    run = ltrain.setup(args, cfg=dataclasses.replace(
        configs.get_smoke(args.arch), param_dtype="float32"))
    _, m = run["step"](run["state"], run["data"](0))
    return float(m["grad_norm"])


def launch_train(rank: int, argv: list, ckpt_dir: str) -> tuple:
    """launch.train's `train()` in this world: its (step, loss) history
    and its first step's grad norm."""
    from repro_torch.launch import train as ltrain
    args = ltrain.build_parser().parse_args(
        argv + ["--ckpt-dir", os.path.join(ckpt_dir, "world")])
    return ltrain.train(args)["history"], first_grad_norm(argv)


def cuda_world(rank: int) -> dict:
    """tests/test_torch_cuda.py's (2, 1) world of ranks sharing the card:
    one FSDP step of minicpm-2b's float32 smoke config on CPU tensors and
    on the card (loss, grad norm, the gathered state), and a 2-stage
    pipeline of its blocks on the card against their sequential run."""
    import torch_pipeline_ranks
    from repro_torch.launch import serve as lserve
    lserve.set_numerics()
    cfg = dataclasses.replace(configs.get_smoke("minicpm-2b"),
                              param_dtype="float32")
    init = {k: v for k, v in LM(cfg, device="cpu", seed=0)
            .state_dict().items()}
    out = {}
    for dev in ("cpu", "cuda"):
        model = LM(cfg, device="meta")
        model.load_state_dict({k: v.to(dev, copy=True)
                               for k, v in init.items()}, assign=True)
        mesh = make_host_mesh(device=dev)
        rules = ShardingRules(mesh, "dp")
        state, _ = _state(model, rules)
        b = {"tokens": torch.from_numpy(_tokens(cfg, B, 0)).to(dev)}
        step = make_train_step(model, AdamWConfig(**OPT))
        with act.activation_sharding(rules):
            state, m = step(state, reshard(b, batch_shardings(rules, b)))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    convert.train_state_to_numpy(state))
    out["pipeline"] = torch_pipeline_ranks.lm_stages(rank, cfg, "cuda")
    return out
