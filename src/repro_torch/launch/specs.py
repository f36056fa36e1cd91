"""Cells: one (architecture x shape) step with its argument specs and
placements (the reference's `repro.launch.specs`).

`build_cell` assembles a cell's step function, its arguments as tensors
on the meta device (nothing is allocated: the parameters of
`LM(cfg, device="meta")`, float32 moments shaped as them, the batch, the
cache) and the `Placement`s of its inputs and outputs under the sharding
rules `choose_policy` picks.  The train cell is how a user reaches
training under the "tp" rules: the MoE architectures, and the dense ones
whose batch does not tile the mesh.

A cell's `fn` runs inside the cell's `activation_sharding(rules,
serve=...)` on a rank's placed state: `meta["model"]` is the LM it runs
(pass `model=` a rank's model on its device; the default, on the meta
device, gives the specs alone).  The train cell's `fn(state, batch)` is
`make_train_step`'s step on a state placed by `in_shardings[0]`.  A
serve cell's `fn(params, cache, tokens[, patch_embeds])` (under
`torch.inference_mode()`, as `serve.ServeEngine` serves) serves the
model's own weights (`params` is its `param_tree()`, placed when the
model was built with `shardings=`), and takes and returns the cache in
the reference's layout (`stacked_cache`): each pattern position's
tensors stacked over the cycles (a `Stacked` of the model's own cache
tensors), the remainder's apart.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.dist.act import activation_sharding
from repro_torch.dist.sharding import (ShardingRules, batch_shardings,
                                       cache_shardings, param_shardings)
from repro_torch.models import LM
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import Stacked, tree_map

META = torch.device("meta")


def batch_size_per_step(shape: ShapeConfig) -> int:
    return shape.global_batch


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The model-input part of a cell: tokens (+ patch embeddings)."""
    b = shape.global_batch
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    if shape.kind == "decode":
        # one new token against a seq_len KV cache
        return {"tokens": _spec((b, 1) + cb, torch.int32)}
    spec = {"tokens": _spec((b, shape.seq_len - cfg.patch_prefix) + cb,
                            torch.int32)}
    if cfg.patch_prefix:
        spec["patch_embeds"] = _spec((b, cfg.patch_prefix, cfg.d_model),
                                     torch.bfloat16)
    return spec


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    fn: Any                  # the step, run on a rank's placed state
    args: Tuple[Any, ...]    # trees of tensors on the meta device
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate: Tuple[int, ...]
    meta: Dict[str, Any]


def _state_specs(model: LM) -> Dict[str, Any]:
    params = model.param_tree()

    def f32(p):
        if isinstance(p, Stacked):
            return Stacked(f32(t) for t in p)
        return _spec(p.shape, torch.float32)
    return {"params": params,
            "opt": {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
                    "step": _spec((), torch.int32)}}


def stacked_cache(cfg: ModelConfig, cache: Dict[str, Any]) -> Dict[str, Any]:
    """The model's cache ({"pos", "layers"}) in the reference's layout:
    {"blocks": per pattern position, each tensor a `Stacked` over the
    cycles; "pos"; "rem": the remainder's layers}, the same tensors."""
    layers = cache["layers"]
    period, n_cyc = len(cfg.block_pattern), cfg.pattern_cycles
    blocks = tuple({k: Stacked(layers[c * period + i][k]
                               for c in range(n_cyc))
                    for k in layers[i]} for i in range(period)) \
        if n_cyc else ()
    return {"blocks": blocks, "pos": cache["pos"],
            "rem": tuple(layers[n_cyc * period:])}


def unstacked_cache(cfg: ModelConfig, tree: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """`stacked_cache`'s inverse: the model's {"pos", "layers"}."""
    period, n_cyc = len(cfg.block_pattern), cfg.pattern_cycles
    layers = [{k: tree["blocks"][c % period][k][c // period]
               for k in tree["blocks"][c % period]}
              for c in range(n_cyc * period)] + list(tree["rem"])
    return {"pos": tree["pos"], "layers": layers}


def choose_policy(cfg: ModelConfig, shape: ShapeConfig, mesh) -> str:
    """Pure FSDP-DP for dense train cells whose batch tiles every device;
    TP/EP/SP otherwise (MoE needs EP; serving batches don't tile)."""
    if (shape.kind == "train" and not cfg.moe
            and shape.global_batch % int(np.prod(mesh.sizes)) == 0):
        return "dp"
    return "tp"


def build_cell(arch: str, shape_name: str, mesh, *,
               cfg: Optional[ModelConfig] = None,
               accum_steps: int = 1,
               policy: Optional[str] = None,
               force_sp: bool = False,
               shape: Optional[ShapeConfig] = None,
               model: Optional[LM] = None) -> Cell:
    """Assemble (fn, specs, placements) for one (arch x shape) cell.
    `model` is the LM the cell's fn runs (its cfg replaces `cfg`, and it
    runs its own: build a prefill cell's model with `meta["cfg"]`'s
    chunks; None: one on the meta device, for the specs alone).  `shape`
    replaces `SHAPES[shape_name]` (with a cut `cfg`: a cell at a batch
    and depth one card holds, on the same code path).

    `force_sp` runs a serve cell outside a serve context
    (`activation_sharding(rules, serve=False)`), as the reference's dry
    runs try.  The port's train layout (`dist/tp.py`) multiplies whole
    weights and splits the sequence inside `LM.loss` only, so a prefill
    or decode step outside a serve context has no layout for weights
    that `param_shardings(serve=True)` splits: where the rules split any
    ("tp" over more than one device), it raises NotImplementedError."""
    shape = shape or SHAPES[shape_name]
    cfg = model.cfg if model is not None else (cfg or configs.get(arch))
    if shape.kind == "prefill" and cfg.q_chunk < 2048:
        # the reference's prefill chunks: its SPMD chunk-boundary reshards
        # scale with the chunk count, so 2k/4k chunks cut its prefill wire
        # bytes 21% at +3% compute
        cfg = dataclasses.replace(cfg, q_chunk=2048, kv_chunk=4096)
    if model is None:
        model = LM(cfg, device=META)
    policy = policy or choose_policy(cfg, shape, mesh)
    rules = ShardingRules(mesh, policy)
    serve = shape.kind != "train" and not force_sp
    if force_sp and shape.kind != "train" and rules.axis_size("tp") > 1:
        raise NotImplementedError(
            f"force_sp: a {shape.kind} step outside a serve context has no "
            f"layout in the port for weights that param_shardings("
            f"serve=True) splits over \"tp\" ({rules.axis_size('tp')} "
            f"devices): the train layout (dist/tp.py) multiplies whole "
            f"weights and splits the sequence inside LM.loss only")

    # a serve cell records no graph, as the port serves (ServeEngine)
    grad = contextlib.nullcontext if shape.kind == "train" \
        else torch.inference_mode

    def _ctx(fn):
        def wrapped(*a):
            with activation_sharding(rules, serve=serve), grad():
                return fn(*a)
        return wrapped

    meta = {"cfg": cfg, "model": model, "policy": policy, "rules": rules}
    if shape.kind == "train":
        opt_cfg = AdamWConfig(schedule="wsd" if arch == "minicpm-2b"
                              else "cosine")
        step_fn = _ctx(make_train_step(model, opt_cfg,
                                       accum_steps=accum_steps))
        state = _state_specs(model if model.device == META
                             else LM(cfg, device=META))
        batch = input_specs(cfg, shape)
        p_sh = param_shardings(rules, state["params"])
        state_sh = {"params": p_sh,
                    "opt": {"mu": p_sh, "nu": p_sh,
                            "step": rules.named((), [])}}
        metrics_sh = {k: rules.named((), [])
                      for k in ("grad_norm", "loss", "lr")}
        return Cell(arch, shape, step_fn, (state, batch),
                    (state_sh, batch_shardings(rules, batch)),
                    (state_sh, metrics_sh), donate=(0,), meta=meta)

    spec_model = LM(cfg, device=META)
    params = spec_model.param_tree()
    p_sh = param_shardings(rules, params, serve=True)
    b = shape.global_batch
    cache = stacked_cache(cfg, spec_model.init_cache(b, shape.seq_len))
    cache["pos"] = _spec((), torch.int32)
    c_sh = cache_shardings(rules, cache)
    batch = input_specs(cfg, shape)
    batch_sh = batch_shardings(rules, batch)
    logits_sh = rules.named(
        (b, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
        + (cfg.vocab_size,), ["dp"] + [None] * (3 if cfg.n_codebooks
                                                else 2))

    def own(params):
        if params["embed"] is not model.embed:
            raise ValueError("a serve cell runs its model's own weights: "
                             "pass meta['model'].param_tree()")

    if shape.kind == "prefill":
        @_ctx
        def fn(params, cache, tokens, patch_embeds=None):
            own(params)
            logits, c = model.prefill(tokens, unstacked_cache(cfg, cache),
                                      patch_embeds)
            return logits, stacked_cache(cfg, c)
        args = (params, cache, batch["tokens"])
        in_sh = (p_sh, c_sh, batch_sh["tokens"])
        if cfg.patch_prefix:
            args += (batch["patch_embeds"],)
            in_sh += (batch_sh["patch_embeds"],)
        return Cell(arch, shape, fn, args, in_sh, (logits_sh, c_sh),
                    donate=(1,), meta=meta)

    # decode: the cache filled to seq_len - 1 (the new token lands at the
    # last slot)
    @_ctx
    def fn(params, cache, tokens):
        own(params)
        logits, c = model.decode_step(tokens, unstacked_cache(cfg, cache))
        return logits, stacked_cache(cfg, c)
    return Cell(arch, shape, fn, (params, cache, batch["tokens"]),
                (p_sh, c_sh, batch_sh["tokens"]), (logits_sh, c_sh),
                donate=(1,), meta=meta)


def cell_is_applicable(arch: str, shape_name: str) -> Tuple[bool, str]:
    cfg = configs.get(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense-causal decode "
                       "requires sub-quadratic attention (DESIGN.md)")
    return True, ""
