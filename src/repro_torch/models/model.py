"""LM: assembles the architecture zoo from block kinds.

The layer stack is `block_pattern` cycled `pattern_cycles` times plus a
remainder, held as one `nn.ModuleList` of `n_layers` blocks in stack order
(the reference stacks each pattern position over the cycles and scans;
`convert.lm_params_from_repro` unstacks).  One code path serves train (no
cache), prefill (cache written) and decode (cache read and updated, one
token).  `loss` is the training objective: the reference's chunked
cross-entropy, each chunk under `torch.utils.checkpoint`, and with
`cfg.remat` each cycle of the pattern recomputed in the backward pass, as
the reference's `jax.remat(cycle)`.  `param_tree` gives the parameters in
the reference's stacked layout (`repro_torch.tree`), the layout of the
optimizer state and of checkpoints.

Parameters keep the reference's dict keys as their names and its [in, out]
layout, so `x @ p.wq` reads as the reference's `x @ p["wq"]`.  The cache
is a dict of preallocated tensors written in place: `{"pos": int, "layers":
[one dict a layer]}`; `pos` is a host int, so a decode step never reads
the device.

Tensor-parallel serving (the "tp" policy, `dist/tp.py`).  `LM(cfg,
shardings=...)` (a `param_shardings(rules, LM(cfg, device="meta")
.param_tree(), serve=True)` tree) draws every block whole, in the order
and from the seed a one-device `LM(cfg)` draws, keeps this rank's slices
(`member_placements`) and frees the rest; `assign_params` takes a rank's
slices made elsewhere (`convert.lm_params_from_repro(..., shardings=)`).
Inside `activation_sharding(rules, serve=True)` the blocks multiply the
rank's share of every product: attention over the rank's heads (the
reference's choice between heads and sequence: the sequence layout keeps
every head on every rank, "sp" staying whole), the MLP over its hidden
features, the embedding over its vocabulary rows.  The residual stream
and the returned logits are whole on every rank, and the KV cache holds
the rank's KV heads where they split.

Training under the "tp" rules (a train context whose "sp" axis spans
more than one device).  `loss` runs within `act.seq_split`: the weights
are whole on every rank, the stream between blocks (what remat saves a
cycle) is the rank's 1/n of the positions, each block gathers the
normed stream and computes its share of the heads, features, channels
or experts (`dist/tp.py`), and the NLL, its count and the MoE
statistics are summed over every rank's positions.  The train step
sums each gradient over "model" (`dist.sharding.reduce_grad`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import tp
from repro_torch.dist import act
from repro_torch.dist.act import axis_size, constrain, psum_batch, psum_seq
from repro_torch.dist.sharding import (Placement, placement_of, reshard,
                                       split_axes, split_dims,
                                       with_placement)
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.recurrent import (init_rglru, init_rglru_cache,
                                          rglru_block)
from repro_torch.models.xlstm import (init_mlstm, init_mlstm_cache,
                                      init_slstm, init_slstm_cache,
                                      mlstm_block, slstm_block)
from repro_torch.tree import Stacked


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _param(t: torch.Tensor) -> nn.Parameter:
    """`t` as a parameter, keeping the placement of a rank's slice."""
    return with_placement(nn.Parameter(t), placement_of(t))


class Params(nn.Module):
    """Parameters under the reference's dict keys: a tensor becomes a
    trainable parameter, a nested dict a submodule, so `moe.experts.w1`
    names what the reference keeps at p["moe"]["experts"]["w1"].  Serving
    runs under `torch.inference_mode()` (`serve.ServeEngine`), so it
    records no graph."""

    def __init__(self, tensors: Dict[str, Any]):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, dict):
                self.add_module(name, Params(t))
            else:
                self.register_parameter(name, _param(t))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self) -> Dict[str, Any]:
        """The parameters as the reference's nested dict."""
        out: Dict[str, Any] = dict(self._parameters)
        for name, mod in self._modules.items():
            out[name] = mod.tree()
        return out


class ParamView:
    """A block's parameters held as the reference's nested dict (a
    stage's slice of stacked weights, say) read as a `Params` is read
    (`p.wq`), so `apply_block` takes them as they are, autograd and all."""

    def __init__(self, tree: Dict[str, Any]):
        self._tree = tree

    def __getattr__(self, name: str):
        try:
            v = self.__dict__["_tree"][name]
        except KeyError:
            raise AttributeError(name) from None
        return ParamView(v) if isinstance(v, dict) else v

    def __contains__(self, name: str) -> bool:
        return name in self._tree


class Block(Params):
    """One layer of the stack: its kind and its parameters."""

    def __init__(self, kind: str, tensors: Dict[str, Any]):
        super().__init__(tensors)
        self.kind = kind


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def init_attn_block(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    p = {
        "ln1": L.vector(d, 1.0, device),
        "wq": L.dense_init(gen, d, h * hd, dtype, device),
        "wk": L.dense_init(gen, d, kv * hd, dtype, device),
        "wv": L.dense_init(gen, d, kv * hd, dtype, device),
        "wo": L.dense_init(gen, h * hd, d, dtype, device),
        "ln2": L.vector(d, 1.0, device),
    }
    if cfg.qkv_bias:
        p["bq"] = L.vector(h * hd, 0.0, device)
        p["bk"] = L.vector(kv * hd, 0.0, device)
        p["bv"] = L.vector(kv * hd, 0.0, device)
    if cfg.qk_norm:
        p["q_norm"] = L.vector(hd, 1.0, device)
        p["k_norm"] = L.vector(hd, 1.0, device)
    if cfg.moe:
        p["moe"] = init_moe(gen, cfg, dtype, device)
    else:
        p["w1"] = L.dense_init(gen, d, f, dtype, device)
        p["w3"] = L.dense_init(gen, d, f, dtype, device)
        p["w2"] = L.dense_init(gen, f, d, dtype, device)
    return p


def attn_layout(cfg: ModelConfig):
    """(q's spec, k/v's spec, q heads split, k/v heads split) under the
    active context: the reference's choice of heads-TP where the head
    count divides the tp axis, else (or under qkv_spec="sp") the query's
    sequence layout.  On ranks ("tp" over more than one device in a serve
    context) the heads layout gives each rank its chunk of the q heads,
    and of the KV heads where they divide too; the sequence layout keeps
    every head on every rank ("sp" stays whole)."""
    if cfg.qkv_spec == "sp":
        qspec = kvspec = ("dp", "sp", None, None)
    elif cfg.n_heads % max(axis_size("tp"), 1) == 0:
        qspec = kvspec = ("dp", None, "tp", None)
    else:
        qspec = ("dp", "sp", None, None)
        kvspec = ("dp", None, "tp", None)
    heads = qspec[2] == "tp" and tp.divides(cfg.n_heads)
    return qspec, kvspec, heads, heads and tp.divides(cfg.n_kv_heads)


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    dtype, device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    if attn_layout(cfg)[3]:
        kv //= tp.size()                    # this rank's KV heads
    w = min(cfg.window, max_len) if kind == "swa" else max_len
    cache = {"k": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
             "v": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device)}
    if kind == "swa":
        cache["pos_arr"] = torch.full((batch, w), -1, dtype=torch.int32,
                                      device=device)
    return cache


def _head_norm(x, w, eps):
    """Per-head RMSNorm over the last (head_dim) axis (qwen3 qk-norm)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def attn_block(x, p, cfg: ModelConfig, kind: str, cache: Optional[dict],
               positions: torch.Tensor, pos0: Optional[int], x32=None):
    """x [B,S,D]; positions [B,S] int32; pos0 = the cache's fill level (None
    without a cache); x32 = x's unrounded float32 value where the first
    norm reads it (`layers.residual`).  Writes the cache in place; returns
    (x, cache, aux_loss or None, x's unrounded float32 value)."""
    b, s, _ = x.shape
    h_, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.window if kind == "swa" else None
    qspec, kvspec, heads, kv_split = attn_layout(cfg)
    n = tp.size()
    hl = h_ // n if heads else h_
    kvl = kv // n if kv_split else kv

    hnorm = L.rmsnorm(x, p.ln1, cfg.norm_eps, x32)
    # training under "tp" (x the rank's positions): k and v, and q in the
    # heads layout, come from the whole sequence gathered over "model";
    # in the sequence layout q keeps the rank's positions
    train = tp.training()
    hw = tp.seq_gather(hnorm, train)
    q_pos = kv_pos = positions
    if train:
        kv_pos = torch.arange(hw.shape[1], dtype=torch.int32,
                              device=x.device).expand(b, hw.shape[1])
        if heads:
            q_pos = kv_pos
    q = tp.matmul(hw if heads else hnorm, p.wq, local=heads)
    k = tp.matmul(hw, p.wk, local=kv_split)
    v = tp.matmul(hw, p.wv, local=kv_split)
    if cfg.qkv_bias:
        q = q + tp.chunk(p.bq, heads).to(q.dtype)
        k = k + tp.chunk(p.bk, kv_split).to(k.dtype)
        v = v + tp.chunk(p.bv, kv_split).to(v.dtype)
    sq, skv = q.shape[1], k.shape[1]
    q = constrain(q.reshape(b, sq, hl, hd), *qspec)
    k = constrain(k.reshape(b, skv, kvl, hd), *kvspec)
    v = constrain(v.reshape(b, skv, kvl, hd), *kvspec)
    if cfg.qk_norm:
        q = _head_norm(q, p.q_norm, cfg.norm_eps)
        k = _head_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.use_rope:
        cos, sin = L.rope_tables(kv_pos, hd, cfg.rope_base)
        k = L.apply_rope(k, cos, sin)
        if q_pos is not kv_pos:
            cos, sin = L.rope_tables(q_pos, hd, cfg.rope_base)
        q = L.apply_rope(q, cos, sin)

    # a prefill (s > 1) attends within its own sequence: the cache write
    # never feeds the attention read; the rank's query positions against
    # the whole sequence (training's sequence layout) are masked, not
    # cut at the diagonal
    kk, vv, triangular = k, v, sq == skv
    if cache is not None and "pos_arr" in cache:      # sliding-window ring
        w = cache["k"].shape[1]
        if s == 1:
            # decode: attend over (old ring UNION the new token), read
            # before the ring is written
            kk = torch.cat([cache["k"], k], dim=1)
            vv = torch.cat([cache["v"], v], dim=1)
            kv_pos = torch.cat([cache["pos_arr"], positions], dim=1)
            triangular = False
        lw = min(s, w)
        slots = (positions[0, -lw:] % w).long()       # row 0's layout
        cache["k"].index_copy_(1, slots, k[:, -lw:])
        cache["v"].index_copy_(1, slots, v[:, -lw:])
        cache["pos_arr"].index_copy_(1, slots, positions[:, -lw:])
    elif cache is not None:                           # full causal cache
        max_len = cache["k"].shape[1]
        if pos0 + s > max_len:
            raise ValueError(f"cache of {max_len} slots cannot take "
                             f"positions {pos0}..{pos0 + s - 1}")
        cache["k"][:, pos0:pos0 + s] = k
        cache["v"][:, pos0:pos0 + s] = v
        if s == 1:
            row = torch.arange(max_len, dtype=torch.int32, device=x.device)
            kv_pos = torch.where(row < pos0 + s, row, -1).expand(b, max_len)
            kk, vv, triangular = cache["k"], cache["v"], False

    if heads and not kv_split and kv > 1:
        # this rank's q heads read their KV heads of the whole set (GQA)
        idx = (tp.axis().i * hl + torch.arange(hl, device=x.device)) \
            // (h_ // kv)
        kk, vv = kk.index_select(2, idx), vv.index_select(2, idx)
    o = L.flash_attention(q, kk, vv, q_pos, kv_pos, window=window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                          triangular=triangular)
    # wo / w2: a float32 sum rounded once to the activation dtype (the
    # reference's reduce_dtype only changes a sharded reduction's wire type;
    # split over ranks, the float32 partials are summed, in training onto
    # the rank's positions: `tp.matmul`)
    x, x32 = L.residual(x, tp.matmul(o.reshape(b, sq, hl * hd), p.wo,
                                     x_local=heads))
    x = constrain(x, "dp", "sp", None)

    h2 = L.rmsnorm(x, p.ln2, cfg.norm_eps, x32)
    aux = None
    if cfg.moe:
        ffn, aux = moe_ffn(h2, p.moe, cfg)
    else:
        ffn = L.mlp(h2, p, cfg)
    x, x32 = L.residual(x, ffn)
    return constrain(x, "dp", "sp", None), cache, aux, x32


# ---------------------------------------------------------------------------
# block dispatch
# ---------------------------------------------------------------------------

_INIT = {"attn": init_attn_block, "swa": init_attn_block,
         "rglru": init_rglru, "mlstm": init_mlstm, "slstm": init_slstm}


def init_block_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    if kind in ("attn", "swa"):
        return init_attn_cache(cfg, kind, batch, max_len, dtype, device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return init_slstm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def apply_block(kind: str, x, p, cfg, cache, positions, pos0, x32=None):
    """Returns (x, cache, aux_loss or None, x's unrounded float32 value)."""
    if kind in ("attn", "swa"):
        return attn_block(x, p, cfg, kind, cache, positions, pos0, x32)
    if kind == "rglru":
        x, c, x32 = rglru_block(x, p, cfg, cache, x32)
    elif kind == "mlstm":
        x, c, x32 = mlstm_block(x, p, cfg, cache, x32)
    elif kind == "slstm":
        x, c, x32 = slstm_block(x, p, cfg, cache, x32)
    else:
        raise ValueError(kind)
    return x, c, None, x32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _codebook_logits(x, head):
    return torch.einsum("bsd,cdv->bscv", x, head)


def member_placements(cfg: ModelConfig, shardings: Dict[str, Any]
                      ) -> Dict[str, Placement]:
    """The Placement of each parameter of an `LM` of `cfg` (its
    state-dict name) that a rank holds as a slice under `shardings` (a
    tree of Placements over `LM.param_tree()`'s layout, as
    `param_shardings` gives it): a stacked leaf's placement without its
    stacking dim.  A parameter is whole on every rank, and has no entry,
    where its placement splits nothing, where it is a vector (the blocks
    use norms, biases and gates whole, so they stay whole from placement
    on), or where its leaf is split on the stacking dim (no
    configuration's serve placement does that)."""
    out: Dict[str, Placement] = {}

    def walk(prefix: str, tree, stacked: bool):
        for k, pl in tree.items():
            if isinstance(pl, dict):
                walk(f"{prefix}{k}.", pl, stacked)
                continue
            spec = pl.spec
            if stacked:
                if split_axes(pl.mesh, spec[:1]):
                    continue
                spec = spec[1:]
            member = Placement(pl.mesh, tuple(spec))
            if len(spec) > 1 and split_dims(member):
                out[prefix + k] = member

    period = len(cfg.block_pattern)
    for i, tree in enumerate(shardings["blocks"]):
        for c in range(cfg.pattern_cycles):
            walk(f"blocks.{c * period + i}.", tree, True)
    for j, tree in enumerate(shardings["rem"]):
        walk(f"blocks.{cfg.pattern_cycles * period + j}.", tree, False)
    walk("", {k: v for k, v in shardings.items()
              if k in ("embed", "head", "final_norm")}, False)
    return out


class LM(nn.Module):
    """The language model of `cfg` on `device` (None: CUDA).  Its
    parameters are drawn from `generator`, or from a generator on the
    device seeded with `seed`; on the meta device nothing is drawn (the
    parameter counts, or `load_state_dict(..., assign=True)` of
    `convert.lm_params_from_repro`'s state).  With `shardings` (see the
    module's docstring) a rank keeps only its slices: each block is drawn
    whole and cut, so a rank's peak while it places the weights is its
    slices plus one whole block (or the embedding or head, if larger)."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 shardings: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(seed)
        self.init(generator, dev, {} if shardings is None
                  else member_placements(cfg, shardings))

    # -- params ---------------------------------------------------------------

    def init(self, gen: Optional[torch.Generator], device,
             placements: Optional[Dict[str, Placement]] = None) -> None:
        """Draws every parameter, in stack order: embed, the blocks, the
        head (float32 draws cast to param_dtype, as `dense_init`); a
        parameter named in `placements` is cut to this rank's slice as
        soon as its block is drawn."""
        cfg = self.cfg
        dtype = _dtype(cfg)
        placements = placements or {}

        def cut(prefix: str, t):
            if isinstance(t, dict):
                return {k: cut(f"{prefix}{k}.", v) for k, v in t.items()}
            pl = placements.get(prefix[:-1])
            return t if pl is None else reshard(t, pl)

        if cfg.n_codebooks:
            shape = (cfg.n_codebooks, cfg.vocab_size, cfg.d_model)
        else:
            shape = (cfg.vocab_size, cfg.d_model)
        self.embed = _param(cut("embed.", L.normal(gen, shape, 0.02, dtype,
                                                    device)))
        pattern = cfg.block_pattern
        self.blocks = nn.ModuleList(
            Block(kind, cut(f"blocks.{i}.",
                            _INIT[kind](gen, cfg, dtype, device)))
            for i, kind in ((i, pattern[i % len(pattern)])
                            for i in range(cfg.n_layers)))
        self.final_norm = nn.Parameter(L.vector(cfg.d_model, 1.0, device))
        head = None
        if not cfg.tie_embeddings:
            if cfg.n_codebooks:
                head = L.normal(gen, (cfg.n_codebooks, cfg.d_model,
                                      cfg.vocab_size), 0.02, dtype, device)
            else:
                head = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                    device)
            head = _param(cut("head.", head))
        self.head = head

    def assign_params(self, state: Dict[str, torch.Tensor]) -> "LM":
        """Every parameter replaced by the tensor of its name in `state`:
        `load_state_dict(state, assign=True)` for a rank's slices too
        (`convert.lm_params_from_repro(..., shardings=)`), each keeping its
        placement.  `state` names every parameter."""
        names = set(dict(self.named_parameters()))
        if set(state) != names:
            raise KeyError(f"state and model differ: missing "
                           f"{sorted(names - set(state))[:4]}, unexpected "
                           f"{sorted(set(state) - names)[:4]}")
        for name, t in state.items():
            mod, _, attr = name.rpartition(".")
            setattr(self.get_submodule(mod) if mod else self, attr, _param(t))
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_tree(self) -> Dict[str, Any]:
        """The parameters in the reference's tree: {"blocks": one dict a
        pattern position, each leaf a `Stacked` of that position's
        parameter over the cycles; "embed"; "final_norm"; "head" where
        untied; "rem": one dict a remainder layer}.  Its leaves are this
        module's own parameters, so JAX's flatten order and paths hold for
        the optimizer state and checkpoints built over it."""
        cfg = self.cfg
        period = len(cfg.block_pattern)
        n_cyc = cfg.pattern_cycles

        def stack(trees):
            first = trees[0]
            if isinstance(first, dict):
                return {k: stack([t[k] for t in trees]) for k in first}
            pl = placement_of(first)
            return with_placement(Stacked(trees), None if pl is None else
                                  Placement(pl.mesh, (None,) + pl.spec))

        blocks = tuple(
            stack([self.blocks[c * period + i].tree() for c in range(n_cyc)])
            for i in range(period)) if n_cyc else ()
        tree: Dict[str, Any] = {
            "blocks": blocks, "embed": self.embed,
            "final_norm": self.final_norm,
            "rem": tuple(self.blocks[n_cyc * period + i].tree()
                         for i in range(cfg.pattern_remainder))}
        if self.head is not None:
            tree["head"] = self.head
        return tree

    # -- caches -----------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        dtype = _dtype(cfg)
        return {"pos": 0,
                "layers": [init_block_cache(cfg, blk.kind, batch, max_len,
                                            dtype, self.device)
                           for blk in self.blocks]}

    # -- embedding / head ---------------------------------------------------------

    def _embed(self, tokens, patch_embeds=None):
        """The stream of the embedded tokens after the patch embeddings:
        within `act.seq_split`, the rank's positions."""
        cfg = self.cfg
        sh = act.seq_shard()
        if sh is not None:
            s_all = tokens.shape[1] + (0 if patch_embeds is None
                                       else patch_embeds.shape[1])
            if s_all % sh.n:
                raise ValueError(
                    f"a sequence of {s_all} positions does not split over "
                    f"{sh.n} ranks of \"model\": training under the \"tp\" "
                    f"rules needs a length they divide")
            if patch_embeds is None:
                lo, hi = sh.span(s_all // sh.n)
                tokens = tokens[:, lo:hi]
        if cfg.n_codebooks:
            # tokens [B, S, n_cb]: summed codebook embeddings
            x = sum(tp.lookup(tp.index(self.embed, c), tokens[..., c])
                    for c in range(cfg.n_codebooks))
        else:
            x = tp.lookup(self.embed, tokens)
        if patch_embeds is not None:
            x = tp.seq_take(torch.cat([patch_embeds.to(x.dtype), x], dim=1))
        return constrain(x, "dp", "sp", None)

    def _head(self, x, x32=None):
        cfg = self.cfg
        xf = L.rmsnorm(x, self.final_norm, cfg.norm_eps, x32)
        # the logits whole on every rank (each rank's picks agree)
        if cfg.n_codebooks:
            return tp.matmul(xf, self.head, fn=_codebook_logits)
        return tp.matmul(xf, tp.transpose(self.embed) if cfg.tie_embeddings
                         else self.head)

    # -- layer stack -----------------------------------------------------------------

    def _run_blocks(self, x, caches: Optional[List[dict]], positions,
                    pos0: Optional[int]):
        """Returns (x, aux_loss, x's unrounded float32 value or None).

        The reference scans the pattern over the cycles and unrolls the
        remainder: a block reads its predecessor's unrounded sum
        (`layers.residual`) except where a scan iteration or the remainder
        begins, whose input went through the scan's carry (rounded).  So
        each cycle starts from the rounded stream, and with `cfg.remat`
        (and a graph being recorded) a cycle is recomputed in the backward
        pass, as the reference's `jax.remat(cycle)`."""
        cfg = self.cfg
        period = len(cfg.block_pattern)
        scanned = cfg.pattern_cycles * period
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat and caches is None and torch.is_grad_enabled()
        for start in range(0, scanned, period):
            layers = range(start, start + period)
            if remat:
                x, aux_total = checkpoint(
                    self._cycle_carry, layers, x, aux_total, positions,
                    use_reentrant=False,
                    context_fn=act.checkpoint_contexts)
            else:
                x, aux_total, _ = self._cycle(layers, x, aux_total, caches,
                                              positions, pos0)
        x32 = None
        if cfg.pattern_remainder:
            x, aux_total, x32 = self._cycle(range(scanned, cfg.n_layers), x,
                                            aux_total, caches, positions,
                                            pos0)
        return x, aux_total, x32

    def _cycle(self, layers, x, aux_total, caches, positions, pos0):
        """The blocks `layers` in order from the rounded stream `x`:
        (x, aux_total plus theirs, the last block's unrounded sum)."""
        x32 = None
        for i in layers:
            blk = self.blocks[i]
            c_i = caches[i] if caches is not None else None
            x, _, aux, x32 = apply_block(blk.kind, x, blk, self.cfg, c_i,
                                         positions, pos0, x32)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total, x32

    def _cycle_carry(self, layers, x, aux_total, positions):
        """One cycle without a cache: the scan's carry (x, aux_total)."""
        x, aux_total, _ = self._cycle(layers, x, aux_total, None, positions,
                                      None)
        return x, aux_total

    # -- public entry points ------------------------------------------------------------

    def forward_train(self, tokens, patch_embeds=None):
        """Full forward, no cache. Returns (logits, aux_loss)."""
        x = self._embed(tokens, patch_embeds)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        x, aux, x32 = self._run_blocks(x, None, positions, None)
        return self._head(x, x32), aux

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Chunked cross-entropy: the [B, S, V] logits are never whole in
        memory.  The head product and the cross-entropy run per chunk of
        256 positions, each recomputed in the backward pass (the
        reference's `jax.remat` body), with float32 logits.

        batch: {tokens [B, S(, n_cb)] int32, (patch_embeds [B, P, D])}.
        Returns the float32 scalar mean negative log-likelihood of the
        next token (over the codebooks' mean) plus 0.01 x the MoE
        load-balance loss.  Where the batch's rows are split over ranks
        (`act.batch_split`), the mean and the load-balance statistics run
        over every rank's rows.  In a train context whose rules split the
        sequence ("sp" over "model", the "tp" policy) the loss runs
        within `act.seq_split`: each rank carries its positions of the
        stream, predicts their next tokens, and the sums run over every
        rank's positions (`act.psum_seq`)."""
        axes = act.seq_axes()
        if not axes:
            return self._loss(batch)
        with act.seq_split(act.current_rules().mesh, axes):
            return self._loss(batch)

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(tokens, batch.get("patch_embeds"))
        b, s = x.shape[0], x.shape[1]
        sh = act.seq_shard()
        lo = 0 if sh is None else sh.span(s)[0]
        pos = lo + torch.arange(s, dtype=torch.int32, device=x.device)
        x, aux, x32 = self._run_blocks(x, None, pos.expand(b, s), None)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps, x32)
        if sh is None:
            if cfg.patch_prefix:
                x = x[:, cfg.patch_prefix:]
            x = x[:, :-1]
            labels, weights = tokens[:, 1:].long(), None
        else:
            # position p predicts text token p - P + 1, where there is one
            nxt = pos.long() - cfg.patch_prefix + 1
            real = (nxt >= 1) & (nxt < tokens.shape[1])
            labels = tokens[:, nxt.clamp(0, tokens.shape[1] - 1)].long()
            weights = real.float().expand(b, s)
        total, count = self.chunked_nll(x, labels, weights)
        # over every rank's positions and rows where they are split
        total = psum_batch(psum_seq(total))
        count = psum_batch(psum_seq(count))
        return total / torch.clamp(count, min=1.0) + 0.01 * aux

    def chunked_nll(self, x, labels, weights=None):
        """(sum of the next-token NLL, count of real positions) of hidden
        states x [B, T, D] against labels [B, T(, n_cb)] (`weights` [B, T]
        marks the real positions: all of them when None): the head
        product and the cross-entropy per chunk of 256 positions, each
        recomputed in the backward pass (the reference's `jax.remat`
        body), the tail chunk padded with zero weights."""
        chunk = max(1, min(256, x.shape[1]))
        n_chunk = -(-x.shape[1] // chunk)
        pad = n_chunk * chunk - x.shape[1]
        if weights is None:
            weights = torch.ones(x.shape[:2], dtype=torch.float32,
                                 device=x.device)
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            labels = F.pad(labels, (0, 0) * (labels.dim() - 2) + (0, pad))
            weights = F.pad(weights, (0, pad))

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n_chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            total = total + checkpoint(self._chunk_nll, x[:, sl],
                                       labels[:, sl], weights[:, sl],
                                       use_reentrant=False)
        return total, weights.sum()

    def _chunk_nll(self, xc, lc, wc):
        """Sum over a chunk of the weighted next-token NLL (float32)."""
        cfg = self.cfg
        if cfg.n_codebooks:
            logits = torch.einsum("bsd,cdv->bscv", xc, self.head).float()
            logits = constrain(logits, "dp", "tp", None, None)
        else:
            head = self.embed.T if cfg.tie_embeddings else self.head
            logits = constrain((xc @ head).float(), "dp", "tp", None)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        nll = logz - gold
        if cfg.n_codebooks:
            nll = torch.mean(nll, dim=-1)
        return torch.sum(nll * wc)

    def prefill(self, tokens, cache, patch_embeds=None):
        """Writes the cache; returns (last-token logits, cache)."""
        x = self._embed(tokens, patch_embeds)
        b, s = x.shape[0], x.shape[1]
        pos0 = cache["pos"]
        positions = (pos0 + torch.arange(s, dtype=torch.int32,
                                         device=x.device)).expand(b, s)
        x, _, _ = self._run_blocks(x, cache["layers"], positions, pos0)
        cache["pos"] = pos0 + s
        # the reference slices before its final norm: the rounded stream
        return self._head(x[:, -1:]), cache

    def decode_step(self, tokens, cache):
        """tokens [B,1(,n_cb)]; returns (logits [B,1,V(,cb)], cache)."""
        x = self._embed(tokens)
        b = x.shape[0]
        pos0 = cache["pos"]
        positions = torch.full((b, 1), pos0, dtype=torch.int32,
                               device=x.device)
        x, _, x32 = self._run_blocks(x, cache["layers"], positions, pos0)
        cache["pos"] = pos0 + 1
        return self._head(x, x32), cache
