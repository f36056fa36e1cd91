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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.act import constrain, psum_batch
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
                self.register_parameter(name, nn.Parameter(t))

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


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    dtype, device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
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

    hnorm = L.rmsnorm(x, p.ln1, cfg.norm_eps, x32)
    q = hnorm @ p.wq
    k = hnorm @ p.wk
    v = hnorm @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    q = constrain(q.reshape(b, s, h_, hd), "dp", None, "tp", None)
    k = constrain(k.reshape(b, s, kv, hd), "dp", None, "tp", None)
    v = constrain(v.reshape(b, s, kv, hd), "dp", None, "tp", None)
    if cfg.qk_norm:
        q = _head_norm(q, p.q_norm, cfg.norm_eps)
        k = _head_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.use_rope:
        cos, sin = L.rope_tables(positions, hd, cfg.rope_base)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)

    # a prefill (s > 1) attends within its own sequence: the cache write
    # never feeds the attention read
    kk, vv, kv_pos, triangular = k, v, positions, True
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

    o = L.flash_attention(q, kk, vv, positions, kv_pos, window=window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                          triangular=triangular)
    # wo / w2: a float32 sum rounded once to the activation dtype (the
    # reference's reduce_dtype only changes a sharded reduction's wire type)
    x, x32 = L.residual(x, o.reshape(b, s, h_ * hd) @ p.wo)
    x = constrain(x, "dp", "sp", None)

    h2 = L.rmsnorm(x, p.ln2, cfg.norm_eps, x32)
    aux = None
    if cfg.moe:
        ffn, aux = moe_ffn(h2, p.moe, cfg)
    else:
        h1 = constrain(L.activation(h2 @ p.w1, cfg.act), "dp", None, "tp")
        ffn = (h1 * (h2 @ p.w3)) @ p.w2
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

class LM(nn.Module):
    """The language model of `cfg` on `device` (None: CUDA).  Its
    parameters are drawn from `generator`, or from a generator on the
    device seeded with `seed`; on the meta device nothing is drawn (the
    parameter counts, or `load_state_dict(..., assign=True)` of
    `convert.lm_params_from_repro`'s state)."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(seed)
        self.init(generator, dev)

    # -- params ---------------------------------------------------------------

    def init(self, gen: Optional[torch.Generator], device) -> None:
        """Draws every parameter, in stack order: embed, the blocks, the
        head (float32 draws cast to param_dtype, as `dense_init`)."""
        cfg = self.cfg
        dtype = _dtype(cfg)
        if cfg.n_codebooks:
            shape = (cfg.n_codebooks, cfg.vocab_size, cfg.d_model)
        else:
            shape = (cfg.vocab_size, cfg.d_model)
        self.embed = nn.Parameter(L.normal(gen, shape, 0.02, dtype, device))
        pattern = cfg.block_pattern
        self.blocks = nn.ModuleList(
            Block(kind, _INIT[kind](gen, cfg, dtype, device))
            for kind in (pattern[i % len(pattern)]
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
            head = nn.Parameter(head)
        self.head = head

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
            return Stacked(trees)

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
        cfg = self.cfg
        if cfg.n_codebooks:
            # tokens [B, S, n_cb]: summed codebook embeddings
            x = sum(self.embed[c][tokens[..., c]]
                    for c in range(cfg.n_codebooks))
        else:
            x = self.embed[tokens]
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        return constrain(x, "dp", "sp", None)

    def _head(self, x, x32=None):
        cfg = self.cfg
        xf = L.rmsnorm(x, self.final_norm, cfg.norm_eps, x32)
        if cfg.n_codebooks:
            return torch.einsum("bsd,cdv->bscv", xf, self.head)
        return xf @ (self.embed.T if cfg.tie_embeddings else self.head)

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
                x, aux_total = checkpoint(self._cycle_carry, layers, x,
                                          aux_total, positions,
                                          use_reentrant=False)
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
        over every rank's rows."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(tokens, batch.get("patch_embeds"))
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        x, aux, x32 = self._run_blocks(x, None, positions, None)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps, x32)
        if cfg.patch_prefix:
            x = x[:, cfg.patch_prefix:]
        x = x[:, :-1]
        labels = tokens[:, 1:].long()
        total, count = self.chunked_nll(x, labels)
        # over every rank's rows where the batch is split (`act.batch_split`)
        total, count = psum_batch(total), psum_batch(count)
        return total / torch.clamp(count, min=1.0) + 0.01 * aux

    def chunked_nll(self, x, labels):
        """(sum of the next-token NLL, count of real positions) of hidden
        states x [B, T, D] against labels [B, T(, n_cb)]: the head product
        and the cross-entropy per chunk of 256 positions, each recomputed
        in the backward pass (the reference's `jax.remat` body), the tail
        chunk padded with zero weights."""
        chunk = max(1, min(256, x.shape[1]))
        n_chunk = -(-x.shape[1] // chunk)
        pad = n_chunk * chunk - x.shape[1]
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
