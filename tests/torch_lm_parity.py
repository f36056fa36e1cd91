"""Shared set-up of the LM parity tests (tests/test_torch_models*.py,
tests/test_torch_lm_serve.py): one reference model and its port twin per
(architecture, dtype), loaded from the reference's own weights through
`convert.lm_params_from_repro`, and the bars.

Bars.  float32 (the smoke config with param_dtype="float32"): rtol = atol =
1e-4; the two packages differ only in summation order and in the last bits
of float32 transcendentals, and a bf16 slip anywhere misses this bar by two
orders of magnitude.  bf16 (the configs' own dtype): rtol = atol = 2e-2,
the reference's own bar for prefill against forward_train
(tests/test_arch_smoke.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as rconfigs
from repro.models import LM as RLM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import LM as TLM

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def _ref_params_f32(name: str):
    cfg = dataclasses.replace(rconfigs.get_smoke(name), param_dtype="float32")
    return RLM(cfg).init(jax.random.PRNGKey(0))


def ref_params(cfg):
    """The reference's `LM(cfg).init(PRNGKey(0))` for a smoke config: its
    init draws every matrix in float32 and casts it to param_dtype, so
    the bf16 weights are the float32 draw cast where the bf16 init casts
    (one init a name, whatever the dtype)."""
    f32 = _ref_params_f32(cfg.name[:-len("-smoke")])
    want = jax.eval_shape(lambda: RLM(cfg).init(jax.random.PRNGKey(0)))
    return jax.tree.map(lambda a, w: a.astype(w.dtype), f32, want)


@functools.lru_cache(maxsize=None)
def pair(name: str, dtype: str, **overrides):
    """(reference cfg, reference LM, its params, port cfg, port LM)."""
    cr = dataclasses.replace(rconfigs.get_smoke(name), param_dtype=dtype,
                             **overrides)
    ct = dataclasses.replace(tconfigs.get_smoke(name), param_dtype=dtype,
                             **overrides)
    rm = RLM(cr)
    params = ref_params(cr)
    tm = TLM(ct, device="meta")
    tm.load_state_dict(convert.lm_params_from_repro(
        ct, jax.tree.map(np.asarray, params), device="cpu"), assign=True)
    return cr, rm, params, ct, tm


@functools.lru_cache(maxsize=None)
def jitted(name: str, dtype: str, **overrides):
    """The reference's forward_train / prefill / decode_step, jitted once."""
    _, rm, _, _, _ = pair(name, dtype, **overrides)
    return (jax.jit(rm.forward_train), jax.jit(rm.prefill),
            jax.jit(rm.decode_step))


def inputs(cfg, b: int, s: int, seed: int = 0):
    """numpy tokens [b, s(, n_cb)] and patch embeddings (or None)."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    pe = None
    if cfg.patch_prefix:
        pe = rng.standard_normal((b, cfg.patch_prefix, cfg.d_model)).astype(
            np.float32)
    return toks, pe


def to_torch(a) -> torch.Tensor:
    """A CPU tensor holding a copy of the array `a`."""
    return torch.from_numpy(np.array(a))



def as_np(x) -> np.ndarray:
    """float32 numpy of a jax or torch array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, dtype: str, what: str = "") -> None:
    tol = TOL[dtype]
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol,
                               err_msg=what)


def same_cache(cfg, ref_cache, port_cache, dtype: str, what: str) -> None:
    """The port's cache equals the reference's (converted) at the bar."""
    want = convert.lm_cache_from_repro(
        cfg, jax.tree.map(np.asarray, ref_cache), device="cpu")
    assert want["pos"] == port_cache["pos"], what
    for i, (lw, lg) in enumerate(zip(want["layers"], port_cache["layers"])):
        assert lw.keys() == lg.keys(), (what, i)
        for k in lw:
            close(lg[k], lw[k], dtype, f"{what}: layer {i} {k}")


def run_arch(name: str, dtype: str, b: int = 2, s: int = 20,
             n_decode: int = 4):
    """forward_train over s + n_decode tokens, then prefill of s and
    n_decode decode steps on the reference's own tokens, in both packages;
    logits and caches compared after every step."""
    cr, rm, params, ct, tm = pair(name, dtype)
    fwd, pre, dec = jitted(name, dtype)
    toks, pe = inputs(cr, b, s + n_decode)
    pej = () if pe is None else (jnp.asarray(pe),)
    pet = None if pe is None else to_torch(pe)
    with torch.no_grad():
        lr, aux_r = fwd(params, jnp.asarray(toks), *pej)
        lt, aux_t = tm.forward_train(to_torch(toks), pet)
        close(lt, lr, dtype, f"{name} forward_train")
        close(aux_t, aux_r, dtype, f"{name} aux")

        max_len = 32 + cr.patch_prefix
        rc, tc = rm.init_cache(b, max_len), tm.init_cache(b, max_len)
        lr, rc = pre(params, jnp.asarray(toks[:, :s]), rc, *pej)
        lt, tc = tm.prefill(to_torch(toks[:, :s]), tc, pet)
        close(lt, lr, dtype, f"{name} prefill")
        same_cache(ct, rc, tc, dtype, f"{name} prefill cache")
        for j in range(n_decode):
            tok = toks[:, s + j:s + j + 1]
            lr, rc = dec(params, jnp.asarray(tok), rc)
            lt, tc = tm.decode_step(to_torch(tok), tc)
            close(lt, lr, dtype, f"{name} decode {j}")
            same_cache(ct, rc, tc, dtype, f"{name} decode {j} cache")
