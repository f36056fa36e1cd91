"""The port's LM layers and architectures against `repro`'s.

Every layer function of `repro_torch.models` against its reference on the
same numpy-seeded inputs, then six architectures' smoke configs (the other
four are in tests/test_torch_models_zoo.py) in float32 and in bf16:
`forward_train`, `prefill` and four `decode_step`s, logits and caches
after every step, with the reference's weights loaded through
`convert.lm_params_from_repro`.  Bars in tests/torch_lm_parity.py; the
layer functions in float32 are held at rtol = atol = 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import recurrent as RR  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import act  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from torch_lm_parity import as_np, close, pair, run_arch  # noqa: E402
from torch_lm_parity import to_torch as _t  # noqa: E402

torch.set_num_threads(1)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tight(got, want, what=""):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5,
                               atol=1e-5, err_msg=what)


# -- layer functions -----------------------------------------------------------

def test_rmsnorm_rope_swiglu_head_norm():
    rng = np.random.default_rng(0)
    x, w = _f32(rng, 2, 5, 32), _f32(rng, 32)
    _tight(TL.rmsnorm(_t(x), _t(w)), RL.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.tile(np.arange(7, 12, dtype=np.int32), (2, 1))
    cj, sj = RL.rope_tables(jnp.asarray(pos), 16, 1e6)
    ct, st = TL.rope_tables(_t(pos), 16, 1e6)
    _tight(ct, cj, "cos")
    _tight(st, sj, "sin")
    q = _f32(rng, 2, 5, 3, 16)
    _tight(TL.apply_rope(_t(q), ct, st), RL.apply_rope(jnp.asarray(q), cj, sj))
    w1, w3, w2 = _f32(rng, 32, 48, scale=0.2), _f32(rng, 32, 48, scale=0.2), \
        _f32(rng, 48, 32, scale=0.2)
    for act_name in ("silu", "gelu"):
        _tight(TL.swiglu(_t(x), _t(w1), _t(w3), _t(w2), act_name),
               RL.swiglu(*map(jnp.asarray, (x, w1, w3, w2)), act_name),
               act_name)
    hn = _f32(rng, 16)
    _tight(TM._head_norm(_t(q), _t(hn), 1e-6),
           RM._head_norm(jnp.asarray(q), jnp.asarray(hn), 1e-6))


def test_activations_bitwise_in_bf16():
    """silu, sigmoid and gelu spelled as JAX composes them give XLA's bf16
    bits; the float32 product `silu32` rounds to the same bits."""
    rng = np.random.default_rng(1)
    xj = jnp.asarray(_f32(rng, 4096, scale=3.0), jnp.bfloat16)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    for tf, jf in ((TL.silu, jax.nn.silu), (TL.sigmoid, jax.nn.sigmoid),
                   (TL.gelu, jax.nn.gelu)):
        np.testing.assert_array_equal(as_np(tf(xt)), as_np(jax.jit(jf)(xj)))
    np.testing.assert_array_equal(as_np(TL.silu32(xt).to(torch.bfloat16)),
                                  as_np(TL.silu(xt)))


@pytest.mark.parametrize("case", [
    "decode", "chunked_padded", "triangular", "window", "decode_window"])
@pytest.mark.parametrize("g", [1, 3])
def test_flash_attention(case, g):
    """The decode path, a chunked path padded on both axes (kv slots past
    the cache fill masked by pos = -1), the causal triangle, a window; GQA
    with G query heads a KV head."""
    rng = np.random.default_rng(2)
    b, kv, d = 2, 2, 16
    sq = 1 if case.startswith("decode") else 21
    skv = 37 if case in ("decode", "chunked_padded", "decode_window") else 21
    q = _f32(rng, b, sq, kv * g, d)
    k, v = _f32(rng, b, skv, kv, d), _f32(rng, b, skv, kv, d)
    if case.startswith("decode"):
        q_pos = np.full((b, 1), 30, np.int32)
        kv_pos = np.where(np.arange(skv) <= 30, np.arange(skv), -1)
        kv_pos = np.tile(kv_pos.astype(np.int32), (b, 1))
    elif case == "chunked_padded":
        q_pos = np.tile(np.arange(10, 10 + sq, dtype=np.int32), (b, 1))
        kv_pos = np.where(np.arange(skv) < 31, np.arange(skv), -1)
        kv_pos = np.tile(kv_pos.astype(np.int32), (b, 1))
    else:
        q_pos = np.tile(np.arange(sq, dtype=np.int32), (b, 1))
        kv_pos = q_pos.copy()
    kw = dict(window=6 if "window" in case else None, q_chunk=8, kv_chunk=8,
              triangular=case in ("triangular", "window"))
    want = RL.flash_attention(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                              **kw)
    got = TL.flash_attention(*map(_t, (q, k, v, q_pos, kv_pos)), **kw)
    _tight(got, want)


def test_flash_attention_gqa_head_order():
    """Query head h reads KV head h // G: two KV heads with different
    values give different outputs on the two halves of the query heads."""
    rng = np.random.default_rng(3)
    q = _t(_f32(rng, 1, 4, 4, 8))
    k = _t(_f32(rng, 1, 4, 2, 8))
    v = torch.zeros(1, 4, 2, 8)
    v[:, :, 1] = 1.0
    pos = torch.arange(4, dtype=torch.int32)[None]
    o = TL.flash_attention(q, k, v, pos, pos, q_chunk=4, kv_chunk=4,
                           triangular=True)
    assert torch.all(o[:, :, :2] == 0) and torch.allclose(
        o[:, :, 2:], torch.ones(1, 4, 2, 8))


def test_causal_conv_and_lru_scan():
    rng = np.random.default_rng(4)
    u, w, st = _f32(rng, 2, 9, 8), _f32(rng, 4, 8), _f32(rng, 2, 3, 8)
    for state in (None, st):
        yj, sj = jax.jit(RR.causal_conv)(
            jnp.asarray(u), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        yt, s_t = TR.causal_conv(_t(u), _t(w),
                                 None if state is None else _t(state))
        _tight(yt, yj)
        _tight(s_t, sj)
    for s in (1, 2, 7, 16, 33):
        a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
        bb, h0 = _f32(rng, 2, s, 8), _f32(rng, 2, 8)
        _tight(TR.lru_scan(_t(a), _t(bb), _t(h0)),
               jax.jit(RR.lru_scan)(*map(jnp.asarray, (a, bb, h0))),
               f"S={s}")


def test_top_k_breaks_ties_by_lower_index():
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.0], [0.1, 0.1, 0.1, 0.1, 0.6]],
                 np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 3)
    vt, it = TMOE.top_k(_t(x), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_moe_drops_past_capacity():
    """capacity_factor 1.0: some (token, expert) choices are dropped; the
    output and the aux loss equal the reference's."""
    cr, _, params, ct, tm = pair("mixtral-8x7b", "float32",
                                 capacity_factor=1.0)
    p = jax.tree.map(lambda a: a[0], params["blocks"][0]["moe"])
    x = _f32(np.random.default_rng(5), 2, 24, cr.d_model)
    yj, auxj = jax.jit(lambda x, p: RMOE.moe_ffn(x, p, cr))(jnp.asarray(x), p)
    yt, auxt = TMOE.moe_ffn(_t(x), tm.blocks[0].moe, ct)
    close(yt, yj, "float32", "moe")
    close(auxt, auxj, "float32", "aux")
    t, k, e = 48, ct.top_k, ct.n_experts
    _, top_i = TMOE.top_k(torch.softmax(_t(x).reshape(t, -1)
                                        @ tm.blocks[0].moe.router, -1), k)
    per_expert = torch.bincount(top_i.reshape(-1), minlength=e)
    assert int(per_expert.max()) > TMOE.capacity(ct, t), "nothing dropped"


def test_act_hooks():
    """Outside a context the hooks are the identity; inside one they
    answer from the sharding rules: one device is the identity, a "dp"
    split without a process group raises and names it; a "tp" split in a
    serve context without a process group raises and names it, and so
    does one outside a serve context (training under "tp";
    tests/test_torch_train.py holds the rules,
    tests/test_torch_train_fsdp.py, tests/test_torch_tp.py and
    tests/test_torch_tp_train.py the splits on ranks)."""
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.mesh import make_mesh
    x = torch.ones(2)
    assert act.constrain(x, "dp") is x
    assert act.axis_size("tp") == 1 and act.is_serve() is False
    with act.activation_sharding(ShardingRules(make_mesh((1, 1),
                                                         ("data", "model")),
                                               "tp")):
        assert act.constrain(x, "tp") is x
    rules = ShardingRules(make_mesh((2, 1), ("data", "model")), "dp")
    with act.activation_sharding(rules, serve=True):
        assert act.axis_size("tp") == 1 and act.axis_size("dp") == 2
        assert act.is_serve() is True
        with pytest.raises(RuntimeError, match="process group"):
            act.constrain(x, "dp")
    tp = ShardingRules(make_mesh((1, 2), ("data", "model")), "tp")
    with act.activation_sharding(tp, serve=True):
        with pytest.raises(RuntimeError, match="process group"):
            act.constrain(x, "tp")
    with act.activation_sharding(tp):
        with pytest.raises(RuntimeError, match="process group"):
            act.constrain(x, "tp")
    assert act.axis_size("tp") == 1
    assert act.batch_shards() == 1 and act.psum_batch(x) is x


# -- whole architectures ---------------------------------------------------------

#: this file's architectures; the others are in tests/test_torch_models_zoo.py
ARCHS = ["minicpm-2b", "qwen3-32b", "qwen2.5-14b", "phi4-mini-3.8b",
         "pixtral-12b", "musicgen-medium"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_arch(name, dtype):
    run_arch(name, dtype)


@pytest.mark.parametrize("name", rconfigs.ARCH_NAMES)
def test_n_params_match_reference(name):
    """The copied configs equal the reference's, and so do the parameter
    counts (the port's LM on the meta device, the reference's eval_shape)."""
    cfg_r, cfg_t = rconfigs.get(name), tconfigs.get(name)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_r)
    assert dataclasses.asdict(tconfigs.get_smoke(name)) == \
        dataclasses.asdict(rconfigs.get_smoke(name))
    assert cfg_t.n_params() == cfg_r.n_params()
    assert cfg_t.n_active_params() == cfg_r.n_active_params()
