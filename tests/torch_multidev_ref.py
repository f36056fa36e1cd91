"""The reference side of tests/test_torch_pipeline.py and
tests/test_torch_train_fsdp.py: `repro` on four host devices.

    python tests/torch_multidev_ref.py OUT.pkl PART [PART ...]

runs in a process of its own (the test processes keep one JAX device)
and pickles {part: result} to OUT.pkl.  Importing it (for its constants,
which the port's rank side shares) imports no JAX.  Parts:

  pipeline - tests/test_pipeline.py's problem through the reference's
             `make_pipelined_loss` at n_micro 4 and 1: loss and grads
  fsdp     - minicpm-2b and mixtral-8x7b at their float32 smoke configs
             on a (4, 1) ("data", "model") mesh under the "dp" rules (the
             mesh built directly: `jax.make_mesh` stops on JAX 0.9): the
             loss and grads, one `make_train_step` step at
             accum 1 and 2; for the MoE (its capacity factor cut to 1,
             `OVERRIDES`) the one-device loss beside them and a step on a
             batch of 6 rows, which the dp axis does not divide; the
             param/batch shardings' specs of every smoke architecture on
             (4, 1) and (2, 2)
  tp_a, tp_b - tests/test_torch_tp*.py's serving cases (`TP_CASES`):
             each smoke architecture of the part in float32 and bf16 on
             one device, from `LM(cfg).init(PRNGKey(0))` (the weights
             the port's world converts): prefill of `TP_S` tokens and
             `TP_STEPS` decode steps fed the prompt's next tokens, the
             logits of each; and greedy tokens (`TP_STEPS` of them:
             prefill, then decode steps on the picks).  For the
             recurrent bf16 cases also the spread of the forward's logits
             when one embedding weight of a prompt token moves by one ulp
             (tests/test_torch_models_zoo.py's bar for them)
  tp_mesh    - the `TP_MESH` cases on a (2, 2) ("data", "model") mesh
             under the "tp" rules, as `specs.build_cell` runs a serve
             cell (params placed by `param_shardings(serve=True)`, the
             cache by `cache_shardings`, the batch by `batch_shardings`,
             the calls inside `activation_sharding(rules, serve=True)`),
             the same steps and logits; and the same cases on one device
  tp_specs   - the "tp" rules' serve param, cache and batch shardings'
             specs of every smoke architecture on (1, 2), (2, 2) and
             (1, 4)
  tp_train   - tests/test_torch_tp_train.py's training under the "tp"
             rules, from `LM(cfg).init(PRNGKey(0))` and the batch of
             `tp_train_inputs`: "one", `jax.value_and_grad(model.loss)`
             on one device (loss and grads) of every smoke architecture
             in float32 and of `TPT_BF16` in bf16; "mesh", the `TPT_MESH`
             architectures in float32 (mixtral-8x7b at capacity factor 1,
             `OVERRIDES`) on a (2, 2) ("data", "model") mesh as
             `specs.build_cell`'s train cell runs them under "tp" (params
             and moments placed by `param_shardings`, the batch by
             `batch_shardings`, the calls inside `activation_sharding
             (rules)`): the loss and grads, one `make_train_step` step at
             accum 1 and 2 (loss, grad norm, the state), and the
             one-device loss beside them
"""

import dataclasses
import os
import pickle
import sys

import numpy as np

ARCHS = ("minicpm-2b", "mixtral-8x7b")
B, S, LR = 8, 32, 3e-4
UNEVEN_B = 6
OPT = dict(peak_lr=LR, warmup_steps=2, total_steps=10)
#: the smoke MoE drops no token at its capacity factor of 8; at 1 the
#: four dp groups drop others than one group would, so a step that ranks
#: and caps the batch as one group misses the bars
OVERRIDES = {"mixtral-8x7b": {"capacity_factor": 1.0}}

#: the "tp" serving cases: (architecture, dtype) of each part
TP_ARCHS = {"tp_a": ("minicpm-2b", "qwen3-32b", "qwen2.5-14b",
                     "phi4-mini-3.8b", "pixtral-12b"),
            "tp_b": ("mixtral-8x7b", "qwen3-moe-235b-a22b",
                     "recurrentgemma-9b", "xlstm-350m", "musicgen-medium")}
TP_CASES = {part: [(a, d) for a in archs for d in ("float32", "bfloat16")]
            for part, archs in TP_ARCHS.items()}
TP_MESH = [(a, d) for a in ("qwen2.5-14b", "mixtral-8x7b")
           for d in ("float32", "bfloat16")]
TP_RECURRENT = ("recurrentgemma-9b", "xlstm-350m")
TP_B, TP_S, TP_STEPS = 2, 20, 4
TP_SPEC_SHAPES = ((1, 2), (2, 2), (1, 4))


#: training under the "tp" rules: the bf16 cases on (1, 2), the (2, 2)
#: cases, the batch (rows x positions, the patch prefix included)
TPT_BF16 = ("mixtral-8x7b", "qwen2.5-14b")
TPT_MESH = ("mixtral-8x7b", "qwen2.5-14b")
TPT_B, TPT_S = 4, 32


def tp_train_inputs(cfg, seed: int = 0):
    """numpy {"tokens" [TPT_B, TPT_S - P(, n_cb)] int32, ("patch_embeds"
    [TPT_B, P, D] float32)} of a training case."""
    rng = np.random.default_rng(seed)
    shape = (TPT_B, TPT_S - cfg.patch_prefix) + (
        (cfg.n_codebooks,) if cfg.n_codebooks else ())
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.patch_prefix:
        out["patch_embeds"] = rng.standard_normal(
            (TPT_B, cfg.patch_prefix, cfg.d_model)).astype(np.float32)
    return out


def tp_inputs(cfg, seed: int = 0):
    """numpy tokens [TP_B, TP_S + TP_STEPS(, n_cb)] and patch embeddings
    (or None) of a serving case."""
    rng = np.random.default_rng(seed)
    shape = (TP_B, TP_S + TP_STEPS) + ((cfg.n_codebooks,)
                                       if cfg.n_codebooks else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    pe = None
    if cfg.patch_prefix:
        pe = rng.standard_normal((TP_B, cfg.patch_prefix,
                                  cfg.d_model)).astype(np.float32)
    return toks, pe


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def pipeline():
    import jax
    import jax.numpy as jnp
    from repro.dist.pipeline import make_pipelined_loss
    n, m, mb, d = 4, 4, 2, 16
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(n), ("pod",))
    rng = np.random.default_rng(0)
    params = {"w": jnp.asarray(rng.standard_normal((n, d, d)) * 0.3,
                               jnp.float32),
              "b": jnp.asarray(rng.standard_normal((n, d)) * 0.1,
                               jnp.float32)}
    x = jnp.asarray(rng.standard_normal((m * mb, d)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((m * mb, d)), jnp.float32)

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"]) + p["b"]

    def loss_fn(out, y):
        return jnp.mean((out - y) ** 2)

    out = {}
    for n_micro in (4, 1):
        pipe = make_pipelined_loss(mesh, stage_fn, loss_fn, axis_name="pod",
                                   n_micro=n_micro)
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(pipe))(params, x, y)
        out[n_micro] = (float(loss), _np(grads))
    return out


def _mesh(shape):
    import jax
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                             ("data", "model"))


def fsdp():
    import jax
    from repro import configs
    from repro.data.pipeline import SyntheticTokens
    from repro.dist.act import activation_sharding
    from repro.dist.sharding import (ShardingRules, batch_shardings,
                                     param_shardings)
    from repro.models import LM
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.train_step import make_train_step

    mesh = _mesh((4, 1))
    rules = ShardingRules(mesh, "dp")
    out = {"archs": {}, "specs": {}, "overrides": OVERRIDES}
    for name in ARCHS:
        cfg = dataclasses.replace(configs.get_smoke(name),
                                  param_dtype="float32",
                                  **OVERRIDES.get(name, {}))
        model = LM(cfg)
        params = model.init(jax.random.PRNGKey(0))
        batch = SyntheticTokens(cfg.vocab_size, B, S, seed=0)(0)
        p_sh = param_shardings(rules, jax.eval_shape(lambda: params))
        state_sh = {"params": p_sh, "opt": {
            "mu": p_sh, "nu": p_sh, "step": rules.named((), [])}}

        def run(fn, *args):
            def ctx(*a):
                with activation_sharding(rules):
                    return fn(*a)
            with mesh:
                return jax.jit(ctx)(*args)

        def placed_batch(b):
            return jax.device_put(b, batch_shardings(rules, b))
        res = {"tokens": np.asarray(batch["tokens"])}
        loss, grads = run(jax.value_and_grad(model.loss),
                          jax.device_put(params, p_sh), placed_batch(batch))
        res["loss"], res["grads"] = float(loss), _np(grads)
        if cfg.moe:
            res["loss_one_device"] = float(jax.jit(model.loss)(params, batch))
        for accum in (1, 2):
            state = jax.device_put(
                {"params": params, "opt": adamw_init(params)}, state_sh)
            step = make_train_step(model, AdamWConfig(**OPT),
                                   accum_steps=accum)
            st, met = run(step, state, placed_batch(batch))
            res[f"step{accum}"] = (float(met["loss"]),
                                   float(met["grad_norm"]), _np(st))
        if cfg.moe:
            uneven = SyntheticTokens(cfg.vocab_size, UNEVEN_B, S, seed=1)(0)
            state = jax.device_put(
                {"params": params, "opt": adamw_init(params)}, state_sh)
            st, met = run(make_train_step(model, AdamWConfig(**OPT)), state,
                          placed_batch(uneven))
            res["uneven"] = (np.asarray(uneven["tokens"]), float(met["loss"]),
                             float(met["grad_norm"]), _np(st))
        out["archs"][name] = res

    def norm(spec):
        return [list(p) if isinstance(p, tuple) else p for p in spec]
    for shape in ((4, 1), (2, 2)):
        r = ShardingRules(_mesh(shape), "dp")
        for name in configs.ARCH_NAMES:
            cfg = configs.get_smoke(name)
            params = jax.eval_shape(
                lambda: LM(cfg).init(jax.random.PRNGKey(0)))
            batch = jax.eval_shape(lambda: SyntheticTokens(
                cfg.vocab_size, B, S, n_codebooks=cfg.n_codebooks,
                patch_prefix=cfg.patch_prefix, d_model=cfg.d_model,
                seed=0)(0))
            out["specs"][(shape, name)] = (
                [norm(s.spec) for s in jax.tree_util.tree_leaves(
                    param_shardings(r, params))],
                {k: norm(s.spec) for k, s in
                 batch_shardings(r, batch).items()})
    return out


def _tp_model(name, dtype, **over):
    import jax
    from repro import configs
    from repro.models import LM
    cfg = dataclasses.replace(configs.get_smoke(name), param_dtype=dtype,
                              **over)
    f32 = LM(dataclasses.replace(cfg, param_dtype="float32")).init(
        jax.random.PRNGKey(0))
    want = jax.eval_shape(lambda: LM(cfg).init(jax.random.PRNGKey(0)))
    # the bf16 init is the float32 draw cast (tests/torch_lm_parity.py)
    params = jax.tree.map(lambda a, w: a.astype(w.dtype), f32, want)
    return cfg, LM(cfg), params


def _tp_run(cfg, model, params, wrap=lambda f: f, place=lambda t, k: t):
    """Prefill and decode logits fed the prompt's next tokens, and the
    greedy tokens, of one serving case (`wrap` jits each call in a
    sharding context, `place` puts an input on its shardings)."""
    import jax.numpy as jnp
    toks, pe = tp_inputs(cfg)
    pej = () if pe is None else (place(jnp.asarray(pe), "batch"),)
    pre, dec = wrap(model.prefill), wrap(model.decode_step)

    def cache():
        return place(model.init_cache(TP_B, 32 + cfg.patch_prefix), "cache")
    logits = []
    lg, c = pre(params, place(jnp.asarray(toks[:, :TP_S]), "batch"),
                cache(), *pej)
    logits.append(np.asarray(lg.astype(jnp.float32)))
    for j in range(TP_STEPS):
        lg, c = dec(params, place(jnp.asarray(
            toks[:, TP_S + j:TP_S + j + 1]), "batch"), c)
        logits.append(np.asarray(lg.astype(jnp.float32)))
    lg, c = pre(params, place(jnp.asarray(toks[:, :TP_S]), "batch"),
                cache(), *pej)
    greedy = []
    for j in range(TP_STEPS):
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        greedy.append(np.asarray(tok))
        if j < TP_STEPS - 1:
            lg, c = dec(params, place(tok, "batch"), c)
    return {"logits": logits, "greedy": np.concatenate(greedy, axis=1)}


def _tp_spread(cfg, model, params):
    """How far the forward's bf16 logits move when one embedding weight of
    a prompt token moves by one ulp."""
    import jax
    import jax.numpy as jnp
    toks, _ = tp_inputs(cfg)
    fwd = jax.jit(model.forward_train)
    want = np.asarray(fwd(params, jnp.asarray(toks))[0].astype(jnp.float32))
    emb = params["embed"]
    tok, col = int(toks[0, 3]), 5
    bumped = dict(params, embed=emb.at[tok, col].set(jnp.nextafter(
        emb[tok, col], jnp.asarray(np.inf, emb.dtype))))
    got = np.asarray(fwd(bumped, jnp.asarray(toks))[0].astype(jnp.float32))
    return float(np.abs(got - want).max())


def _tp_serving(part):
    import jax
    out = {}
    for name, dtype in TP_CASES[part]:
        cfg, model, params = _tp_model(name, dtype)
        res = _tp_run(cfg, model, params, wrap=jax.jit)
        if dtype == "bfloat16" and name in TP_RECURRENT:
            res["spread"] = _tp_spread(cfg, model, params)
        out[(name, dtype)] = res
    return out


def tp_a():
    return _tp_serving("tp_a")


def tp_b():
    return _tp_serving("tp_b")


def tp_mesh():
    import jax
    from repro.dist.act import activation_sharding
    from repro.dist.sharding import (ShardingRules, batch_shardings,
                                     cache_shardings, param_shardings)
    mesh = _mesh((2, 2))
    rules = ShardingRules(mesh, "tp")

    def wrap(fn):
        def ctx(*a):
            with activation_sharding(rules, serve=True):
                return fn(*a)
        jitted = jax.jit(ctx)

        def call(*a):
            with mesh:
                return jitted(*a)
        return call

    def place(t, kind):
        sh = (cache_shardings if kind == "cache" else batch_shardings)(
            rules, t)
        return jax.device_put(t, sh)
    out = {"one": {}, "mesh": {}}
    for name, dtype in TP_MESH:
        cfg, model, params = _tp_model(name, dtype)
        out["one"][(name, dtype)] = _tp_run(cfg, model, params, jax.jit)
        placed = jax.device_put(params, param_shardings(rules, params,
                                                        serve=True))
        out["mesh"][(name, dtype)] = _tp_run(cfg, model, placed, wrap, place)
    return out


def tp_specs():
    import jax
    from repro import configs
    from repro.data.pipeline import SyntheticTokens
    from repro.dist.sharding import (ShardingRules, batch_shardings,
                                     cache_shardings, param_shardings)
    from repro.models import LM

    def norm(spec):
        return [list(p) if isinstance(p, tuple) else p for p in spec]
    out = {}
    for shape in TP_SPEC_SHAPES:
        n = shape[0] * shape[1]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                                 ("data", "model"))
        r = ShardingRules(mesh, "tp")
        for name in configs.ARCH_NAMES:
            cfg = configs.get_smoke(name)
            model = LM(cfg)
            params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
            cache = jax.eval_shape(lambda: model.init_cache(
                8, 32 + cfg.patch_prefix))
            batch = jax.eval_shape(lambda: SyntheticTokens(
                cfg.vocab_size, 8, 32, n_codebooks=cfg.n_codebooks,
                patch_prefix=cfg.patch_prefix, d_model=cfg.d_model,
                seed=0)(0))
            out[(shape, name)] = (
                [norm(s.spec) for s in jax.tree_util.tree_leaves(
                    param_shardings(r, params, serve=True))],
                [norm(s.spec) for s in jax.tree_util.tree_leaves(
                    cache_shardings(r, cache))],
                {k: norm(s.spec) for k, s in
                 batch_shardings(r, batch).items()})
    return out


def tp_train():
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.dist.act import activation_sharding
    from repro.dist.sharding import (ShardingRules, batch_shardings,
                                     param_shardings)
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.train_step import make_train_step

    def batch_of(cfg):
        return {k: jnp.asarray(v) for k, v in tp_train_inputs(cfg).items()}
    out = {"one": {}, "mesh": {}}
    cases = [(a, "float32") for a in configs.ARCH_NAMES] + [
        (a, "bfloat16") for a in TPT_BF16]
    for name, dtype in cases:
        cfg, model, params = _tp_model(name, dtype)
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            params, batch_of(cfg))
        out["one"][(name, dtype)] = (float(loss), _np(grads))

    mesh = _mesh((2, 2))
    rules = ShardingRules(mesh, "tp")

    def run(fn, *args):
        def ctx(*a):
            with activation_sharding(rules):
                return fn(*a)
        with mesh:
            return jax.jit(ctx)(*args)
    for name in TPT_MESH:
        cfg, model, params = _tp_model(name, "float32",
                                       **OVERRIDES.get(name, {}))
        batch = batch_of(cfg)
        p_sh = param_shardings(rules, params)
        state_sh = {"params": p_sh, "opt": {
            "mu": p_sh, "nu": p_sh, "step": rules.named((), [])}}
        placed = jax.device_put(batch, batch_shardings(rules, batch))
        res = {"loss_one_device": float(jax.jit(model.loss)(params, batch))}
        loss, grads = run(jax.value_and_grad(model.loss),
                          jax.device_put(params, p_sh), placed)
        res["loss"], res["grads"] = float(loss), _np(grads)
        for accum in (1, 2):
            state = jax.device_put(
                {"params": params, "opt": adamw_init(params)}, state_sh)
            step = make_train_step(model, AdamWConfig(**OPT),
                                   accum_steps=accum)
            st, met = run(step, state, placed)
            res[f"step{accum}"] = (float(met["loss"]),
                                   float(met["grad_norm"]), _np(st))
        out["mesh"][name] = res
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    parts = {"pipeline": pipeline, "fsdp": fsdp, "tp_a": tp_a, "tp_b": tp_b,
             "tp_mesh": tp_mesh, "tp_specs": tp_specs,
             "tp_train": tp_train}
    result = {p: parts[p]() for p in sys.argv[2:]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
