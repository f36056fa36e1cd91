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


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    parts = {"pipeline": pipeline, "fsdp": fsdp}
    result = {p: parts[p]() for p in sys.argv[2:]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(result, f)
