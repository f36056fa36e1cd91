"""The port's training substrate against `repro`'s: schedules, AdamW, the
train step, the data pipeline, checkpoints, the restart loop and the
sharding rules.

Bars.  Schedules: the float32 learning rate bit for bit at every step.
AdamW: float32 params and moments at rtol 1e-6 plus 1e-6 of the leaf's
largest entry (the global norm sums the same leaves in the same order;
only the sum inside a leaf runs in another order, so the clip scale may
differ by an ulp, and a moment that sums terms of both signs keeps that
ulp against a smaller value), bf16 params within one ulp; grad_norm at rtol 1e-6 with
clipping engaged.  make_train_step: 3 steps on minicpm-2b's float32
smoke config at accum_steps 1 and 2, loss and every state leaf at rtol =
atol = 1e-5, at the reference driver's peak lr of 3e-4 (the first AdamW
step moves each weight by about lr x sign(g), so a gradient entry at the
float32 noise floor moves by up to lr either way in either package: at
lr 1e-2 one such entry of 1,440 in a w3 leaf departs by 1.5e-5).  Data:
batches bit-equal.  Checkpoints: `data.msgpack` byte-equal to the
reference's for the same leaves, the manifest equal, and a checkpoint of
either package restored by the other leaf for leaf.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as rdata  # noqa: E402
from repro.dist import fault as rfault  # noqa: E402
from repro.train import checkpoint as rckpt  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import train_step as rstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.dist import act  # noqa: E402
from repro_torch.dist import fault as tfault  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.tree import Stacked, leaves, members  # noqa: E402
from torch_lm_parity import as_np, inputs, pair  # noqa: E402

torch.set_num_threads(1)


def _np(x):
    """numpy of a jax array or torch tensor, bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_tree(port, ref_port_layout, rtol=0.0, atol=0.0):
    """Leaf for leaf (Stacked slice by slice), ints equal."""
    lp, lr = leaves(port), leaves(ref_port_layout)
    assert len(lp) == len(lr)
    for a, b in zip(lp, lr):
        for x, y in zip(members(a), members(b)):
            if isinstance(x, int):
                assert x == y
            elif rtol == atol == 0.0:
                np.testing.assert_array_equal(_np(x), _np(y))
            else:
                np.testing.assert_allclose(as_np(x), as_np(y), rtol=rtol,
                                           atol=atol)


# -- schedules and AdamW ----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(schedule="wsd", warmup_steps=3, total_steps=20),
    dict(schedule="wsd", warmup_steps=1, total_steps=12, peak_lr=1e-3),
    dict(schedule="cosine", warmup_steps=3, total_steps=20),
    dict(schedule="cosine", warmup_steps=1, total_steps=50, peak_lr=3e-4),
    dict(schedule="const", warmup_steps=1, total_steps=5)])
def test_schedules_bitwise(kw):
    rf = ropt.schedule_fn(ropt.AdamWConfig(**kw))
    tf = topt.schedule_fn(topt.AdamWConfig(**kw))
    for step in range(kw["total_steps"] + 5):
        want = np.asarray(rf(jnp.asarray(step, jnp.int32)), np.float32)
        got = tf(step)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), (step, got, want)


def _trees(dtype, scale, seed=0):
    """A parameter tree, three gradient trees, in both packages."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "blocks": ({"a": (3, 4), "b": (4,)},),
              "emb": (7, 3)}

    def draw(shape, s):
        return rng.standard_normal(shape).astype(np.float32) * s
    p = jax.tree.map(lambda sh: draw(sh, 1.0), shapes,
                     is_leaf=lambda x: isinstance(x, tuple) and
                     all(isinstance(i, int) for i in x))
    gs = [jax.tree.map(lambda a: draw(a.shape, scale), p) for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(tdt), p)
    rgs = [jax.tree.map(lambda a: jnp.asarray(a, jdt), g) for g in gs]
    tgs = [jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(tdt), g)
           for g in gs]
    return rp, tp, rgs, tgs


@pytest.mark.parametrize("dtype,scale", [("float32", 0.1), ("bfloat16", 0.1),
                                         ("float32", 10.0)])
def test_adamw_update_matches_repro(dtype, scale):
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    rcfg, tcfg = ropt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    rp, tp, rgs, tgs = _trees(dtype, scale)
    ro, to = ropt.adamw_init(rp), topt.adamw_init(tp)
    for rg, tg in zip(rgs, tgs):
        rp, ro, rm = ropt.adamw_update(rcfg, rg, ro, rp)
        tp, to, tm = topt.adamw_update(tcfg, tg, to, tp)
        gn = float(rm["grad_norm"])
        if scale > 1:
            assert gn > tcfg.clip_norm          # clipping engaged
        np.testing.assert_allclose(float(tm["grad_norm"]), gn, rtol=1e-6)
        assert float(tm["lr"]) == float(rm["lr"])
        assert to["step"] == int(ro["step"])
        for a, b in zip(leaves(to["mu"]) + leaves(to["nu"]),
                        jax.tree_util.tree_leaves((ro["mu"], ro["nu"]))):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
        for a, b in zip(leaves(tp), jax.tree_util.tree_leaves(rp)):
            if dtype == "float32":
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                           atol=1e-6 * np.abs(b).max())
            else:
                ulps = np.abs(_np(a).astype(np.int32) -
                              _np(b).astype(np.int32))
                assert ulps.max() <= 1, ulps.max()


def test_adamw_stacked_leaf_is_its_slices():
    """A Stacked leaf updates slice by slice exactly as the stacked array
    would, and the global norm counts it once."""
    cfg = topt.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=5)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 4, 3)).astype(np.float32)
    g = rng.standard_normal((2, 4, 3)).astype(np.float32)
    whole = {"x": torch.from_numpy(a.copy())}
    split = {"x": Stacked(torch.from_numpy(a[i].copy()) for i in range(2))}
    _, _, m1 = topt.adamw_update(cfg, {"x": torch.from_numpy(g)},
                                 topt.adamw_init(whole), whole)
    _, _, m2 = topt.adamw_update(
        cfg, {"x": Stacked(torch.from_numpy(g[i].copy()) for i in range(2))},
        topt.adamw_init(split), split)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(torch.stack(split["x"]).numpy(),
                               whole["x"].numpy(), rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_repro(accum):
    cr, rm, params, ct, _ = pair("minicpm-2b", "float32")
    # a model of its own: the step updates its parameters in place, and
    # pair()'s port model is shared with other tests of this process
    tm = TLM(ct, device="meta")
    tm.load_state_dict(convert.lm_params_from_repro(
        ct, jax.tree.map(np.asarray, params), device="cpu"), assign=True)
    kw = dict(warmup_steps=2, total_steps=10)
    r_step = jax.jit(rstep.make_train_step(rm, ropt.AdamWConfig(**kw),
                                           accum_steps=accum))
    rs = {"params": params, "opt": ropt.adamw_init(params)}
    start = convert.train_state_from_repro(
        ct, jax.tree.map(np.asarray, rs), device="cpu")
    t_step = tstep.make_train_step(tm, topt.AdamWConfig(**kw),
                                   accum_steps=accum)
    ts = start        # bound into the model by the first step
    for s in range(3):
        toks, _ = inputs(cr, 4, 12, seed=10 + s)
        rs, rmet = r_step(rs, {"tokens": jnp.asarray(toks)})
        ts, tmet = t_step(ts, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tmet["loss"]), float(rmet["loss"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(rmet["grad_norm"]), rtol=1e-5)
        want = convert.train_state_from_repro(
            ct, jax.tree.map(np.asarray, rs), device="cpu")
        _same_tree(ts, want, rtol=1e-5, atol=1e-5)
    # the state's parameters are the model's own tensors
    own = leaves(tm.param_tree())
    for a, b in zip(leaves(ts["params"]), own):
        assert all(x is y for x, y in zip(members(a), members(b)))


# -- data ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(n_codebooks=4),
                                dict(patch_prefix=4, d_model=16)])
def test_synthetic_tokens_bit_equal(kw):
    r = rdata.SyntheticTokens(1000, 3, 16, seed=5, **kw)
    t = tdata.SyntheticTokens(1000, 3, 16, seed=5, device="cpu", **kw)
    for step in (0, 1, 7):
        rb, tb = r(step), t(step)
        assert rb.keys() == tb.keys()
        assert tb["tokens"].dtype == torch.int32
        for k in rb:
            np.testing.assert_array_equal(_np(tb[k]), _np(rb[k]))
        if "patch_embeds" in tb:
            assert tb["patch_embeds"].dtype == torch.bfloat16


def test_packed_file_dataset_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 60000, 5000)
    pr, pt = str(tmp_path / "r.bin"), str(tmp_path / "t.bin")
    rdata.PackedFileDataset.write(pr, toks)
    tdata.PackedFileDataset.write(pt, toks)
    assert open(pr, "rb").read() == open(pt, "rb").read()
    r = rdata.PackedFileDataset(pr, batch=3, seq_len=32, seed=2)
    t = tdata.PackedFileDataset(pt, batch=3, seq_len=32, seed=2,
                                device="cpu")
    for step in range(4):
        np.testing.assert_array_equal(t(step)["tokens"].numpy(),
                                      np.asarray(r(step)["tokens"]))


def test_prefetcher_order_and_stale_drop():
    ds = tdata.SyntheticTokens(100, 2, 8, seed=1, device="cpu")
    pf = tdata.Prefetcher(ds, depth=2).start(0)
    try:
        for s in range(4):
            assert torch.equal(pf.get(s)["tokens"], ds(s)["tokens"])
        # restart skew: asking for a later step drops the ones before it
        assert torch.equal(pf.get(7)["tokens"], ds(7)["tokens"])
    finally:
        pf.stop()


# -- checkpoints --------------------------------------------------------------------


def _ref_state(name="mixtral-8x7b", dtype="bfloat16"):
    """A reference train state with non-trivial moments and step (after
    one step), and its port twin through the converter."""
    cr, rm, params, ct, tm = pair(name, dtype)
    rs = {"params": params, "opt": ropt.adamw_init(params)}
    toks, _ = inputs(cr, 2, 9)
    rs, _ = jax.jit(rstep.make_train_step(rm, ropt.AdamWConfig()))(
        rs, {"tokens": jnp.asarray(toks)})
    ts = convert.train_state_from_repro(ct, jax.tree.map(np.asarray, rs),
                                        device="cpu")
    return rs, ts, tm


def test_checkpoint_files_equal_repro(tmp_path):
    rs, ts, tm = _ref_state()
    rpath = rckpt.save_checkpoint(str(tmp_path / "r"), 1, rs, {"k": 1})
    tpath = tckpt.save_checkpoint(str(tmp_path / "t"), 1, ts, {"k": 1})
    for f in ("data.msgpack", "manifest.json"):
        a = open(os.path.join(rpath, f), "rb").read()
        b = open(os.path.join(tpath, f), "rb").read()
        if f == "manifest.json":
            a, b = json.loads(a), json.loads(b)
        assert a == b, f
    # and msgpack itself reads the port's file as the reference writes it
    import msgpack
    with open(os.path.join(tpath, "data.msgpack"), "rb") as f:
        up = msgpack.Unpacker(f, max_buffer_size=2**31)
        n = up.unpack()
        assert n == len(leaves(ts)) == len(jax.tree_util.tree_leaves(rs))
    # the port's model state in the same layout as a converted one
    assert [p for p, _ in tckpt.flatten_with_paths(tm.param_tree())] == [
        p for p, _ in tckpt.flatten_with_paths(ts["params"])]


def test_checkpoint_crosses_packages(tmp_path):
    rs, ts, _ = _ref_state("qwen2.5-14b")
    # repro -> port
    rckpt.save_checkpoint(str(tmp_path / "r"), 3, rs)
    got, step = tckpt.restore_checkpoint(str(tmp_path / "r"),
                                         tckpt.spec_of(ts))
    assert step == 3
    _same_tree(got, ts)
    # port -> repro
    tckpt.save_checkpoint(str(tmp_path / "t"), 4, ts)
    back, step = rckpt.restore_checkpoint(str(tmp_path / "t"), rs)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(rs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))


def test_checkpoint_keeps_last_three_and_restores_placed(tmp_path):
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.ones(2, 3, dtype=torch.bfloat16)}, "s": 7}
    for step in (1, 2, 3, 4):
        tckpt.save_checkpoint(str(tmp_path), step, tree)
    kept = sorted(os.listdir(tmp_path))
    assert kept == [f"step_{s:010d}" for s in (2, 3, 4)]
    mesh = make_host_mesh(device="cpu")
    rules = tsh.ShardingRules(mesh, "dp")
    got, step = tckpt.restore_checkpoint(
        str(tmp_path), tree, shardings=tsh.replicated(mesh, tree))
    assert step == 4 and got["s"] == 7
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert rules.axis_size("dp") == 1


def test_async_checkpointer(tmp_path):
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    x = {"x": torch.ones(5)}
    ck.save(3, x)
    x["x"].add_(1.0)          # the step after the save updates in place
    ck.wait()
    assert tckpt.latest_step(str(tmp_path)) == 3
    got, _ = tckpt.restore_checkpoint(str(tmp_path), x)
    assert torch.equal(got["x"], torch.ones(5))


# -- restart loop (mirrors tests/test_substrate.py's) ------------------------------


def _quadratic():
    cfg = topt.AdamWConfig(peak_lr=0.05, warmup_steps=1, total_steps=100,
                           weight_decay=0.0, schedule="const")

    def step_fn(state, batch):
        w = state["params"]["w"].detach().requires_grad_(True)
        loss = torch.sum((w - batch) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        with torch.no_grad():
            params = {"w": state["params"]["w"]}
        new_p, new_opt, m = topt.adamw_update(cfg, {"w": g}, state["opt"],
                                              params)
        return {"params": new_p, "opt": new_opt}, m

    def data_fn(step):
        return torch.from_numpy(
            np.random.default_rng(step).standard_normal(4).astype(
                np.float32))

    def make_init():
        w = torch.zeros(4)
        return {"params": {"w": w}, "opt": topt.adamw_init({"w": w})}
    return step_fn, data_fn, make_init


@pytest.mark.parametrize("fails,total", [({17, 42}, 60), ({2}, 12),
                                         ({0, 5}, 12)])
def test_restart_manager_recovers(tmp_path, capsys, fails, total):
    """Failures before and after the first periodic save; the step
    updates in place, so a failure before step 10 must restore step 0's
    snapshot from disk.  The final state equals an uninterrupted run's
    and the reference's."""
    step_fn, data_fn, make_init = _quadratic()
    ref = make_init()
    for s in range(total):
        ref, _ = step_fn(ref, data_fn(s))
    pending = set(fails)

    def failure_hook(step):
        if step in pending:
            pending.remove(step)
            raise RuntimeError(f"simulated preemption at {step}")

    mgr = tfault.RestartManager(str(tmp_path / "ckpt"), save_every=10)
    state, steps, restarts = mgr.run(make_init(), step_fn, data_fn, total,
                                     failure_hook=failure_hook)
    assert steps == total and restarts == len(fails)
    assert torch.equal(state["params"]["w"], ref["params"]["w"])
    assert state["opt"]["step"] == total
    err = capsys.readouterr().err
    assert err.count("[restart-manager]") == len(fails)

    # the reference's loop on the same data and failures
    rcfg = ropt.AdamWConfig(peak_lr=0.05, warmup_steps=1, total_steps=100,
                            weight_decay=0.0, schedule="const")

    def r_step(st, batch):
        g = jax.grad(lambda p: jnp.sum((p["w"] - batch) ** 2))(st["params"])
        p, o, m = ropt.adamw_update(rcfg, g, st["opt"], st["params"])
        return {"params": p, "opt": o}, m
    pending.update(fails)
    rstate, _, _ = rfault.RestartManager(
        str(tmp_path / "rckpt"), save_every=10).run(
        {"params": {"w": jnp.zeros(4)}, "opt": ropt.adamw_init(
            {"w": jnp.zeros(4)})}, r_step,
        lambda s: jnp.asarray(data_fn(s).numpy()), total,
        failure_hook=failure_hook)
    np.testing.assert_allclose(state["params"]["w"].numpy(),
                               np.asarray(rstate["params"]["w"]), rtol=1e-6)


def test_restart_manager_resumes_a_directory(tmp_path):
    step_fn, data_fn, make_init = _quadratic()
    d = str(tmp_path / "ckpt")
    tfault.RestartManager(d, save_every=5).run(make_init(), step_fn,
                                               data_fn, 10)
    state, steps, restarts = tfault.RestartManager(d, save_every=5).run(
        make_init(), step_fn, data_fn, 15)
    ref = make_init()
    for s in range(15):
        ref, _ = step_fn(ref, data_fn(s))
    assert steps == 15 and restarts == 0
    assert torch.equal(state["params"]["w"], ref["params"]["w"])


# -- sharding rules -----------------------------------------------------------------

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((8, 1), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
CASES = [((8, 16), ("dp", None)), ((8, 6, 16), ("dp", "sp", "tp")),
         ((6, 12), ("fsdp", "tp")), ((16, 16), ("dp", "fsdp")),
         ((4, 8, 2, 16), ("dp", None, "tp", None)), ((3,), ("ep",)),
         ((24, 8), ("fsdp", "ep")), ((7, 5), ("dp", "tp")), ((), ())]
LEAVES = [(128, 64), (64,), (4, 64, 96), (3, 16, 16), (2, 8, 5)]

SPEC_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from repro.dist.sharding import (ShardingRules, param_shardings,
                                 batch_shardings, cache_shardings)
meshes, cases, shapes = json.loads(sys.argv[1])
def norm(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]
out = []
for sizes, names in meshes:
    mesh = jax.make_mesh(tuple(sizes), tuple(names))
    for policy in ("dp", "tp"):
        r = ShardingRules(mesh, policy)
        tree = [jax.ShapeDtypeStruct(tuple(s), jnp.float32) for s in shapes]
        out.append({
            "spec": [norm(r.spec(s, ax)) for s, ax in cases],
            "axis": [r.axis_size(a) for a in ("dp", "fsdp", "tp", "sp", "ep")],
            "train": [norm(x.spec) for x in param_shardings(r, tree)],
            "serve": [norm(x.spec) for x in param_shardings(r, tree,
                                                            serve=True)],
            "batch": [norm(x.spec) for x in batch_shardings(r, tree)],
            "cache": [norm(x.spec) for x in cache_shardings(r, tree)]})
print("SPECS=" + json.dumps(out))
"""


def test_sharding_specs_match_repro():
    arg = json.dumps([MESHES, CASES, LEAVES])
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", SPEC_SCRIPT, arg],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.split("SPECS=")[1])

    def norm(spec):
        return [list(p) if isinstance(p, tuple) else p for p in spec]
    got = []
    for sizes, names in MESHES:
        mesh = make_mesh(sizes, names)
        for policy in ("dp", "tp"):
            r = tsh.ShardingRules(mesh, policy)
            tree = [torch.empty(s, device="meta") for s in LEAVES]
            got.append({
                "spec": [norm(r.spec(s, ax)) for s, ax in CASES],
                "axis": [r.axis_size(a) for a in
                         ("dp", "fsdp", "tp", "sp", "ep")],
                "train": [norm(x.spec) for x in tsh.param_shardings(r, tree)],
                "serve": [norm(x.spec) for x in tsh.param_shardings(
                    r, tree, serve=True)],
                "batch": [norm(x.spec) for x in tsh.batch_shardings(r, tree)],
                "cache": [norm(x.spec) for x in tsh.cache_shardings(r, tree)]})
    assert got == want


def test_reshard_and_constrain_raise_on_a_split_axis():
    """One device: every placement is the device and constrain the
    identity.  An axis of two devices without a process group: a split
    raises and names the process group (it never replicates); a "tp"
    split in a serve context without a process group raises and names
    it, and so does one in training (tests/test_torch_train_fsdp.py,
    tests/test_torch_tp.py and tests/test_torch_tp_train.py run the
    splits on a world of ranks)."""
    x = torch.ones(8, 4)
    one = tsh.ShardingRules(make_host_mesh(device="cpu"), "dp")
    big = tsh.ShardingRules(make_mesh((2, 1), ("data", "model"),
                                      [torch.device("cpu")] * 2), "dp")
    # one device: every placement is the device, constrain the identity
    assert tsh.reshard({"x": x}, tsh.param_shardings(one, {"x": x}))["x"] \
        is x
    assert tsh.placement_of(x) is None
    with act.activation_sharding(one):
        assert act.constrain(x, "dp", None) is x
        assert act.axis_size("dp") == 1 and act.is_serve() is False
    # an axis of two devices and no process group: a split raises
    with pytest.raises(RuntimeError, match="process group"):
        tsh.reshard({"x": x}, tsh.param_shardings(big, {"x": x}))
    with act.activation_sharding(big, serve=True):
        assert act.axis_size("dp") == 2 and act.is_serve() is True
        with pytest.raises(RuntimeError, match="process group"):
            act.constrain(x, "dp", None)
        # a dim the axis does not divide stays whole, as in the reference
        y = torch.ones(3, 4)
        assert act.constrain(y, "dp", None) is y
    tp = tsh.ShardingRules(make_mesh((1, 2), ("data", "model")), "tp")
    with act.activation_sharding(tp, serve=True):
        with pytest.raises(RuntimeError, match="process group"):
            act.constrain(x, None, "tp")
        assert act.constrain(x, "dp", None) is x
    with act.activation_sharding(tp):
        with pytest.raises(RuntimeError, match="process group"):
            act.constrain(x, None, "tp")
        assert act.constrain(x, "dp", None) is x
    # and outside any context the hooks are the identity again
    assert act.constrain(x, "dp") is x and act.axis_size("tp") == 1


def test_single_device_trainer_splits_no_axis(monkeypatch):
    """A host that shows four cards: the trainer's mesh is its one device
    (outside torch.distributed), so the "dp" rules split no axis of any
    minicpm-2b leaf and reshard places the state there."""
    import repro_torch.launch.mesh as lmesh
    from repro_torch import configs
    card = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(lmesh, "resolve_device", lambda device=None: card)
    mesh = lmesh.make_host_mesh()
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert mesh.devices == (card,) and mesh.local_device == card
    rules = tsh.ShardingRules(mesh, "dp")
    model = TLM(configs.get("minicpm-2b"), device="meta")
    state = {"params": model.param_tree()}
    placed = tsh.param_shardings(rules, state["params"])
    specs = [pl.spec for pl in leaves(placed)]
    assert specs and all(tsh.split_axes(mesh, s) == [] for s in specs)
    assert all(rules.axis_size(a) == 1 for a in ("dp", "fsdp", "tp", "ep"))


def test_training_entry_points_default_to_cuda(tmp_path):
    """No card: the training entry points raise instead of dropping to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train as ltrain
    for call in (lambda: tdata.SyntheticTokens(10, 2, 4),
                 lambda: make_host_mesh(),
                 lambda: ltrain.main(["--smoke", "--steps", "1",
                                      "--ckpt-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
