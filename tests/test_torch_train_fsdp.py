"""The port's training over several ranks (FSDP-DP under the "dp" rules)
against `repro`'s on a four-device CPU mesh.

Both start from the reference's init.  The reference side runs in a
subprocess with four host devices (tests/torch_multidev_ref.py, its "fsdp"
part, which tests/test_torch_pipeline.py runs for its own part), the port,
at the same time, in a gloo world
of four CPU ranks (`run_world`, rank side in tests/torch_train_fsdp_ranks.py,
which imports no JAX), each rank holding its slices of the parameters and
moments and its rows of the batch.  Bars: the A12.2a bars of
tests/test_torch_train.py (rtol = atol = 1e-5 at lr 3e-4) on the loss,
the grad norm, the gathered gradients and every leaf of the state after a
`make_train_step` step at accum 1 and 2, for minicpm-2b (dense) and
mixtral-8x7b (MoE at capacity factor 1, where the reference's four dp
groups drop other tokens than one group: its four-device loss is first
shown to differ from its one-device loss by more than the bar).
Checkpoints cross between the world, one device and `repro` bit for bit.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_multidev_ref as mref  # noqa: E402
import torch_train_fsdp_ranks as ranks  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro.train import checkpoint as rckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.dist.sharding import (ShardingRules, batch_shardings,  # noqa
                                       param_shardings)
from repro_torch.dist.world import run_world  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from torch_lm_parity import ref_params  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))


def start_reference(tmp, part: str):
    """tests/torch_multidev_ref.py's `part` in a subprocess with four host
    devices: (the process, where it pickles its result)."""
    out = os.path.join(tmp, f"ref_{part}.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen([sys.executable,
                             os.path.join(HERE, "torch_multidev_ref.py"),
                             out, part], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    return proc, out


def finish_reference(proc, out, part: str) -> dict:
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)[part]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _close(got, want, what):
    lg, lw = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw), what
    for i, (a, b) in enumerate(zip(lg, lw)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=f"{what} leaf {i}")


def _equal(got, want, what):
    lg, lw = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw), what
    for i, (a, b) in enumerate(zip(lg, lw)):
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what} leaf {i}")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's subprocess and the port's 4-rank world, at once,
    from the reference's init (one JAX device here)."""
    tmp = str(tmp_path_factory.mktemp("fsdp"))
    proc, out = start_reference(tmp, "fsdp")
    try:
        params = {name: jax.tree.map(np.asarray, ref_params(
            dataclasses.replace(rconfigs.get_smoke(name),
                                param_dtype="float32",
                                **mref.OVERRIDES.get(name, {}))))
                  for name in mref.ARCHS}
        # one device writes through repro: a state with non-zero moments
        rng = np.random.default_rng(7)
        p = params["minicpm-2b"]
        want_in = {"params": p, "opt": {
            "mu": jax.tree.map(lambda a: rng.standard_normal(
                a.shape).astype(np.float32), p),
            "nu": jax.tree.map(lambda a: rng.random(
                a.shape).astype(np.float32), p), "step": np.int32(3)}}
        ckpt_in = os.path.join(tmp, "one_device")
        rckpt.save_checkpoint(ckpt_in, 3, jax.tree.map(jnp.asarray, want_in))
        ckpt_out = os.path.join(tmp, "world")
        got = run_world(ranks.parity, 4, device="cpu", store_dir=tmp,
                        args=(params, ckpt_in, ckpt_out, want_in))
    finally:
        ref = finish_reference(proc, out, "fsdp")
    return ref, got, want_in, ckpt_out


def test_reference_groups_change_the_moe_loss(world):
    r = world[0]["archs"]["mixtral-8x7b"]
    assert abs(r["loss"] - r["loss_one_device"]) > 10 * TOL


@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x7b"])
def test_ranks_draw_the_reference_batches(world, arch):
    ref, got = world[0]["archs"][arch], world[1][arch]
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x7b"])
def test_loss_and_grads_match_the_four_device_reference(world, arch):
    ref, got = world[0]["archs"][arch], world[1][arch]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TOL, atol=TOL)
    _close(got["grads"], ref["grads"], f"{arch} grads")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x7b"])
def test_train_step_matches_the_four_device_reference(world, arch, accum):
    loss_r, gn_r, st_r = world[0]["archs"][arch][f"step{accum}"]
    loss, gn, st = world[1][arch][f"step{accum}"]
    np.testing.assert_allclose(loss, loss_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gn, gn_r, rtol=TOL)
    assert st["opt"]["step"] == 1
    _close(st, st_r, f"{arch} accum {accum} state")


def test_uneven_batch_stays_whole_and_matches_the_reference(world):
    """6 rows on 4 ranks: every rank steps on the whole batch (the
    reference's spec drops the dp axis), its gradient not summed, and the
    MoE ranks and caps it in the reference's four groups."""
    arch = "mixtral-8x7b"
    tok_r, loss_r, gn_r, st_r = world[0]["archs"][arch]["uneven"]
    tok, loss, gn, st = world[1][arch]["uneven"]
    np.testing.assert_array_equal(tok, tok_r)
    np.testing.assert_allclose(loss, loss_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gn, gn_r, rtol=TOL)
    _close(st, st_r, f"{arch} uneven state")


def test_checkpoints_cross_world_one_device_and_repro(world):
    _, got, want_in, ckpt_out = world
    g = got["minicpm-2b"]
    # one device (repro) -> the world's placements, gathered: bit for bit
    step, restored = g["restored"]
    assert step == 3 and g["sliced"]
    _equal(restored, want_in, "repro checkpoint restored on 4 ranks")
    # and the same state carried over by the converter onto the placements
    _equal(g["converted"], want_in, "repro state placed on 4 ranks")
    # the world -> one device, in the port and in repro
    world_state = g["step1"][2]
    cfg = dataclasses.replace(tconfigs.get_smoke("minicpm-2b"),
                              param_dtype="float32")
    params = LM(cfg, device="cpu").param_tree()
    like = tckpt.spec_of({"params": params, "opt": adamw_init(params)})
    back, step = tckpt.restore_checkpoint(ckpt_out, like)
    assert step == 1
    _equal(convert.train_state_to_numpy(back), world_state,
           "4-rank checkpoint restored on one device")
    rback, step = rckpt.restore_checkpoint(
        ckpt_out, jax.tree.map(jnp.asarray, world[0]["archs"][
            "minicpm-2b"]["step1"][2]))
    assert step == 1
    _equal(world_state, rback, "4-rank checkpoint restored by repro")


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_placement_specs_match_repro(world, shape):
    want = world[0]["specs"]

    def norm(spec):
        return [list(p) if isinstance(p, tuple) else p for p in spec]
    for name in tconfigs.ARCH_NAMES:
        cfg = tconfigs.get_smoke(name)
        rules = ShardingRules(make_mesh(shape, ("data", "model")), "dp")
        params = LM(cfg, device="meta").param_tree()
        batch = {"tokens": torch.empty(
            (8, 32 - cfg.patch_prefix) + ((cfg.n_codebooks,)
                                          if cfg.n_codebooks else ()),
            device="meta")}
        if cfg.patch_prefix:
            batch["patch_embeds"] = torch.empty(
                (8, cfg.patch_prefix, cfg.d_model), device="meta")
        p_specs = [norm(pl.spec) for pl in leaves(param_shardings(
            rules, params))]
        b_specs = {k: norm(pl.spec) for k, pl in
                   batch_shardings(rules, batch).items()}
        assert (p_specs, b_specs) == want[(shape, name)], name


def _train_args(extra=()):
    return ["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
            "--steps", "12", "--batch", "8", "--seq-len", "32", "--lr",
            "3e-4", "--save-every", "25", *extra]


def test_launch_train_on_two_ranks_matches_one(tmp_path):
    """launch.train's loop on a 2-rank world: 12 steps, the loss falling.
    Its first loss is one rank's at 1e-5.  Later ones drift as any change
    of summation order drifts: AdamW moves a weight by about lr x sign(g),
    and a gradient entry at the float32 noise floor takes either sign, so
    one process at accum 2 (the same sum in another order) leaves its own
    accum-1 run by up to 1.4e-4 over these 12 steps.  So each loss is held
    within twice that self-spread of the one-process run.  The first
    step of the same set-up in float32 has one rank's grad norm at 1e-5,
    which AdamW's near independence of the gradient's scale would not
    show in the losses: a gradient summed once too often over the ranks
    fails here."""
    hist, gn = run_world(ranks.launch_train, 2, device="cpu",
                     store_dir=str(tmp_path), args=(_train_args(),
                                                    str(tmp_path)))

    def one(*extra):
        return np.array([loss for _, loss in ltrain.train(
            ltrain.build_parser().parse_args(_train_args(
                [*extra, "--ckpt-dir", str(tmp_path / f"one{extra}")])))[
                "history"]])
    base, reordered = one(), one("--accum", "2")
    assert [s for s, _ in hist] == list(range(12))
    losses = np.array([loss for _, loss in hist])
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    np.testing.assert_allclose(losses[0], base[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gn, ranks.first_grad_norm(_train_args()),
                               rtol=TOL, atol=TOL)
    spread = float(np.abs(base - reordered).max())
    assert 0.0 < spread < 1e-3
    assert float(np.abs(losses - base).max()) <= max(TOL, 2 * spread)
