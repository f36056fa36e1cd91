"""The port's training under the "tp" rules (`dist/tp.py`'s train
layout, `LM.loss` within `act.seq_split`, `reduce_grad`'s sum over
"model") against `repro`.

Both start from the reference's init and the batch of
`torch_multidev_ref.tp_train_inputs`.  The reference runs in one
subprocess with four host devices (tests/torch_multidev_ref.py, its
"tp_train" part); the port, at the same time, in two gloo worlds of CPU
ranks (`run_world`, rank side tests/torch_tp_train_ranks.py, which
imports no JAX): a (1, 2) and a (2, 2) ("data", "model") world, each
rank holding whole weights, its rows of the batch and its positions of
the sequence.  Bars:
  (1, 2): every smoke architecture in float32 against `repro`'s
          one-device `value_and_grad`: the loss at rtol = atol = 1e-4 (the
          serving bar of tests/test_torch_tp.py), each gathered gradient
          leaf within 1e-4 of its own largest entry plus 1e-8 of the
          model's largest (tests/test_torch_train_zoo.py's bar for the
          port's one-device gradients: xlstm-350m's one-device gradients
          already depart from `repro`'s by 2.3e-4 in a few entries of
          unit scale, which an elementwise 1e-4 would lay on this path);
          mixtral-8x7b and qwen2.5-14b in bf16, the loss at 2e-2, and
          each gradient leaf within 2e-2 of its largest entry of the
          port's own one-device bf16 gradients (those depart from
          `repro`'s by up to 2.2% of a leaf's largest entry already:
          qwen2.5-14b's q/k/v bias gradients, bf16 sums over every
          position; the bf16 loss is all earlier tests held);
  (2, 2): mixtral-8x7b (capacity factor 1: the reference's two "data"
          groups drop other tokens than one group) and qwen2.5-14b in
          float32 against `repro`'s own (2, 2) "tp" cell: the loss, the
          gradients and one `make_train_step` step at accum 1 and 2, at
          tests/test_torch_train_fsdp.py's 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_multidev_ref as mref  # noqa: E402
import torch_tp_train_ranks as ranks  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.dist.world import run_world  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_train_fsdp import finish_reference, start_reference  # noqa
from torch_lm_parity import ref_params  # noqa: E402

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MESH_TOL = 1e-5
ARCHS = tuple(rconfigs.ARCH_NAMES)


def _params(name, dtype):
    return jax.tree.map(np.asarray, ref_params(dataclasses.replace(
        rconfigs.get_smoke(name), param_dtype=dtype)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's subprocess and the port's two worlds, at once."""
    tmp = str(tmp_path_factory.mktemp("tp_train"))
    proc, out = start_reference(tmp, "tp_train")
    try:
        cases = [(a, "float32", _params(a, "float32")) for a in ARCHS] + [
            (a, "bfloat16", _params(a, "bfloat16")) for a in mref.TPT_BF16]
        one = run_world(ranks.one_by_two, 2, device="cpu", store_dir=tmp,
                        args=(cases,))
        mesh = run_world(ranks.two_by_two, 4, device="cpu", store_dir=tmp,
                         args=({a: _params(a, "float32")
                                for a in mref.TPT_MESH},))
    finally:
        ref = finish_reference(proc, out, "tp_train")
    return ref, one, mesh


def _f32(a):
    """A numpy leaf in float32 (the port's bf16 arrive as uint16 bits)."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _close(got, want, tol, what):
    lg, lw = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw), what
    for i, (a, b) in enumerate(zip(lg, lw)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol,
                                   err_msg=f"{what} leaf {i}")


def _scaled(got, want, tol, what):
    """Each leaf within `tol` of its own largest entry plus 1e-8 of the
    tree's largest entry."""
    lg = [_f32(a) for a in leaves(got)]
    lw = [_f32(b) for b in leaves(want)]
    assert len(lg) == len(lw), what
    top = max(float(np.abs(b).max()) for b in lw)
    for i, (a, b) in enumerate(zip(lg, lw)):
        bar = tol * float(np.abs(b).max()) + 1e-8 * top
        err = float(np.abs(a - b).max())
        assert err <= bar, (what, i, err, bar)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_two_float32_matches_repro(world, arch):
    loss_r, grads_r = world[0]["one"][(arch, "float32")]
    loss, grads = world[1][(arch, "float32")]
    tol = TOL["float32"]
    np.testing.assert_allclose(loss, loss_r, rtol=tol, atol=tol)
    _scaled(grads, grads_r, tol, f"{arch} float32 grads")


@pytest.mark.parametrize("arch", mref.TPT_BF16)
def test_one_by_two_bf16_matches_repro(world, arch):
    loss_r, grads_r = world[0]["one"][(arch, "bfloat16")]
    loss, grads = world[1][(arch, "bfloat16")]
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(loss, loss_r, rtol=tol, atol=tol)
    loss_1, grads_1 = world[1][(arch, "one device")]
    np.testing.assert_allclose(loss, loss_1, rtol=tol, atol=tol)
    _scaled(grads, grads_1, tol, f"{arch} bf16 grads")


def test_a_sequence_the_model_ranks_do_not_divide_raises(world):
    assert "does not split over 2 ranks" in world[1]["odd"]


@pytest.mark.parametrize("arch", mref.TPT_MESH)
def test_two_by_two_loss_and_grads_match_the_repro_cell(world, arch):
    ref, got = world[0]["mesh"][arch], world[2][arch]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=MESH_TOL,
                               atol=MESH_TOL)
    _close(got["grads"], ref["grads"], MESH_TOL, f"{arch} grads")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", mref.TPT_MESH)
def test_two_by_two_train_step_matches_the_repro_cell(world, arch, accum):
    loss_r, gn_r, st_r = world[0]["mesh"][arch][f"step{accum}"]
    loss, gn, st = world[2][arch][f"step{accum}"]
    np.testing.assert_allclose(loss, loss_r, rtol=MESH_TOL, atol=MESH_TOL)
    np.testing.assert_allclose(gn, gn_r, rtol=MESH_TOL)
    assert st["opt"]["step"] == 1
    _close(st, st_r, MESH_TOL, f"{arch} accum {accum} state")


def test_the_data_groups_move_the_moe_loss_in_both(world):
    """At capacity factor 1 the reference's (2, 2) cell ranks and caps
    mixtral's tokens in two "data" groups, which drop other tokens than
    one group: its loss leaves its one-device loss, and the port's
    follows the cell, not the one device."""
    ref = world[0]["mesh"]["mixtral-8x7b"]
    got = world[2]["mixtral-8x7b"]["loss"]
    assert abs(ref["loss"] - ref["loss_one_device"]) > 100 * MESH_TOL
    assert abs(got - ref["loss"]) <= MESH_TOL * (1 + abs(ref["loss"]))
    assert abs(got - ref["loss_one_device"]) > 100 * MESH_TOL


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("arch, sname, shape", ranks.DRYRUN_CELLS)
def test_the_fake_world_predicts_every_collective(world, arch, sname, shape,
                                                  rank):
    """`dryrun.run_cell`'s calls in a fake world of 2 (meta tensors) are
    the (1, 2) gloo world's, call for call: op, bytes, group."""
    got = world[1]["calls"][rank][(arch, sname)]
    rec = dryrun.run_cell(arch, sname, False, cfg=tconfigs.get_smoke(arch),
                          shape=shape, mesh_shape=(1, 2), rank=rank)
    want = [(op, b, tuple(r)) for op, b, r in rec["calls"]]
    assert len(got) == rec["comm_calls"] > 0
    assert got == want
