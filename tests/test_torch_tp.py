"""The port's tensor-parallel serving (the "tp" policy, `dist/tp.py`)
against `repro`.

A gloo world of two CPU ranks on a (1, 2) ("data", "model") mesh
(`run_world`, rank side tests/torch_tp_ranks.py, which imports no JAX)
loads `repro`'s own init of each smoke architecture through
`convert.lm_params_from_repro(..., shardings=param_shardings(rules,
params, serve=True))`, each rank keeping its slices, and serves it
inside `activation_sharding(rules, serve=True)`: prefill of 20 tokens
and four decode steps fed the prompt's next tokens, then greedy
`ServeEngine.generate`.  `repro` runs the same on one device in a
subprocess (tests/torch_multidev_ref.py's parts), at the same time.
Bars (tests/torch_lm_parity.py): every step's logits at rtol = atol =
1e-4 in float32 and 2e-2 in bf16, and the float32 greedy tokens equal.
The recurrent architectures in bf16 are held within the spread of the
reference's own logits under a one-ulp change of one embedding weight
(tests/test_torch_models_zoo.py's end-to-end bar for them: their
recurrences amplify last-bit differences past 2e-2).

This file holds the dense attention architectures, a (2, 2) world
(data x model) against both `repro` on one device and `repro`'s own
"tp" run on a (2, 2) mesh of host devices, and a rank's slices;
tests/test_torch_tp_zoo.py the MoE, recurrent and codebook ones and the
placement specs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_multidev_ref as mref  # noqa: E402
import torch_tp_ranks as ranks  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro_torch.dist.world import run_world  # noqa: E402
from test_torch_train_fsdp import finish_reference, start_reference  # noqa
from torch_lm_parity import TOL, ref_params  # noqa: E402

torch.set_num_threads(1)


def _cases(cases, **over):
    """(name, dtype, the reference's init as numpy, `over`) of each case."""
    import jax
    return [(name, dtype, jax.tree.map(np.asarray, ref_params(
        dataclasses.replace(rconfigs.get_smoke(name), param_dtype=dtype))),
        over) for name, dtype in cases]


#: qwen2.5-14b under qkv_spec="sp": the reference's sequence layout of
#: q, k and v (every head on every rank here); on one device the same
#: model as qkv_spec="auto"
SP = ("qwen2.5-14b", "float32", ("qkv_spec", "sp"))


def hold(got, want, name, dtype):
    """Every step's logits at the dtype's bar (recurrent bf16: within the
    reference's one-ulp spread); float32 greedy tokens equal."""
    spread = want.get("spread")
    for j, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        what = f"{name} {dtype} step {j}"
        assert g.shape == w.shape, what
        if spread is None:
            np.testing.assert_allclose(g, w, rtol=TOL[dtype],
                                       atol=TOL[dtype], err_msg=what)
        else:
            assert spread > TOL[dtype], spread
            err = float(np.abs(g - w).max())
            assert np.isfinite(g).all() and err <= spread, (what, err)
    if dtype == "float32":
        np.testing.assert_array_equal(got["greedy"], want["greedy"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    proc, out = start_reference(tmp, "tp_a")
    mesh_proc, mesh_out = start_reference(tmp, "tp_mesh")
    try:
        got = run_world(ranks.serve_world, 2, device="cpu", store_dir=tmp,
                        args=(_cases(mref.TP_CASES["tp_a"])
                              + _cases([SP[:2]], qkv_spec="sp"), 2))
        got_mesh = run_world(ranks.serve_world, 4, device="cpu",
                             store_dir=tmp,
                             args=(_cases(mref.TP_MESH), 2))
        placed = run_world(ranks.placement_world, 2, device="cpu",
                           store_dir=tmp, args=("qwen2.5-14b",))
    finally:
        ref = finish_reference(proc, out, "tp_a")
        ref_mesh = finish_reference(mesh_proc, mesh_out, "tp_mesh")
    return ref, got, ref_mesh, got_mesh, placed


@pytest.mark.parametrize("name,dtype", mref.TP_CASES["tp_a"])
def test_tp_world_serves_like_repro(world, name, dtype):
    hold(world[1][(name, dtype)], world[0][(name, dtype)], name, dtype)


def test_sequence_layout_serves_like_repro(world):
    """qkv_spec="sp": q, k and v whole on every rank, the attention of
    every head on each, against `repro` on one device."""
    hold(world[1][SP], world[0][SP[:2]], *SP[:2])


@pytest.mark.parametrize("name,dtype", mref.TP_MESH)
def test_data_by_model_world_serves_like_repro(world, name, dtype):
    """(2, 2): each data group serves its row, the model ranks their
    slices; against `repro` on one device."""
    hold(world[3][(name, dtype)], world[2]["one"][(name, dtype)], name,
         dtype)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "mixtral-8x7b"])
def test_data_by_model_world_matches_repro_under_tp(world, name):
    """The same world in float32 against `repro`'s own serve cell on a
    (2, 2) mesh of host devices under the "tp" rules (which runs on JAX
    0.9)."""
    hold(world[3][(name, "float32")], world[2]["mesh"][(name, "float32")],
         name, "float32")


@pytest.mark.parametrize("name", ["qwen2.5-14b", "mixtral-8x7b"])
def test_repro_bf16_tp_cell_leaves_the_bar_the_port_keeps(world, name):
    """In bf16 `repro`'s own (2, 2) serve cell sums partial products
    rounded to bf16 and leaves its one-device logits by more than the
    2e-2 bar; the port sums them in float32 (the reference's `acc_t`)
    and stays within it (`test_data_by_model_world_serves_like_repro`)."""
    one = world[2]["one"][(name, "bfloat16")]["logits"]
    mesh = world[2]["mesh"][(name, "bfloat16")]["logits"]
    port = world[3][(name, "bfloat16")]["logits"]
    ref_err = max(float(np.abs(a - b).max()) for a, b in zip(mesh, one))
    port_err = max(float(np.abs(a - b).max()) for a, b in zip(port, one))
    assert ref_err > TOL["bfloat16"] > port_err, (ref_err, port_err)


def test_a_rank_holds_only_its_slices(world):
    """qwen2.5-14b's bf16 smoke config drawn as slices: every matrix is
    split (the worked example of the placement rule: wq, wo, w1, w3 and
    the head on their output dim; wk, wv and w2 on their input dim; the
    embedding on its vocabulary) and its resident bytes are the slice's;
    the vectors are whole; the slices are those of a whole `LM(cfg,
    seed=0)`; the KV cache holds the rank's KV heads; a decode step
    gathers no weight and makes five collectives a layer plus the
    embedding's and the head's."""
    got = world[4]
    cfg = rconfigs.get_smoke("qwen2.5-14b")
    assert got["same"]
    split_dim = {"wq": 1, "wo": 1, "w1": 1, "w3": 1, "head": 1,
                 "wk": 0, "wv": 0, "w2": 0, "embed": 0}
    resident = whole = 0
    for name, (res, full, spec) in got["params"].items():
        leaf = name.rsplit(".", 1)[-1]
        resident, whole = resident + res, whole + full
        if leaf in split_dim:
            assert spec is not None and spec[split_dim[leaf]] == "model", \
                (name, spec)
            assert res * 2 == full, name
        else:
            assert spec is None and res == full, name
    vectors = sum(full for _, full, spec in got["params"].values()
                  if spec is None)
    assert resident == (whole - vectors) // 2 + vectors
    assert all(k[2] == cfg.n_kv_heads // 2 for k in got["cache_k"])
    stats, gathered = got["decode"]
    assert gathered == {"calls": 0, "bytes": 0}
    assert stats["calls"] == 5 * cfg.n_layers + 2
    assert got["prefill"][1]["calls"] == 0
