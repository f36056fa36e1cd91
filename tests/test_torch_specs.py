"""The port's `launch/specs.py` against `repro.launch.specs`.

`choose_policy` for every architecture x shape on four meshes; each
`build_cell`'s argument shapes and dtypes, `donate`, policy and the
specs of its input and output placements, against the reference's cell
of the same architecture (its smoke config: `jax.eval_shape` only on the
reference's side, the meta device on the port's, so nothing is
allocated; the reference's meshes are `AbstractMesh`es, which need no
devices); `cell_is_applicable`; and the cells' functions run on one CPU
device: a train step and a prefill with the cache in the reference's
layout.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.models.config import SHAPES as RSHAPES  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

MESHES = [(1, 2), (2, 2), (1, 4), (4, 1)]
AXES = ("data", "model")


def _norm(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _shape(x) -> tuple:
    if isinstance(x, tuple):                    # a Stacked leaf
        return (len(x),) + tuple(x[0].shape)
    return tuple(x.shape)


def _port_cell(cell) -> dict:
    return {"policy": cell.meta["policy"], "donate": cell.donate,
            "args": [(_shape(a), _dtype(a if not isinstance(a, tuple)
                                        else a[0]))
                     for a in leaves(cell.args)],
            "in": [_norm(pl.spec) for pl in leaves(cell.in_shardings)],
            "out": [_norm(pl.spec) for pl in leaves(cell.out_shardings)]}


def _ref_cell(cell) -> dict:
    tl = jax.tree_util.tree_leaves
    return {"policy": cell.meta["policy"], "donate": cell.donate,
            "args": [(tuple(a.shape), a.dtype.name) for a in tl(cell.args)],
            "in": [_norm(s.spec) for s in tl(cell.in_shardings)],
            "out": [_norm(s.spec) for s in tl(cell.out_shardings)]}


@pytest.mark.parametrize("shape", MESHES)
def test_choose_policy_matches_repro(shape):
    rmesh, tmesh = AbstractMesh(shape, AXES), make_mesh(shape, AXES)
    for name in tconfigs.ARCH_NAMES:
        for sname in SHAPES:
            assert tspecs.choose_policy(tconfigs.get(name), SHAPES[sname],
                                        tmesh) == rspecs.choose_policy(
                rconfigs.get(name), RSHAPES[sname], rmesh), (name, sname)
    # the MoE train cells train under "tp", the dense ones under "dp"
    # where the batch of 256 tiles the mesh (every mesh here)
    train = SHAPES["train_4k"]
    assert {n: tspecs.choose_policy(tconfigs.get(n), train, tmesh)
            for n in ("mixtral-8x7b", "qwen3-moe-235b-a22b",
                      "qwen2.5-14b")} == {"mixtral-8x7b": "tp",
                                          "qwen3-moe-235b-a22b": "tp",
                                          "qwen2.5-14b": "dp"}


@pytest.mark.parametrize("sname", list(SHAPES))
@pytest.mark.parametrize("shape", MESHES)
def test_build_cell_matches_repro(shape, sname):
    rmesh, tmesh = AbstractMesh(shape, AXES), make_mesh(shape, AXES)
    for name in tconfigs.ARCH_NAMES:
        got = _port_cell(tspecs.build_cell(
            name, sname, tmesh, cfg=tconfigs.get_smoke(name)))
        want = _ref_cell(rspecs.build_cell(
            name, sname, rmesh, cfg=rconfigs.get_smoke(name)))
        assert got == want, (name, sname, shape)


def test_mixtral_full_width_train_cell_matches_repro():
    """mixtral-8x7b's train_4k cell at its published widths on (1, 2):
    the "tp" policy, and every spec as the reference's."""
    got = tspecs.build_cell("mixtral-8x7b", "train_4k",
                            make_mesh((1, 2), AXES))
    want = rspecs.build_cell("mixtral-8x7b", "train_4k",
                             AbstractMesh((1, 2), AXES))
    assert _port_cell(got) == _ref_cell(want)
    assert got.meta["policy"] == "tp"
    assert all(a.device.type == "meta" for a in leaves(got.args)
               if isinstance(a, torch.Tensor))


def test_cell_is_applicable_matches_repro():
    for name in tconfigs.ARCH_NAMES:
        for sname in SHAPES:
            assert tspecs.cell_is_applicable(name, sname) == \
                rspecs.cell_is_applicable(name, sname), (name, sname)
    assert not tspecs.cell_is_applicable("qwen2.5-14b", "long_500k")[0]
    assert tspecs.cell_is_applicable("mixtral-8x7b", "long_500k")[0]


def test_stacked_cache_round_trip_keeps_the_tensors():
    for name in ("recurrentgemma-9b", "mixtral-8x7b", "xlstm-350m"):
        cfg = tconfigs.get_smoke(name)
        cache = LM(cfg, device="meta").init_cache(2, 32)
        back = tspecs.unstacked_cache(cfg, tspecs.stacked_cache(cfg, cache))
        assert back["pos"] == cache["pos"]
        assert len(back["layers"]) == len(cache["layers"]) == cfg.n_layers
        for a, b in zip(back["layers"], cache["layers"]):
            assert a.keys() == b.keys()
            assert all(a[k] is b[k] for k in a)


def test_cell_functions_run_on_one_device():
    """A train cell's step on a model on the CPU (one device: the "tp"
    rules split nothing) equals `make_train_step`'s, and a prefill
    cell's function equals the model's prefill, its cache in the
    reference's layout."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    cfg = dataclasses.replace(tconfigs.get_smoke("mixtral-8x7b"),
                              param_dtype="float32")
    mesh = make_host_mesh(device="cpu")
    batch = SyntheticTokens(cfg.vocab_size, 2, 32, seed=0,
                            device="cpu")(0)
    losses = []
    for via_cell in (True, False):
        model = LM(cfg, device="cpu", seed=0)
        params = model.param_tree()
        state = {"params": params, "opt": adamw_init(params)}
        if via_cell:
            cell = tspecs.build_cell("mixtral-8x7b", "train_4k", mesh,
                                     model=model)
            assert cell.meta["policy"] == "tp" and cell.meta["model"] is \
                model
            state, m = cell.fn(state, batch)
        else:
            state, m = make_train_step(model, AdamWConfig())(state, batch)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    assert losses[0] == losses[1]

    cfg = dataclasses.replace(tconfigs.get_smoke("qwen2.5-14b"),
                              param_dtype="float32")
    model = LM(cfg, device="cpu", seed=0)
    cell = tspecs.build_cell("qwen2.5-14b", "prefill_32k", mesh,
                             model=model)
    toks = batch["tokens"][:, :20]
    with torch.no_grad():
        lg, c = cell.fn(model.param_tree(), tspecs.stacked_cache(
            cfg, model.init_cache(2, 32)), toks)
        want, _ = model.prefill(toks, model.init_cache(2, 32))
    assert c["pos"] == 20
    np.testing.assert_array_equal(lg.numpy(), want.numpy())
    with pytest.raises(ValueError, match="own weights"):
        cell.fn(LM(cfg, device="meta").param_tree(), None, toks)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_force_sp_matches_repro_or_raises(shape):
    """`build_cell(force_sp=True)`: a train cell as the reference's (its
    context is a train one either way); a serve cell, whose weights the
    "tp" rules split over "model" on these meshes, raises with the
    reason (the port's train layout runs whole weights)."""
    rmesh, tmesh = AbstractMesh(shape, AXES), make_mesh(shape, AXES)
    kinds = {"built": 0, "raised": 0}
    for name in tconfigs.ARCH_NAMES:
        for sname in SHAPES:
            want = _ref_cell(rspecs.build_cell(
                name, sname, rmesh, cfg=rconfigs.get_smoke(name),
                force_sp=True))
            if SHAPES[sname].kind == "train":
                got = _port_cell(tspecs.build_cell(
                    name, sname, tmesh, cfg=tconfigs.get_smoke(name),
                    force_sp=True))
                assert got == want, (name, sname, shape)
                kinds["built"] += 1
                continue
            with pytest.raises(NotImplementedError,
                               match="whole weights"):
                tspecs.build_cell(name, sname, tmesh,
                                  cfg=tconfigs.get_smoke(name),
                                  force_sp=True)
            kinds["raised"] += 1
    assert kinds == {"built": 10, "raised": 30}


def test_force_sp_runs_where_nothing_splits_the_weights():
    """On a mesh whose "model" axis is one device the serve cell runs
    outside a serve context: its specs are the reference's."""
    rmesh, tmesh = AbstractMesh((2, 1), AXES), make_mesh((2, 1), AXES)
    for name in ("qwen2.5-14b", "mixtral-8x7b"):
        got = tspecs.build_cell(name, "decode_32k", tmesh,
                                cfg=tconfigs.get_smoke(name), force_sp=True)
        assert _port_cell(got) == _ref_cell(rspecs.build_cell(
            name, "decode_32k", rmesh, cfg=rconfigs.get_smoke(name),
            force_sp=True))


def test_shape_overrides_the_named_shape():
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    cell = tspecs.build_cell("minicpm-2b", "train_4k", make_mesh((1, 1), AXES),
                             cfg=tconfigs.get_smoke("minicpm-2b"),
                             shape=shape)
    assert cell.shape == shape
    assert tuple(cell.args[1]["tokens"].shape) == (8, 64)
