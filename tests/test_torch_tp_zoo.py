"""The port's tensor-parallel serving against `repro`: the MoE, recurrent
and codebook architectures (tests/test_torch_tp.py says how and holds
the others), and the "tp" rules' serve placements against `repro`'s.

The experts split on F or D (no serve placement splits E, so no token
crosses ranks), the RG-LRU on its channels, the xLSTM blocks gather their
weights at use, musicgen's codebook embeddings and heads split on the
vocabulary.  The placement specs: `param_shardings(serve=True)`,
`cache_shardings` and `batch_shardings` under "tp" on (1, 2), (2, 2) and
(1, 4) for every smoke architecture, equal to `repro`'s on host devices
(tests/torch_multidev_ref.py's tp_specs part).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_multidev_ref as mref  # noqa: E402
import torch_tp_ranks as ranks  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist.sharding import (ShardingRules, batch_shardings,  # noqa
                                       cache_shardings, param_shardings)
from repro_torch.dist.world import run_world  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.tree import Stacked, leaves  # noqa: E402
from test_torch_tp import _cases, hold  # noqa: E402
from test_torch_train_fsdp import finish_reference, start_reference  # noqa

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_zoo"))
    proc, out = start_reference(tmp, "tp_b")
    spec_proc, spec_out = start_reference(tmp, "tp_specs")
    try:
        got = run_world(ranks.serve_world, 2, device="cpu", store_dir=tmp,
                        args=(_cases(mref.TP_CASES["tp_b"]), 2))
    finally:
        ref = finish_reference(proc, out, "tp_b")
        specs = finish_reference(spec_proc, spec_out, "tp_specs")
    return ref, got, specs


@pytest.mark.parametrize("name,dtype", mref.TP_CASES["tp_b"])
def test_tp_world_serves_like_repro(world, name, dtype):
    hold(world[1][(name, dtype)], world[0][(name, dtype)], name, dtype)


def _reference_cache(model, cfg, batch, max_len):
    """The port's cache in the reference's layout: each pattern position's
    leaves stacked over the cycles (a `Stacked`), the remainder's apart,
    the fill level a scalar."""
    layers = model.init_cache(batch, max_len)["layers"]
    period, n_cyc = len(cfg.block_pattern), cfg.pattern_cycles
    blocks = tuple({k: Stacked(layers[c * period + i][k]
                               for c in range(n_cyc))
                    for k in layers[i]} for i in range(period)) \
        if n_cyc else ()
    return {"blocks": blocks, "pos": 0,
            "rem": tuple(layers[n_cyc * period:])}


@pytest.mark.parametrize("shape", mref.TP_SPEC_SHAPES)
def test_serve_placement_specs_match_repro(world, shape):
    want = world[2]

    def norm(spec):
        return [list(p) if isinstance(p, tuple) else p for p in spec]
    for name in tconfigs.ARCH_NAMES:
        cfg = tconfigs.get_smoke(name)
        rules = ShardingRules(make_mesh(shape, ("data", "model")), "tp")
        model = LM(cfg, device="meta")
        cache = _reference_cache(model, cfg, 8, 32 + cfg.patch_prefix)
        batch = {"tokens": torch.empty(
            (8, 32 - cfg.patch_prefix) + ((cfg.n_codebooks,)
                                          if cfg.n_codebooks else ()),
            device="meta")}
        if cfg.patch_prefix:
            batch["patch_embeds"] = torch.empty(
                (8, cfg.patch_prefix, cfg.d_model), device="meta")
        got = ([norm(pl.spec) for pl in leaves(param_shardings(
                    rules, model.param_tree(), serve=True))],
               [norm(pl.spec) for pl in leaves(cache_shardings(
                   rules, cache))],
               {k: norm(pl.spec) for k, pl in
                batch_shardings(rules, batch).items()})
        assert got == want[(shape, name)], name


def test_no_serve_placement_splits_the_experts():
    """E is smaller than D and F in every MoE configuration, so the
    placement rule never picks the expert dim and no token exchange is
    called for."""
    for name in tconfigs.ARCH_NAMES:
        for cfg in (tconfigs.get(name), tconfigs.get_smoke(name)):
            if not cfg.moe:
                continue
            for n in (2, 4, 16):
                rules = ShardingRules(make_mesh((1, n), ("data", "model")),
                                      "tp")
                tree = LM(cfg, device="meta").param_tree()
                sh = param_shardings(rules, tree, serve=True)
                for w in ("w1", "w3", "w2"):
                    spec = sh["blocks"][0]["moe"]["experts"][w].spec
                    assert spec[1] is None, (cfg.name, n, w, spec)


def test_qwen_full_width_serve_placements():
    """The worked example of the placement rule at qwen2.5-14b's published
    widths on a "model" axis of two: wq, wo, w1, w3 and the head split on
    their output dim, wk, wv and w2 on their input dim, the embedding on
    its vocabulary, the norm and bias vectors in half."""
    cfg = tconfigs.get("qwen2.5-14b")
    rules = ShardingRules(make_mesh((1, 2), ("data", "model")), "tp")
    sh = param_shardings(rules, LM(cfg, device="meta").param_tree(),
                         serve=True)
    block = {k: pl.spec for k, pl in sh["blocks"][0].items()}
    out, inp = (None, None, "model"), (None, "model", None)
    assert block == {"wq": out, "wo": out, "w1": out, "w3": out,
                     "wk": inp, "wv": inp, "w2": inp,
                     "ln1": (None, "model"), "ln2": (None, "model"),
                     "bq": (None, "model"), "bk": (None, "model"),
                     "bv": (None, "model")}
    assert sh["head"].spec == (None, "model")
    assert sh["embed"].spec == ("model", None)
    assert sh["final_norm"].spec == ("model",)
