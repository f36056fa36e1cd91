"""The port's GPipe pipeline (`repro_torch.dist.pipeline`) against
`repro`'s `make_pipelined_loss`.

tests/test_pipeline.py's problem (S = 4 stages, M = 4 microbatches of 2
rows, D = 16, `default_rng(0)`): the reference runs it in a subprocess
with four host devices (tests/torch_multidev_ref.py, its "pipeline"
part), the port in a gloo world of four CPU ranks, one stage a rank
(`run_world`, rank side in tests/torch_pipeline_ranks.py, which imports no
JAX), with the parameters whole on every rank and placed P("pod").  Bars,
the reference test's: loss within 1e-5; every gradient within rtol 1e-4,
atol 1e-5, of the reference's and of the sequential stages'.  Then
n_micro = 1, the two ValueErrors, and a 2-stage pipeline of a float32
smoke model's blocks against the same blocks in sequence.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_pipeline_ranks as ranks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist.pipeline import make_pipelined_loss  # noqa: E402
from repro_torch.dist.world import run_world  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 4-rank world, at once."""
    import pickle
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    out = os.path.join(tmp, "ref.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ref = subprocess.Popen([sys.executable,
                            os.path.join(HERE, "torch_multidev_ref.py"), out,
                            "pipeline"], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env)
    try:
        got = run_world(ranks.world4, 4, device="cpu", store_dir=tmp)
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)["pipeline"], got


def _grads_close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("placed", ["whole", "placed"])
@pytest.mark.parametrize("n_micro", [4, 1])
def test_pipelined_loss_and_grads_match_repro(runs, n_micro, placed):
    ref, got = runs
    loss_r, grads_r = ref[n_micro]
    loss, grads = got["toy"][n_micro][placed]
    assert abs(loss - loss_r) < 1e-5, (loss, loss_r)
    _grads_close(grads, grads_r)
    # and the sequential stages
    loss_s, grads_s = got["toy"][n_micro]["sequential"]
    assert abs(loss - loss_s) < 1e-5
    _grads_close(grads, grads_s)


def test_the_two_value_errors(runs):
    assert runs[1]["errors"] == [
        "batch 8 not divisible by n_micro=3",
        "pipeline stages must be shape-homogeneous: (4, 16) -> (4, 15)"]


def test_more_than_one_stage_needs_a_process_group():
    params, x, y = ranks.problem()
    pipe = make_pipelined_loss(make_mesh((4,), ("pod",)), ranks.stage_fn,
                               ranks.loss_fn, n_micro=4)
    with pytest.raises(RuntimeError, match="process group"):
        pipe({k: torch.from_numpy(v) for k, v in params.items()},
             torch.from_numpy(x), torch.from_numpy(y))


def test_two_stage_pipeline_of_model_blocks(tmp_path):
    out = run_world(ranks.lm_stages, 2, device="cpu", store_dir=str(tmp_path),
                    args=(configs.get_smoke("minicpm-2b"),))
    assert abs(out["pipelined"] - out["sequential"]) < 1e-5
    assert len(out["grads"]) == len(out["want"]) > 5
    for g, w in zip(out["grads"], out["want"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
