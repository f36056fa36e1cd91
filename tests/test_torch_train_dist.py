"""The port's compressed data-parallel gradient (`dist.compression.
make_compressed_grad_fn`) against `repro`'s.

The reference test (tests/test_substrate.py) runs it on a (1,) mesh and
holds the grads within atol 2e-2 of the exact gradient.  Here: one rank
(no process group) equals repro's (1,) mesh to 1e-6, and a 2-rank gloo
world (`run_world`, rank side in tests/torch_train_ranks.py) with the
batch split in two contiguous halves, as a ("data",) mesh of two would
shard it, holds the grads within the reference test's atol 2e-2 of the
exact full-batch gradient, the loss equal to the full batch's (the mean
of the halves' means), and a non-zero error-feedback residual.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_train_ranks as ranks  # noqa: E402
from repro.dist.compression import make_compressed_grad_fn as r_make  # noqa
from repro_torch.dist.compression import make_compressed_grad_fn  # noqa
from repro_torch.dist.world import run_world  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

W = np.random.default_rng(0).standard_normal((4, 2)).astype(np.float32)
BATCH = np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32)


def _repro(err):
    mesh = jax.make_mesh((1,), ("data",))

    def loss_fn(params, batch):
        return jnp.mean((batch @ params["w"]) ** 2)
    fn = r_make(mesh, loss_fn)
    with mesh:
        loss, grads, new_err = fn({"w": jnp.asarray(W)},
                                  {"w": jnp.asarray(err)},
                                  jnp.asarray(BATCH))
    exact = jax.grad(loss_fn)({"w": jnp.asarray(W)}, jnp.asarray(BATCH))
    return (float(loss), np.asarray(grads["w"]), np.asarray(new_err["w"]),
            np.asarray(exact["w"]))


@pytest.mark.parametrize("err_scale", [0.0, 0.05])
def test_one_rank_equals_repro(err_scale):
    err = (np.random.default_rng(2).standard_normal(W.shape) *
           err_scale).astype(np.float32)
    loss_r, g_r, e_r, _ = _repro(err)
    fn = make_compressed_grad_fn(make_mesh((1,), ("data",)), ranks.loss_fn)
    loss, grads, new_err = fn({"w": torch.from_numpy(W)},
                              {"w": torch.from_numpy(err)},
                              torch.from_numpy(BATCH))
    np.testing.assert_allclose(float(loss), loss_r, rtol=1e-6)
    np.testing.assert_allclose(grads["w"].numpy(), g_r, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(new_err["w"].numpy(), e_r, rtol=1e-6,
                               atol=1e-6)


def test_two_ranks_against_the_exact_gradient(tmp_path):
    _, _, _, exact = _repro(np.zeros_like(W))
    out = run_world(ranks.compressed_grads, 2, device="cpu",
                    store_dir=str(tmp_path),
                    args=(W, BATCH, np.zeros_like(W)))
    full = float(np.mean((BATCH @ W) ** 2))
    np.testing.assert_allclose(out["loss"], full, rtol=1e-6)
    np.testing.assert_allclose(out["grads"], exact, atol=2e-2)
    assert float(np.abs(out["err"]).max()) > 0.0


def test_a_larger_axis_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_compressed_grad_fn(make_mesh((2,), ("data",)), ranks.loss_fn)
