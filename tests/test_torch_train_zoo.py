"""`LM.loss` and every gradient of the port against `repro`'s, for all ten
architectures at their smoke sizes (the reference's weights carried over
by `convert.lm_params_from_repro`, its gradients mapped by
`convert.grads_from_repro`).

Bars.  float32: the loss at rtol = atol = 1e-5; each gradient leaf
within 1e-4 of its own largest entry, plus a tenth of a float32 ulp of
the model's largest gradient entry (1e-8 of it).  The floor matters
only for xLSTM's input-gate biases (`b_i`, `bi`): the exponential
gate's stabilizer cancels their gradient to rounding noise (about 1e-8
against 27 for the embedding), where neither package's value means
anything.  bf16 and remat: tests/test_torch_train_zoo_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from torch_lm_parity import as_np, inputs, pair  # noqa: E402

torch.set_num_threads(1)

ARCHS = list(rconfigs.ARCH_NAMES)


def _batches(cr, b=2, s=20):
    toks, pe = inputs(cr, b, s)
    rb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if pe is not None:
        rb["patch_embeds"] = jnp.asarray(pe, jnp.bfloat16)
        tb["patch_embeds"] = torch.from_numpy(pe).to(torch.bfloat16)
    return rb, tb


def _port_grads(tm, tb):
    for p in tm.parameters():
        p.grad = None
    loss = tm.loss(tb)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    for p in tm.parameters():
        p.grad = None
    return loss.detach(), grads


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_float32(name):
    cr, rm, params, ct, tm = pair(name, "float32")
    rb, tb = _batches(cr)
    lr, gr = jax.jit(jax.value_and_grad(rm.loss))(params, rb)
    lt, gt = _port_grads(tm, tb)
    np.testing.assert_allclose(float(lt), float(lr), rtol=1e-5, atol=1e-5)
    want = convert.grads_from_repro(ct, jax.tree.map(np.asarray, gr),
                                    device="cpu")
    assert want.keys() == gt.keys()
    top = max(float(np.abs(as_np(w)).max()) for w in want.values())
    for n, w in want.items():
        w, g = as_np(w), as_np(gt[n])
        bar = 1e-4 * float(np.abs(w).max()) + 1e-8 * top
        err = float(np.abs(g - w).max())
        assert err <= bar, (name, n, err, bar)
