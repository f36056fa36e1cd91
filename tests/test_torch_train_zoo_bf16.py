"""`LM.loss` in bf16 against `repro`'s for all ten architectures at their
smoke sizes, and remat on and off in the port (the float32 loss and
gradients: tests/test_torch_train_zoo.py).

Bars.  bf16: the loss at 2e-2, the reference's own bf16 bar; the
recurrent architectures meet it too (within 1e-3), so phase 10a's
one-ulp-spread rule is not needed for the loss.  With remat on and off
the port's loss and gradients are bit-identical (the recomputed forward
is the same sequence of ops).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_zoo import ARCHS, _batches, _port_grads  # noqa: E402
from torch_lm_parity import pair  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_bf16(name):
    cr, rm, params, ct, tm = pair(name, "bfloat16")
    rb, tb = _batches(cr)
    lr = jax.jit(rm.loss)(params, rb)
    with torch.no_grad():
        lt = tm.loss(tb)
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(float(lt), float(lr), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", ["minicpm-2b", "mixtral-8x7b",
                                  "recurrentgemma-9b", "pixtral-12b"])
def test_remat_on_and_off_identical(name):
    _, _, _, ct, tm = pair(name, "bfloat16")
    cr = dataclasses.replace(ct, remat=False)
    _, tb = _batches(ct)
    assert ct.remat
    l_on, g_on = _port_grads(tm, tb)
    tm.cfg = cr
    try:
        l_off, g_off = _port_grads(tm, tb)
    finally:
        tm.cfg = ct
    assert torch.equal(l_on, l_off)
    for n in g_on:
        assert torch.equal(g_on[n], g_off[n]), n
