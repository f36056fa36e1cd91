"""The port's LM serving path against `repro`'s: carried caches, the
serving engine, the serving driver, the plain float32 forward, and the two
reference faults the port does not copy (ROADMAP C).

Float32 smoke configs (rtol = atol = 1e-4, tests/torch_lm_parity.py) with
the reference's weights loaded through `convert.lm_params_from_repro`.
"""

import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.ref import plain_forward  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from torch_lm_parity import (as_np, close, inputs, jitted, pair,  # noqa: E402
                             same_cache)
from torch_lm_parity import to_torch as _t  # noqa: E402

torch.set_num_threads(1)
F32 = "float32"


@pytest.mark.parametrize("name", ["qwen2.5-14b", "mixtral-8x7b",
                                  "recurrentgemma-9b", "xlstm-350m",
                                  "musicgen-medium"])
def test_cache_carried_from_repro(name):
    """Prefill in the reference, carry its cache over, decode in the port:
    the same logits and caches as decoding on in the reference.  The
    prompt of 20 tokens is longer than the smoke window of 16, so the
    sliding-window ring has wrapped."""
    cr, rm, params, ct, tm = pair(name, F32)
    _, pre, dec = jitted(name, F32)
    b, s = 2, 20
    toks, _ = inputs(cr, b, s + 3, seed=7)
    rc = rm.init_cache(b, 32)
    _, rc = pre(params, jnp.asarray(toks[:, :s]), rc)
    tc = convert.lm_cache_from_repro(ct, jax.tree.map(np.asarray, rc),
                                     device="cpu")
    with torch.no_grad():
        for j in range(3):
            tok = toks[:, s + j:s + j + 1]
            lr, rc = dec(params, jnp.asarray(tok), rc)
            lt, tc = tm.decode_step(_t(tok), tc)
            close(lt, lr, F32, f"{name} decode {j}")
            same_cache(ct, rc, tc, F32, f"{name} decode {j}")


@pytest.mark.parametrize("s", [128, 130])
def test_xlstm_cache_after_a_long_prefill(s):
    """The reference pads a prefill to its 128-step chunk and carries the
    state through the padding: after 130 tokens its next decode step is
    off, the port's equals its own forward_train at that position.  At
    128 tokens (no padding) the port equals the reference."""
    name = "xlstm-350m"
    cr, rm, params, ct, tm = pair(name, F32)
    fwd, pre, dec = jitted(name, F32)
    toks, _ = inputs(cr, 1, s + 1, seed=3)
    rc = rm.init_cache(1, s + 8)
    lr_pre, rc = pre(params, jnp.asarray(toks[:, :s]), rc)
    lr_dec, _ = dec(params, jnp.asarray(toks[:, s:]), rc)
    with torch.no_grad():
        full, _ = tm.forward_train(_t(toks))
        tc = tm.init_cache(1, s + 8)
        lt_pre, tc = tm.prefill(_t(toks[:, :s]), tc)
        lt_dec, tc = tm.decode_step(_t(toks[:, s:]), tc)
    close(lt_pre[:, 0], full[:, s - 1], F32, "prefill vs own forward")
    close(lt_dec[:, 0], full[:, s], F32, "decode vs own forward")
    ref_err = np.abs(as_np(lr_dec)[:, 0] - as_np(full)[:, s]).max()
    if s % 128:
        assert ref_err > 0.1, ref_err          # the reference's fault
    else:
        close(lt_pre, lr_pre, F32, "prefill vs repro")
        close(lt_dec, lr_dec, F32, "decode vs repro")
        assert ref_err < 1e-4, ref_err


GREEDY = [n for n in rconfigs.ARCH_NAMES if n != "musicgen-medium"]


@pytest.mark.parametrize("name", GREEDY)
def test_generate_greedy_matches_repro(name):
    """Each token is the argmax of the port's own logits, and the tokens
    equal the reference engine's."""
    cr, rm, params, ct, tm = pair(name, F32)
    toks, _ = inputs(cr, 2, 12, seed=11)
    want = RServeEngine(rm, params, max_len=32).generate(jnp.asarray(toks), 6)
    seen = {}
    got = ServeEngine(tm, max_len=32).generate(
        _t(toks), 6, on_logits=lambda i, lg: seen.__setitem__(i, lg.clone()))
    assert got.shape == (2, 6) and got.dtype == torch.int32
    for i in range(6):
        assert torch.equal(got[:, i], torch.argmax(seen[i][:, -1], dim=-1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_keeps_the_codebook_axis():
    """musicgen generates [B, n_steps, n_cb] (the reference reshapes the
    [B, 1, n_cb] token to [B, 1] and raises); greedy and sampled."""
    cr, rm, params, ct, tm = pair("musicgen-medium", F32)
    toks, _ = inputs(cr, 2, 12, seed=11)
    eng = ServeEngine(tm, max_len=32)
    seen = {}
    got = eng.generate(_t(toks), 5, on_logits=lambda i, lg: seen.__setitem__(
        i, lg.clone()))
    assert got.shape == (2, 5, cr.n_codebooks)
    for i in range(5):
        assert torch.equal(got[:, i], torch.argmax(seen[i][:, -1], dim=-1))
    with pytest.raises(TypeError):
        RServeEngine(rm, params, max_len=32).generate(jnp.asarray(toks), 2)
    draws = [eng.generate(_t(toks), 5, greedy=False,
                          generator=torch.Generator().manual_seed(4))
             for _ in range(2)]
    assert draws[0].shape == (2, 5, cr.n_codebooks)
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < cr.vocab_size


def _admissions(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [ln for ln in out.getvalue().splitlines()
            if ln.startswith("decode batch of")]


@pytest.mark.parametrize("arch", ["minicpm-2b", "xlstm-350m"])
def test_serve_driver_admissions_match_repro(arch, monkeypatch):
    args = ["--arch", arch, "--smoke", "--requests", "12", "--steps", "3",
            "--prompt-len", "6"]
    got = _admissions(tserve.main, args + ["--device", "cpu"])

    def ref_main(argv):
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        return rserve.main()

    want = _admissions(ref_main, args)
    assert got == want and len(got) >= 2


@pytest.mark.parametrize("name", rconfigs.ARCH_NAMES)
def test_plain_forward_matches_repro(name):
    """The plain float32 forward (full softmax, step loops, no cache)
    against the reference's forward_train; for the MoE configs at
    capacity_factor 1.0, so tokens are dropped."""
    moe = rconfigs.get_smoke(name).moe
    over = dict(capacity_factor=1.0) if moe else {}
    cr, rm, params, ct, tm = pair(name, F32, **over)
    toks, pe = inputs(cr, 2, 20, seed=5)
    pej = () if pe is None else (jnp.asarray(pe),)
    want, _ = jax.jit(rm.forward_train)(params, jnp.asarray(toks), *pej)
    got = plain_forward(tm, _t(toks), None if pe is None else _t(pe))
    assert got.dtype == torch.float32
    close(got, want, F32, name)


def test_port_entry_points_default_to_cuda():
    """No card: the entry points raise instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(tconfigs.get_smoke("minicpm-2b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke"])
