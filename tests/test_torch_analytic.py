"""The port's analytic FLOP model (`repro_torch.launch.analytic`) equal to
the reference's for every configuration and smoke configuration, on
every `SHAPES` entry and on the serving shapes of chip_smoke.py's phases
10b and 13b."""

import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import analytic as ranalytic  # noqa: E402
from repro.models.config import ShapeConfig as RShape  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import analytic as tanalytic  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.config import ShapeConfig as TShape  # noqa: E402

#: phase 10b: 8 prompts of 2048 tokens, then decode over 2048 + 32;
#: phase 13b: 4 prompts of 512, then decode over 512 + 16
CHIP_SHAPES = [("prefill", 2048, 8), ("decode", 2080, 8),
               ("prefill", 512, 4), ("decode", 528, 4)]
SHAPE_ARGS = ([(s.name, s.kind, s.seq_len, s.global_batch)
               for s in SHAPES.values()]
              + [(f"chip_{k}_{n}x{b}", k, n, b) for k, n, b in CHIP_SHAPES])
KINDS = ("attn", "swa", "rglru", "mlstm", "slstm")


def _pair(name, smoke):
    if smoke:
        return rconfigs.get_smoke(name), tconfigs.get_smoke(name)
    return rconfigs.get(name), tconfigs.get(name)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", tconfigs.ARCH_NAMES)
def test_cell_and_block_flops_equal_the_reference(name, smoke):
    rc, tc = _pair(name, smoke)
    for args in SHAPE_ARGS:
        want = ranalytic.cell_flops(rc, RShape(*args))
        got = tanalytic.cell_flops(tc, TShape(*args))
        assert got == want, (name, smoke, args)
    for kind in KINDS:
        for tokens, s_kv in ((1.0, 4096.0), (2048.0, 1536.5), (7.0, 3.0)):
            try:
                want = ranalytic.block_flops(rc, kind, tokens, s_kv)
            except (ValueError, ZeroDivisionError) as e:
                with pytest.raises(type(e)):
                    tanalytic.block_flops(tc, kind, tokens, s_kv)
                continue
            assert tanalytic.block_flops(tc, kind, tokens, s_kv) == want
    for s in (1, 17, 2048, 32768):
        assert tanalytic._attn_kv_effective(tc, s) == \
            ranalytic._attn_kv_effective(rc, s)
