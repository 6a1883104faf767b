"""The plain reference against the port's plain path (the CPU runs the
kernels' plain versions) at a tiny size: each cell's run through its own
traffic module and comparison comes out correct, and its numbers sit far below the
cell's limits."""
import pytest
import torch

from nwsbench.reference import newt as ref
from neural_waveshaping_synthesis_tpu_torch.kernels import fast_newt
from neural_waveshaping_synthesis_tpu_torch.ops.fastmath import fast_sin

from conftest import tiny_run

CELLS = ["newt.train_b8", "fastnewt.render_b32", "newt.render_b32", "newt.stream_live"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_tiny_run_is_correct(cell):
    correct, rec = tiny_run(cell)
    assert correct, rec["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0


def test_polynomial_sine_is_the_ports():
    x = torch.linspace(-700.0, 700.0, 100001)
    assert torch.equal(ref.psin(x), fast_sin(x))


def test_lookup_is_the_ports():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(4096, 64, generator=gen)
    x = torch.randn(5, 64, generator=gen) * 2.5
    x[0, :3] = torch.tensor([-3.5, 3.0, 3.5])
    torch.testing.assert_close(ref.lookup(table, x), fast_newt.fast_newt_lookup_plain(table, x),
                               rtol=1e-6, atol=1e-6)
