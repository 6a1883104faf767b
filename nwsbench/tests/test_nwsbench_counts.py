"""The frozen yardstick equals the port's constants today: a later change
to the port's counts shows here, and the benchmark's do not follow it."""
import importlib.util
import json

import pytest

from nwsbench import counts, harness
from neural_waveshaping_synthesis_tpu_torch.kernels import roofline


def test_peaks_and_block_counts():
    assert counts.PEAK_F32_FLOP_PER_S == roofline.PEAK_F32_FLOP_PER_S
    assert counts.PEAK_BYTES_PER_S == roofline.PEAK_BYTES_PER_S
    assert counts.CR_FLOP_PER_ELEMENT == roofline.CR_FLOP_PER_ELEMENT == 757
    assert counts.CR_BWD_FLOP_PER_ELEMENT == roofline.CR_BWD_FLOP_PER_ELEMENT == 1721
    assert counts.PSIN_FLOP == roofline.PSIN_FLOP


@pytest.mark.parametrize("args", [(10, 20, 30, False), (10, 20, 30, True), (7, 0, 3, True)])
def test_shaper_bytes(args):
    assert counts.shaper_bytes(*args) == roofline.shaper_bytes(*args)


@pytest.mark.parametrize("kernel,b,tc", [(1, 8, 500), (2, 8, 500), (1, 32, 500), (2, 2, 7)])
def test_datasheet_bound(kernel, b, tc):
    spec = importlib.util.spec_from_file_location(
        "torch_roofline_shaper", harness.ROOT / "scripts" / "torch_roofline_shaper.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert counts.datasheet_bound_ms(kernel, b, tc, 128) == pytest.approx(
        script.datasheet_bound_ms(kernel, b, tc, 128), rel=1e-12)


def test_model_counts():
    m = harness.read_json(harness.HERE / "configs" / "newt.json")["model"]
    assert counts.n_params(m) == 266945
    # kernel 1's bound at a batch-8 render of 512 frames, as the port's records give it
    assert counts.datasheet_bound_ms(1, 8, 512, 128) == pytest.approx(0.379, abs=5e-4)
    assert counts.datasheet_bound_ms(2, 8, 512, 128) == pytest.approx(0.862, abs=5e-4)
    step = counts.train_step_flop(m, 8, 500)
    fwd = counts.forward_flop(m, 8, 500)
    assert 2.0 * fwd < step < 4.0 * fwd
    assert counts.forward_flop(m, 8, 500, lookup=True) < fwd
    # a second of eight streams in buffers of 8 frames: the forward's work per
    # frame and sample, the reverb as partitions in place of one circular FFT
    streamed = counts.stream_buffer_flop(m, 8, 8) * 500 / 8
    assert 0.8 * fwd < streamed < 1.5 * fwd
