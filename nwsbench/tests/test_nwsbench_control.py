"""The control: the plain reference put in the program's place and
computed with TF32 products, the precision below the configuration's
float32, fails the cell's limits; and the half-batch and stale-slot faults
fail the training cell's. TF32 exists only on the card, so these run there
(``python3 -m pytest nwsbench/tests -m card``), at a size a test run holds:
a render batch of 4 clips, 4 streams of 40 buffers, the recipe's batch of 8
for 3 steps."""
import copy

import pytest

from nwsbench import calibrate, harness


def _cell(name, **params):
    cell, config = harness.load_cell(name)
    cell = copy.deepcopy(cell)
    cell["traffic_params"].update(params)
    return cell, config


@pytest.mark.card
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_train_control_and_fault_fail(card, seed):
    cell, config = _cell("newt.train_b8", train_clips=64)
    out = calibrate.calibrate_train(cell, config["model"], seed, card)
    limits = cell["checks"]
    assert set(out) == {"control", "half_batch", "stale_slot"}
    for reading in out.values():
        assert any(reading[k] > limits[k] for k in limits), reading


@pytest.mark.card
@pytest.mark.parametrize("name", ["fastnewt.render_b32", "newt.render_b32"])
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_render_control_fails(card, name, seed):
    cell, config = _cell(name, batch=4, max_kept=1)
    out = calibrate.calibrate_render(cell, config, seed, card)
    assert out["control"]["audio_nrms"] > cell["checks"]["audio_nrms"], out


@pytest.mark.card
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_stream_control_fails(card, seed):
    cell, config = _cell("newt.stream_live", streams=64, compare_streams=4)
    out = calibrate.calibrate_stream(cell, config["model"], seed, card, pushes=40)
    assert out["control"]["buffer_nrms"] > cell["checks"]["buffer_nrms"], out
