"""The benchmark's own tests: on the CPU, its files, its yardstick, its
plain reference against the port's plain path, and its comparison failing
planted faults, each cell run at a tiny size; tests marked ``card`` need a
CUDA card and skip without one (run them on the card with
``python3 -m pytest nwsbench/tests -m card``)."""
import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from nwsbench import harness  # noqa: E402
from nwsbench.run import load_module  # noqa: E402

# each traffic kind at a size a CPU test run holds; every width is the
# configuration's own
TINY = {
    "train": dict(batch=2, frames=16, train_clips=8, val_clips=2, log_every_n_steps=4,
                  val_every_n_steps=8),
    "render": dict(batch=3, frames=16, warmup_batches=1, sample_every=1, max_kept=2,
                   reference_rows=2),
    "stream": dict(streams=3, warmup_pushes=2, compare_streams=2),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the kernels exist only there")
    return torch.device("cuda")


def tiny_cell(name: str):
    cell, config = harness.load_cell(name)
    cell = copy.deepcopy(cell)
    cell["traffic_params"].update(TINY[cell["traffic"]])
    return cell, config


def tiny_run(name: str, seed: int = 2 ** 31 + 12345, seconds: float = 0.4, device="cpu"):
    """One run of cell ``name`` at its tiny size -> (correct, record)."""
    cell, config = tiny_cell(name)
    ctx = harness.Context(name, seed, seconds, False, cell, config, device, time.time())
    traffic = load_module(harness.HERE / "traffic" / f"{cell['traffic']}.py",
                         f"nwsbench_test_traffic_{cell['traffic']}")
    rec = traffic.run(ctx)
    return harness.judge(rec, cell)[0], rec
