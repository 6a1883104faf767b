"""The port's timbre-transfer notebook runs top to bottom on the CPU.

Executes every code cell of ``colab/NEWT_Timbre_Transfer_torch.ipynb`` in
order in one namespace with ``NWS_DEVICE=cpu``, against its default
checkpoint (the repo's run120k_cr ``best.ckpt``, statistics beside it) and a
4-s vibrato tone given through the notebook's env-var parameters, and
checks what ``tests/test_notebook.py`` checks of JAX's notebook: the output
wav, its rate and length, the speed factor and the FastNEWT cell's output.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from neural_waveshaping_synthesis_tpu_torch import minigin as gin

REPO = Path(__file__).resolve().parents[1]
NOTEBOOK = REPO / "colab" / "NEWT_Timbre_Transfer_torch.ipynb"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's tests, restored after: the test
    workers share the machine's cores, and torch's default of a thread per
    core in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_notebook_runs_top_to_bottom(tmp_path, monkeypatch):
    sr = 16000
    t = np.arange(4 * sr) / sr
    f = 330 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
    wav = (0.4 * np.sin(2 * np.pi * np.cumsum(f) / sr)).astype(np.float32)
    in_path = tmp_path / "in.wav"
    wavfile.write(in_path, sr, (wav * 32767).astype(np.int16))
    out_path = tmp_path / "out.wav"

    monkeypatch.delenv("NWS_CHECKPOINT", raising=False)
    monkeypatch.delenv("CREPE_WEIGHTS", raising=False)
    monkeypatch.setenv("NWS_INPUT_WAV", str(in_path))
    monkeypatch.setenv("NWS_OUTPUT_WAV", str(out_path))
    monkeypatch.setenv("NWS_DEVICE", "cpu")
    monkeypatch.chdir(REPO / "colab")

    import matplotlib

    matplotlib.use("Agg")  # headless plot cell

    nb = json.loads(NOTEBOOK.read_text())
    ns = {}
    try:
        for i, cell in enumerate(nb["cells"]):
            if cell["cell_type"] != "code":
                continue
            src = "".join(cell["source"])
            assert "jax" not in src and "neural_waveshaping_synthesis_tpu." not in src, src
            try:
                exec(compile(src, f"<cell {i}>", "exec"), ns)
            except Exception as e:  # noqa: BLE001
                pytest.fail(f"notebook cell {i} raised {type(e).__name__}: {e}\n{src}")
    finally:
        gin.clear_config()  # the notebook parses the model gin file globally

    assert ns["CHECKPOINT"].endswith("docs/results/run120k_cr/checkpoint/best.ckpt")
    assert str(ns["synth"].device) == "cpu"
    assert out_path.exists()
    out_sr, out = wavfile.read(out_path)
    assert out_sr == 16000
    assert len(out) == len(ns["out"])
    assert ns["x_realtime"] > 0
    # FastNEWT cell ran and produced comparable audio
    assert ns["out_fast"].shape == ns["out"].shape
    assert np.all(np.isfinite(ns["out"])) and np.all(np.isfinite(ns["out_fast"]))
