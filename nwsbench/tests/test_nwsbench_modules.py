"""A tiny run of each traffic kind, in a process of its own, loads no
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or the JAX
package's (the port's own name begins with the JAX package's, so names are
compared whole); nor does the plain reference import the port."""
import subprocess
import sys

import pytest

from conftest import ROOT

SCRIPT = """
import sys
sys.path.insert(0, {tests!r})
from conftest import tiny_run
from nwsbench import harness
correct, rec = tiny_run({cell!r})
print("CORRECT", correct)
print("LOADED", harness.forbidden_modules())
"""


@pytest.mark.parametrize("cell", ["newt.train_b8", "fastnewt.render_b32", "newt.stream_live"])
def test_traffic_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(tests=str(ROOT / "nwsbench" / "tests"),
                                                              cell=cell)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CORRECT True" in out.stdout
    assert "LOADED []" in out.stdout


def test_whole_names():
    from nwsbench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["neural_waveshaping_synthesis_tpu_torch_fake"] = sys
        assert harness.forbidden_modules() == [m for m in saved
                                               if m.split(".")[0] in harness.FORBIDDEN_MODULES]
    finally:
        sys.modules.pop("neural_waveshaping_synthesis_tpu_torch_fake", None)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, {root!r}); import nwsbench.reference.stream, "
            "nwsbench.reference.train; print(sorted(m for m in sys.modules "
            "if m.startswith('neural_waveshaping')))").format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
