"""PyTorch/CUDA port of neural waveshaping synthesis (NEWT).

A second package beside the JAX one (``neural_waveshaping_synthesis_tpu``),
which stays the reference: every module here keeps its counterpart's name
and is held against it by the ``tests/test_torch_*.py`` parity tests.

The port imports ``torch``, numpy and scipy only — never JAX, and nothing
of the JAX package. Public functions keep the JAX code's channels-last
``(B, T, C)`` layout; randomness comes from ``torch.Generator``s.

Entry points run on ``device="cuda"`` unless the caller asks for
``device="cpu"``, and raise when CUDA is asked for but missing
(:mod:`.device`). The slices ported so far, all float32:

* offline inference: :class:`inference.resynthesis.Synthesizer` renders
  control signals to audio through
  :class:`models.neural_waveshaping.NeuralWaveshaping`;
* training: :class:`training.trainer.Trainer` fits the model on a
  :class:`data.general.GeneralDataModule` (the reference's ``.npy``
  shards) with the multi-resolution STFT loss, clip + Adam + StepLR, logs
  the JAX trainer's metrics (:mod:`training.logging`), and writes
  reference-format checkpoints that ``Synthesizer`` serves;
  ``scripts/torch_train.py`` drives it from the repo's gin files through
  the port's copy of :mod:`minigin`;
* streaming: :class:`streaming.StreamingSynth` renders buffer by buffer
  with carried state, and :class:`streaming.PipelinedStreamer` keeps
  several buffers in flight;
* timbre transfer: :func:`inference.timbre_transfer.timbre_transfer` and
  ``stream_timbre_transfer`` take audio of any rate to the checkpoint's
  instrument, extracting f0 (YIN) and loudness with :mod:`data.preprocess`.

On the card the model's FiLM -> shaper -> FiLM block runs the
hand-written CUDA kernels of :mod:`kernels.newt_fused`: the control-rate
forward and, in training, its backward (``NEWT.fused = "cr"``, the
default); with ``"full_lane"``/``"fl"``/``True`` the audio-rate forward and
backward; in a stream the streaming forward. FastNEWT's
table lookup runs the CUDA kernel of :mod:`kernels.fast_newt`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
