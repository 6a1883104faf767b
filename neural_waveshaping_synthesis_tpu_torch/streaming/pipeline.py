"""Pipelined (multi-buffered) streaming (counterpart of the JAX
``streaming/pipeline.py``).

A serial loop (step buffer k, copy it to the host, wait, step k+1) leaves
the card idle while the host waits for each copy and the host idle while
the card computes. PyTorch enqueues CUDA work asynchronously, so
:meth:`PipelinedStreamer.push` enqueues the step, then an asynchronous
copy of its audio into a pinned host buffer, and records a CUDA event
after the copy; the buffer is handed out ``depth`` pushes later, when
:meth:`PipelinedStreamer.pop` waits on its event. Up to ``depth`` buffers
are in flight; the price is ``depth`` buffers of output latency.

The pipeline changes when samples reach the host, never what they are:
its output is bit-identical to the serial loop over the same controls.
"""
from collections import deque
from typing import Callable, Deque, Iterator, Optional, Tuple

import numpy as np
import torch

from .synth import StreamingSynth


class PipelinedStreamer:
    """``batch`` streams of a :class:`StreamingSynth`, ``depth`` buffers
    in flight::

        streamer = PipelinedStreamer(synth, batch=1, generator=g, depth=4)
        for f0, control in controls:        # (B, K) Hz, (B, K, 2) normalised
            audio = streamer.push(f0, control)  # None while priming
            if audio is not None:
                play(audio)                     # (B, K*hop), from depth pushes ago
        for audio in streamer.flush():
            play(audio)

    ``device`` is the card unless told otherwise (it raises without one);
    ``generator`` (on that device) is :meth:`StreamingSynth.init_state`'s.
    ``step`` (JAX's ``jit_step``) replaces :meth:`StreamingSynth.step`: it
    takes and returns what that does, ``(state, f0, control, ir_spectra) ->
    (audio, state)``, and its audio may be of another dtype (a cast on the
    card before the copy, e.g. the int16 wire of ``scripts/
    torch_serving_capacity.py``); the pinned host buffer takes that dtype.
    """

    def __init__(
        self,
        synth: StreamingSynth,
        batch: int,
        generator: Optional[torch.Generator] = None,
        depth: int = 4,
        device="cuda",
        step: Optional[Callable] = None,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.synth = synth
        self.depth = depth
        self.state = synth.init_state(batch, generator, device=device)
        self.ir_spectra = synth.ir_partition_spectra()
        self._step = synth.step if step is None else step
        self._inflight: Deque[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = deque()

    def __len__(self) -> int:
        return len(self._inflight)

    def _to_device(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.float32)
        if t.device == self.synth.device:
            return t
        if self.synth.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()  # so that the copy below does not wait for the card
        return t.to(self.synth.device, non_blocking=True)

    def push(self, f0, control) -> Optional[np.ndarray]:
        """Enqueue one buffer (f0 (B, K) Hz, control (B, K, >=2), arrays or
        tensors); return the buffer from ``depth`` pushes ago as a (B, K*hop)
        array (float32, or the dtype ``step`` returns), or None while the
        pipeline is priming."""
        audio, self.state = self._step(
            self.state, self._to_device(f0), self._to_device(control), self.ir_spectra
        )
        if audio.is_cuda:
            host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
            host.copy_(audio, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._inflight.append((host, done))
        else:
            self._inflight.append((audio, None))
        if len(self._inflight) > self.depth:
            return self.pop()
        return None

    def pop(self) -> np.ndarray:
        """Wait for the oldest buffer in flight and return it."""
        if not self._inflight:
            raise IndexError("pop from an empty pipeline")
        host, done = self._inflight.popleft()
        if done is not None:
            done.synchronize()
        return host.numpy()

    def flush(self) -> Iterator[np.ndarray]:
        """Drain the buffers still in flight (end of stream)."""
        while self._inflight:
            yield self.pop()
