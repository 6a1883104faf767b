"""Stateful buffer-by-buffer NEWT synthesis (counterpart of the JAX
``streaming/synth.py``).

A stream renders K control frames (K*hop samples) per :meth:`StreamingSynth
.step` and carries what joins one buffer to the next in a
:class:`StreamState`: the GRU state, the oscillator phase, the last f0 and
FiLM frames (each buffer ramps on from them), the noise branch's raw-noise
prefix and overlap-add tail, and the reverb's frequency-domain delay line
and tail.

Semantics kept from JAX:

* within a buffer, f0 and the FiLM parameters ramp linearly from the
  previous control frame to each new frame over one hop
  (:func:`segment_interp`), continuous across buffers, where the offline
  graph upsamples with align_corners=False;
* per-stream harmonic phase offsets, (B, H), are drawn once at
  :meth:`StreamingSynth.init_state` and carried;
* ``prev_f0`` starts at 0 Hz, so the first buffer ramps up from 0 Hz;
* the noise filter of each control frame is applied to its own frame, then
  a rectangular overlap-add whose overlap count r = n_fft/hop divides it;
* the reverb is a true linear convolution by uniform-partitioned FFT, not
  the offline graph's circular one.

Where the port differs: the oscillator phase is summed and carried in
float64 (``ops/oscillator.py``); the reverb delay line is complex64 (JAX
stores re/im float pairs for a TPU runtime's sake); the noise comes from a
``torch.Generator`` on the stream's device where JAX splits a key, so the
same seed gives other noise (a test injects it with ``step(noise=...)``).

On the card, with ``NEWT.fused`` ``"cr"`` (the default), NEWT's FiLM ->
shaper -> FiLM runs the hand-written CUDA stream kernel
(``kernels/csrc/newt_fused_stream.cu``); JAX runs its Pallas kernel on the
TPU backend only.
"""
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.neural_waveshaping import NeuralWaveshaping
from ..ops.fir import (
    n_partitions,
    partition_ir_spectra,
    partitioned_convolve_step,
    windowed_fir_from_magnitude,
)
from ..ops.stft import frame_signal, overlap_add
from ..ops.upsample import segment_interp

__all__ = ["StreamState", "StreamingSynth", "segment_interp"]


class StreamState(NamedTuple):
    """The carries of B streams, tensors on one device."""

    gru_h: torch.Tensor  # (B, H) control-encoder GRU state
    osc_phase: torch.Tensor  # (B,) float64 phase accumulator, wrapped mod tau
    phase_offset: torch.Tensor  # (B, n_harmonics) per-stream phase offsets
    prev_f0: torch.Tensor  # (B,) last f0 frame (Hz)
    prev_film: torch.Tensor  # (B, 4C) last FiLM frame, contiguous
    noise_prev: torch.Tensor  # (B, n_fft - hop) raw noise carried into the next frames
    noise_ola: torch.Tensor  # (B, n_fft - hop) overlap-add tail of the noise branch
    reverb_fdl: torch.Tensor  # (B, P, block + 1) complex64 delay line, newest first
    reverb_tail: torch.Tensor  # (B, block) overlap-add tail of the reverb
    generator: torch.Generator  # draws each buffer's noise, on the state's device


class StreamingSynth:
    """Streams a :class:`NeuralWaveshaping` (on the device the streams run
    on) in buffers of ``buffer_frames`` control frames."""

    def __init__(self, model: NeuralWaveshaping, buffer_frames: int):
        if buffer_frames < 1:
            raise ValueError(f"buffer_frames must be >= 1, got {buffer_frames}")
        n_fft = model.noise_synth.ir_length
        if n_fft % model.control_hop or n_fft < model.control_hop:
            raise ValueError(f"the noise FIR length {n_fft} must be a multiple of the hop")
        self.model = model
        self.buffer_frames = buffer_frames

    @property
    def hop(self) -> int:
        return self.model.control_hop

    @property
    def buffer_size(self) -> int:
        return self.buffer_frames * self.hop

    @property
    def device(self) -> torch.device:
        return self.model.harmonic_mixer.w.device

    # -- state ---------------------------------------------------------------
    def init_state(
        self,
        batch: int,
        generator: Optional[torch.Generator] = None,
        phase_offset: Optional[torch.Tensor] = None,
        device="cuda",
    ) -> StreamState:
        """Zero carries for ``batch`` streams on ``device`` (the card unless
        told otherwise; it raises without one) and the model's device.

        ``generator`` (on ``device``) draws the (B, H) phase offsets, uniform
        in [-pi, pi), and later each buffer's noise; a new one seeded with 0
        when None. ``phase_offset`` (B, H) injects the offsets instead."""
        dev = resolve_device(device)
        if self.device.type != dev.type or (dev.index is not None and self.device != dev):
            raise ValueError(f"the model is on {self.device}, the streams asked for {dev}")
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif torch.device(generator.device).type != dev.type:
            raise ValueError(f"the generator is on {generator.device}, the streams on {dev}")
        m = self.model
        n_harm = m.osc.n_harmonics
        if phase_offset is None:
            u = torch.rand((batch, n_harm), generator=generator, device=dev)
            phase_offset = u * (2 * torch.pi) - torch.pi
        elif tuple(phase_offset.shape) != (batch, n_harm):
            raise ValueError(f"phase_offset must be ({batch}, {n_harm}), got {tuple(phase_offset.shape)}")
        overlap = m.noise_synth.ir_length - self.hop
        block = self.buffer_size
        n_part = n_partitions(m.reverb.impulse_response().shape[-1], block)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return StreamState(
            gru_h=zeros(batch, m.embedding.gru.rnn.hidden_size),
            osc_phase=zeros(batch, dtype=torch.float64),
            phase_offset=phase_offset.to(dev, torch.float32),
            prev_f0=zeros(batch),
            prev_film=zeros(batch, 4 * m.newt.n_waveshapers),
            noise_prev=zeros(batch, overlap),
            noise_ola=zeros(batch, overlap),
            reverb_fdl=zeros(batch, n_part, block + 1, dtype=torch.complex64),
            reverb_tail=zeros(batch, block),
            generator=generator,
        )

    @torch.inference_mode()
    def ir_partition_spectra(self) -> torch.Tensor:
        """(P, block + 1) complex64 spectra of the reverb IR's zero-padded
        blocks (make once per stream set and pass to :meth:`step`)."""
        return partition_ir_spectra(self.model.reverb.impulse_response(), self.buffer_size)

    # -- step ----------------------------------------------------------------
    @torch.inference_mode()
    def step(
        self,
        state: StreamState,
        f0: torch.Tensor,
        control: torch.Tensor,
        ir_spectra: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, StreamState]:
        """One buffer: f0 (B, K) Hz and control (B, K, >=2) normalised, on
        the state's device -> ((B, K*hop) audio, next state).

        ``noise``: (B, K*hop) uniform [0, 1) excitation to use instead of a
        draw from ``state.generator``. Nothing here waits for the device."""
        m = self.model
        hop, k = self.hop, self.buffer_frames
        b = f0.shape[0]
        if tuple(f0.shape) != (b, k) or control.shape[:2] != (b, k):
            raise ValueError(
                f"a buffer is f0 ({b}, {k}) and control ({b}, {k}, >=2); got "
                f"{tuple(f0.shape)} and {tuple(control.shape)}"
            )

        # 1-2. control encoder with the carried GRU state; control-rate features
        emb, gru_h = m.get_embedding(control, state.gru_h)
        film = m.newt.film_params(emb)  # (B, K, 4C)
        h_re = m.h_generator(emb)  # (B, K, bins)

        # 3-4. f0 ramped from the carried frame; exciter with the carried phase
        f0_aud = segment_interp(state.prev_f0[:, None], f0[..., None], hop)[..., 0]
        bank = m.osc(f0_aud, phase_offset=state.phase_offset, initial_phase=state.osc_phase)
        osc_phase = m.osc.carry_phase(f0_aud, state.osc_phase)
        exciter = m.harmonic_mixer(bank)  # (B, K*hop, C)

        # 5. FiLM -> shaper -> FiLM with the FiLM ramped from the carried frame
        shaped = m.newt.forward_stream(exciter, state.prev_film, film)[..., 0]

        # 6. noise: each frame's windowed FIR, then the streaming rectangular OLA
        n_fft = m.noise_synth.ir_length
        r = n_fft // hop
        if noise is None:
            noise = torch.rand((b, k * hop), generator=state.generator, device=f0.device)
        noise_sig = torch.cat([state.noise_prev, noise], dim=-1)  # exactly K frames
        spec = torch.fft.rfft(frame_signal(noise_sig, n_fft, hop), dim=-1)
        frames_out = torch.fft.irfft(spec * windowed_fir_from_magnitude(h_re), n=n_fft, dim=-1)
        ola = overlap_add(frames_out, hop, (k + r - 1) * hop)
        overlap = n_fft - hop
        ola = torch.cat([ola[:, :overlap] + state.noise_ola, ola[:, overlap:]], dim=-1)
        dry = shaped + ola[:, : k * hop] / r  # r: the steady-state overlap count

        # 7. reverb: uniform-partitioned FFT convolution (a linear convolution)
        if ir_spectra is None:
            ir_spectra = self.ir_partition_spectra()
        wet, fdl, reverb_tail = partitioned_convolve_step(
            dry, state.reverb_fdl, state.reverb_tail, ir_spectra
        )

        new_state = StreamState(
            gru_h=gru_h,
            osc_phase=osc_phase,
            phase_offset=state.phase_offset,
            prev_f0=f0[:, -1],
            prev_film=film[:, -1].contiguous(),
            noise_prev=noise_sig[:, k * hop :],
            noise_ola=ola[:, k * hop :],
            reverb_fdl=fdl,
            reverb_tail=reverb_tail,
            generator=state.generator,
        )
        return dry + wet, new_state
