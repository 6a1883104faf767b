"""The full NEWT synthesizer graph (counterpart of the JAX
``models/neural_waveshaping.py`` ``NeuralWaveshaping.apply``, here
``forward``):

    f0 (B, Tc) Hz --linear upsample--> f0 (B, Ta)
        '-> harmonic oscillator (B, Ta, 101) --mixer--> exciter (B, Ta, 64)
    control (B, Tc, 2) --GRU+proj--> embedding (B, Tc, 128)
        |-> NEWT: FiLM > shaper bank > FiLM > mix --> (B, Ta, 1)
        '-> noise MLP > H (B, Tc, 129) > FIR noise --> (B, Ta)
    sum --> learned reverb --> audio (B, Ta)

float32 throughout (the JAX inference default ``compute_dtype``). The
exciter-fusing options of the JAX model (``fuse_exciter``,
``fuse_out_mixer``, both off there by default) are not ported.

The model and its submodules are gin configurables (:mod:`..minigin`), so
the repo's ``gin/models/newt.gin`` bindings reach them as they reach the
JAX model's ``default_factory`` submodules: the noise MLP and the noise
synth are built inside the ``noise_synth`` scope.
"""
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .. import minigin as gin
from ..ops.oscillator import draw_phase_offset
from ..ops.upsample import linear_upsample
from .generators import FIRNoiseSynth, HarmonicOscillator, Reverb
from .modules import ControlModule, Dense, Params, TimeDistributedMLP
from .newt import NEWT


def _default_noise_mlp(generator=None) -> TimeDistributedMLP:
    """The noise branch's H generator, built in the ``noise_synth`` scope
    (``noise_synth/TimeDistributedMLP.*``, gin/models/newt.gin): the
    bindings give its sizes; with none it is the shipped 128 -> 128 -> 129
    MLP of depth 4, as JAX ``_default_noise_mlp``."""
    with gin.config_scope("noise_synth"):
        try:
            return TimeDistributedMLP(generator=generator)
        except TypeError:
            return TimeDistributedMLP(128, 128, 129, depth=4, generator=generator)


@gin.configurable
class NeuralWaveshaping(nn.Module):
    """The synthesizer. Each submodule is built by its configurable with
    only what the model owns passed explicitly (``n_waveshapers`` to NEWT
    and the harmonic mixer, ``sample_rate`` to the oscillator and the
    reverb, ``control_hop`` to the noise synth; gin/models/newt.gin binds
    those to the same macros), so every other binding (the harmonic count,
    NEWT's widths and ``fused``, the noise MLP's sizes, the FIR length, the
    reverb's length) reaches it. With no bindings it is the shipped
    architecture, 266,945 parameters, drawn from ``generator`` in the order
    embedding, harmonic mixer, NEWT, noise MLP, reverb."""

    def __init__(
        self,
        n_waveshapers: int = 64,
        control_hop: int = 128,
        sample_rate: float = 16000,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.control_hop = control_hop
        self.sample_rate = sample_rate
        self.embedding = ControlModule(generator=generator)
        self.osc = HarmonicOscillator(sample_rate=sample_rate)
        self.harmonic_mixer = Dense(self.osc.n_harmonics, n_waveshapers, generator)
        self.newt = NEWT(n_waveshapers=n_waveshapers, generator=generator)
        self.h_generator = _default_noise_mlp(generator)
        with gin.config_scope("noise_synth"):
            self.noise_synth = FIRNoiseSynth(hop_length=control_hop)
        self.reverb = Reverb(sr=int(sample_rate), generator=generator)

    def params(self) -> Params:
        """The parameters as a tree in the JAX layout (views of the
        module's own tensors): what ``load_params`` takes, and what
        ``convert.save_reference_checkpoint`` writes."""
        return {
            "embedding": self.embedding.params(),
            "harmonic_mixer": self.harmonic_mixer.params(),
            "newt": self.newt.params(),
            "h_generator": self.h_generator.params(),
            "reverb": self.reverb.params(),
        }

    def load_params(self, p: Params) -> None:
        """Copy in a parameter tree in the JAX layout (``convert/checkpoint.py``)."""
        self.embedding.load_params(p["embedding"])
        self.harmonic_mixer.load_params(p["harmonic_mixer"])
        self.newt.load_params(p["newt"])
        self.h_generator.load_params(p["h_generator"])
        self.reverb.load_params(p["reverb"])

    def get_embedding(
        self, control: torch.Tensor, h0: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, Tc, >=2) control -> ((B, Tc, E) embedding, final GRU state
        (B, H)); only the first two channels are read. A stream passes its
        carried GRU state as ``h0``."""
        return self.embedding(control[..., :2], h0)

    def forward(
        self,
        f0: torch.Tensor,
        control: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        phase_offset: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        lookup_table: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Synthesize audio.

        Args:
          f0: (B, Tc) f0 in Hz at the control rate.
          control: (B, Tc, C>=2) normalised control channels; the first
            two (f0, loudness) are used.
          generator: draws the oscillator's phase offsets and the noise
            excitation that are not given (the default generator when
            None). A CPU generator gives the same draws on every device.
          phase_offset: (H,) or (B, H) explicit phase offsets.
          noise: (hop*Tc - 1,) explicit uniform noise excitation.
          lookup_table: an (S, C) FastNEWT table
            (``NEWT.bake_lookup_table``) that replaces the shaper bank.

        Returns:
          (B, Tc * control_hop) audio.
        """
        t_audio = f0.shape[1] * self.control_hop
        f0_up = linear_upsample(f0[..., None], t_audio)[..., 0]
        embedding, _ = self.get_embedding(control)
        if phase_offset is None:
            phase_offset = draw_phase_offset(
                self.osc.n_harmonics, generator, f0.device, f0.dtype
            )
        exciter = self.harmonic_mixer(self.osc(f0_up, phase_offset=phase_offset))
        shaped = self.newt(exciter, embedding, lookup_table=lookup_table)  # (B, Ta, 1)
        h = self.h_generator(embedding)  # (B, Tc, 129)
        noise_audio = self.noise_synth(h, generator=generator, noise=noise)
        return self.reverb(shaped[..., 0] + noise_audio)
