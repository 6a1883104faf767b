"""The full NEWT synthesizer graph (counterpart of the JAX
``models/neural_waveshaping.py`` ``NeuralWaveshaping.apply``, here
``forward``):

    f0 (B, Tc) Hz --linear upsample--> f0 (B, Ta)
        '-> harmonic oscillator (B, Ta, 101) --mixer--> exciter (B, Ta, 64)
    control (B, Tc, 2) --GRU+proj--> embedding (B, Tc, 128)
        |-> NEWT: FiLM > shaper bank > FiLM > mix --> (B, Ta, 1)
        '-> noise MLP > H (B, Tc, 129) > FIR noise --> (B, Ta)
    sum --> learned reverb --> audio (B, Ta)

``compute_dtype`` (JAX's field) is ``"float32"`` (the default) or
``"bfloat16"``, the mixed-precision scope of the JAX ``apply``: in bfloat16
the oscillator bank's output, the harmonic mixer's weight (its bias stays
float32, and the mixer's sum is rounded once) and NEWT, which runs in its
exciter's dtype on its parameters cast inside autograd; NEWT's output comes
back to float32. In float32: the phase (summed in float64 and wrapped, the
port's deviation), the GRU embedding (cast for NEWT only), the noise MLP and
FIR, the reverb, the loss, the parameters and the optimizer's state.

``fuse_exciter`` and ``fuse_out_mixer`` (both off by default, as in JAX)
fold the harmonic bank and the 101 -> 64 mixer, and with
``fuse_out_mixer`` also NEWT's 64 -> 1 output mix, into the exciter-fused
kernels (``kernels/newt_fused.py`` ``bank_film_shaper_xcr`` /
``bank_newt_xfull``): on CUDA the hand-written kernels and their backwards,
on the CPU their plain versions, under either ``compute_dtype``. See
:meth:`NeuralWaveshaping._fused_exciter_newt` for when the path engages;
otherwise the bank, the mixer and NEWT run as before.

The model and its submodules are gin configurables (:mod:`..minigin`), so
the repo's ``gin/models/newt.gin`` bindings reach them as they reach the
JAX model's ``default_factory`` submodules: the noise MLP and the noise
synth are built inside the ``noise_synth`` scope.
"""
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .. import minigin as gin
from ..kernels import newt_fused
from ..ops.oscillator import draw_phase_offset, phase_accumulate, wrap_phase
from ..ops.upsample import linear_upsample
from .generators import FIRNoiseSynth, HarmonicOscillator, Reverb
from .modules import ControlModule, Dense, Params, TimeDistributedMLP, cast_params, dense_apply
from .newt import _CR, NEWT

# the compute dtypes the port takes: JAX's field takes any jnp.dtype name
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    embedding, harmonic mixer, NEWT, noise MLP, reverb.

    ``compute_dtype`` is ``"float32"`` or ``"bfloat16"`` (the repo's
    ``gin/train/train_newt_bf16.gin``); any other name raises ``ValueError``.
    ``fuse_exciter`` / ``fuse_out_mixer`` are the JAX fields of the same
    names; like every parameter here they bind from gin (``-b
    "NeuralWaveshaping.fuse_exciter = True"``), also for
    ``Synthesizer.from_checkpoint``'s model."""

    def __init__(
        self,
        n_waveshapers: int = 64,
        control_hop: int = 128,
        sample_rate: float = 16000,
        generator: Optional[torch.Generator] = None,
        compute_dtype: str = "float32",
        fuse_exciter: bool = False,
        fuse_out_mixer: bool = False,
    ):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"NeuralWaveshaping.compute_dtype = {compute_dtype!r}: the port takes "
                "'float32' or 'bfloat16'"
            )
        self.compute_dtype = compute_dtype
        self.control_hop = control_hop
        self.sample_rate = sample_rate
        self.fuse_exciter = fuse_exciter
        self.fuse_out_mixer = fuse_out_mixer
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

    def _fused_exciter_newt(
        self, f0_up: torch.Tensor, embedding: torch.Tensor, phase_offset: torch.Tensor
    ) -> Optional[torch.Tensor]:
        """The exciter-fused path (JAX ``_fused_exciter_newt``): (B, Ta)
        audio-rate f0 + (B, Tc, E) embedding -> NEWT's (B, Ta, out_channels)
        output, or None where the path does not apply and the caller runs
        the bank, the mixer and NEWT.

        It applies when ``fuse_exciter`` is set, NEWT's ``fused`` is a
        control-rate spelling (``"cr"``, ``"full_lane_cr"``), the offsets
        are (H,) (a (B, H) offset is the streaming layout) and
        ``newt_fused.supports_xcr`` takes the geometry; the device decides
        in the kernel wrapper (JAX's "the backend is a TPU" has no
        counterpart). The phase is wrapped in float64 and cast, the tensor
        ``bank_from_phase`` expands. With ``fuse_out_mixer`` and one output
        channel the xfull kernel also mixes to audio and NEWT's mixer bias is
        added here; otherwise the xcr kernel's (B, Ta, C) goes through
        NEWT's mixer.

        Under ``compute_dtype = "bfloat16"``, as JAX's: NEWT's parameters and
        the embedding are cast to bfloat16 (inside autograd), so the FiLM is
        bfloat16 (float32 with ``NEWT.cr_film_f32``); the harmonic mixer's
        ``w`` and ``b`` are both cast (JAX ``pack_mixer``; the unfused path
        keeps ``b`` float32), and so are xfull's ``w_out`` and NEWT's bias,
        added in bfloat16; the kernels' bf16 instances compute in float32
        between load and store and return bfloat16; the result comes back as
        float32."""
        newt = self.newt
        n_harm = self.osc.n_harmonics
        ta, tc = f0_up.shape[1], embedding.shape[1]
        if not (
            self.fuse_exciter
            and newt.fused in _CR
            and phase_offset.dim() == 1
            and newt_fused.supports_xcr(newt.shaping_fn, ta, tc, n_harm)
        ):
            return None
        cd = COMPUTE_DTYPES[self.compute_dtype]
        sr = self.osc.sample_rate
        phase = wrap_phase(phase_accumulate(f0_up, sr), f0_up.dtype)
        fp = newt.film_params(embedding.to(cd))
        if newt.cr_film_f32:
            fp = fp.to(torch.float32)
        args = (phase, f0_up, phase_offset, fp, cast_params(self.harmonic_mixer.params(), cd))
        shaper, packed = newt._shaper_params(cd), newt._packed_shaper(cd)
        if self.fuse_out_mixer and newt.mixer.w.shape[1] == 1:
            audio = newt_fused.bank_newt_xfull(
                *args, newt.mixer.w[:, 0].to(cd), shaper, n_harm, sr, ta // tc, packed=packed
            )
            return (audio + newt.mixer.b[0].to(cd))[..., None].float()
        x = newt_fused.bank_film_shaper_xcr(*args, shaper, n_harm, sr, ta // tc, packed=packed)
        return newt.mixer(x).float()

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
        shaped = None
        if lookup_table is None:
            shaped = self._fused_exciter_newt(f0_up, embedding, phase_offset)
        if shaped is None:
            bank = self.osc(f0_up, phase_offset=phase_offset)
            cd = COMPUTE_DTYPES[self.compute_dtype]
            # The mixer's w and the bank in compute_dtype, its b in float32.
            mixer = {"w": self.harmonic_mixer.w.to(cd), "b": self.harmonic_mixer.b}
            exciter = dense_apply(mixer, bank.to(cd))
            shaped = self.newt(exciter, embedding, lookup_table=lookup_table).float()  # (B, Ta, 1)
        h = self.h_generator(embedding)  # (B, Tc, 129)
        noise_audio = self.noise_synth(h, generator=generator, noise=noise)
        return self.reverb(shaped[..., 0] + noise_audio)
