"""Time-sharded offline rendering of one long clip (counterpart of the JAX
``parallel/time_shard.py``).

For a long render (minutes of audio) the batch axis has nothing to split:
one clip is one row. The long axis is time, and once the oscillator's
phase and the FiLM parameters are known NEWT's audio-rate work is
pointwise in time, so it splits into contiguous chunks with nothing to
approximate:

* computed once, on the input's device (cheap, O(T) with small
  constants): the GRU at the control rate, the FiLM and noise MLPs, the f0
  upsample, the global phase sum (float64, the port's deviation: ROADMAP
  section 3), the noise branch and the reverb;
* per chunk, on the mesh's device for that chunk (the audio-rate bulk): the
  harmonic bank from its slice of the global phase, the harmonic mixer, the
  FiLM upsample from the chunk's frames and one halo frame on each side,
  FiLM -> shaper -> FiLM through kernel 5 (:func:`newt_fused.film_shaper_fl`,
  ``kernels/csrc/newt_fused_fl.cu`` on the card, its plain version on the
  CPU), and NEWT's mixer.

The chunk boundaries are exact: each chunk slices the global phase (no
accumulator restarts), and its FiLM upsample reproduces
``ops.upsample.linear_upsample`` over the whole clip bit for bit, head and
tail clamps included (:func:`_upsample_chunk`). The draws (phase offsets,
then the noise) happen once, in the model's order, so the same generator
gives the audio ``model.forward`` gives, within float32 reassociation of the
mixers' sums.

Where JAX places one chunk per device in one SPMD program, the port runs the
chunks one after another from this process, each on its device: the kernel
launches are asynchronous, so chunks on different cards overlap; chunks on
one card (``[cuda:0] * k``) run in turn, and what they save is the peak
memory of the audio-rate FiLM, which one chunk holds at a time. The chunks
of a clip whose frames do not divide by the device count are ``ceil(Tc/n)``
frames, the last shorter (JAX pads it; no chunk is rendered past the clip).

The renderer runs the bank and FiLM -> shaper -> FiLM whatever the model's
``fuse_exciter`` says, as JAX's does, and takes no FastNEWT table.
"""
from typing import Callable, Optional

import torch

from ..kernels import newt_fused
from ..models.modules import cast_params, dense_apply
from ..ops.oscillator import bank_from_phase, draw_phase_offset, phase_accumulate
from ..ops.upsample import _linear_upsample_integer, linear_upsample
from .mesh import Mesh


def _upsample_chunk(halo: torch.Tensor, hop: int, head: bool) -> torch.Tensor:
    """(B, K+2, C) edge-clamped halo frames -> (B, K*hop, C): the chunk's
    slice of ``linear_upsample`` over the whole clip.

    A chunk covering frames [m0, m0+K) reads frames m0-1 .. m0+K (each
    output sample lerps between its frame and one neighbour), which are the
    K+2 halo rows, clamped at the clip's ends. The integer-hop upsample of
    those rows, cut to the K middle frames, computes each sample from the
    same three frames with the same arithmetic as the whole clip's. At the
    clip's head (``head``: m0 = 0) the first row is the clamp itself, and
    the upsample of the rows from frame 0 on applies the head clamp as the
    whole clip's does; at the tail the clamped last row gives the tail's
    lerp between two copies of the last frame."""
    k = halo.shape[1] - 2
    if head:
        return _linear_upsample_integer(halo[:, 1:], hop)[:, : k * hop]
    return _linear_upsample_integer(halo, hop)[:, hop : (k + 1) * hop]


def make_time_sharded_renderer(model, mesh: Mesh) -> Callable[..., torch.Tensor]:
    """-> fn(f0, control, generator=None, noise=None, phase_offset=None)
    rendering (B, Tc * hop) audio as ``model.forward`` does (the same
    arguments, the same draws), with the audio-rate work cut into
    ``len(mesh.devices)`` time chunks, chunk i on ``mesh.devices[i]``.

    Under ``compute_dtype = "bfloat16"`` the chunks keep the model's
    mixed-precision scope: the FiLM from the embedding and NEWT's MLP cast
    to bfloat16, the bank and the harmonic mixer's ``w`` in bfloat16 (its
    ``b`` float32), kernel 5's (bf16, bf16) instance, NEWT's mixer in
    bfloat16, the chunk's audio back in float32. The FiLM upsample is
    float32, rounded once to bfloat16 (JAX's chunk upsamples in bfloat16):
    the unsharded render's kernel 1 lerps its bf16 frames in float32.

    On the card a shaper kernel 5 does not take raises (no fallback to the
    plain chain, as NEWT's ``"fl"``); on the CPU the kernel's plain version
    runs."""
    hop = int(model.control_hop)
    devices = tuple(mesh.devices)
    newt = model.newt
    n_harmonics = int(model.osc.n_harmonics)
    osc_rate = float(model.osc.sample_rate)

    def chunk_weights(device: torch.device, cd: torch.dtype):
        """The chunk's weights on ``device`` in the compute dtype (the
        model's own tensors where it lives there)."""
        mixer = model.harmonic_mixer
        shaper = cast_params(newt.shaping_fn.params(), cd)
        shaper = {"input_scale": shaper["input_scale"].to(device),
                  "layers": [{k: v.to(device) for k, v in layer.items()}
                             for layer in shaper["layers"]]}
        return (
            {"w": mixer.w.to(device, cd), "b": mixer.b.to(device)},
            shaper,
            newt._packed_shaper(cd).to(device),
            {k: v.to(device, cd) for k, v in newt.mixer.params().items()},
        )

    def render_chunk(device, phase, f0_up, offset, halo, head, weights, cd):
        """(B, S) phase and f0, (B, K+2, 4C) halo frames -> (B, S) in f0's
        dtype."""
        mixer, shaper, packed, out_mixer = weights
        bank = bank_from_phase(phase, f0_up, n_harmonics, osc_rate, offset)
        exciter = dense_apply(mixer, bank.to(cd))
        # the lerp in float32 (bf16 frames widened), rounded once to bf16 for
        # kernel 5, nearest the unsharded render's in-kernel float32 lerp
        acc = torch.promote_types(cd, torch.float32)
        film_a = _upsample_chunk(halo.to(acc), hop, head).to(cd).contiguous()
        if device.type == "cuda" and not newt_fused.supports(newt.shaping_fn):
            raise newt._refuse("fl", exciter.shape[1], halo.shape[1] - 2)
        x = newt_fused.film_shaper_fl(exciter, film_a, shaper, packed=packed)
        return dense_apply(out_mixer, x)[..., 0].to(f0_up.dtype)

    def render(
        f0: torch.Tensor,
        control: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        phase_offset: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, tc = f0.shape
        ta = tc * hop
        cd = model.block_dtype(f0.dtype)
        # -- computed once, in model.forward's order of draws --------------
        f0_up = linear_upsample(f0[..., None], ta)[..., 0]
        embedding, _ = model.get_embedding(control)
        if phase_offset is None:
            phase_offset = draw_phase_offset(n_harmonics, generator, f0.device, f0.dtype)
        film = newt.film_params(embedding.to(cd))  # (B, Tc, 4C)
        phase = phase_accumulate(f0_up, osc_rate)  # float64
        noise_audio = model.noise_synth(model.h_generator(embedding), generator=generator,
                                        noise=noise)
        # -- the chunks: frames [i*K, min((i+1)*K, Tc)) on devices[i] -------
        k_frames = -(-tc // len(devices))
        film_pp = torch.cat([film[:, :1], film, film[:, -1:]], dim=1)  # edge-clamped
        weights = {}
        pieces = []
        for i, device in enumerate(devices):
            m0, m1 = i * k_frames, min((i + 1) * k_frames, tc)
            if m0 >= m1:
                break
            if device not in weights:
                weights[device] = chunk_weights(device, cd)
            s0, s1 = m0 * hop, m1 * hop
            shaped = render_chunk(
                device, phase[:, s0:s1].to(device), f0_up[:, s0:s1].to(device),
                phase_offset.to(device), film_pp[:, m0 : m1 + 2].to(device), m0 == 0,
                weights[device], cd,
            )
            pieces.append(shaped.to(f0.device))
        shaped = torch.cat(pieces, dim=1)
        return model.reverb(shaped + noise_audio)

    return render
