"""NEWT waveshaper core (counterpart of the JAX ``models/newt.py``).

The block predicts 4*C FiLM parameters per control frame from the
control embedding, upsamples them to audio rate, modulates the exciter,
pushes it through the bank of learned scalar shapers, modulates again,
and mixes the C shaper outputs down to ``out_channels``.
"""
from typing import Optional, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .. import minigin as gin
from ..kernels import fast_newt, newt_fused
from ..ops.upsample import linear_upsample
from .modules import (
    Dense,
    Params,
    TimeDistributedMLP,
    TrainableNonlinearity,
    cast_params,
    dense_apply,
    film,
    shaper_apply,
)

_CR = ("cr", "full_lane_cr")
_AUDIO_RATE = (True, "full_lane", "fl")
_FUSED = (*_CR, *_AUDIO_RATE, None, False)


@gin.configurable
class NEWT(nn.Module):
    """``fused`` keeps the JAX dispatch, gated on "the exciter is on
    CUDA" where JAX gated on "the backend is a TPU":

    * ``"cr"`` (the default): on CUDA the control-rate kernel
      (:func:`newt_fused.film_shaper_cr`), whose backward is the CUDA
      backward kernel (``newt_fused._FilmShaperCR``). A shaper or geometry
      that :func:`newt_fused.supports_cr` refuses raises on CUDA: JAX's
      ``"cr"`` falls back to its XLA chain there, but on the card that
      chain is ~45x slower than the kernel, so the port asks for
      ``fused=False`` to run it;
    * ``"full_lane_cr"`` (the JAX training recipe's spelling): the
      control-rate kernel where ``supports_cr`` holds; otherwise, as in
      JAX, the audio-rate kernel (a non-integer hop, e.g. Ta=130, Tc=4);
    * ``True``, ``"full_lane"``, ``"fl"`` (JAX's half-lane and full-lane
      TPU layouts of one function): on CUDA the FiLM is upsampled to audio
      rate and the audio-rate kernel runs
      (:func:`newt_fused.film_shaper_fl`), its backward the CUDA kernel
      ``newt_fused._FilmShaperFL``. A shaper that
      :func:`newt_fused.supports` refuses raises on CUDA;
    * ``False`` (or ``None`` at construction): the plain chain everywhere.

    On the CPU under float32 every value runs the plain chain (under
    bfloat16, see below). Any other value raises
    ``ValueError``. With ``remat_shaper`` the plain chain's shaper bank
    runs under ``torch.utils.checkpoint`` (JAX ``jax.checkpoint``): its
    activations are recomputed in the backward instead of kept; the
    kernels recompute in their backward anyway, so it changes nothing on a
    kernel path.

    :meth:`forward_stream`, one streaming buffer, runs the stream kernel
    (:func:`newt_fused.film_shaper_stream`) on CUDA for every ``fused``
    that is not ``False``, as JAX runs its stream kernel for any truthy
    ``NEWT.fused``.

    A FastNEWT ``lookup_table`` (:meth:`bake_lookup_table`) replaces the
    shaper bank whatever ``fused`` says, as in JAX: the FiLM is upsampled
    to audio rate and the lookup runs between the two FiLMs; on CUDA it
    launches the lookup kernel (:func:`fast_newt.fast_newt_lookup`), on
    the CPU its plain version.

    NEWT computes in its exciter's dtype, as the JAX NEWT computes in the
    dtype of the tree ``NeuralWaveshaping.apply`` casts for it: under the
    model's ``compute_dtype = "bfloat16"`` its parameters (the FiLM MLP, the
    shaper and the mixer) are cast to bfloat16 inside autograd on every
    forward, so the float32 masters get the gradients. The chain then runs
    per operation in bfloat16, as JAX's does. The control-rate kernels take
    bfloat16 I/O and compute in float32 between load and store; on the CPU
    a bfloat16 exciter on a cr ``fused`` therefore runs the kernel's plain
    version (:func:`newt_fused.film_shaper_cr_plain`), which computes the
    same, where under float32 the chain is already that plain version.
    ``cr_film_f32`` (JAX's field) hands the kernel a float32 FiLM with a
    bfloat16 exciter; under float32 it changes nothing. The audio-rate
    kernels (``True``, ``"full_lane"``, ``"fl"`` and ``"full_lane_cr"``'s
    fallback) take a bfloat16 exciter with its bfloat16 FiLM in the same
    way, and on the CPU a bfloat16 exciter there runs their plain version
    (:func:`newt_fused.film_shaper_fl_plain`). With a FastNEWT table a
    bfloat16 exciter runs as JAX's: the FiLM in bfloat16, the lookup's index
    in bfloat16 and its interpolation against the float32 table in float32
    (the lookup kernel's bf16-x instance on CUDA, its plain version on the
    CPU), the second FiLM and the mixer (its weights rounded to bfloat16)
    in float32; that path returns float32. :meth:`forward_stream` runs in
    float32 whatever the model's ``compute_dtype``, as JAX's stream does: the
    stream kernel takes float32 only. Every kernel spelling thus runs under
    either ``compute_dtype`` (the exciter-fused path too, in
    ``NeuralWaveshaping``).
    """

    def __init__(
        self,
        n_waveshapers: int = 64,
        control_embedding_size: int = 128,
        shaping_fn_size: int = 8,
        out_channels: int = 1,
        shaping_fn_depth: int = 4,
        remat_shaper: bool = False,
        fused: Optional[Union[str, bool]] = "cr",
        cr_film_f32: bool = False,
        generator=None,
    ):
        super().__init__()
        self._check_fused(fused)
        self.n_waveshapers = n_waveshapers
        self.remat_shaper = remat_shaper
        self.fused = fused
        self.cr_film_f32 = cr_film_f32
        self.mlp = TimeDistributedMLP(
            control_embedding_size, control_embedding_size, n_waveshapers * 4,
            depth=4, generator=generator,
        )
        self.shaping_fn = TrainableNonlinearity(
            n_waveshapers, shaping_fn_size, depth=shaping_fn_depth, generator=generator,
        )
        self.mixer = Dense(n_waveshapers, out_channels, generator)
        self._packed, self._packed_key = None, None

    def _shaper_params(self, dtype: torch.dtype = torch.float32) -> Params:
        """The shaper's parameter tree in ``dtype`` (cast inside autograd)."""
        return cast_params(self.shaping_fn.params(), dtype)

    def _packed_shaper(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The kernel's packed float32 weight planes, packed from the shaper
        leaves cast to ``dtype``: under bfloat16 the kernel gets exact float32
        copies of the rounded weights, as JAX packs the tree after its cast,
        and the plane gradient is rounded to bfloat16 on its way back. With
        grad enabled and a shaper parameter that needs a gradient they are
        packed anew, with autograd, on every call, so that the kernel's plane
        gradient flows back to the 9 shaper leaves; otherwise the pack is
        cached, keyed by ``dtype``, and made again only when a shaper
        parameter has moved or been written in place."""
        if torch.is_grad_enabled() and any(
            t.requires_grad for t in self.shaping_fn.parameters()
        ):
            return newt_fused.pack_weights(self._shaper_params(dtype))
        key = (dtype, tuple((t.data_ptr(), t._version) for t in self.shaping_fn.parameters()))
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = newt_fused.pack_weights(self._shaper_params(dtype))
            self._packed_key = key
        return self._packed

    @staticmethod
    def _check_fused(fused) -> None:
        if not any(fused is v or (isinstance(v, str) and fused == v) for v in _FUSED):
            raise ValueError(
                f"NEWT fused={fused!r} is not one of "
                "'cr', 'full_lane_cr', True, 'full_lane', 'fl', False, None"
            )

    def params(self) -> Params:
        return {
            "mlp": self.mlp.params(),
            "shaping_fn": self.shaping_fn.params(),
            "mixer": self.mixer.params(),
        }

    def load_params(self, p: Params) -> None:
        self.mlp.load_params(p["mlp"])
        self.shaping_fn.load_params(p["shaping_fn"])
        self.mixer.load_params(p["mixer"])

    def bake_lookup_table(self, table_size: int = 4096) -> torch.Tensor:
        """The FastNEWT table: the shaper bank sampled on ``table_size``
        points over the lookup's range [-3, 3] -> (table_size, C)."""
        return self.shaping_fn.bake_table(table_size, fast_newt.TABLE_MIN, fast_newt.TABLE_MAX)

    def film_params(self, control_embedding: torch.Tensor) -> torch.Tensor:
        """(B, Tc, E) -> (B, Tc, 4C) control-rate FiLM parameters."""
        return self.mlp(control_embedding)

    def _refuse(self, fused, ta: int, tc: int) -> ValueError:
        return ValueError(
            f"NEWT fused={fused!r}: the CUDA kernel does not take this shaper "
            f"or geometry (Ta={ta}, Tc={tc}); pass fused=False for the plain chain"
        )

    def _chain(self, exciter: torch.Tensor, film_a: torch.Tensor, params: Params) -> torch.Tensor:
        """The plain chain on the audio-rate FiLM; with ``remat_shaper`` and
        grad enabled the shaper bank runs under ``checkpoint``."""
        if not (self.remat_shaper and torch.is_grad_enabled()):
            return newt_fused.film_shaper_chain(exciter, film_a, params)
        gi, bi, gn, bn = film_a.split(self.n_waveshapers, dim=-1)
        x = checkpoint(shaper_apply, params, film(exciter, gi, bi), use_reentrant=False)
        return film(x, gn, bn)

    def forward(
        self,
        exciter: torch.Tensor,
        control_embedding: torch.Tensor,
        lookup_table: Optional[torch.Tensor] = None,
        fused: Optional[Union[str, bool]] = None,
    ) -> torch.Tensor:
        """(B, Ta, C) exciter + (B, Tc, E) embedding -> (B, Ta, out_channels),
        in the exciter's dtype (the embedding is cast to it), but float32
        with a ``lookup_table``, whose lookup returns float32 as JAX's does.

        ``fused=None`` defers to the ``fused`` given at construction;
        ``lookup_table`` (S, C) takes the FastNEWT path instead."""
        fused = self.fused if fused is None else fused
        self._check_fused(fused)
        dtype = exciter.dtype
        narrow = dtype == torch.bfloat16
        fp = self.film_params(control_embedding.to(dtype))  # (B, Tc, 4C) control-rate FiLM
        ta, tc = exciter.shape[1], fp.shape[1]
        if lookup_table is not None:
            gi, bi, gn, bn = linear_upsample(fp, ta).split(self.n_waveshapers, dim=-1)
            x = fast_newt.fast_newt_lookup(lookup_table, film(exciter, gi, bi))  # float32
            # the mixer's weights in NEWT's dtype, applied in float32 (JAX's
            # dense_apply of a bf16 tree on a float32 x)
            return dense_apply(cast_params(self.mixer.params(), dtype), film(x, gn, bn))
        params = self._shaper_params(dtype)
        kernel_path = exciter.is_cuda or narrow  # on the CPU under bf16: its plain version
        if fused in _CR and kernel_path:
            if newt_fused.supports_cr(self.shaping_fn, ta, tc):
                if self.cr_film_f32:
                    fp = fp.to(torch.float32)
                x = newt_fused.film_shaper_cr(
                    exciter, fp, params, ta // tc, packed=self._packed_shaper(dtype)
                )
                return self.mixer(x)
            if exciter.is_cuda and fused == "cr":
                raise self._refuse(fused, ta, tc)
            if fused == "full_lane_cr":
                fused = "full_lane"  # JAX's fallback for the training spelling
        film_a = linear_upsample(fp, ta)  # (B, Ta, 4C)
        if fused in _AUDIO_RATE and kernel_path:
            if newt_fused.supports(self.shaping_fn):
                # the kernels take the FiLM in the exciter's dtype; at a
                # non-integer hop the lerp is float32 (ROADMAP.md section 3)
                x = newt_fused.film_shaper_fl(
                    exciter, film_a.to(dtype), params, packed=self._packed_shaper(dtype)
                )
                return self.mixer(x)
            if exciter.is_cuda:
                raise self._refuse(fused, ta, tc)
        return self.mixer(self._chain(exciter, film_a, params))

    def forward_stream(
        self,
        exciter: torch.Tensor,
        prev_film: torch.Tensor,
        film_c: torch.Tensor,
        fused: Optional[Union[str, bool]] = None,
    ) -> torch.Tensor:
        """One streaming buffer: (B, K*hop, C) exciter, the carried (B, 4C)
        FiLM frame and the buffer's (B, K, 4C) FiLM frames ->
        (B, K*hop, out_channels). The FiLM ramps from each frame to the
        next over one hop (``ops.upsample.segment_interp``), continuous
        across buffers. Forward only.

        On CUDA every ``fused`` but ``False`` runs the stream kernel (JAX
        runs its Pallas kernel for any truthy ``NEWT.fused`` on the TPU)
        and a shaper or geometry it does not take raises; ``fused=False``
        and the CPU run the plain version."""
        fused = self.fused if fused is None else fused
        self._check_fused(fused)
        ta, k = exciter.shape[1], film_c.shape[1]
        params = self.shaping_fn.params()
        if exciter.is_cuda and fused:
            if not newt_fused.supports_stream(self.shaping_fn, ta, k):
                raise self._refuse(fused, ta, k)
            x = newt_fused.film_shaper_stream(
                exciter, prev_film, film_c, params, ta // k, packed=self._packed_shaper()
            )
        else:
            hop = ta // k if k else 0
            x = newt_fused.film_shaper_stream_plain(exciter, prev_film, film_c, params, hop)
        return self.mixer(x)
