"""NEWT waveshaper core (counterpart of the JAX ``models/newt.py``).

The block predicts 4*C FiLM parameters per control frame from the
control embedding, upsamples them to audio rate, modulates the exciter,
pushes it through the bank of learned scalar shapers, modulates again,
and mixes the C shaper outputs down to ``out_channels``.
"""
from typing import Optional, Union

import torch
import torch.nn as nn

from ..kernels import fast_newt, newt_fused
from ..ops.upsample import linear_upsample
from .modules import Dense, Params, TimeDistributedMLP, TrainableNonlinearity, film

_NOT_PORTED = (
    "is not ported yet (ROADMAP.md, queue 2); the port has fused='cr' "
    "(or its training spelling 'full_lane_cr') and the plain chain (fused=False)"
)
_CR = ("cr", "full_lane_cr")


class NEWT(nn.Module):
    """``fused`` keeps the JAX dispatch, gated on "the exciter is on
    CUDA" where JAX gated on "the backend is a TPU":

    * ``"cr"`` (the default): on CUDA the control-rate kernel
      (:func:`newt_fused.film_shaper_cr`), whose backward is the CUDA
      backward kernel (``newt_fused._FilmShaperCR``). A shaper or geometry
      that :func:`newt_fused.supports_cr` refuses raises on CUDA: JAX's
      ``"cr"`` falls back to its XLA chain there, but on the card that
      chain is ~45x slower than the kernel, so the port asks for
      ``fused=False`` to run it. On the CPU the plain chain runs;
    * ``"full_lane_cr"`` (the JAX training recipe's spelling) behaves as
      ``"cr"``. JAX falls back from it to the audio-rate kernel when its
      TPU gate refuses the geometry; the Hopper gate accepts every integer
      hop, so with the shipped shaper that fallback cannot be reached;
    * ``False`` (or ``None`` at construction): the plain chain everywhere.

    :meth:`forward_stream`, one streaming buffer, follows the same rule
    with the stream kernel (:func:`newt_fused.film_shaper_stream`).

    A FastNEWT ``lookup_table`` (:meth:`bake_lookup_table`) replaces the
    shaper bank whatever ``fused`` says, as in JAX: the FiLM is upsampled
    to audio rate and the lookup runs between the two FiLMs; on CUDA it
    launches the lookup kernel (:func:`fast_newt.fast_newt_lookup`), on
    the CPU its plain version.

    ``"full_lane"``, ``True`` and ``remat_shaper`` raise
    ``NotImplementedError``.
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
        generator=None,
    ):
        super().__init__()
        if remat_shaper:
            raise NotImplementedError(f"remat_shaper {_NOT_PORTED}")
        self._check_fused(fused)
        self.n_waveshapers = n_waveshapers
        self.fused = fused
        self.mlp = TimeDistributedMLP(
            control_embedding_size, control_embedding_size, n_waveshapers * 4,
            depth=4, generator=generator,
        )
        self.shaping_fn = TrainableNonlinearity(
            n_waveshapers, shaping_fn_size, depth=shaping_fn_depth, generator=generator,
        )
        self.mixer = Dense(n_waveshapers, out_channels, generator)
        self._packed, self._packed_key = None, None

    def _packed_shaper(self) -> torch.Tensor:
        """The kernel's packed weight planes. With grad enabled and a shaper
        parameter that needs a gradient they are packed anew, with autograd,
        on every call, so that the kernel's plane gradient flows back to
        the 9 shaper leaves; otherwise the pack is cached and made again
        only when a shaper parameter has moved or been written in place."""
        if torch.is_grad_enabled() and any(
            t.requires_grad for t in self.shaping_fn.parameters()
        ):
            return newt_fused.pack_weights(self.shaping_fn.params())
        key = tuple((t.data_ptr(), t._version) for t in self.shaping_fn.parameters())
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = newt_fused.pack_weights(self.shaping_fn.params())
            self._packed_key = key
        return self._packed

    @staticmethod
    def _check_fused(fused) -> None:
        if fused not in (*_CR, None, False):
            raise NotImplementedError(f"NEWT fused={fused!r} {_NOT_PORTED}")

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

    def _use_kernel(self, fused, exciter: torch.Tensor, ta: int, tc: int, gate) -> bool:
        """The dispatch rule shared by both forwards: True when the CUDA
        kernel runs; raises on the card for what ``gate`` (the kernel's
        ``supports_*``) refuses."""
        fused = self.fused if fused is None else fused
        self._check_fused(fused)
        if fused not in _CR or not exciter.is_cuda:
            return False
        if not gate(self.shaping_fn, ta, tc):
            raise ValueError(
                f"NEWT fused={fused!r}: the CUDA kernel does not take this shaper "
                f"or geometry (Ta={ta}, Tc={tc}); pass fused=False for the plain chain"
            )
        return True

    def forward(
        self,
        exciter: torch.Tensor,
        control_embedding: torch.Tensor,
        lookup_table: Optional[torch.Tensor] = None,
        fused: Optional[Union[str, bool]] = None,
    ) -> torch.Tensor:
        """(B, Ta, C) exciter + (B, Tc, E) embedding -> (B, Ta, out_channels).

        ``fused=None`` defers to the ``fused`` given at construction;
        ``lookup_table`` (S, C) takes the FastNEWT path instead."""
        fp = self.film_params(control_embedding)  # (B, Tc, 4C) control-rate FiLM
        ta, tc = exciter.shape[1], fp.shape[1]
        if lookup_table is not None:
            gi, bi, gn, bn = linear_upsample(fp, ta).split(self.n_waveshapers, dim=-1)
            x = fast_newt.fast_newt_lookup(lookup_table, film(exciter, gi, bi))
            return self.mixer(film(x, gn, bn))
        params = self.shaping_fn.params()
        if self._use_kernel(fused, exciter, ta, tc, newt_fused.supports_cr):
            x = newt_fused.film_shaper_cr(
                exciter, fp, params, ta // tc, packed=self._packed_shaper()
            )
            return self.mixer(x)
        x = newt_fused.film_shaper_chain(exciter, linear_upsample(fp, ta), params)
        return self.mixer(x)

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

        The dispatch is :meth:`forward`'s: with ``"cr"``/``"full_lane_cr"``
        the CUDA stream kernel runs on the card (JAX gates its Pallas kernel
        on the TPU backend) and a shaper or geometry it does not take
        raises; ``fused=False`` and the CPU run the plain version."""
        ta, k = exciter.shape[1], film_c.shape[1]
        params = self.shaping_fn.params()
        if self._use_kernel(fused, exciter, ta, k, newt_fused.supports_stream):
            x = newt_fused.film_shaper_stream(
                exciter, prev_film, film_c, params, ta // k, packed=self._packed_shaper()
            )
        else:
            hop = ta // k if k else 0
            x = newt_fused.film_shaper_stream_plain(exciter, prev_film, film_c, params, hop)
        return self.mixer(x)
