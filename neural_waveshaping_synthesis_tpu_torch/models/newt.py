"""NEWT waveshaper core (counterpart of the JAX ``models/newt.py``).

The block predicts 4*C FiLM parameters per control frame from the
control embedding, upsamples them to audio rate, modulates the exciter,
pushes it through the bank of learned scalar shapers, modulates again,
and mixes the C shaper outputs down to ``out_channels``.
"""
import warnings
from typing import Optional, Union

import torch
import torch.nn as nn

from ..kernels import newt_fused
from ..ops.upsample import linear_upsample
from .modules import Dense, Params, TimeDistributedMLP, TrainableNonlinearity

_NOT_PORTED = (
    "is not ported yet (ROADMAP.md, queue 2); this slice has fused='cr' "
    "and the plain chain (fused=False)"
)


class NEWT(nn.Module):
    """``fused`` keeps the JAX dispatch, gated on "the exciter is on
    CUDA" where JAX gated on "the backend is a TPU":

    * ``"cr"`` (the default): on CUDA, in a geometry
      :func:`newt_fused.supports_cr` accepts, the control-rate kernel
      (:func:`newt_fused.film_shaper_cr`); otherwise the plain chain, as
      JAX's ``"cr"`` falls back to its XLA chain. On CUDA that fallback
      is ~45x slower than the kernel, so it warns and adds one to
      ``NEWT.cuda_chain_runs``;
    * ``False`` (or ``None`` at construction): the plain chain everywhere.

    ``"full_lane_cr"``, ``"full_lane"``, ``True``, a FastNEWT
    ``lookup_table`` and ``remat_shaper`` raise ``NotImplementedError``.
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

    cuda_chain_runs = 0  # forwards with fused="cr" that ran the chain on CUDA

    def _packed_shaper(self) -> torch.Tensor:
        """The kernel's packed weight planes, packed again only when a
        shaper parameter has moved or been written in place."""
        key = tuple((t.data_ptr(), t._version) for t in self.shaping_fn.parameters())
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = newt_fused.pack_weights(self.shaping_fn.params())
            self._packed_key = key
        return self._packed

    @staticmethod
    def _check_fused(fused) -> None:
        if fused not in ("cr", None, False):
            raise NotImplementedError(f"NEWT fused={fused!r} {_NOT_PORTED}")

    def load_params(self, p: Params) -> None:
        self.mlp.load_params(p["mlp"])
        self.shaping_fn.load_params(p["shaping_fn"])
        self.mixer.load_params(p["mixer"])

    def forward(
        self,
        exciter: torch.Tensor,
        control_embedding: torch.Tensor,
        lookup_table: Optional[torch.Tensor] = None,
        fused: Optional[Union[str, bool]] = None,
    ) -> torch.Tensor:
        """(B, Ta, C) exciter + (B, Tc, E) embedding -> (B, Ta, out_channels).

        ``fused=None`` defers to the ``fused`` given at construction."""
        if lookup_table is not None:
            raise NotImplementedError(f"the FastNEWT lookup_table {_NOT_PORTED}")
        fused = self.fused if fused is None else fused
        self._check_fused(fused)
        fp = self.mlp(control_embedding)  # (B, Tc, 4C) control-rate FiLM
        ta, tc = exciter.shape[1], fp.shape[1]
        params = self.shaping_fn.params()
        if fused == "cr" and exciter.is_cuda:
            if newt_fused.supports_cr(self.shaping_fn, ta, tc):
                x = newt_fused.film_shaper_cr(
                    exciter, fp, params, ta // tc, packed=self._packed_shaper()
                )
                return self.mixer(x)
            NEWT.cuda_chain_runs += 1
            warnings.warn(
                f"NEWT fused='cr': the kernel does not take this shaper or "
                f"geometry (Ta={ta}, Tc={tc}); running the plain chain on CUDA"
            )
        x = newt_fused.film_shaper_chain(exciter, linear_upsample(fp, ta), params)
        return self.mixer(x)
