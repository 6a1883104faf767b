"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources live in ``csrc/`` and are built at first use
(``_build.py``), never at import."""
from typing import Dict


def _wrappers() -> Dict[str, object]:
    from . import fast_newt, newt_fused, roofline

    wrappers = (newt_fused.film_shaper_cr, newt_fused.film_shaper_fl,
                newt_fused.film_shaper_stream, newt_fused.bank_film_shaper_xcr,
                newt_fused.bank_newt_xfull, fast_newt.fast_newt_lookup, roofline.fma_chain,
                roofline.psin_chain)
    return {w.__name__: w for w in wrappers}


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counters, ``"<wrapper>.<counter>"`` ->
    count (e.g. ``"film_shaper_cr.launches"``, ``"film_shaper_cr
    .bwd_launches_bf16"``). Each counter moves only where its kernel
    launches on the card (a CUDA graph's replay of it included, through
    :func:`add_launch_counts`), never for a plain version."""
    return {f"{name}.{k}": v for name, w in _wrappers().items()
            for k, v in sorted(vars(w).items()) if "launches" in k}


def add_launch_counts(moves: Dict[str, int]) -> None:
    """Add ``moves`` (``"<wrapper>.<counter>"`` -> n, the keys of
    :func:`launch_counts`) to the counters. A CUDA graph replays its kernels
    without calling their wrappers: the training step's graph adds the
    launches it holds on every replay, and takes back those its capture
    counted, since a capture launches nothing."""
    wrappers = _wrappers()
    for key, n in moves.items():
        name, counter = key.split(".")
        setattr(wrappers[name], counter, getattr(wrappers[name], counter) + n)
