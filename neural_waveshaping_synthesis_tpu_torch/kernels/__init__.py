"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources live in ``csrc/`` and are built at first use
(``_build.py``), never at import."""
from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counters, ``"<wrapper>.<counter>"`` ->
    count (e.g. ``"film_shaper_cr.launches"``, ``"film_shaper_cr
    .bwd_launches_bf16"``). Each counter moves only where its kernel
    launches on the card, never for a plain version."""
    from . import fast_newt, newt_fused, roofline

    wrappers = (newt_fused.film_shaper_cr, newt_fused.film_shaper_fl,
                newt_fused.film_shaper_stream, newt_fused.bank_film_shaper_xcr,
                newt_fused.bank_newt_xfull, fast_newt.fast_newt_lookup, roofline.fma_chain,
                roofline.psin_chain)
    return {f"{w.__name__}.{k}": v for w in wrappers for k, v in sorted(vars(w).items())
            if "launches" in k}
