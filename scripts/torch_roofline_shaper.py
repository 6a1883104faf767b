#!/usr/bin/env python3
"""The card's own ceilings for the NEWT waveshaper bank, and the bank's
floor at those ceilings (the counterpart of ``scripts/roofline_shaper.py``).

    python3 scripts/torch_roofline_shaper.py [--n-short 5 --n-long 25 --repeats 3]
        [--batch 8 --n-frames 500] [--skip-kernels] [--device cpu]

The kernels' bounds in ``PERF.md`` come from the data sheet (3.35 TB/s, 67
TFLOP/s in float32). This script measures what the card reaches on the
same kind of work, counts the bank's arithmetic per element as the JAX
script does (``shaper_op_counts``: an FMA one operation, a polynomial sine
or cosine one sine), and prints the floor at the measured rates next to
the measured times, with each kernel's data-sheet bound beside it.

Every row is timed by ``utils.profiling.differential_loop_ms``: an eager
loop of ``--n-long`` and ``--n-short`` iterations, each between CUDA events
and synchronised once, best of ``--repeats``, the per-iteration time the
difference over the difference in lengths. Rows (JAX's, by name):

  hbm_read            one read and reduce of 384 MB (``torch.sum``)
  fma128 / fma64      x <- x * a + x0, 256 deep, over (n/128, 128) / (n/64, 64)
  fma128_ilp4         four independent chains (x, x/2, x/4, x/8)
  psin128             x <- psin(x) + x0, 32 deep, the polynomial sine
  xsin128             the same with ``torch.sin``
  cuda_*              the fma, fma ilp4 and psin chains in kernel 9
                      (``csrc/roofline_chain.cu``), counterparts of JAX's
                      ``pallas_*`` rows, and cuda_psin128_ilp4, four sine
                      chains a thread (no JAX counterpart: kernels 1-8 run
                      four samples a thread, so their sine rate is this one)

The plain rows run one eager operator per step, each reading and writing the
whole array: on the card they are bound by device memory and are no compute
ceiling (kept as JAX's rows, and because the floor takes the best rate any
row reaches, as JAX's does). The compute ceilings are the ``cuda_*`` rows.
The two lane layouts are one flat layout on the card.

Shaper probes at the training shape (B=8 x T=64000 x C=64, W=8, depth 4):

  shaper_fwd / shaper_fwd_bwd                the plain chain (``film_shaper_chain``)
  shaper_fused_fl_fwd / shaper_fused_fl_fwd_bwd  kernels 5-6 (``film_shaper_fl``)

JAX's half-lane (``film_shaper_fused``) and full-lane rows are two TPU
layouts of one function, which is one kernel in the port: it is timed once.

With ``--device cpu`` (or ``--skip-kernels``) the kernel rows are skipped,
as JAX skips its Pallas rows on the CPU. On the card the script exits
non-zero unless kernel 9's and kernels 5-6's launch counters moved.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts, newt_fused  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels.roofline import (  # noqa: E402
    CR_BWD_FLOP_PER_ELEMENT,
    CR_FLOP_PER_ELEMENT,
    FL_BWD_FLOP_PER_ELEMENT,
    FL_FLOP_PER_ELEMENT,
    PEAK_BYTES_PER_S,
    PEAK_F32_FLOP_PER_S,
    bound,
    fma_chain,
    fma_chain_plain,
    psin_chain,
    psin_chain_plain,
    shaper_bytes,
)
from neural_waveshaping_synthesis_tpu_torch.models.modules import TrainableNonlinearity  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import (  # noqa: E402
    differential_loop_ms,
    require_launches,
)

W = 8
C = 64
K_FMA, K_SIN, A = 256, 32, 0.99
N_HBM = 96 * 1024 * 1024  # float32 elements: 384 MB
N_CHAIN = 8 * 1024 * 1024  # float32 elements of each chain
# float32 operations per (sample, channel) of kernels 1, 2, 5 and 6, an FMA
# as two (kernels/roofline.py)
KERNEL_FLOP = {1: CR_FLOP_PER_ELEMENT, 2: CR_BWD_FLOP_PER_ELEMENT, 5: FL_FLOP_PER_ELEMENT,
               6: FL_BWD_FLOP_PER_ELEMENT}
# the counters that must move on the card: kernel 9's four instances,
# kernels 5 and 6
REQUIRED = ("fma_chain.launches", "fma_chain.launches_ilp4", "psin_chain.launches",
            "psin_chain.launches_ilp4", "film_shaper_fl.launches", "film_shaper_fl.bwd_launches")


def shaper_op_counts():
    """(fwd_muls, fwd_sines, bwd_muls, bwd_sines) per (t, c) element, as
    the JAX script counts them (an FMA one op; a sine or cosine one sine).

    fwd: scale 1; L1 W fma + W sin; L2/L3 W*W fma + W sin each;
         L4 W fma + 1 sin; FiLM in/out 1 fma each.
    bwd (with stored activations): FiLM-out 2; L4: cos + 1 mul + W mul +
         W fma + 1; L3/L2: W cos + W mul + 2*W*W fma + W add each; L1: W cos
         + W mul + 2*W fma + W add; scale 2; FiLM-in 3.
    A recomputing backward adds the fwd counts on top."""
    fwd_muls = 1 + W + W * W + W * W + W + 2
    fwd_sines = 3 * W + 1
    bwd_muls = 2 + (1 + W + W + 1) + 2 * (W + 2 * W * W + W) + (W + 2 * W + W) + 2 + 3
    bwd_sines = 1 + W + W + W
    return fwd_muls, fwd_sines, bwd_muls, bwd_sines


def datasheet_bound_ms(kernel: int, b: int, tc: int, hop: int) -> float:
    """Kernel 1, 2, 5 or 6's least time at (B, Tc * hop, 64) in float32 on
    the data sheet's rates (``kernels.roofline.bound``): kernels 1-2 read a
    control-rate FiLM, 5-6 an audio-rate one."""
    n = b * tc * hop * C
    film = 4 * C * (b * tc if kernel in (1, 2) else b * tc * hop)
    nbytes = shaper_bytes(4 * n, 4 * film, 4 * 170 * C, backward=kernel in (2, 6))
    return bound(n * KERNEL_FLOP[kernel], nbytes)[0]


def main_impl(n_short=5, n_long=25, repeats=3, skip_kernels=False, batch=8, n_frames=500,
              n_hbm=N_HBM, n_chain=N_CHAIN, device="cuda"):
    """Print every row, the ceilings and the floors -> {row: (ms, rate)}."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    kernels = cuda and not skip_kernels
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(f"[roofline] device={name} loop {n_short}/{n_long} best-of-{repeats}", flush=True)
    before = launch_counts()
    rng = np.random.default_rng(0)
    results = {}

    def timed(row, body, work, unit):
        ms = differential_loop_ms(body, n_short, n_long, repeats, device=dev)
        rate = work / (ms * 1e-3)
        results[row] = (ms, rate)
        print(f"  {row:<24} {ms:9.4f} ms   {rate / 1e9:10.2f} G{unit}/s", flush=True)

    def on_dev(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    # ---- device-memory read rate --------------------------------------------
    x_hbm = on_dev((n_hbm // 128, 128))
    timed("hbm_read", lambda c: torch.sum(x_hbm), n_hbm * 4, "B")
    del x_hbm

    # ---- FMA and sine chains -------------------------------------------------
    x128, x64 = on_dev((n_chain // 128, 128)), on_dev((n_chain // 64, 64))
    x0_128, x0_64 = x128 * 0.01, x64 * 0.01
    xs = on_dev((n_chain // 128, 128))
    xs0 = xs * 1e-6

    def sin_chain(x, x0):
        for _ in range(K_SIN):
            x = torch.sin(x) + x0
        return x

    fma_work, sin_work = n_chain * K_FMA, n_chain * K_SIN
    timed("fma128", lambda c: fma_chain_plain(x128, x0_128, K_FMA, A), fma_work, "fma")
    timed("fma128_ilp4", lambda c: fma_chain_plain(x128, x0_128, K_FMA, A, ilp=4),
          4 * fma_work, "fma")
    timed("fma64", lambda c: fma_chain_plain(x64, x0_64, K_FMA, A), fma_work, "fma")
    timed("psin128", lambda c: psin_chain_plain(xs, xs0, K_SIN), sin_work, "sin")
    timed("xsin128", lambda c: sin_chain(xs, xs0), sin_work, "sin")
    if kernels:
        timed("cuda_fma128", lambda c: fma_chain(x128, x0_128, K_FMA, A), fma_work, "fma")
        timed("cuda_fma128_ilp4", lambda c: fma_chain(x128, x0_128, K_FMA, A, ilp=4),
              4 * fma_work, "fma")
        timed("cuda_fma64", lambda c: fma_chain(x64, x0_64, K_FMA, A), fma_work, "fma")
        timed("cuda_psin128", lambda c: psin_chain(xs, xs0, K_SIN), sin_work, "sin")
        timed("cuda_psin128_ilp4", lambda c: psin_chain(xs, xs0, K_SIN, ilp=4), 4 * sin_work,
              "sin")
    else:
        print("  (kernel rows skipped: " + ("--skip-kernels)" if cuda else "CPU)"))
    del x128, x64, x0_128, x0_64, xs, xs0

    # ---- the shaper bank at the training shape ------------------------------
    b, ta = batch, n_frames * 128
    shaper = TrainableNonlinearity(C, W, depth=4, generator=torch.Generator().manual_seed(0))
    shaper = shaper.to(dev)
    p = shaper.params()
    packed = newt_fused.pack_weights(p).detach()
    exc = on_dev((b, ta, C), 0.3)
    film = on_dev((b, ta, 4 * C))
    n_elem = b * ta * C

    def fwd_bwd(f, inputs, params=()):
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        return torch.autograd.grad(f(*leaves).sum(), leaves + list(params))

    def p_fwd(c):
        with torch.no_grad():
            return newt_fused.film_shaper_chain(exc, film, p)

    def p_fwd_bwd(c):
        return fwd_bwd(lambda x: newt_fused.film_shaper_chain(x, film, p), [exc],
                       shaper.parameters())

    # the kernels' probes differentiate into the exciter and the film only,
    # as JAX's: the weights are fixed planes
    p_fixed = {"input_scale": p["input_scale"].detach(),
               "layers": [{k: v.detach() for k, v in layer.items()} for layer in p["layers"]]}

    def fl_fwd(c):
        with torch.no_grad():
            return newt_fused.film_shaper_fl(exc, film, p_fixed, packed=packed)

    def fl_fwd_bwd(c):
        return fwd_bwd(lambda x, f: newt_fused.film_shaper_fl(x, f, p_fixed, packed=packed),
                       [exc, film])

    rows = [("shaper_fwd", p_fwd), ("shaper_fwd_bwd", p_fwd_bwd)]
    if kernels:
        rows += [("shaper_fused_fl_fwd", fl_fwd), ("shaper_fused_fl_fwd_bwd", fl_fwd_bwd)]
    print(f"[roofline] shaper probes at B={b} T={ta} C={C} ({n_elem / 1e6:.1f}M elements)",
          flush=True)
    for row, body in rows:
        ms = differential_loop_ms(body, n_short, n_long, repeats, device=dev)
        results[row] = (ms, 0.0)
        print(f"  {row:<24} {ms:9.4f} ms", flush=True)

    # ---- the floors at the measured ceilings --------------------------------
    # each ceiling is the best rate any row reached: the card goes at least
    # that fast, and a floor from an underestimated ceiling would overstate
    # how close the implementation is
    fwd_m, fwd_s, bwd_m, bwd_s = shaper_op_counts()
    fma_rate = max(results[k][1] for k in ("fma128", "fma128_ilp4", "cuda_fma128",
                                           "cuda_fma128_ilp4") if k in results)
    sin_rate = max(results[k][1] for k in ("psin128", "cuda_psin128", "cuda_psin128_ilp4")
                   if k in results)
    bw = results["hbm_read"][1]

    def floor_ms(muls, sines, bytes_per_elem):
        compute = n_elem * muls / fma_rate + n_elem * sines / sin_rate
        return max(compute, n_elem * bytes_per_elem / bw) * 1e3, compute * 1e3

    print(f"[roofline] ceilings: fma {fma_rate / 1e9:.1f} G/s ({2 * fma_rate / 1e12:.2f} TFLOP/s"
          f" of the data sheet's {PEAK_F32_FLOP_PER_S / 1e12:.0f}), psin {sin_rate / 1e9:.2f} G/s, "
          f"hbm {bw / 1e9:.1f} GB/s (of {PEAK_BYTES_PER_S / 1e9:.0f})")
    # fwd: read exc (4 B) + film (16 B), write out (4 B) = 24 B/elem; the
    # backward recomputes the forward: read exc, film, dy (24 B), write dexc
    # (4 B) + dfilm (16 B) = 44 B/elem; fwd+bwd 68 B/elem
    floors = {"fwd": floor_ms(fwd_m, fwd_s, 24),
              "bwd": floor_ms(fwd_m + bwd_m, fwd_s + bwd_s, 44),
              "fwd+bwd": floor_ms(fwd_m + (fwd_m + bwd_m), fwd_s + (fwd_s + bwd_s), 68)}
    for what, (fl, compute) in floors.items():
        print(f"  {what:<8} floor {fl:8.4f} ms (compute {compute:8.4f} ms)")
    for what, row in (("fwd", "shaper_fwd"), ("fwd", "shaper_fused_fl_fwd"),
                      ("fwd+bwd", "shaper_fwd_bwd"), ("fwd+bwd", "shaper_fused_fl_fwd_bwd")):
        if row in results:
            ms = results[row][0]
            print(f"  {row:<24} measured {ms:9.4f} ms = {ms / floors[what][0]:6.2f} x {what} floor")
    # each kernel: its data-sheet bound and its floor at the measured rates
    # (kernels 1 and 2 compute 5 and 6's shaper, plus the FiLM lerp and its
    # transpose, and read a control-rate FiLM)
    print(f"[roofline] kernels at B={b} T={ta}: data-sheet bound | floor at measured ceilings")
    for k, what in ((1, "fwd"), (5, "fwd"), (2, "bwd"), (6, "bwd")):
        print(f"  kernel {k}: data-sheet bound {datasheet_bound_ms(k, b, n_frames, 128):8.4f} ms"
              f" | {what} floor {floors[what][0]:8.4f} ms")
    print("  (op counts/elem: fwd %d mul + %d sin; bwd adds %d mul + %d cos; recompute doubles "
          "fwd)" % (fwd_m, fwd_s, bwd_m, bwd_s))
    if kernels:
        moved = require_launches(before, REQUIRED, dev)
        missing = [k for k in REQUIRED if k not in moved]
        if missing:
            raise SystemExit(f"no launch of {missing} on the card")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-short", type=int, default=5)
    ap.add_argument("--n-long", type=int, default=25)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--skip-kernels", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-frames", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    main_impl(args.n_short, args.n_long, args.repeats, args.skip_kernels, args.batch,
              args.n_frames, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
