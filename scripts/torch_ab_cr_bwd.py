#!/usr/bin/env python3
"""Kernel 2 (``kernels/csrc/newt_fused_cr_bwd.cu``, the default training
backward) against other CUDA sources with its C interface, on the card.

    python3 scripts/torch_ab_cr_bwd.py OTHER.cu [OTHER.cu ...] [--iters 30]

Builds the checkout's kernel 2 and each OTHER source (nvcc with the port's
flags and ``-I kernels/csrc``, into ``build/ab_cr_bwd/``) and prints, for
each, ptxas's report and the SASS opcode counts (cuobjdump) of its backward
kernel: the whole function, and the innermost loop that holds every shuffle
(in the lane-sum design, one channel's pass over 32 samples). Then, on seeded
random inputs at a training step's shape (B=8, Tc=500, hop 128) with the
run120k_cr shaper, it checks that two calls of each give the same bits, gives
each one's largest difference from the checkout's kernel relative to the
latter's largest value per output, and times all of them in turns (a, b, ...,
..., b, a) by CUDA-event medians of ``--iters`` calls. One JSON line each,
with the card's name and power limit. Without a card it exits non-zero.
"""
import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import _build  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf  # noqa: E402

OUT = _build.BUILD_DIR / "ab_cr_bwd"
# one SASS line: address, opcode (after any predicate), a branch's target
SASS_LINE = re.compile(
    r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*?(?:0x([0-9a-f]+))?\s*;")


def build(name: str, source: Path):
    """-> (library path, ptxas lines)."""
    lib = OUT / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return lib, report


def launcher(lib: Path):
    """-> (exc, film_c, packed, dy, hop) -> the three gradients, launching the
    library at ``lib`` through kernel 2's C interface (the grid as
    ``newt_fused._cr_backward_blocks``: any block count strides over every
    segment, also in a design with several segments per block)."""
    dll = ctypes.CDLL(str(lib))
    query, fn = dll.newt_fused_cr_backward_resident_blocks, dll.newt_fused_cr_backward
    query.argtypes, query.restype = [], ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    resident = query()
    if resident <= 0:
        raise RuntimeError(f"{lib.name}: resident blocks query failed, CUDA error {-resident}")

    def launch(exc, film_c, packed, dy, hop):
        b, ta, _ = exc.shape
        tc = film_c.shape[1]
        blocks = nf._cr_backward_blocks(b * tc, resident)
        outs = (torch.empty_like(exc), torch.empty_like(film_c), torch.empty_like(packed))
        film_part = torch.empty((b * tc, 3, 256), dtype=torch.float32, device=exc.device)
        w_part = torch.empty((blocks, 170, 64), dtype=torch.float32, device=exc.device)
        err = fn(exc.data_ptr(), film_c.data_ptr(), packed.data_ptr(), dy.data_ptr(),
                 *(o.data_ptr() for o in outs), film_part.data_ptr(), w_part.data_ptr(),
                 b, ta, tc, blocks, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
        return outs
    return launch


def sass_counts(lib: Path) -> dict:
    """Opcode counts of the backward kernel: all of it, and the innermost loop
    (a backward branch's span) that holds every SHFL."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)
                if "bwd_kernel" in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2), m.group(3))
           for m in map(SASS_LINE.match, body.splitlines()) if m]
    index = {addr: i for i, (addr, _, _) in enumerate(ins)}
    shfl = [i for i, (_, op, _) in enumerate(ins) if op == "SHFL"]
    loops = [(index[int(tgt, 16)], i) for i, (addr, op, tgt) in enumerate(ins)
             if op == "BRA" and tgt and int(tgt, 16) < addr and int(tgt, 16) in index]
    holding = [(lo, hi) for lo, hi in loops if shfl and lo <= shfl[0] and shfl[-1] <= hi]
    out = {"kernel": collections.Counter(op for _, op, _ in ins).most_common()}
    if holding:
        lo, hi = min(holding, key=lambda span: span[1] - span[0])
        loop = collections.Counter(op for _, op, _ in ins[lo:hi + 1])
        out["loop"] = {"instructions": hi + 1 - lo, "ops": loop.most_common()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", type=Path, help="CUDA sources with kernel 2's C interface")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ab_cr_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"current": _build.CSRC / "newt_fused_cr_bwd.cu"}
    sources.update((p.stem, p) for p in args.others)
    launch = {}
    for name, src in sources.items():
        lib, report = build(name, src)
        print(json.dumps({"source": str(src), "name": name, "ptxas": report,
                          "sass": sass_counts(lib)}), flush=True)
        launch[name] = launcher(lib)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, tc, hop = 8, 500, 128
    exc = torch.from_numpy((rng.standard_normal((b, tc * hop, 64)) * 0.5).astype(np.float32)).to(dev)
    film_c = torch.from_numpy(rng.standard_normal((b, tc, 256)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.standard_normal((b, tc * hop, 64)).astype(np.float32)).to(dev)
    shaper = load_checkpoint(cs.CKPT)[0]["newt"]["shaping_fn"]
    packed = nf.pack_weights({"input_scale": shaper["input_scale"].to(dev),
                              "layers": [{k: v.to(dev) for k, v in layer.items()}
                                         for layer in shaper["layers"]]})
    ref = launch["current"](exc, film_c, packed, dy, hop)
    for name, fn in launch.items():
        first, second = fn(exc, film_c, packed, dy, hop), fn(exc, film_c, packed, dy, hop)
        torch.cuda.synchronize()
        print(json.dumps({"name": name, "bit_identical_repeat": all(map(torch.equal, first, second)),
                          "max_rel_diff_vs_current": {
                              k: float((o - r).abs().max() / r.abs().max())
                              for k, o, r in zip(("d_exciter", "d_film_c", "d_planes"), first, ref)}}),
              flush=True)
    order = list(launch) + list(launch)[::-1]
    ms = collections.defaultdict(list)
    for name in order:
        ms[name].append(cs.cuda_median_ms(lambda: launch[name](exc, film_c, packed, dy, hop),
                                          n=args.iters))
    print(json.dumps({"card": smi, "B": b, "Tc": tc, "hop": hop, "order": order, "ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
