#!/usr/bin/env python3
"""A kernel of the port against other CUDA sources with its C interface, on
the card: kernel 2 (``kernels/csrc/newt_fused_cr_bwd.cu``, the default
training backward), kernel 6 (``newt_fused_fl_bwd.cu``, the audio-rate
backward), kernel 8 (``newt_fused_x_bwd.cu``, the exciter-fused backward,
xcr and xfull), kernel 3 (``newt_fused_stream.cu``, the streaming forward),
kernel 1 (``newt_fused_cr.cu``, the control-rate forward), kernel 7
(``newt_fused_x.cu``, the exciter-fused forwards, xcr and xfull), kernel 5
(``newt_fused_fl.cu``, the audio-rate forward) or kernel 4
(``fast_newt_lookup.cu``, the FastNEWT lookup).

    python3 scripts/torch_ab_bwd.py --kernel cr|fl|x|stream|cr_fwd|x_fwd|fl_fwd|lookup OTHER.cu [...] [--iters 30]

Builds the checkout's kernel and each OTHER source (nvcc with the port's
flags and ``-I kernels/csrc``, into ``build/ab_bwd/``) and prints, for each,
ptxas's report and the SASS opcode counts (cuobjdump) of each kernel
function (kernels 7 and 8 have two: xcr and xfull; kernel 4 its vec4 and
scalar paths): the whole function, the
innermost loop that holds every shuffle (in the lane-sum design, one
channel's pass over 32 samples; in kernel 7's xfull, a group's pass) or,
without shuffles, the longest loop (the forwards' pass over a group of
samples) and a summary of every loop. Then, on seeded random inputs with the
run120k_cr shaper, at a training step's shape (B=8, Tc=500, hop 128; H=101
for kernel 8; for kernel 6 the ``full_lane`` step's B=8, Ta=64000), for the
stream kernel at 256 streams of 1024-sample buffers (B=256, K=8, hop 128),
for kernels 1 and 7 at a batch-8 render's (B=8, Tc=512, hop 128; H=101),
for kernel 5 at a batch-8 ``full_lane`` render's (B=8, Ta=65536), and for
kernel 4 on the (4096, 64) table and the x of a batch-8 x 4-s FastNEWT
render of the run120k_cr checkpoint (caught at the launch), on x uniform in
[-4, 4] of that shape, and on the render's x as a view at storage offset 1
(the scalar path), for each case (cr; fl; xcr and xfull; stream; cr_fwd;
xcr and xfull; fl_fwd; render_b8_4s, uniform and offset1) it checks that two
calls of each source give the same bits, gives each one's largest
difference from the checkout's kernel relative to the latter's largest
value per output, and times all of them in turns (a, b, ..., ..., b, a) by
CUDA-event medians of ``--iters`` calls; for kernel 4 also PyTorch's copy
of x into a new tensor, the same bytes moved with no lookup. One JSON line
each, with the card's name and power limit. Without a card it exits
non-zero.
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
from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import _build, fast_newt  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf  # noqa: E402

OUT = _build.BUILD_DIR / "ab_bwd"
B, TC, HOP, H = 8, 500, 128, 101
FL_TA = 64000
FWD_TC = 512  # a batch-8 render's padded frames: the forwards' shape in chip_smoke.py
STREAM_B, STREAM_K = 256, 8
# one SASS line: address, opcode (after any predicate), a branch's target
SASS_LINE = re.compile(
    r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*?(?:0x([0-9a-f]+))?\s*;")


def build(sources: dict) -> dict:
    """{name: source} -> {name: (library path, ptxas lines)}, one nvcc
    process per source, all started together."""
    jobs = {}
    for name, source in sources.items():
        lib = OUT / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(source)]
        jobs[name] = (lib, source, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                    text=True))
    built = {}
    for name, (lib, source, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source}:\n{log}")
        built[name] = lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return built


def _fn(dll, symbol, argtypes):
    fn = getattr(dll, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _resident(dll, query, lib):
    blocks = _fn(dll, query, [])()
    if blocks <= 0:
        raise RuntimeError(f"{lib.name}: {query} failed, CUDA error {-blocks}")
    return blocks


def cr_launcher(lib: Path):
    """-> a function of kernel 2's inputs (exc, film_c, packed, dy) -> its
    three gradients, launching the library at ``lib`` through kernel 2's C
    interface (the grid as ``newt_fused._segment_blocks``: any block count
    strides over every segment, also in a design with several segments per
    block)."""
    dll = ctypes.CDLL(str(lib))
    resident = _resident(dll, "newt_fused_cr_backward_resident_blocks", lib)
    fn = _fn(dll, "newt_fused_cr_backward", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def launch(exc, film_c, packed, dy):
        b, ta, _ = exc.shape
        tc = film_c.shape[1]
        blocks = nf._segment_blocks(b * tc, resident)
        outs = (torch.empty_like(exc), torch.empty_like(film_c), torch.empty_like(packed))
        film_part = exc.new_empty((b * tc, 3, 256))
        w_part = exc.new_empty((blocks, 170, 64))
        err = fn(exc.data_ptr(), film_c.data_ptr(), packed.data_ptr(), dy.data_ptr(),
                 *(o.data_ptr() for o in outs), film_part.data_ptr(), w_part.data_ptr(),
                 b, ta, tc, blocks, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
        return outs
    return {"cr": launch}


def fl_launcher(lib: Path):
    """-> {"fl": fn}: a function of kernel 6's inputs (exc, film_a, packed,
    dy) -> its three gradients, launching the library at ``lib`` through
    kernel 6's C interface (the grid as ``newt_fused._chunk_blocks``: any
    block count strides over every sample, also in the earlier design of 4
    samples per block)."""
    dll = ctypes.CDLL(str(lib))
    resident = _resident(dll, "newt_fused_fl_backward_resident_blocks", lib)
    fn = _fn(dll, "newt_fused_fl_backward", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p])

    def launch(exc, film_a, packed, dy):
        b, ta, _ = exc.shape
        blocks = nf._chunk_blocks(b * ta, resident)
        outs = (torch.empty_like(exc), torch.empty_like(film_a), torch.empty_like(packed))
        w_part = exc.new_empty((blocks, 170, 64))
        err = fn(exc.data_ptr(), film_a.data_ptr(), packed.data_ptr(), dy.data_ptr(),
                 *(o.data_ptr() for o in outs), w_part.data_ptr(), b * ta, blocks,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
        return outs
    return {"fl": launch}


def x_launcher(lib: Path):
    """-> {"xcr": fn, "xfull": fn}: functions of kernel 8's inputs (phase,
    f0, offsets, film_c, w, b, packed, w_out, dy) -> (d_film_c, the (rows,
    64) gradient table), launching the library at ``lib`` through kernel 8's
    C interface with the grid of ``newt_fused._segment_blocks`` (any block
    count strides over every segment, also in the two-segment blocks of the
    earlier design)."""
    dll = ctypes.CDLL(str(lib))
    resident = {kind: _resident(dll, f"newt_fused_{kind}_backward_resident_blocks", lib)
                for kind in ("xcr", "xfull")}
    fn = _fn(dll, "newt_fused_x_backward",
             [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])

    def make(kind):
        def launch(phase, f0, off, film_c, w, bias, packed, w_out, dy):
            bsz, ta = phase.shape
            tc = film_c.shape[1]
            h = off.shape[0]
            wo = w_out if kind == "xfull" else None
            rows = 170 + h + 1 + int(wo is not None)
            blocks = nf._segment_blocks(bsz * tc, resident[kind])
            d_film, grads = torch.empty_like(film_c), phase.new_empty((rows, 64))
            film_part, part = phase.new_empty((bsz * tc, 3, 256)), phase.new_empty((blocks, rows, 64))
            err = fn(phase.data_ptr(), f0.data_ptr(), off.data_ptr(), film_c.data_ptr(), w.data_ptr(),
                     bias.data_ptr(), packed.data_ptr(), wo.data_ptr() if wo is not None else None,
                     dy[kind].data_ptr(), d_film.data_ptr(), grads.data_ptr(), film_part.data_ptr(),
                     part.data_ptr(), bsz, ta, tc, h, blocks, 8000.0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
            return d_film, grads
        return launch
    return {"xcr": make("xcr"), "xfull": make("xfull")}


def cr_inputs(rng, dev, packed):
    exc = (rng.standard_normal((B, TC * HOP, 64)) * 0.5).astype(np.float32)
    film_c = rng.standard_normal((B, TC, 256)).astype(np.float32)
    dy = rng.standard_normal((B, TC * HOP, 64)).astype(np.float32)
    exc, film_c, dy = (torch.from_numpy(a).to(dev) for a in (exc, film_c, dy))
    return (exc, film_c, packed, dy), ("d_exciter", "d_film_c", "d_planes")


def fl_inputs(rng, dev, packed):
    """As ``chip_smoke.py``'s made-up audio-rate cases: a 0.5-scaled
    exciter, a normal audio-rate FiLM and dy."""
    exc = (rng.standard_normal((B, FL_TA, 64)) * 0.5).astype(np.float32)
    film_a = rng.standard_normal((B, FL_TA, 256)).astype(np.float32)
    dy = rng.standard_normal((B, FL_TA, 64)).astype(np.float32)
    exc, film_a, dy = (torch.from_numpy(a).to(dev) for a in (exc, film_a, dy))
    return (exc, film_a, packed, dy), ("d_exciter", "d_film", "d_planes")


def x_inputs(rng, dev, packed, tc=TC, backward=True):
    """As ``tests/test_torch_cuda.py`` ``_x_inputs``: wrapped phase and f0
    (110 Hz to 1.76 kHz, so the antialias mask cuts real harmonics), offsets,
    film, a 0.1-scaled mixer and w_out; for the backward dy for xcr and for
    xfull."""
    f0 = (110.0 * 2.0 ** rng.uniform(0, 4, (B, tc * HOP))).astype(np.float32)
    phase = np.mod(2 * np.pi * np.cumsum(f0.astype(np.float64), -1) / 16000, 2 * np.pi).astype(np.float32)
    arrays = (phase, f0, rng.uniform(-np.pi, np.pi, H).astype(np.float32),
              rng.standard_normal((B, tc, 256)).astype(np.float32),
              (rng.standard_normal((H, 64)) * 0.1).astype(np.float32),
              (rng.standard_normal(64) * 0.1).astype(np.float32))
    phase, f0, off, film_c, w, bias = (torch.from_numpy(a).to(dev) for a in arrays)
    w_out = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32)).to(dev)
    if not backward:
        return (phase, f0, off, film_c, w, bias, packed, w_out), ("out",)
    dy = {"xcr": torch.from_numpy(rng.standard_normal((B, tc * HOP, 64)).astype(np.float32)).to(dev),
          "xfull": torch.from_numpy(rng.standard_normal((B, tc * HOP)).astype(np.float32)).to(dev)}
    return (phase, f0, off, film_c, w, bias, packed, w_out, dy), ("d_film_c", "grads")


def stream_launcher(lib: Path):
    """-> {"stream": fn}: a function of kernel 3's inputs (exciter,
    prev_film, film_c, packed) -> (out,), launching the library at ``lib``
    through kernel 3's C interface with the grid the library reports."""
    dll = ctypes.CDLL(str(lib))
    resident = _resident(dll, "newt_fused_stream_resident_blocks", lib)
    fn = _fn(dll, "newt_fused_stream_forward", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def launch(exc, prev, film_c, packed):
        b, ta, _ = exc.shape
        k = film_c.shape[1]
        out = torch.empty_like(exc)
        err = fn(exc.data_ptr(), prev.data_ptr(), film_c.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 b * ta, ta, k, ta // k, resident, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
        return (out,)
    return {"stream": launch}


def stream_inputs(rng, dev, packed):
    """As ``chip_smoke.py``'s made-up stream cases: a 0.5-scaled exciter,
    normal carried and buffer FiLM frames."""
    exc = (rng.standard_normal((STREAM_B, STREAM_K * HOP, 64)) * 0.5).astype(np.float32)
    prev = rng.standard_normal((STREAM_B, 256)).astype(np.float32)
    film_c = rng.standard_normal((STREAM_B, STREAM_K, 256)).astype(np.float32)
    exc, prev, film_c = (torch.from_numpy(a).to(dev) for a in (exc, prev, film_c))
    return (exc, prev, film_c, packed), ("out",)


def cr_fwd_launcher(lib: Path):
    """-> {"cr_fwd": fn}: a function of kernel 1's inputs (exciter, film_c,
    packed) -> (out,), launching the library at ``lib`` through kernel 1's
    C interface (the library sizes its own grid)."""
    dll = ctypes.CDLL(str(lib))
    fn = _fn(dll, "newt_fused_cr_forward", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def launch(exc, film_c, packed):
        b, ta, _ = exc.shape
        tc = film_c.shape[1]
        out = torch.empty_like(exc)
        err = fn(exc.data_ptr(), film_c.data_ptr(), packed.data_ptr(), out.data_ptr(), b * ta, ta, tc,
                 ta // tc, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
        return (out,)
    return {"cr_fwd": launch}


def cr_fwd_inputs(rng, dev, packed):
    """As ``chip_smoke.py``'s made-up control-rate cases: a 0.5-scaled
    exciter and a normal control-rate FiLM, at a batch-8 render's shape."""
    exc = (rng.standard_normal((B, FWD_TC * HOP, 64)) * 0.5).astype(np.float32)
    film_c = rng.standard_normal((B, FWD_TC, 256)).astype(np.float32)
    exc, film_c = (torch.from_numpy(a).to(dev) for a in (exc, film_c))
    return (exc, film_c, packed), ("out",)


def x_fwd_launcher(lib: Path):
    """-> {"xcr": fn, "xfull": fn}: functions of kernel 7's inputs (phase,
    f0, offsets, film_c, w, b, packed, w_out) -> (out,), launching the
    library at ``lib`` through kernel 7's C interface on the blocks it
    reports resident (any block count strides over every sample, whatever
    the samples a block pass)."""
    dll = ctypes.CDLL(str(lib))
    resident = {kind: _resident(dll, f"newt_fused_{kind}_resident_blocks", lib) for kind in ("xcr", "xfull")}
    fn = _fn(dll, "newt_fused_x_forward",
             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])

    def make(kind):
        def launch(phase, f0, off, film_c, w, bias, packed, w_out):
            bsz, ta = phase.shape
            tc = film_c.shape[1]
            wo = w_out if kind == "xfull" else None
            out = phase.new_empty((bsz, ta) if wo is not None else (bsz, ta, 64))
            err = fn(phase.data_ptr(), f0.data_ptr(), off.data_ptr(), film_c.data_ptr(), w.data_ptr(),
                     bias.data_ptr(), packed.data_ptr(), wo.data_ptr() if wo is not None else None,
                     out.data_ptr(), bsz * ta, ta, tc, ta // tc, off.shape[0], resident[kind], 8000.0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
            return (out,)
        return launch
    return {"xcr": make("xcr"), "xfull": make("xfull")}


def x_fwd_inputs(rng, dev, packed):
    """:func:`x_inputs` at a batch-8 render's shape, without dy."""
    return x_inputs(rng, dev, packed, tc=FWD_TC, backward=False)


def fl_fwd_launcher(lib: Path):
    """-> {"fl_fwd": fn}: a function of kernel 5's inputs (exciter, film_a,
    packed) -> (out,), launching the library at ``lib`` through kernel 5's
    C interface (the library sizes its own grid)."""
    dll = ctypes.CDLL(str(lib))
    fn = _fn(dll, "newt_fused_fl_forward", [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])

    def launch(exc, film_a, packed):
        out = torch.empty_like(exc)
        err = fn(exc.data_ptr(), film_a.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 exc.shape[0] * exc.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
        return (out,)
    return {"fl_fwd": launch}


def fl_fwd_inputs(rng, dev, packed):
    """As ``chip_smoke.py``'s made-up audio-rate cases (a 0.5-scaled
    exciter, a normal audio-rate FiLM) at a batch-8 render's shape."""
    exc = (rng.standard_normal((B, FWD_TC * HOP, 64)) * 0.5).astype(np.float32)
    film_a = rng.standard_normal((B, FWD_TC * HOP, 256)).astype(np.float32)
    exc, film_a = (torch.from_numpy(a).to(dev) for a in (exc, film_a))
    return (exc, film_a, packed), ("out",)


LOOKUP_CASES = ("render_b8_4s", "uniform", "offset1")


def lookup_launcher(lib: Path):
    """-> {case: fn}: a function of kernel 4's inputs (table, x) -> (out,),
    launching the library at ``lib`` through kernel 4's C interface: the
    row count and the path of ``fast_newt._lookup_path``
    (``fast_newt_lookup_rows``), or an earlier source's element count
    (``fast_newt_lookup_forward``)."""
    dll = ctypes.CDLL(str(lib))
    rows = hasattr(dll, "fast_newt_lookup_rows")
    if rows:
        fn = _fn(dll, "fast_newt_lookup_rows",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    else:
        fn = _fn(dll, "fast_newt_lookup_forward", [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
            ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

    def launch(table, x):
        out = torch.empty_like(x)
        s, c = table.shape
        stream = torch.cuda.current_stream().cuda_stream
        if rows:
            vec4 = int(fast_newt._lookup_path(x, out) == "vec4")
            err = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(), x.numel() // c, s, c, vec4,
                     fast_newt.TABLE_MIN, fast_newt.SPAN, stream)
        else:
            err = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(), x.numel(), s, c,
                     fast_newt.TABLE_MIN, fast_newt.SPAN, stream)
        if err:
            raise RuntimeError(f"{lib.name} did not launch: CUDA error {err}")
        return (out,)
    return {case: launch for case in LOOKUP_CASES}


def lookup_inputs(rng, dev, packed):
    """{case: (table, x)}: the run120k_cr checkpoint's baked (4096, 64)
    table and the x its batch-8 x 4-s FastNEWT render hands the kernel, x
    uniform in [-4, 4] of that shape, and the render's x copied into a view
    at storage offset 1 (4 B past 16-B alignment: the scalar path)."""
    synth = Synthesizer.from_checkpoint(cs.CKPT, device="cuda")
    f0_b, ctrl_b, _ = synth.prepare(cs.make_requests([4] * B, 6))
    f0_t, ctrl_t = torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev)
    with torch.inference_mode():
        table = synth.model.newt.bake_lookup_table()
        table, x = cs.caught_lookups(lambda: synth.model(
            f0_t, ctrl_t, generator=torch.Generator().manual_seed(0), lookup_table=table))[0]
    uniform = torch.from_numpy(rng.uniform(-4, 4, tuple(x.shape)).astype(np.float32)).to(dev)
    offset1 = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    offset1.copy_(x)
    return {"render_b8_4s": (table, x), "uniform": (table, uniform), "offset1": (table, offset1)}, ("out",)


# --kernel -> (source, SASS function-name mark, launcher, inputs, shape printed)
KERNELS = {"cr": ("newt_fused_cr_bwd.cu", "bwd_kernel", cr_launcher, cr_inputs,
                  {"B": B, "Tc": TC, "hop": HOP}),
           "fl": ("newt_fused_fl_bwd.cu", "bwd_kernel", fl_launcher, fl_inputs, {"B": B, "Ta": FL_TA}),
           "x": ("newt_fused_x_bwd.cu", "bwd_kernel", x_launcher, x_inputs,
                 {"B": B, "Tc": TC, "hop": HOP, "H": H}),
           "stream": ("newt_fused_stream.cu", "stream_kernel", stream_launcher, stream_inputs,
                      {"B": STREAM_B, "K": STREAM_K, "hop": HOP}),
           "cr_fwd": ("newt_fused_cr.cu", "film_shaper_cr_kernel", cr_fwd_launcher, cr_fwd_inputs,
                      {"B": B, "Tc": FWD_TC, "hop": HOP}),
           "x_fwd": ("newt_fused_x.cu", "bank_film_shaper_x_kernel", x_fwd_launcher, x_fwd_inputs,
                     {"B": B, "Tc": FWD_TC, "hop": HOP, "H": H}),
           "fl_fwd": ("newt_fused_fl.cu", "film_shaper_fl_kernel", fl_fwd_launcher, fl_fwd_inputs,
                      {"B": B, "Ta": FWD_TC * HOP}),
           "lookup": ("fast_newt_lookup.cu", "fast_newt_lookup", lookup_launcher, lookup_inputs,
                      {"B": B, "Ta": FWD_TC * HOP, "C": 64, "S": 4096})}


def sass_counts(lib: Path, mark: str) -> dict:
    """Per kernel function whose name holds ``mark``: opcode counts of all
    of it, of the innermost loop (a backward branch's span) that holds every
    SHFL (without SHFL: the longest loop), and each loop's length with its
    FFMA, LDS and SHFL counts."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass):
        title = body.split("\n", 1)[0].strip()
        if mark not in title:
            continue
        ins = [(int(m.group(1), 16), m.group(2), m.group(3))
               for m in map(SASS_LINE.match, body.splitlines()) if m]
        index = {addr: i for i, (addr, _, _) in enumerate(ins)}
        shfl = [i for i, (_, op, _) in enumerate(ins) if op == "SHFL"]
        loops = [(index[int(tgt, 16)], i) for i, (addr, op, tgt) in enumerate(ins)
                 if op == "BRA" and tgt and int(tgt, 16) < addr and int(tgt, 16) in index]
        fn = {"kernel": collections.Counter(op for _, op, _ in ins).most_common()}
        if shfl:
            holding = [(lo, hi) for lo, hi in loops if lo <= shfl[0] and shfl[-1] <= hi]
            chosen = min(holding, key=lambda span: span[1] - span[0]) if holding else None
        else:
            chosen = max(loops, key=lambda span: span[1] - span[0]) if loops else None
        if chosen:
            lo, hi = chosen
            loop = collections.Counter(op for _, op, _ in ins[lo:hi + 1])
            fn["loop"] = {"instructions": hi + 1 - lo, "ops": loop.most_common()}
        fn["loops"] = []
        for lo, hi in sorted(loops):
            ops = collections.Counter(op for _, op, _ in ins[lo:hi + 1])
            fn["loops"].append({"span": [lo, hi], "instructions": hi + 1 - lo,
                                **{op: ops[op] for op in ("FFMA", "LDS", "SHFL", "BAR")}})
        out[title] = fn
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", type=Path, help="CUDA sources with the kernel's C interface")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="cr")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ab_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    source, mark, launcher, make_inputs, shape = KERNELS[args.kernel]
    sources = {"current": _build.CSRC / source}
    sources.update((p.stem, p) for p in args.others)
    launch = {}
    built = build({f"{args.kernel}_{name}": src for name, src in sources.items()})
    for name, src in sources.items():
        lib, report = built[f"{args.kernel}_{name}"]
        print(json.dumps({"source": str(src), "name": name, "ptxas": report,
                          "sass": sass_counts(lib, mark)}), flush=True)
        launch[name] = launcher(lib)

    dev = torch.device("cuda")
    shaper = load_checkpoint(cs.CKPT)[0]["newt"]["shaping_fn"]
    packed = nf.pack_weights({"input_scale": shaper["input_scale"].to(dev),
                              "layers": [{k: v.to(dev) for k, v in layer.items()}
                                         for layer in shaper["layers"]]})
    made, outputs = make_inputs(np.random.default_rng(0), dev, packed)
    for case in launch["current"]:
        inputs = made[case] if isinstance(made, dict) else made
        ref = launch["current"][case](*inputs)
        for name, fns in launch.items():
            first, second = fns[case](*inputs), fns[case](*inputs)
            torch.cuda.synchronize()
            print(json.dumps({"case": case, "name": name,
                              "bit_identical_repeat": all(map(torch.equal, first, second)),
                              "bit_identical_vs_current": all(map(torch.equal, first, ref)),
                              "max_rel_diff_vs_current": {
                                  k: float((o - r).abs().max() / r.abs().max())
                                  for k, o, r in zip(outputs, first, ref)}}), flush=True)
        order = list(launch) + list(launch)[::-1]
        ms = collections.defaultdict(list)
        for name in order:
            ms[name].append(cs.cuda_median_ms(lambda: launch[name][case](*inputs), n=args.iters))
        print(json.dumps({"card": smi, "case": case, **shape, "order": order, "ms": ms}), flush=True)
        if args.kernel == "lookup":  # the bytes alone: PyTorch's copy of x into a new tensor
            x = inputs[1]
            copy_ms = cs.cuda_median_ms(lambda: torch.empty_like(x).copy_(x), n=args.iters)
            print(json.dumps({"card": smi, "case": case, "copy_ms": copy_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
