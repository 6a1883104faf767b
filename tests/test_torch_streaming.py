"""The streaming slice of the port against the JAX package, on the CPU:
the segment ramp, the stream kernel's plain version (against the JAX TPU
kernel ``film_shaper_fused_stream`` in interpret mode and the JAX chain),
the oscillator's phase carry, the partitioned reverb, a whole
``StreamingSynth.step`` chained over buffers on the run120k_cr weights with
every carried leaf, and ``PipelinedStreamer``. The card's own cases are in
tests/test_torch_cuda.py."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu.kernels import newt_fused as jnf
from neural_waveshaping_synthesis_tpu.models import NEWT as JNEWT
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.ops import fir as jfir
from neural_waveshaping_synthesis_tpu.ops import oscillator as josc
from neural_waveshaping_synthesis_tpu.streaming import StreamingSynth as JStreamingSynth
from neural_waveshaping_synthesis_tpu.streaming.synth import _segment_interp
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax, stream_state_from_jax
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NEWT, NeuralWaveshaping, TrainableNonlinearity
from neural_waveshaping_synthesis_tpu_torch.ops import (
    fft_convolve_full,
    final_phase,
    harmonic_oscillator_bank,
    partition_ir_spectra,
    partitioned_convolve_step,
)
from neural_waveshaping_synthesis_tpu_torch.streaming import (
    PipelinedStreamer,
    StreamingSynth,
    segment_interp,
)

CKPT = str(
    Path(__file__).resolve().parents[1]
    / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt"
)
TAU = 2 * np.pi


@pytest.fixture(scope="module")
def jax_newt():
    newt = JNEWT()
    return newt, newt.init(jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def shipped():
    """The run120k_cr weights: the JAX tree and the port's model on the CPU."""
    jparams = load_reference_checkpoint(CKPT)[0]
    model = NeuralWaveshaping()
    model.load_params(params_from_jax(jparams))
    return jparams, model.eval()


@pytest.mark.parametrize("k,hop", [(6, 16), (3, 128), (1, 10)])
def test_segment_interp_matches_jax_bit_for_bit(k, hop):
    """Same (o+1)/hop weight, same start + (end - start) * t form, three
    roundings each: bit-exact (XLA's CPU does not contract it here)."""
    rng = np.random.default_rng(k + hop)
    prev = rng.standard_normal((2, 256)).astype(np.float32)
    frames = rng.standard_normal((2, k, 256)).astype(np.float32)
    ref = np.asarray(_segment_interp(jnp.asarray(prev), jnp.asarray(frames), hop))
    out = segment_interp(torch.from_numpy(prev), torch.from_numpy(frames), hop).numpy()
    np.testing.assert_array_equal(out, ref)


def _stream_inputs(b=2, k=6, hop=16, seed=13):
    rng = np.random.default_rng(seed)
    exciter = (rng.standard_normal((b, k * hop, 64)) * 0.5).astype(np.float32)
    film_c = rng.standard_normal((b, k, 256)).astype(np.float32)
    prev = rng.standard_normal((b, 256)).astype(np.float32)
    return exciter, prev, film_c


def test_stream_plain_matches_jax_kernel_and_chain(jax_newt):
    """film_shaper_stream_plain vs the JAX TPU kernel in interpret mode and
    the JAX chain (streaming/synth.py step 5) at B=2, K=6, hop=16, the JAX
    suite's kernel-vs-chain tolerance rtol=1e-4, atol=1e-5."""
    newt, p = jax_newt
    exciter, prev, film_c = _stream_inputs()
    hop = 16
    kernel = jnf.film_shaper_fused_stream(
        jnp.asarray(exciter), jnp.asarray(prev), jnp.asarray(film_c),
        jnf.pack_weights_fl(p["shaping_fn"]), hop, True,
    )
    film_a = _segment_interp(jnp.asarray(prev), jnp.asarray(film_c), hop)
    gi, bi, gn, bn = (film_a[..., i * 64 : (i + 1) * 64] for i in range(4))
    chain = gn * newt.shaping_fn.apply(p["shaping_fn"], gi * jnp.asarray(exciter) + bi) + bn
    out = nf.film_shaper_stream_plain(
        torch.from_numpy(exciter), torch.from_numpy(prev), torch.from_numpy(film_c),
        params_from_jax(p["shaping_fn"]), hop,
    ).numpy()
    np.testing.assert_allclose(out, np.asarray(kernel), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(chain), rtol=1e-4, atol=1e-5)


def test_stream_plain_split_is_bit_identical(jax_newt):
    """Two buffers (2 + 4 frames, the second carrying the first's last
    frame) give the bits of one 6-frame buffer."""
    _, p = jax_newt
    exciter, prev, film_c = (torch.from_numpy(a) for a in _stream_inputs())
    w, hop, cut = params_from_jax(p["shaping_fn"]), 16, 2
    whole = nf.film_shaper_stream_plain(exciter, prev, film_c, w, hop)
    first = nf.film_shaper_stream_plain(exciter[:, : cut * hop], prev, film_c[:, :cut], w, hop)
    second = nf.film_shaper_stream_plain(
        exciter[:, cut * hop :], film_c[:, cut - 1], film_c[:, cut:], w, hop
    )
    assert torch.equal(whole, torch.cat([first, second], dim=1))


def test_stream_wrapper_dispatches_cpu_tensors_to_plain(jax_newt):
    _, p = jax_newt
    exciter, prev, film_c = (torch.from_numpy(a) for a in _stream_inputs(k=3, hop=12))
    args = (exciter, prev, film_c, params_from_jax(p["shaping_fn"]), 12)
    before = nf.film_shaper_stream.launches
    out = nf.film_shaper_stream(*args)
    assert nf.film_shaper_stream.launches == before
    assert torch.equal(out, nf.film_shaper_stream_plain(*args))


def test_stream_hopper_gate():
    """The shipped shaper, any K >= 1 and any integer hop: K = 1 and odd K,
    which the TPU gate refused, are accepted."""
    shaper = TrainableNonlinearity(64, 8, depth=4)
    assert nf.supports_stream(shaper, 8 * 128, 8)
    assert nf.supports_stream(shaper, 1 * 128, 1)
    assert nf.supports_stream(shaper, 3 * 64, 3)
    assert not nf.supports_stream(shaper, 130, 8)
    assert not nf.supports_stream(TrainableNonlinearity(64, 8, depth=3), 128, 1)


@pytest.mark.parametrize("case", ["shape", "dtype", "contiguity", "device", "hop"])
def test_stream_launch_checks_refuse_what_the_kernel_does_not_take(case):
    exc = torch.zeros(2, 4 * 8, 64)
    prev = torch.zeros(2, 256)
    film_c = torch.zeros(2, 4, 256)
    w = torch.zeros(170, 64)
    hop = 8
    if case == "shape":
        prev = torch.zeros(1, 256)
    elif case == "dtype":
        prev = prev.double()
    elif case == "contiguity":
        prev = torch.zeros(256, 2).T
    elif case == "device":
        prev = prev.to("meta")
    elif case == "hop":
        hop = 7
    with pytest.raises((ValueError, TypeError)):
        nf._check_stream(exc, prev, film_c, w, hop)


def test_newt_forward_stream_on_cpu_runs_the_plain_version(jax_newt):
    """NEWT.forward_stream with fused="cr" on the CPU is the plain version
    plus the mixer, the same bits as fused=False; the offline forward
    still matches its own chain."""
    _, p = jax_newt
    port = NEWT()
    port.load_params(params_from_jax(p))
    exciter, prev, film_c = (torch.from_numpy(a) for a in _stream_inputs(k=3, hop=16))
    with torch.no_grad():
        out = port.forward_stream(exciter, prev, film_c)
        plain = port.forward_stream(exciter, prev, film_c, fused=False)
        ref = port.mixer(nf.film_shaper_stream_plain(
            exciter, prev, film_c, port.shaping_fn.params(), 16))
    assert out.shape == (2, 48, 1)
    assert torch.equal(out, plain) and torch.equal(out, ref)
    with pytest.raises(ValueError):
        port.forward_stream(exciter[:, :47], prev, film_c)


def test_oscillator_initial_and_final_phase_match_jax():
    """The bank with a carried (B,) phase and (B, H) offsets, and the carry
    after the buffer. The port sums in float64, JAX in float32, whose phase
    near 400 rad carries ~3e-5 rad of rounding, times the harmonic number
    in the bank: observed when written, bank 4.2e-4 apart at most (atol
    1e-3), the carry 3.3e-5 rad (bar 1e-4); the port's carry is the exact
    float64 sum."""
    rng = np.random.default_rng(5)
    b, t, h = 2, 1024, 101
    f0 = (rng.uniform(100, 900, (b, 1)) * np.linspace(1.0, 1.2, t)).astype(np.float32)
    init = rng.uniform(0, TAU, b).astype(np.float32)
    offset = rng.uniform(-np.pi, np.pi, (b, h)).astype(np.float32)
    ref = josc.harmonic_oscillator_bank(
        jnp.asarray(f0), h, 16000.0, phase_offset=jnp.asarray(offset), initial_phase=jnp.asarray(init)
    )
    out = harmonic_oscillator_bank(
        torch.from_numpy(f0), h, 16000.0, torch.from_numpy(offset), torch.from_numpy(init)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)
    carry = final_phase(torch.from_numpy(f0), 16000.0, torch.from_numpy(init))
    assert carry.dtype == torch.float64
    jcarry = np.asarray(josc.final_phase(jnp.asarray(f0), 16000.0, jnp.asarray(init)))
    diff = np.angle(np.exp(1j * (carry.numpy() - jcarry)))
    assert np.all(np.abs(diff) < 1e-4), diff
    exact = np.mod(TAU * np.sum(f0.astype(np.float64), -1) / 16000 + init, TAU)
    np.testing.assert_allclose(carry.numpy(), exact, rtol=0, atol=1e-12)


def test_partitioned_convolution_matches_jax_and_linear():
    """Chained partitioned_convolve_step == JAX's chain == the port's
    fft_convolve_full (tests/test_streaming.py's case), rtol 1e-3,
    atol 1e-4; the partition spectra match JAX's."""
    rng = np.random.default_rng(0)
    block, n_blocks = 64, 12
    ir = (rng.standard_normal(300) * 0.2).astype(np.float32)
    x = rng.standard_normal((2, block * n_blocks)).astype(np.float32)
    spectra = partition_ir_spectra(torch.from_numpy(ir), block)
    jspectra = jfir.partition_ir_spectra(jnp.asarray(ir), block)
    assert spectra.dtype == torch.complex64 and spectra.shape == (5, block + 1)
    np.testing.assert_allclose(spectra.numpy(), np.asarray(jspectra), rtol=1e-5, atol=1e-5)
    fdl = torch.zeros((2, 5, block + 1), dtype=torch.complex64)
    tail = torch.zeros((2, block))
    jfdl, jtail = jnp.zeros((2, 5, block + 1), jnp.complex64), jnp.zeros((2, block))
    outs, jouts = [], []
    for i in range(n_blocks):
        xb = x[:, i * block : (i + 1) * block]
        y, fdl, tail = partitioned_convolve_step(torch.from_numpy(xb), fdl, tail, spectra)
        jy, jfdl, jtail = jfir.partitioned_convolve_step(jnp.asarray(xb), jfdl, jtail, jspectra)
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
    streamed = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(streamed, np.concatenate(jouts, -1), rtol=1e-3, atol=1e-4)
    direct = fft_convolve_full(torch.from_numpy(x), torch.from_numpy(ir)).numpy()
    assert direct.shape == (2, block * n_blocks + 299)
    np.testing.assert_allclose(streamed, direct[:, : block * n_blocks], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(fdl.numpy(), np.asarray(jfdl), rtol=1e-4, atol=1e-4)


def _controls(b, tc, seed):
    rng = np.random.default_rng(seed)
    f0 = (220.0 * 2.0 ** rng.uniform(0, 1.5, (b, 1)) * np.linspace(1.0, 1.25, tc)
          + rng.standard_normal((b, tc))).astype(np.float32)
    control = rng.standard_normal((b, tc, 2)).astype(np.float32)
    return f0, control


def _nrms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


@pytest.mark.parametrize("k", [2, 3])
def test_step_matches_jax_on_run120k_cr(shipped, k):
    """Six chained buffers of B=2 streams at K frames, from the JAX
    init_state's carries (stream_state_from_jax) and the noise its key
    chain draws. Each buffer's audio is held to the 1e-3 nRMS golden bar;
    observed when written: 3.4e-6 on the first buffer, growing with JAX's
    float32 phase drift to at most 2.9e-5 (K=2) and 4.2e-5 (K=3). After the
    last buffer every carried leaf matches JAX: osc_phase within 1e-4 rad
    (mod tau; JAX's float32 carry drifts from the exact sum, observed
    3.2e-5), prev_f0 and noise_prev exactly (they
    are the inputs), gru_h and prev_film rtol 1e-4 / atol 1e-5; each FFT
    sum within a share of its largest value: noise_ola 1e-4 (observed
    5.4e-6), the reverb tail and delay line, which carry the dry audio and
    its drift, 1e-3 (observed 3.5e-5 and 4.3e-5)."""
    jparams, model = shipped
    jss = JStreamingSynth(JNeuralWaveshaping(), k)
    ss = StreamingSynth(model, k)
    b, n_buffers, hop = 2, 6, 128
    jstate = jss.init_state(jparams, b, jax.random.PRNGKey(k))
    fields = {n: np.asarray(v) for n, v in jstate._asdict().items() if n != "key"}
    state = stream_state_from_jax(fields, device="cpu")
    jstep = jax.jit(jss.step)
    jspec = jss.ir_partition_spectra(jparams)
    spec = ss.ir_partition_spectra()
    np.testing.assert_allclose(
        spec.numpy(), np.asarray(jspec[..., 0]) + 1j * np.asarray(jspec[..., 1]), rtol=1e-4, atol=1e-6
    )
    f0, control = _controls(b, k * n_buffers, seed=20 + k)
    errs = []
    for i in range(n_buffers):
        sl = slice(i * k, (i + 1) * k)
        _, k_noise = jax.random.split(jstate.key)
        noise = np.array(jax.random.uniform(k_noise, (b, k * hop)))
        jaudio, jstate = jstep(jparams, jstate, jnp.asarray(f0[:, sl]), jnp.asarray(control[:, sl]), jspec)
        audio, state = ss.step(state, torch.from_numpy(f0[:, sl]), torch.from_numpy(control[:, sl]),
                               spec, noise=torch.from_numpy(noise))
        assert audio.shape == (b, k * hop)
        errs.append(_nrms(audio.numpy(), np.asarray(jaudio)))
    assert max(errs) <= 1e-3, errs

    j = {n: np.asarray(v) for n, v in jstate._asdict().items() if n != "key"}
    diff = np.angle(np.exp(1j * (state.osc_phase.numpy() - j["osc_phase"])))
    assert np.all(np.abs(diff) < 1e-4), diff
    np.testing.assert_array_equal(state.prev_f0.numpy(), j["prev_f0"])
    np.testing.assert_array_equal(state.noise_prev.numpy(), j["noise_prev"])
    np.testing.assert_array_equal(state.phase_offset.numpy(), j["phase_offset"])
    for name in ("gru_h", "prev_film"):
        np.testing.assert_allclose(getattr(state, name).numpy(), j[name], rtol=1e-4, atol=1e-5, err_msg=name)
    fdl = state.reverb_fdl.numpy()
    jfdl = j["reverb_fdl"][..., 0] + 1j * j["reverb_fdl"][..., 1]
    for name, ours, theirs in (("noise_ola", state.noise_ola.numpy(), j["noise_ola"]),
                               ("reverb_tail", state.reverb_tail.numpy(), j["reverb_tail"]),
                               ("reverb_fdl", fdl, jfdl)):
        assert ours.shape == theirs.shape, name
        rel = np.max(np.abs(ours - theirs)) / np.max(np.abs(theirs))
        assert rel <= (1e-4 if name == "noise_ola" else 1e-3), (name, rel)


def _serial_and_piped(model, k, f0s, ctrls, seed, depth):
    ss = StreamingSynth(model, k)
    state = ss.init_state(1, torch.Generator().manual_seed(seed), device="cpu")
    spec = ss.ir_partition_spectra()
    serial = []
    for f0, c in zip(f0s, ctrls):
        audio, state = ss.step(state, torch.from_numpy(f0), torch.from_numpy(c), spec)
        serial.append(audio.numpy())
    streamer = PipelinedStreamer(ss, 1, torch.Generator().manual_seed(seed), depth=depth, device="cpu")
    piped = [a for a in (streamer.push(f0, c) for f0, c in zip(f0s, ctrls)) if a is not None]
    piped.extend(streamer.flush())
    return serial, piped


def test_pipelined_matches_serial(shipped):
    """PipelinedStreamer changes when buffers reach the host, never what
    they are: depth 4 over 10 buffers, bit-identical to the serial loop
    from the same seed (tests/test_streaming.py's case)."""
    _, model = shipped
    rng = np.random.default_rng(11)
    f0s = [np.full((1, 2), 110.0 + 5.0 * i, np.float32) for i in range(10)]
    ctrls = [rng.standard_normal((1, 2, 2)).astype(np.float32) for _ in range(10)]
    serial, piped = _serial_and_piped(model, 2, f0s, ctrls, seed=11, depth=4)
    assert len(piped) == len(serial) == 10
    for s, p in zip(serial, piped):
        np.testing.assert_array_equal(s, p)


def test_pipelined_priming_and_flush(shipped):
    """push returns None for exactly `depth` priming calls, then one buffer
    per push; flush drains the remaining `depth` (tests/test_streaming.py)."""
    _, model = shipped
    depth = 3
    streamer = PipelinedStreamer(StreamingSynth(model, 2), 2, depth=depth, device="cpu")
    f0 = np.full((2, 2), 110.0, np.float32)
    control = np.zeros((2, 2, 2), np.float32)
    outs = [streamer.push(f0, control) for _ in range(7)]
    assert all(o is None for o in outs[:depth])
    assert all(o is not None and o.shape == (2, 256) and o.dtype == np.float32 for o in outs[depth:])
    drained = list(streamer.flush())
    assert len(drained) == depth and len(streamer) == 0
    with pytest.raises(IndexError):
        streamer.pop()
    with pytest.raises(ValueError):
        PipelinedStreamer(StreamingSynth(model, 2), 1, depth=0, device="cpu")


def test_streaming_synth_checks_its_inputs(shipped):
    _, model = shipped
    ss = StreamingSynth(model, 2)
    state = ss.init_state(2, device="cpu")
    assert state.phase_offset.shape == (2, 101) and state.reverb_fdl.shape == (2, 125, 257)
    assert state.osc_phase.dtype == torch.float64 and state.reverb_fdl.dtype == torch.complex64
    assert torch.all(state.phase_offset >= -np.pi) and torch.all(state.phase_offset < np.pi)
    with pytest.raises(ValueError):
        ss.step(state, torch.zeros(2, 3), torch.zeros(2, 3, 2))
    with pytest.raises(ValueError):
        ss.init_state(2, phase_offset=torch.zeros(2, 100), device="cpu")
    with pytest.raises(ValueError):
        StreamingSynth(model, 0)
    # one seed, one stream; the injected offsets are carried as given
    again = ss.init_state(2, device="cpu")
    assert torch.equal(state.phase_offset, again.phase_offset)
    offset = torch.full((2, 101), 0.5)
    assert torch.equal(ss.init_state(2, phase_offset=offset, device="cpu").phase_offset, offset)
