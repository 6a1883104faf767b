#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printed as one JSON line; any failure raises, so the run
exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the nine kernel sources of ``kernels/csrc`` for
   sm_90a, the forward (``newt_fused_cr.cu``), the backward
   (``newt_fused_cr_bwd.cu``), the streaming forward
   (``newt_fused_stream.cu``), the audio-rate forward and backward
   (``newt_fused_fl.cu``, ``newt_fused_fl_bwd.cu``), the FastNEWT lookup
   (``fast_newt_lookup.cu``), the exciter-fused forward and backward
   (``newt_fused_x.cu``, ``newt_fused_x_bwd.cu``) and the roofline's chains
   (``roofline_chain.cu``, kernel 9), in parallel;
3. kernels: the forward kernel's wrapper on CUDA tensors against its plain
   PyTorch version on the same tensors (rtol=1e-4, atol=1e-5), and the
   kernel's FiLM interpolation bit for bit against ``linear_upsample``.
   The inputs are the ones the main path hands the kernel, caught with
   hooks in one forward of the served model per request set: the served
   batch (4 requests padded to 1024 frames), the single request and the
   timed batch of 8 (512 frames each); then two made-up shapes the TPU
   gate refused (odd Tc=37, hop=64) and one where a thread's group of 4
   samples straddles two clips (B=3, Tc=1, hop 3);
4. serve: ``Synthesizer.from_checkpoint(..., device="cuda")`` renders a
   batch of four requests (2, 4, 4 and 7 s) and one 4-s request; the
   outputs must be finite and not silent, and every render must have
   launched the kernel (NEWT raises on the card rather than run its
   plain chain). Then one request rendered on the card and on the CPU from
   the same injected phase offsets and noise must agree within 1e-3
   normalised RMS;
5. timing: CUDA-event medians of 20 runs after warm-up — the kernel and
   its plain version on the batch-8 inputs of phase 3, the model's
   forward and the whole render at batch 1 and 8 x 4 s;
5a. kernel_stream: the stream kernel against its plain version
   (rtol=1e-4, atol=1e-5) on the inputs ``StreamingSynth.step`` hands it
   at 1024-sample buffers (K=8), caught with hooks at batch 1 and 256,
   and on made-up K=1, K=3, hop 64, hop 5 (B*Ta = 15) and hop 33 (B=3,
   K=5); two calls bit-identical; its FiLM ramp bit for bit against
   ``segment_interp``; a K//2 + rest frame split bit-identical to one
   buffer;
5b. stream: ``PipelinedStreamer(device="cuda")`` at batch 1 and 256, depth
   4, over 64 buffers (4.1 s): finite, not silent, exactly one stream
   kernel launch per push and no launch of the offline kernels, and
   bit-identical to the serial loop of ``StreamingSynth.step``, whose
   steps run under ``torch.cuda.set_sync_debug_mode("error")`` (no hidden
   wait for the card); then 8 buffers on the card and on the CPU from the
   same injected phase offsets and noise within 1e-3 normalised RMS;
5c. timing_stream: CUDA-event medians of one step at batch 1 and 256, the
   host cadence of ``push`` (p50, p95, max) over 200 buffers at depth 4,
   the x real time of that window (all the audio pushed over the window's
   wall time, one clock read before the pushes and one after), and the
   stream kernel and its plain version at batch 256 with its bound;
6. kernel_bwd: the backward kernel against autograd through the plain
   version (rtol 1e-3, atol 1e-3 * max|plain| per output), on the inputs
   one ``Trainer`` step at batch 8 x 4 s hands it (exciter, control-rate
   film and the cotangent dy, caught with hooks), on the same inputs
   with a cotangent that reads only the first half-hop and the last hop
   (the clamps), and on four made-up shapes (odd Tc=37, hop 64, and hops
   33 and 300, whose last 32-sample lane-group is partial); two calls on
   the same inputs must give the same bits;
7. train_card_vs_cpu, train_fl_card_vs_cpu: one step's loss and gradients
   from the same weights, batch (1 x 2 s), phase offsets and noise, on the
   card (both cr kernels; then, with ``NEWT.fused = "full_lane"``, both
   audio-rate kernels and no other) and on the CPU (plain): loss within
   1e-4 relative, every parameter's gradient nonzero on the card and
   within 1e-3 normalised, or by the float64-witness rule;
8. train: ``Trainer(device="cuda").fit`` for 30 steps at batch 8 x 4 s
   from a seeded random init on a synthetic shard dataset written here
   (harmonic tones with their controls: 16 train, 4 val and 16 test clips,
   the test split drawn last, so a dataset written without it has the same
   train and val bytes, checked); finite losses, one launch of
   each kernel per step (and one forward launch per validation batch),
   moved parameters; then the checkpoint it
   wrote served by ``Synthesizer.from_checkpoint(device="cuda")``;
9. timing_train: CUDA-event medians of 20 after warm-up at batch 8 x 4 s:
   the whole training step, the backward kernel and its plain version on
   phase 6's inputs, and the peak device memory of a step;
10. kernel_fast_newt: the FastNEWT lookup kernel against its plain version
   (rtol 0, atol 1e-6, with the count of elements that are not bit-exact)
   on the (table, x) the FastNEWT path hands it, caught by a hook on the
   launch in a 4-s ``timbre_transfer`` and in a batch-8 x 4-s FastNEWT
   render, then on made-up x beyond both table edges, the exact grid
   points, S = 256, a row count that is not a multiple of a block's 16
   rows and a contiguous view at storage offset 1; each case reports the
   kernel's path, which must be vec4 but for the view (scalar);
11. timbre_transfer: the repo's 4-s 16-kHz wav and a 2-s 330-Hz tone
   written as a 44.1-kHz int16 stereo wav (so that the resampler and the
   downmix run), each through ``timbre_transfer`` with and without FastNEWT
   and through ``stream_timbre_transfer`` (1024-sample buffers, depth 4):
   finite, not silent, Tc * 128 samples; the tone (octave +1) peaks at a
   harmonic of 660 Hz; FastNEWT renders launch the lookup kernel and not
   ``film_shaper_fused_cr``, the others launch ``film_shaper_fused_cr``,
   and the stream only the stream kernel;
12. timbre_card_vs_cpu: features on the card against the CPU (loudness
   atol 1e-4, f0 rtol 1e-4 on the voiced frames), and a FastNEWT render
   of one set of controls on both from the same phase offsets and noise
   (1e-3 nRMS);
13. timing_timbre: medians of 20 after warm-up: resample, YIN and loudness
   on 4 s of 44.1-kHz audio (CUDA events), ``timbre_transfer``'s x real
   time with and without FastNEWT (and the host time of a whole call),
   the table's bake, the model's forward at batch 8 x 4 s with and
   without FastNEWT, and the lookup kernel and its plain version at
   batch 8 x 4 s with its bound;
14. train_cli: ``scripts/torch_train.py --gin-file gin/train/train_newt.gin
   -b "NEWT.fused = 'full_lane'"`` for 20 steps (validation every 10) on
   the tone dataset of phase 8, in this process: every step launches the
   audio-rate forward and backward once (and each validation batch the
   forward) and never the cr kernels; finite losses, ``metrics.csv`` with
   the JAX columns, ``last.ckpt``, ``best.ckpt`` and the two step saves; then the checkpoint
   served by ``Synthesizer`` with ``fused="full_lane"`` and ``"cr"`` (the
   two renders within 1e-5 nRMS);
15. kernel_fl: the audio-rate forward against its plain version (rtol
   1e-4, atol 1e-5) on the inputs the path hands it (caught by wrapping
   its launch): ``full_lane`` renders at batch 1 and 8 x 4 s, the CLI's
   first step, the ``"full_lane_cr"`` fallback at Ta=130, Tc=4; then
   made-up odd B*Ta and a ragged last block, each reporting whether it is
   bit-identical to the plain version; and kernel 1 on the batch-8 render's
   control-rate FiLM against it (rtol 1e-5, atol 2e-6, with its bit
   identity);
16. kernel_fl_bwd: the audio-rate backward against autograd through the
   plain version (rtol 1e-3, atol 1e-3 * max|plain|) on the CLI step's
   inputs and made-up shapes (odd B*Ta, a ragged last 32-sample chunk,
   fewer samples than one chunk, chunks across clip boundaries, the
   full_lane_cr fallback's 130 samples); two calls bit-identical;
17. timing_fl: medians of 20 after warm-up (CUDA events): both audio-rate
   kernels and their plain versions with bounds, and in turns (cr,
   full_lane, full_lane, cr) the training step, its peak memory and the
   batch-8 x 4-s forward;
18. serve_fused: ``Synthesizer.from_checkpoint(..., device="cuda")`` with
   ``NeuralWaveshaping.fuse_exciter`` (xcr) and then also ``fuse_out_mixer``
   (xfull) bound through gin renders phase 4's request sets: finite, not
   silent, one launch of its exciter-fused kernel per render and none of
   kernel 1; from injected offsets and noise the fused render against the
   unfused one on the card (rtol 1e-4, atol 1e-5) and against the CPU's plain
   versions (1e-3 nRMS); (B, H) offsets and H = 129 take the unfused path
   (kernel 1, counted);
19. kernel_xcr, kernel_xfull: the exciter-fused forwards against their plain
   versions (rtol 1e-4, atol 1e-5) on the inputs the renders hand them
   (caught by wrapping ``newt_fused._launch_forward_x``) at batch 8 and 1 x
   4 s, then made-up odd Tc = 37, hop 64, H = 2 and 128, f0 up to ~2 kHz, a
   ragged last pass and groups of 4 samples across clips (B=3, Tc=1, hop
   3); xfull plus the bias against xcr and NEWT's mixer; kernel_x_film_lerp:
   with gamma_out = 0 xcr's output is its FiLM's beta_out lerp, bit for bit
   ``linear_upsample`` on the CPU, on the renders' inputs and the straddling
   shape;
20. kernel_xcr_bwd, kernel_xfull_bwd: one ``Trainer`` step at batch 8 x 4 s
   with each field set (counted: its pair once, kernels 1-2 never), its
   backward inputs caught; the backwards against autograd through the plain
   versions (rtol 1e-3, atol 1e-3 * max|plain| per output: d_film, d_w, d_b,
   the planes, d_w_out) there and on made-up shapes (odd Tc, hops 64, 33 and
   300, H = 2 and 128), two calls bit-identical;
21. train_fused_card_vs_cpu: phase 7 with each field set: its pair once,
   kernels 1-2 never, loss within 1e-4 relative, the gradient rule;
22. train_cli_fused: ``scripts/torch_train.py`` with the recipe and both
   fields bound for 20 steps: xfull's pair only, counted; finite losses; the
   checkpoint serves;
23. timing_kernel_fused, timing_fused: the four kernels and their plain
   versions with bounds, and in turns (off, xcr, xfull, xfull, xcr, off) the
   batch-1 and batch-8 x 4-s forward, the training step and its peak memory;
24. kernel_bf16: mixed precision (``NeuralWaveshaping.compute_dtype =
   'bfloat16'`` bound through gin). Kernel 1's bf16 instances, (bf16 exciter,
   bf16 FiLM) and (bf16 exciter, float32 FiLM: ``NEWT.cr_film_f32``), against
   the plain version within one bf16 ulp (rtol 2^-7, atol 1e-5), on the
   inputs a bf16 ``Synthesizer``'s renders of phase 4's request sets and of
   the timed batch 8 hand them (caught by wrapping the launch) and on the
   odd_tc, hop_64 and straddle shapes; with gamma_out = 0 the output is
   ``linear_upsample`` of the widened FiLM rounded to bf16, bit for bit;
25. serve_bf16: the bf16 ``Synthesizer`` renders the batch and the single
   request (one launch of the (bf16, bf16) instance each, none of the
   float32 one), and with cr_film_f32 one request (the (bf16, f32)
   instance); finite, not silent; from the same offsets and noise the card
   within 1e-2 nRMS of the CPU and the bf16 render within 0.05 of the
   float32 one, in float32;
26. kernel_bwd_bf16: kernel 2's two bf16 instances against autograd through
   the plain version on the inputs one bf16 ``Trainer`` step with
   ``NEWT.fused = "full_lane_cr"`` hands them (without and with
   cr_film_f32) and at hop 33: d_exciter and d_film one bf16 ulp beyond the
   float32 bar (rtol 1e-3 + 2^-7, atol 1e-3 * max|plain|), d_planes at that
   bar; two calls bit-identical;
27. train_cli_bf16: ``scripts/torch_train.py --gin-file
   gin/train/train_newt_bf16.gin`` for 20 steps as written (the chain: no
   kernel launch), with ``-b "NEWT.fused = 'full_lane_cr'"`` (kernels 1 and
   2 in their (bf16, bf16) instances only, counted) and with ``-b
   "NEWT.cr_film_f32 = True"`` as well (the (bf16, f32) instances only);
   finite losses;
28. timing_kernel_bf16, timing_bf16_step: both kernels' bf16 instances beside
   their float32 instance on the same shapes, in turns, with plain versions
   and bounds (the bytes at the tensors' own sizes); the training step at
   batch 8 x 4 s in float32 (full_lane_cr), bf16 with the chain and bf16 with
   full_lane_cr, in turns (six medians of 20 each), with each arm's peak
   memory;
29. train_resume: the training runtime with the recipe's ``NEWT.fused =
   'full_lane_cr'`` at batch 8 x 4 s, validating and checkpointing every 5
   steps (keep 2): ``Trainer.fit`` to 20 steps twice, and to 10 and then, on
   a model of another seed, ``fit(restore=True)`` to 20. The restored state
   (parameters, Adam's moments and step, the learning rate, StepLR's state,
   the step) must be bit-equal to the one saved at step 10; the resumed
   run's losses bit-identical to the first twin's if the twins are, else
   within 2x the twins' largest relative difference plus 1e-6 (cuDNN's GRU
   backward and atomics-based ops need not repeat bit for bit); each run
   launches kernel 2 once a step and kernel 1 once a step and once a
   validation batch, and nothing else; checkpoint_write: what a
   validation's three checkpoint files cost;
30. train_cli_resume: ``scripts/torch_train.py`` with the recipe for 10
   steps in memory and with ``--no-load-data-to-memory``, three runs of each
   in turns, then the last lazy run ``--restore-checkpoint`` to 20: it
   resumes at step 10 and ends at 20, ``metrics.csv``'s steps do not
   repeat, ``best.ckpt``'s val_loss is the lowest logged; the 10 steps'
   seconds of each run of both loaders, and their medians (counted);
31. resynth_cli: ``scripts/torch_resynthesise_dataset.py`` on the test split
   (16 clips, two batches of its default 8) from that run's checkpoint
   directory (its best-on-val save), with kernel 1 and with
   ``--use-fast-newt`` (kernel 4, and not kernel 1): once with ``--device
   cpu``, then one untimed and five timed calls of each arm on the card, in
   turns; every card call gives the same distances, and the last is within
   1e-3 nRMS per clip of the CPU's; x real time per warm call (median, least
   and most), per batch (median), and the mean STFT distance;
32. preprocess_dataset: a wav corpus written here (four 16-s 16-kHz mono
   tones with a rest, a 12-s 44.1-kHz int16 stereo tone, 8 s of noise)
   through ``scripts/torch_create_dataset.py`` with the data gin file and
   ``--f0-extractor yin``, on the card and with ``--device cpu``: at least
   one 8-clip train batch and a val batch; the same shard files; audio atol
   1e-5, loudness atol 1e-4, voiced f0 rtol 1e-4 and confidence atol 1e-4,
   MFCC atol 1e-2 dB, the means within 1e-3 of a std and the stds rtol 1e-3
   (``PRE_BARS``); the card builds twice (the first is timed cold), and the
   count of files the two builds wrote differently is reported;
33. preprocess_pyin: ``extract_f0_with_pyin`` on 4 s on the card against the
   CPU: the decoded bins the same on >= 99 % of frames, f0 rtol 1e-4 and
   periodicity atol 1e-4 where they are;
34. preprocess_crepe: random full-capacity CREPE weights in torchcrepe's
   layout, saved as a .pth and bound as ``--crepe-weights`` binds them:
   ``extract_f0_with_crepe`` on 1 s on the card against the CPU (bins as
   phase 33, periodicity atol 1e-3), then the CLI on the card with CREPE
   (every segment kept): finite shards;
35. train_from_created: ``scripts/torch_train.py`` with the recipe, 5 steps
   at batch 8 on the card from phase 32's card tree: finite losses, kernels
   1 and 2 counted;
36. timing_preprocess: per extractor (YIN, pYIN, CREPE full) the seconds per
   second of audio on the card at 4 and 60 s (medians of 5 after a warm-up),
   the Viterbi decode's seconds and share, the CNN alone and its TFLOP/s,
   the decode's device launches on 4 s (profiler), and the whole
   ``create_dataset``'s seconds per second of audio on the card and the CPU;
37. serve_bf16_fl: a bf16 ``Synthesizer`` renders the batch and the single
   request with ``NEWT.fused = "full_lane"``: one launch of kernel 5's bf16
   instance a render and nothing else (counted); finite, not silent; from the
   same offsets and noise the card within 2e-3 nRMS of the CPU (its plain
   version) and the bf16 render within 0.05 of the float32 one, at least 1e-3
   from it;
38. train_cli_bf16_fl: ``scripts/torch_train.py --gin-file
   gin/train/train_newt_bf16.gin -b "NEWT.fused = 'full_lane'"`` for 20 steps
   with validation: kernels 5 and 6's bf16 instances only, counted; finite
   losses; full_lane_cr_fallback_bf16: one step of a bf16 NEWT with
   ``"full_lane_cr"`` at Ta=130, Tc=4 (the fallback): one launch of each bf16
   instance and nothing else, finite gradients;
39. kernel_fl_bf16, kernel_fl_bwd_bf16: both bf16 instances against their
   plain versions on the inputs phases 37-38 handed them (caught by wrapping
   the launches: renders at batch 1 and 8 x 4 s, the CLI's first step, the
   fallback) and made-up odd B*Ta, a ragged last chunk, fewer samples than a
   chunk and chunks across clips: the output within one bf16 ulp (rtol 2^-7,
   atol 1e-5), d_exciter and d_film one ulp beyond the float32 gradient bar,
   d_planes at it, two backward calls bit-identical;
40. timing_kernel_fl_bf16, timing_bf16_fl_step: both bf16 instances beside
   the float32 instance on the same shapes, in turns, with plain versions and
   bounds (the bytes at the tensors' own sizes); the training step at batch 8
   x 4 s at ``full_lane`` in float32 and in bf16, in turns (three medians of
   20 each), with each arm's peak memory;
41. serve_bf16_fused: a bf16 ``Synthesizer`` with ``fuse_exciter`` (xcr) and
   with ``fuse_out_mixer`` (xfull) renders 4-s requests at batch 8 and 1 (one
   launch of kernel 7's (bf16 mixer, bf16 FiLM) instance a render and nothing
   else, counted) and, with ``NEWT.cr_film_f32``, one request (its (bf16,
   f32 FiLM) instance); finite, not silent; from the same offsets and noise
   the card within 2e-3 nRMS of the CPU (the plain versions) and 1e-3 to 0.05
   from the float32 fused render;
42. train_cli_bf16_fused: ``scripts/torch_train.py --gin-file
   gin/train/train_newt_bf16.gin -b "NEWT.fused = 'full_lane_cr'" -b
   "NeuralWaveshaping.fuse_exciter = True"`` for 20 steps with validation:
   kernels 7 and 8's xcr (bf16, bf16) instances only, counted; finite losses;
   train_step_bf16_fused: one bf16 ``Trainer`` step at batch 8 x 4 s per
   field and FiLM dtype, each launching its instance pair once;
43. timbre_bf16_fast_newt: a bf16 ``timbre_transfer`` with FastNEWT of the
   repo's 4-s wav and a batch-8 x 4-s FastNEWT render (one launch of kernel
   4's bf16-x instance each, nothing else); a FastNEWT render of the wav's
   controls on the card within 2e-3 nRMS of the CPU's and 1e-3 to 0.05 from
   the float32 one;
44. kernel_x_bf16, kernel_x_bwd_bf16, kernel_fast_newt_bf16: each bf16
   instance against its plain version on the inputs phases 41-43 handed it
   (caught by wrapping the launches) and on made-up shapes (odd Tc, hop 64,
   H = 2 and 128, a ragged last pass, groups across clips; hops 33 and 300;
   the lookup beyond both table edges, S = 256, ragged rows, views at a bf16
   offset of 1 (scalar path) and 4 (vec4)): the output within one bf16 ulp,
   the gradients one ulp beyond the float32 bar (d_planes at it), two
   backward calls bit-identical, the lookup bit for bit;
45. timing_kernel_x_bf16, timing_kernel_fast_newt_bf16: kernels 7 and 8's
   bf16 instances beside their float32 instance on the same shapes, in turns,
   with plain versions and bounds (the bytes at the tensors' own sizes); the
   lookup's bf16-x instance beside its float32 one;
46. timing_bf16_fused: the forward and the training step at batch 8 x 4 s
   with xcr and xfull, in float32 and bf16, in turns, with each arm's peak
   memory;
47-50. the multi-GPU phases (``parallel_phases``: data-parallel training on
   gloo ranks sharing the card and under torchrun, the time-sharded render);
51-56. the measurement CLIs (``measure_cli_phases``), each ``main(argv)`` run
   in this process with every launch counter zeroed just before and read
   just after: the kernel it times must have launched, no other kernel and
   no plain version (``plain_calls``); each prints its figures on a line:
   51. cli_time_forward_pass: ``scripts/torch_time_forward_pass.py`` at batch
   1 and 8 x 4 s, with kernel 1 and with ``--use-fast-newt`` (kernel 4);
   52. cli_time_buffer_sizes: ``--streaming`` at 1024 and 4096 samples (kernel
   3: serial latency, queued-loop step, the profiler's busy time, cadence at
   depth 4); 53. cli_serving_capacity: 1, 64 and 256 streams of 1024 samples,
   float32 and ``--fetch-int16`` (kernel 3); 54. cli_time_train_step: the
   recipe at 8 x 500 frames (kernels 1 and 2); 55. cli_profile_train_step
   (2 x 100 frames: kernels 1, 2, 5 and 6 through the probes' ``NEWT.fused``
   spellings) and cli_profile_streaming_step (16 streams: kernel 3); 56.
   train_cli_host_profile: ``scripts/torch_train.py`` for 10 steps under
   ``NWS_TPU_HOST_PROFILE`` (kernels 1 and 2; the host profile's stages and
   each validation's printed);
57. kernel_chain: kernel 9's four instances (fma, fma ilp4, sin, sin ilp4)
   against their plain versions (rtol 1e-4, atol 1e-5) at the roofline CLI's
   8,388,608 elements in (n/128, 128) and, for fma, (n/64, 64), on an x0
   drawn apart from x, with the plain chain of K - 1 steps required to fail
   the same bars; two calls bit-identical; timing_kernel_chain: each
   instance on the CLI's inputs (a queued loop by difference, as the
   roofline CLI times it) and its plain version (CUDA-event median) with
   its bound;
58. train_trajectory: 60 float32 steps of ``train_step`` at ``"full_lane_cr"``
   over ``utils/trajectory.py``'s recipe (the port's seeded init, 2 tones of
   16 frames, the numpy draws) from each of the four inits of the fixture's
   float32 family: kernels 1 and 2 once a step and nothing else; against
   JAX's float64 curve in ``tests/data/jax_loss_trajectory.json``, the
   seeded init's step-1 loss within 1e-4, and JAX's three-tier gate with
   each bar raised to JAX's own spread (the fixture's twelve curves): tiers
   1 and 2 on the seeded init's curve, tier 2 on all four, tier 3 on the
   median of the four plateau gaps;
59-61. the queue-1 CLIs through ``run_cli``: cli_roofline,
   ``scripts/torch_roofline_shaper.py`` at its defaults (kernel 9's four
   instances and kernels 5-6 must launch; its plain rows run the plain
   chains on purpose); cli_bench_data_path, ``torch_bench_data_path.py``
   on the tone dataset for 40 steps an arm (kernels 1-2); cli_profile_loss,
   ``torch_profile_loss.py`` at its defaults (no kernel; the float32 value
   within 1e-5 of its float64 oracle);
62. notebook: every code cell of ``colab/NEWT_Timbre_Transfer_torch.ipynb``
   on the card on a 4-s tone: kernel 1 and the FastNEWT lookup launch, no
   plain version runs, the outputs as ``tests/test_torch_notebook.py`` checks;
63. train_chunked: the chunked ``Trainer.fit`` (the train split on the card,
   chunks of 10 steps, the step one CUDA graph replayed after a warm-up) at
   the recipe, 8 x 4 s at ``"full_lane_cr"``, 40 steps with log 10 and
   validation 20: (a) its per-step losses and grad norms against an eager
   loop of ``Trainer.train_step`` over the same batches and draws from the
   same init, bit-identical where two eager twins are, else within twice
   their difference + 1e-6 (the resume rule); (b) the lazy fit against the
   in-memory one, the same rule; (c) kernels 1 and 2's counters over one
   more chunk against the kernels of that chunk in a ``torch.profiler``
   trace; (d) ``fit(restore=True)`` on the same Trainer recaptures once and
   equals a fresh Trainer's resumed run; (e) steps/s of the graphed chunk
   and of the eager steps in turns, each form's device busy time and idle
   share, the fits' host ms a step by stage, the capture's seconds and its
   pool's bytes. Since this phase the earlier fits and CLI runs go through
   the chunked fit too.

Then the kernels line (the numbers of phases 3-63 per kernel, with its
least possible time on an H100 from its bytes and operations; kernels 1, 2,
4, 5, 6, 7 and 8's bf16 instances and kernel 9's four instances as entries
of their own) and, last,
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
cuDNN (the GRU), so the card computes in float32 like the CPU reference.
"""
import contextlib
import copy
import csv
import dataclasses
import gc
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from scipy.io import wavfile

from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import (
    extract_f0_with_crepe,
    extract_f0_with_pyin,
    extract_f0_with_yin,
    extract_perceptual_loudness,
    resample_audio,
)
from neural_waveshaping_synthesis_tpu_torch.inference import (
    ControlAdjustments,
    Synthesizer,
    adjust_controls,
    extract_features,
    stream_timbre_transfer,
    timbre_transfer,
)
from neural_waveshaping_synthesis_tpu_torch.kernels import _build, fast_newt, roofline
from neural_waveshaping_synthesis_tpu_torch.kernels.roofline import (
    CR_BWD_FLOP_PER_ELEMENT,
    CR_FLOP_PER_ELEMENT,
    FL_BWD_FLOP_PER_ELEMENT,
    FL_FLOP_PER_ELEMENT,
    bound,
)
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.models import crepe
from neural_waveshaping_synthesis_tpu_torch.ops import linear_upsample, segment_interp
from neural_waveshaping_synthesis_tpu_torch.streaming import PipelinedStreamer, StreamingSynth
from neural_waveshaping_synthesis_tpu_torch.convert import load_lightning_checkpoint
from neural_waveshaping_synthesis_tpu_torch.parallel import (
    all_reduce_sum_,
    create_mesh,
    make_time_sharded_renderer,
)
from neural_waveshaping_synthesis_tpu_torch.utils import trajectory
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import device_busy, differential_loop_ms
from neural_waveshaping_synthesis_tpu_torch.training import (
    Optimizer,
    TrainConfig,
    Trainer,
    compute_loss,
    step_generator,
    train_step,
)

REPO = Path(__file__).resolve().parent
CKPT = str(REPO / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt")
WAV = str(REPO / "logs" / "audio" / "val_original_step20.wav")  # 4 s, 16 kHz int16
HOP, SR = 128, 16000
RTOL, ATOL = 1e-4, 1e-5
N_TIMED = 20
# the H100's data-sheet peaks, bound(), and kernels 1, 2, 5 and 6's
# operations per (sample, channel) come from kernels/roofline.py; the
# stream kernel's: newt_fused_stream.cu is the cr count with the stream ramp,
# 4 * (sub, mul, add) + one division = 13, in place of the lerp's 14.
STREAM_FLOP_PER_ELEMENT = 13 + 3 + 288 + 450 + 2
BWD_RTOL = 1e-3  # the JAX suite's gradient bar; atol = BWD_RTOL * max|plain| per output
TRAIN_STEPS = 30
CLI_STEPS = 20
CLI_VAL_EVERY = 10
# the JAX CSVLogger's columns (training/logging.py of the JAX package)
JAX_CSV_COLUMNS = ["step", "time", "train/loss", "train/lr", "train/steps_per_sec",
                   "val/loss", "test/loss", "grad_norm"]
STREAM_K = 8  # control frames per streaming buffer: 1024 samples
STREAM_BUFFERS = 64  # 4.1 s of controls per stream
STREAM_BATCHES = (1, 256)  # one live stream; the concurrent streams of the JAX serving claim
CADENCE_PUSHES = 200
# ... and in fast_newt_lookup.cu: sub, mul, div, floor, max, min, sub (the
# fraction), and the lerp's sub, mul, add = 10; bytes: x in, out, the table once
LOOKUP_FLOP_PER_ELEMENT = 10
# ... and in newt_fused_x.cu / newt_fused_x_bwd.cu (the exciter-fused
# kernels). Per element: the forward is kernel 1's count plus the mixer's
# bias; the backward is kernel 2's without its d_exciter multiply, plus the
# mixer bias and db's add; xfull adds the output mix's multiply and add
# (forward) and the cotangent's multiply and dw_out's four (backward). On
# top, per element, the mix's H multiply-adds (2H; the backward 4H with the
# mixer gradient's), and per sample the bank: the mask's multiply and compare
# for each of the H harmonics, and each unmasked harmonic's sine (argument 2,
# reduction 4, square 1, Horner 12, r*p 1 = 20): data-dependent, so counted
# from the run's f0 (x_flop).
XCR_FLOP_PER_ELEMENT = CR_FLOP_PER_ELEMENT + 1
XCR_BWD_FLOP_PER_ELEMENT = CR_BWD_FLOP_PER_ELEMENT - 1 + 2
XFULL_FLOP_PER_ELEMENT = XCR_FLOP_PER_ELEMENT + 2
XFULL_BWD_FLOP_PER_ELEMENT = XCR_BWD_FLOP_PER_ELEMENT + 5
X_MIX_FLOP_PER_HARMONIC = 2  # per element; twice that in the backward
X_MASK_FLOP_PER_HARMONIC = 2  # per sample
X_SINE_FLOP = 20  # per sample and unmasked harmonic
KERNELS = list(_build.KERNELS)
BF16 = torch.bfloat16
BF16_RTOL = 2.0**-7  # one bf16 ulp, relative: 8 significant bits
# nRMS, a bf16 render on the card vs the CPU: 1.07e-3 measured on the H100,
# where the float32 render reads 3.5e-3 from the card's bf16 one, so a card
# path that computed in float32 fails it
BF16_CARD_VS_CPU = 2e-3
# nRMS, a bf16 FastNEWT render on the card vs the CPU: the bf16 lookup index
# moves in steps of up to 16 bins of 4096, so the bf16 FiLM MLP's roundings
# (placed apart by cuBLAS and the CPU) reach the output as whole bins: 1.89e-3
# measured on the H100, where the float32 render reads 2.3e-2 from the card's
# bf16 one
BF16_FAST_NEWT_CARD_VS_CPU = 5e-3
BF16_VS_F32 = 0.05  # nRMS, a bf16 render vs the float32 one (JAX tests/test_model_golden.py)
BF16_FLOOR = 1e-3  # nRMS, and at least this far from it: the render computed in bf16
# kernels 1, 2, 7 and 8's bf16 instances: the counters' suffix -> the name's
# suffix in the kernels line ((bf16 I/O, bf16 FiLM) and (bf16 I/O, f32 FiLM);
# the I/O is kernels 1-2's exciter, kernels 7-8's mixer and output)
BF16_INSTANCES = {"bf16": "[bf16]", "bf16_f32": "[bf16, f32 film]"}
# the tone dataset's splits; the test split is drawn after train and val, so
# their bytes are those of a dataset written without it
TONE_SPLITS = (("train", 16), ("val", 4), ("test", 16))
# the resume phases: uninterrupted to RESUME_STEPS, or to RESUME_AT and
# restored, validating (and checkpointing) every RESUME_VAL_EVERY steps
RESUME_STEPS, RESUME_AT, RESUME_VAL_EVERY = 20, 10, 5
# train_cli_resume times the eager and the lazy loader over this many
# 10-step CLI runs each, in turns; resynth_cli times this many warm calls of
# each arm, in turns, after one untimed call each
CLI_TURNS, RESYNTH_CALLS = 3, 5
# the preprocessing phases: the data gin file, the card-vs-CPU bars of the
# features (loudness and voiced f0 as timbre_card_vs_cpu's; audio as the
# resampler's CPU bar; MFCC in dB and the statistics, stated here: a
# channel's mean within stats_rtol of its std, its std rtol stats_rtol), the
# share of frames whose decoded bin may differ, the timed clips' seconds
DATA_GIN = "gin/data/urmp_4second_crepe.gin"
PRE_BARS = {"audio_atol": 1e-5, "loudness_atol": 1e-4, "f0_rtol": 1e-4, "confidence_atol": 1e-4,
            "mfcc_atol": 1e-2, "stats_rtol": 1e-3, "bins_differ_max": 0.01,
            "periodicity_atol": 1e-4, "crepe_periodicity_atol": 1e-3}
PRE_TIMED_S = (4, 60)
PRE_TIMED_RUNS = 5
DDP_WORLD, DDP_STEPS, DDP_TIMED = 2, 5, 10
CHILD_TIMEOUT_S = 400
TIME_SHARD_S, TIME_SHARD_CHUNKS, TIME_SHARD_TIMED = 60, (1, 2, 8), 3
CREPE_FULL_FLOP_PER_FRAME = 2 * sum(  # multiply-adds of the six convolutions and the classifier
    out_len * c_out * c_in * w for out_len, c_in, c_out, w in (
        (256, 1, 1024, 512), (128, 1024, 128, 64), (64, 128, 128, 64), (32, 128, 128, 64),
        (16, 128, 256, 64), (8, 256, 512, 64))) + 2 * 2048 * 360


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_median_ms(fn, n=N_TIMED, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_median_ms(fn, n=N_TIMED, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()  # ends in a device-to-host copy, which waits for the card
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_ranks(fn, world_size, args=(), timeout=300.0):
    """fn(rank, world_size, *args) in ``world_size`` spawned processes. A
    rank that raises fails the call with its traceback (the others are
    killed); ranks still running after ``timeout`` seconds (a rank blocked
    in a collective its peer never joined) are killed and the call fails.
    No process outlives the call."""
    ctx = torch.multiprocessing.spawn(fn, args=(world_size, *args), nprocs=world_size,
                                      join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def nrms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def make_requests(seconds, seed):
    """f0 glides within 110-880 Hz and loudness contours at 125 Hz."""
    rng = np.random.default_rng(seed)
    out = []
    for s in seconds:
        n = int(s * SR / HOP)
        lo, hi = np.sort(rng.uniform(110.0, 880.0, 2))
        f0 = np.geomspace(lo, hi, n) * (1 + 0.01 * np.sin(np.linspace(0, 40 * s, n)))
        loud = 0.2 + 0.08 * np.sin(np.linspace(0, rng.uniform(2, 8) * s, n)) + 0.01 * rng.standard_normal(n)
        out.append((f0.astype(np.float32), loud.astype(np.float32)))
    return out


def main_path_kernel_inputs(synth, requests):
    """The (exciter, control-rate film) that the main path hands the
    kernel for these requests: one forward of the served model, with
    hooks on NEWT (its exciter) and on NEWT's FiLM MLP (its output)."""
    f0_b, ctrl_b, _ = synth.prepare(requests)
    got = {}
    hooks = [
        synth.model.newt.register_forward_pre_hook(
            lambda m, args: got.__setitem__("exciter", args[0].clone())),
        synth.model.newt.mlp.register_forward_hook(
            lambda m, args, out: got.__setitem__("film_c", out.clone())),
    ]
    try:
        with torch.inference_mode():
            synth.model(torch.from_numpy(f0_b).to(synth.device),
                        torch.from_numpy(ctrl_b).to(synth.device),
                        generator=torch.Generator().manual_seed(0))
    finally:
        for h in hooks:
            h.remove()
    return got["exciter"], got["film_c"]


def made_up_kernel_inputs(b, tc, hop, seed, device):
    rng = np.random.default_rng(seed)
    exc = (rng.standard_normal((b, tc * hop, 64)) * 0.5).astype(np.float32)
    film_c = rng.standard_normal((b, tc, 256)).astype(np.float32)
    return torch.from_numpy(exc).to(device), torch.from_numpy(film_c).to(device)


def write_tone_dataset(root: Path, splits=(("train", 16), ("val", 4)), seconds=4, seed=0) -> str:
    """A synthetic dataset in the reference shard layout, made here with
    numpy: harmonic tones (f0 gliding within 110-880 Hz, amplitude
    contours) with their controls (f0 in Hz, loudness in dB, confidence 1,
    16 MFCC channels of 0), z-scored with the train split's statistics."""
    rng = np.random.default_rng(seed)
    tc = int(seconds * SR) // HOP
    clips = {}
    for split, n in splits:
        for i in range(n):
            lo, hi = np.sort(rng.uniform(110.0, 880.0, 2))
            f0 = np.geomspace(lo, hi, tc) * (1 + 0.01 * np.sin(np.linspace(0, 30, tc)))
            amp = 0.05 + 0.25 * rng.uniform() * (1 + np.sin(np.linspace(0, rng.uniform(2, 9), tc))) / 2
            f0_a, amp_a = (np.interp(np.arange(tc * HOP) / HOP, np.arange(tc), v) for v in (f0, amp))
            phase = 2 * np.pi * np.cumsum(f0_a) / SR
            n_h = int(min(20, (SR / 2) // hi))
            audio = amp_a * sum(np.sin(k * phase) / k for k in range(1, n_h + 1))
            control = np.zeros((19, tc))
            control[0], control[1], control[2] = f0, 20 * np.log10(amp), 1.0
            clips[(split, i)] = (audio.astype(np.float32), control)
    train = np.concatenate([c for (sp, _), (_, c) in clips.items() if sp == "train"], axis=1)
    mean = train.mean(axis=1, keepdims=True)
    std = np.maximum(train.std(axis=1, keepdims=True), 1.0)
    for (split, i), (audio, control) in clips.items():
        for kind in ("audio", "control"):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
        np.save(root / split / "audio" / f"audio_tone{i}.npy", audio)
        np.save(root / split / "control" / f"control_tone{i}.npy",
                ((control - mean) / std).astype(np.float32))
    np.save(root / "data_mean.npy", mean.astype(np.float32))
    np.save(root / "data_std.npy", std.astype(np.float32))
    return str(root)


def check_tone_splits(root: Path, other: Path) -> None:
    """The tone dataset's train and val files and statistics are those of
    one written without the test split, byte for byte."""
    write_tone_dataset(other, splits=TONE_SPLITS[:2])
    files = sorted(p.relative_to(other) for p in other.rglob("*.npy"))
    differ = [str(f) for f in files if (root / f).read_bytes() != (other / f).read_bytes()]
    n_test = len(list((root / "test" / "audio").iterdir()))
    emit({"phase": "tone_dataset", "splits": dict(TONE_SPLITS), "files_compared": len(files),
          "files_differ": differ, "test_clips": n_test})
    if differ or n_test != dict(TONE_SPLITS)["test"]:
        raise RuntimeError(f"the test split changed the train/val files {differ}")


def train_step_kernel_inputs(trainer, batch):
    """The (exciter, control-rate film, cotangent dy) that one training
    step hands the backward kernel: hooks on NEWT (its exciter), its FiLM
    MLP (its output) and its output mixer (the kernel's output, whose
    gradient is dy)."""
    got = {}
    newt = trainer.model.newt

    def keep(name, t):
        got[name] = t.detach().clone(memory_format=torch.contiguous_format)

    def catch_dy(module, args):  # a pre-hook's return value would replace args
        args[0].register_hook(lambda g: keep("dy", g))

    hooks = [
        newt.register_forward_pre_hook(lambda m, args: keep("exciter", args[0])),
        newt.mlp.register_forward_hook(lambda m, args, out: keep("film_c", out)),
        newt.mixer.register_forward_pre_hook(catch_dy),
    ]
    try:
        trainer.train_step(batch)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return got["exciter"], got["film_c"], got["dy"]


def check_backward(label, exc, film_c, dy, weights, packed, hop):
    """Backward kernel vs autograd through the plain version; -> max abs error."""
    out = nf._launch_backward(exc, film_c, packed, dy, hop)
    ref = nf.film_shaper_cr_grad_plain(exc, film_c, weights, hop, dy)
    again = nf._launch_backward(exc, film_c, packed, dy, hop)
    torch.cuda.synchronize()
    bit_identical = all(torch.equal(a, b) for a, b in zip(out, again))
    errs = {}
    for name, o, r in zip(("d_exciter", "d_film_c", "d_planes"), out, ref):
        o, r = o.cpu().numpy(), r.cpu().numpy()
        errs[name] = (float(np.max(np.abs(o - r))), float(np.max(np.abs(r))))
        np.testing.assert_allclose(o, r, rtol=BWD_RTOL, atol=BWD_RTOL * errs[name][1],
                                   err_msg=f"{label} {name}")
    b, ta, _ = exc.shape
    emit({"phase": "kernel_bwd", "name": "_fused_bwd_cr", "case": label, "B": b,
          "Tc": film_c.shape[1], "hop": hop, "max_abs_err": {k: v[0] for k, v in errs.items()},
          "max_abs_plain": {k: v[1] for k, v in errs.items()}, "rtol": BWD_RTOL,
          "bit_identical_repeat": bit_identical})
    if not bit_identical:
        raise RuntimeError(f"{label}: two backward calls gave different bits")
    return max(v[0] for v in errs.values())


def stream_controls(synth, batch, seed):
    """STREAM_BUFFERS buffers of controls for `batch` streams, normalised as
    a render's: f0 (B, Tc) Hz and control (B, Tc, 2), Tc = buffers * K."""
    tc = STREAM_BUFFERS * STREAM_K
    f0_b, ctrl_b, _ = synth.prepare(make_requests([tc * HOP / SR] * batch, seed))
    return np.ascontiguousarray(f0_b[:, :tc]), np.ascontiguousarray(ctrl_b[:, :tc])


def buffer_of(x, i):
    return x[:, i * STREAM_K : (i + 1) * STREAM_K]


def stream_kernel_inputs(ss, f0_d, ctrl_d, spec, batch):
    """The (exciter, prev_film, film_c) that ``StreamingSynth.step`` hands
    the stream kernel on the second buffer of `batch` streams (the first
    gives prev_film a value): hooks on the harmonic mixer (its output is
    the exciter) and on NEWT's FiLM MLP (its output)."""
    state = ss.init_state(batch, torch.Generator(device="cuda").manual_seed(batch))
    _, state = ss.step(state, buffer_of(f0_d, 0), buffer_of(ctrl_d, 0), spec)
    got = {}
    hooks = [ss.model.harmonic_mixer.register_forward_hook(
                 lambda m, args, out: got.__setitem__("exciter", out.clone())),
             ss.model.newt.mlp.register_forward_hook(
                 lambda m, args, out: got.__setitem__("film_c", out.clone()))]
    try:
        ss.step(state, buffer_of(f0_d, 1), buffer_of(ctrl_d, 1), spec)
    finally:
        for h in hooks:
            h.remove()
    return got["exciter"], state.prev_film, got["film_c"]


def stream_phases(dev, synth, cpu_synth):
    """Phases 5a-5c (streaming) -> the stream kernel's numbers."""
    ss = StreamingSynth(synth.model, STREAM_K)
    spec = ss.ir_partition_spectra()
    weights, packed = synth.model.newt.shaping_fn.params(), synth.model.newt._packed_shaper()
    controls = {b: stream_controls(synth, b, seed=30 + b) for b in STREAM_BATCHES}
    on_card = {b: tuple(torch.from_numpy(a).to(dev) for a in controls[b]) for b in STREAM_BATCHES}

    # 5a. the stream kernel on the inputs the step hands it, and made-up shapes
    cases = [(f"step_b{b}", *stream_kernel_inputs(ss, *on_card[b], spec, b)) for b in STREAM_BATCHES]
    # hop 5 (B*Ta = 15) and hop 33 (B = 3, K = 5): groups of samples that
    # straddle segments and buffers, and a ragged last group
    for label, b, k, hop in (("k1", 2, 1, HOP), ("k3", 2, 3, HOP), ("hop_64", 2, STREAM_K, 64),
                             ("hop_5", 1, 3, 5), ("hop_33", 3, 5, 33)):
        exc, film_c = made_up_kernel_inputs(b, k, hop, 40 + k, dev)
        prev = torch.randn((b, 256), generator=torch.Generator().manual_seed(k)).to(dev)
        cases.append((label, exc, prev, film_c))
    max_err = 0.0
    for label, exc, prev, film_c in cases:
        b, ta, _ = exc.shape
        k = film_c.shape[1]
        hop = ta // k
        with torch.inference_mode():
            out = nf.film_shaper_stream(exc, prev, film_c, weights, hop, packed=packed)
            ref = nf.film_shaper_stream_plain(exc, prev, film_c, weights, hop)
            repeat = torch.equal(out, nf.film_shaper_stream(exc, prev, film_c, weights, hop, packed=packed))
            film_z, prev_z = film_c.clone(), prev.clone()
            film_z[..., 128:192] = 0.0
            prev_z[..., 128:192] = 0.0
            ramp = nf.film_shaper_stream(exc, prev_z, film_z, weights, hop, packed=packed).cpu()
            cut = k // 2
            split = cut > 0 and torch.equal(out, torch.cat([
                nf.film_shaper_stream(exc[:, : cut * hop].contiguous(), prev,
                                      film_c[:, :cut].contiguous(), weights, hop, packed=packed),
                nf.film_shaper_stream(exc[:, cut * hop :].contiguous(), film_c[:, cut - 1].contiguous(),
                                      film_c[:, cut:].contiguous(), weights, hop, packed=packed)], dim=1))
        torch.cuda.synchronize()
        out, ref = out.cpu().numpy(), ref.cpu().numpy()
        err = float(np.max(np.abs(out - ref)))
        n_diff = int((ramp != segment_interp(prev_z.cpu(), film_z.cpu(), hop)[..., 192:]).sum())
        emit({"phase": "kernel_stream", "name": "film_shaper_fused_stream", "case": label, "B": b,
              "K": k, "hop": hop, "max_abs_err": err, "rtol": RTOL, "atol": ATOL,
              "ramp_elements_not_bit_exact": n_diff,
              "split_bit_identical": split if cut > 0 else None, "bit_identical_repeat": repeat})
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL, err_msg=label)
        if not repeat:
            raise RuntimeError(f"{label}: two stream kernel calls gave different bits")
        if n_diff:
            raise RuntimeError(f"{label}: the in-kernel FiLM ramp is not bit-exact")
        if cut > 0 and not split:
            raise RuntimeError(f"{label}: two buffers differ from one")
        max_err = max(max_err, err)
    timed_exc, timed_prev, timed_film = cases[1][1:]
    del cases, out, ref, ramp

    # 5b. the entry points a user calls: PipelinedStreamer, then the serial loop
    launches = 0
    for b in STREAM_BATCHES:
        f0_np, ctrl_np = controls[b]
        nf.film_shaper_stream.launches = nf.film_shaper_cr.launches = nf.film_shaper_cr.bwd_launches = 0
        streamer = PipelinedStreamer(ss, batch=b, generator=torch.Generator(device="cuda").manual_seed(b),
                                     depth=4)
        piped = [a for a in (streamer.push(buffer_of(f0_np, i), buffer_of(ctrl_np, i))
                             for i in range(STREAM_BUFFERS)) if a is not None]
        piped.extend(streamer.flush())
        counts = (nf.film_shaper_stream.launches, nf.film_shaper_cr.launches,
                  nf.film_shaper_cr.bwd_launches)
        launches += counts[0]
        state = ss.init_state(b, torch.Generator(device="cuda").manual_seed(b))
        serial = []
        f0_d, ctrl_d = on_card[b]
        torch.cuda.synchronize()
        for i in range(STREAM_BUFFERS):
            torch.cuda.set_sync_debug_mode("error")  # a hidden wait for the card raises
            try:
                audio, state = ss.step(state, buffer_of(f0_d, i), buffer_of(ctrl_d, i), spec)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            serial.append(audio.cpu().numpy())
        audio = np.concatenate(piped, axis=-1)
        identical = len(piped) == len(serial) and all(np.array_equal(p, q) for p, q in zip(piped, serial))
        rms = [float(np.sqrt(np.mean(a**2))) for a in audio]
        emit({"phase": "stream", "B": b, "K": STREAM_K, "depth": 4, "buffers": len(piped),
              "seconds": STREAM_BUFFERS * STREAM_K * HOP / SR, "stream_launches": counts[0],
              "cr_launches": counts[1], "bwd_launches": counts[2],
              "pipelined_bit_identical_to_serial": identical, "sync_debug_mode": "error",
              "rms_min": min(rms), "rms_max": max(rms)})
        if len(piped) != STREAM_BUFFERS or any(p.shape != (b, STREAM_K * HOP) for p in piped):
            raise RuntimeError("the streamer returned the wrong buffers")
        if not np.all(np.isfinite(audio)) or min(rms) < 1e-4:
            raise RuntimeError("streamed audio is not finite or silent")
        if counts != (STREAM_BUFFERS, 0, 0):
            raise RuntimeError(f"launches (stream, cr, bwd) = {counts} for {STREAM_BUFFERS} pushes")
        if not identical:
            raise RuntimeError("pipelined output differs from the serial loop")

    # card vs CPU: 8 buffers, same injected phase offsets and noise
    f0_np, ctrl_np = controls[1]
    rng = np.random.default_rng(5)
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, (1, 101)).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, (8, 1, STREAM_K * HOP)).astype(np.float32))
    outs = []
    for s, d in ((ss, dev), (StreamingSynth(cpu_synth.model, STREAM_K), torch.device("cpu"))):
        state = s.init_state(1, phase_offset=offset, device=d)
        d_spec = s.ir_partition_spectra()
        bufs = []
        for i in range(8):
            y, state = s.step(state, torch.from_numpy(buffer_of(f0_np, i)).to(d),
                              torch.from_numpy(buffer_of(ctrl_np, i)).to(d), d_spec, noise=noise[i].to(d))
            bufs.append(y.cpu().numpy())
        outs.append(bufs)
    per_buffer = [nrms(a, c) for a, c in zip(*outs)]
    emit({"phase": "stream_card_vs_cpu", "B": 1, "buffers": 8, "nrms": per_buffer, "bar": 1e-3})
    if not max(per_buffer) <= 1e-3:
        raise RuntimeError(f"streamed buffers on the card and the CPU differ: nRMS {per_buffer}")

    # 5c. timing: one step, the pipelined cadence, the kernel at batch 256
    for b in STREAM_BATCHES:
        f0_np, ctrl_np = controls[b]
        f0_d, ctrl_d = on_card[b]
        state = ss.init_state(b, torch.Generator(device="cuda").manual_seed(b))
        with torch.inference_mode():
            step_ms = cuda_median_ms(lambda: ss.step(state, buffer_of(f0_d, 1), buffer_of(ctrl_d, 1), spec))
        streamer = PipelinedStreamer(ss, batch=b, generator=torch.Generator(device="cuda").manual_seed(b),
                                     depth=4)
        for i in range(8):
            streamer.push(buffer_of(f0_np, i), buffer_of(ctrl_np, i))
        cadence = []
        window_t0 = time.perf_counter()
        for j in range(CADENCE_PUSHES):
            i = j % STREAM_BUFFERS
            t0 = time.perf_counter()
            streamer.push(buffer_of(f0_np, i), buffer_of(ctrl_np, i))
            cadence.append((time.perf_counter() - t0) * 1e3)
        window_ms = (time.perf_counter() - window_t0) * 1e3
        list(streamer.flush())
        buffer_ms = STREAM_K * HOP / SR * 1e3
        p50, p95 = float(np.percentile(cadence, 50)), float(np.percentile(cadence, 95))
        emit({"phase": "timing_stream", "B": b, "K": STREAM_K, "buffer_ms": buffer_ms,
              "step_ms": step_ms, "step_x_realtime": b * buffer_ms / step_ms,
              "push_p50_ms": p50, "push_p95_ms": p95, "push_max_ms": max(cadence),
              "pushes": CADENCE_PUSHES, "depth": 4, "window_ms": window_ms,
              "x_realtime": CADENCE_PUSHES * b * buffer_ms / window_ms,
              "p95_within_budget": p95 < buffer_ms})
    b, ta, _ = timed_exc.shape
    k = timed_film.shape[1]
    with torch.inference_mode():
        kernel_ms = cuda_median_ms(
            lambda: nf.film_shaper_stream(timed_exc, timed_prev, timed_film, weights, HOP, packed=packed))
        plain_ms = cuda_median_ms(
            lambda: nf.film_shaper_stream_plain(timed_exc, timed_prev, timed_film, weights, HOP))
    n_el = b * ta * 64
    flop = n_el * STREAM_FLOP_PER_ELEMENT
    nbytes = 4 * (2 * n_el + timed_film.numel() + timed_prev.numel() + packed.numel())
    bound_ms, bound_by = bound(flop, nbytes)
    emit({"phase": "timing_kernel_stream", "B": b, "K": k, "hop": HOP, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "flop": flop, "bytes": nbytes, "bound_ms": bound_ms,
          "bound_by": bound_by, "share_of_bound": bound_ms / kernel_ms})
    del timed_exc, timed_prev, timed_film
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def leaf_grads(model):
    return {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}


def relnorm(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def grad_rule(card, cpu, exact):
    """The card-vs-CPU gradient rule -> (rel per leaf, witness of the leaves
    beyond 1e-3, leaves that fail, leaves with no gradient on the card). A
    leaf beyond 1e-3 passes only if the card is no farther from the float64
    gradient than the CPU's own float32 gradient is, plus 1e-3: the
    log-magnitude L1 term of the loss divides by each bin's magnitude, so
    float32 rounding alone moves some leaves that far
    (scripts/torch_grad_bar.py measures the rule, PERF.md)."""
    rel = {n: relnorm(card[n], cpu[n]) for n in cpu}
    witness = {n: {"card_vs_cpu": r, "card_vs_f64": relnorm(card[n], exact[n]),
                   "cpu_vs_f64": relnorm(cpu[n], exact[n])}
               for n, r in rel.items() if r > 1e-3}
    failed = [n for n, w in witness.items() if w["card_vs_f64"] > w["cpu_vs_f64"] + 1e-3]
    zero = [n for n, g in card.items() if not torch.count_nonzero(g)]
    return rel, witness, failed, zero


def train_phases(dev, root, tmp):
    """Phases 6-9 (training) -> the backward kernel's numbers."""
    dm = GeneralDataModule(root, batch_size=8)
    batch = dm.dataset("train").batch(np.arange(8))

    # 6. the backward kernel on the inputs a training step hands it
    trainer = Trainer(NeuralWaveshaping(generator=torch.Generator().manual_seed(0)),
                      TrainConfig(), device="cuda")
    exc, film_c, dy = train_step_kernel_inputs(trainer, batch)
    newt = trainer.model.newt
    weights = {"input_scale": newt.shaping_fn.input_scale.detach(),
               "layers": [{k: v.detach() for k, v in layer.items()}
                          for layer in newt.shaping_fn.params()["layers"]]}
    packed = nf.pack_weights(weights)
    hop = exc.shape[1] // film_c.shape[1]
    with torch.no_grad():
        out = nf.film_shaper_cr(exc, film_c, weights, hop, packed=packed)
    dy_clamp = torch.zeros_like(dy)
    dy_clamp[:, : hop // 2] = 2 * out[:, : hop // 2]
    dy_clamp[:, -hop:] = 2 * out[:, -hop:]
    max_err = check_backward("train_step_b8_4s", exc, film_c, dy, weights, packed, hop)
    max_err = max(max_err, check_backward("clamp", exc, film_c, dy_clamp, weights, packed, hop))
    del out, dy_clamp
    for label, b, tc, h in (("odd_tc", 1, 37, HOP), ("hop_64", 2, 500, 64),
                            ("hop_33", 2, 40, 33), ("hop_300", 1, 30, 300)):
        e, f = made_up_kernel_inputs(b, tc, h, 10 + tc, dev)
        g = torch.randn(e.shape, generator=torch.Generator().manual_seed(tc)).to(dev)
        max_err = max(max_err, check_backward(label, e, f, g, weights, packed, h))
    torch.cuda.empty_cache()

    # 7. one step on the card and on the CPU, same everything
    clip = dm.dataset("train").batch(np.arange(1))
    tc2 = min(2 * SR // HOP, clip["f0"].shape[1])  # 2 s of the clip
    small = {k: torch.from_numpy(np.ascontiguousarray(clip[k][:, : tc2 * HOP if k == "audio" else tc2]))
             for k in ("audio", "f0", "control")}
    rng = np.random.default_rng(11)
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc2 * HOP - 1).astype(np.float32))
    base = NeuralWaveshaping(generator=torch.Generator().manual_seed(1))
    results = []
    # on the CPU every NEWT.fused runs the plain chain, so one CPU float32
    # step and one float64 witness serve both card steps ("cr" and the
    # audio-rate "full_lane")
    for device, dtype, fused in ((dev, torch.float32, "cr"), (dev, torch.float32, "full_lane"),
                                 (torch.device("cpu"), torch.float32, "cr"),
                                 (torch.device("cpu"), torch.float64, "cr")):
        model = copy.deepcopy(base).to(device, dtype)
        model.newt.fused = fused
        reset_counts()
        loss = compute_loss(model, {k: v.to(device, dtype) for k, v in small.items()},
                            phase_offset=offset.to(device, dtype), noise=noise.to(device, dtype))
        loss.backward()
        results.append((float(loss.detach()), leaf_grads(model), counts()))
    (cpu_loss, cpu, _), (exact_loss, exact, _) = results[2:]
    for phase, (card_loss, card, got), expect in (
            ("train_card_vs_cpu", results[0], {"cr": 1, "bwd": 1, "fl": 0, "fl_bwd": 0}),
            ("train_fl_card_vs_cpu", results[1], {"cr": 0, "bwd": 0, "fl": 1, "fl_bwd": 1})):
        rel, witness, failed, zero = grad_rule(card, cpu, exact)
        worst = max(rel, key=rel.get)
        launched = {k: got[k] for k in expect}
        emit({"phase": phase, "B": 1, "Tc": tc2, "loss_card": card_loss,
              "loss_cpu": cpu_loss, "loss_cpu_f64": exact_loss,
              "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss), "leaves": len(rel),
              "worst_leaf": worst, "worst_rel": rel[worst], "leaves_over_1e-3": witness,
              "leaves_failed": failed, "zero_grad_leaves": zero, "launches": launched})
        if abs(card_loss - cpu_loss) > 1e-4 * abs(cpu_loss) or zero or failed:
            raise RuntimeError(f"{phase}: one training step on the card differs from the CPU")
        if launched != expect:
            raise RuntimeError(f"{phase}: launches {launched}, expected {expect}")

    # 8. train through the entry point a user calls, then serve the result
    cfg = TrainConfig(max_steps=TRAIN_STEPS, val_every_n_steps=TRAIN_STEPS,
                      log_every_n_steps=10, checkpoint_dir=str(tmp / "ckpt"))
    fit_trainer = Trainer(NeuralWaveshaping(generator=torch.Generator().manual_seed(0)),
                          cfg, device="cuda")
    before = [p.detach().clone() for p in fit_trainer.model.parameters()]
    nf.film_shaper_cr.launches = nf.film_shaper_cr.bwd_launches = 0
    t0 = time.perf_counter()
    history = fit_trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd, bwd = nf.film_shaper_cr.launches, nf.film_shaper_cr.bwd_launches
    val_batches = len(list(dm.val_batches())) * len(history["val"])
    moved = sum(not torch.equal(a, p) for a, p in zip(before, fit_trainer.model.parameters()))
    emit({"phase": "train", "steps": len(history["loss"]), "B": dm.batch_size,
          "clip_s": batch["audio"].shape[1] / SR,
          "fit_s": fit_s, "loss": history["loss"], "grad_norm": history["grad_norm"],
          "val": history["val"], "fwd_launches": fwd, "bwd_launches": bwd,
          "val_batches": val_batches,
          "params_moved": moved, "params": len(before)})
    if not np.all(np.isfinite(history["loss"])) or len(history["loss"]) != TRAIN_STEPS:
        raise RuntimeError("training losses are not finite")
    if bwd != TRAIN_STEPS or fwd != TRAIN_STEPS + val_batches:
        raise RuntimeError(f"launches: forward {fwd}, backward {bwd}, for {TRAIN_STEPS} steps")
    if moved != len(before):
        raise RuntimeError(f"training moved {moved} of {len(before)} parameters")
    served = Synthesizer.from_checkpoint(str(tmp / "ckpt" / "best.ckpt"), device="cuda")
    f0 = np.geomspace(220.0, 440.0, 4 * SR // HOP).astype(np.float32)
    loud = np.full_like(f0, -15.0)  # dB, the unit of the tone dataset's loudness
    audio = served.render([(f0, loud)], seed=0)[0]
    rms = float(np.sqrt(np.mean(audio**2)))
    emit({"phase": "serve_trained", "samples": int(audio.shape[0]), "rms": rms})
    if audio.shape != (f0.shape[0] * HOP,) or not np.all(np.isfinite(audio)) or rms < 1e-4:
        raise RuntimeError("the trained checkpoint renders bad audio")

    # 9. timing: the whole step, the backward kernel and its plain version
    step_ms = cuda_median_ms(lambda: trainer.train_step(batch))
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(batch)
    peak = torch.cuda.max_memory_allocated()
    bwd_ms = cuda_median_ms(lambda: nf._launch_backward(exc, film_c, packed, dy, hop))
    plain_ms = cuda_median_ms(lambda: nf.film_shaper_cr_grad_plain(exc, film_c, weights, hop, dy))
    b, ta, _ = exc.shape
    n_el = b * ta * 64
    flop = n_el * CR_BWD_FLOP_PER_ELEMENT
    nbytes = 4 * (3 * n_el + 2 * film_c.numel() + 2 * packed.numel())
    bound_ms, bound_by = bound(flop, nbytes)
    audio_s = b * ta / SR
    emit({"phase": "timing_train", "B": b, "Tc": film_c.shape[1], "hop": hop,
          "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
          "x_realtime": audio_s / (step_ms / 1e3), "peak_mem_bytes": peak,
          "bwd_kernel_ms": bwd_ms, "bwd_plain_ms": plain_ms, "flop": flop, "bytes": nbytes,
          "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / bwd_ms})
    return {"fwd_launches": fwd, "bwd_launches": bwd, "max_abs_err": max_err, "ms": bwd_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}

def caught_launches(name, fn, first=None):
    """Run ``fn`` with a hook on ``nf.<name>`` (a launch function of the
    audio-rate or exciter-fused kernels) -> the arguments of each launch (of
    the first ``first`` launches), tensors cloned: what the path hands the
    kernel."""
    got, launch = [], getattr(nf, name)

    def catch(*args):
        if first is None or len(got) < first:
            got.append(tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    setattr(nf, name, catch)
    try:
        fn()
    finally:
        setattr(nf, name, launch)
    return got


def check_fl(label, exc, film_a, packed):
    """Audio-rate forward kernel vs its plain version (rtol 1e-4, atol 1e-5;
    the bf16 instance within one bf16 ulp, rtol 2^-7) -> max abs error."""
    bf16 = exc.dtype == BF16
    rtol = BF16_RTOL if bf16 else RTOL
    weights = nf.unpack_weight_grads(packed)
    with torch.inference_mode():
        out = nf._launch_forward_fl(exc, film_a, packed)
        ref = nf.film_shaper_fl_plain(exc, film_a, weights)
    torch.cuda.synchronize()
    if out.dtype != exc.dtype:
        raise RuntimeError(f"{label}: the audio-rate forward returned {out.dtype} for {exc.dtype}")
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    err = float(np.max(np.abs(out - ref)))
    emit({"phase": "kernel_fl_bf16" if bf16 else "kernel_fl", "name": "film_shaper_fused_fl",
          "io": "bf16" if bf16 else "f32", "case": label, "B": exc.shape[0], "Ta": exc.shape[1],
          "max_abs_err": err, "rtol": rtol, "atol": ATOL,
          "elements_not_bit_identical": int((out != ref).sum()), "elements": int(out.size),
          "bit_identical": bool(np.array_equal(out, ref))})
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=ATOL, err_msg=label)
    return err


def check_fl_backward(label, exc, film_a, packed, dy):
    """Audio-rate backward kernel vs autograd through the plain version
    (rtol 1e-3, atol 1e-3 * max|plain| per output; the bf16 instance's
    d_exciter and d_film one bf16 ulp beyond it, rtol 1e-3 + 2^-7), and two
    calls bit-identical -> max abs error."""
    bf16 = exc.dtype == BF16
    out = nf._launch_backward_fl(exc, film_a, packed, dy)
    again = nf._launch_backward_fl(exc, film_a, packed, dy)
    ref = nf.film_shaper_fl_grad_plain(exc, film_a, nf.unpack_weight_grads(packed), dy)
    torch.cuda.synchronize()
    bit_identical = all(torch.equal(a, b) for a, b in zip(out, again))
    rtols = {"d_exciter": BWD_RTOL + BF16_RTOL * bf16, "d_film": BWD_RTOL + BF16_RTOL * bf16,
             "d_planes": BWD_RTOL}
    errs = {}
    for name, o, r in zip(rtols, out, ref):
        if o.dtype != r.dtype:
            raise RuntimeError(f"{label} {name}: {o.dtype}, the plain version's {r.dtype}")
        o, r = o.float().cpu().numpy(), r.float().cpu().numpy()
        errs[name] = (float(np.max(np.abs(o - r))), float(np.max(np.abs(r))))
        np.testing.assert_allclose(o, r, rtol=rtols[name], atol=BWD_RTOL * errs[name][1],
                                   err_msg=f"{label} {name}")
    emit({"phase": "kernel_fl_bwd_bf16" if bf16 else "kernel_fl_bwd", "name": "_fused_bwd_fl",
          "io": "bf16" if bf16 else "f32", "case": label, "B": exc.shape[0], "Ta": exc.shape[1],
          "dtypes": [str(t.dtype) for t in out],
          "max_abs_err": {k: v[0] for k, v in errs.items()},
          "max_abs_plain": {k: v[1] for k, v in errs.items()}, "rtol": rtols,
          "bit_identical_repeat": bit_identical})
    if not bit_identical:
        raise RuntimeError(f"{label}: two audio-rate backward calls gave different bits")
    return max(v[0] for v in errs.values())


def load_train_cli():
    spec = importlib.util.spec_from_file_location("torch_train", REPO / "scripts" / "torch_train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def render_with(synth, requests, fused):
    """``synth.render`` with ``NEWT.fused`` set to ``fused`` for the call ->
    (audio, the launch counts of that render alone)."""
    synth.model.newt.fused = fused
    reset_counts()
    try:
        audio = synth.render(requests, seed=0)
    finally:
        synth.model.newt.fused = "cr"
    return audio, counts()


def audio_rate_phases(dev, synth, root, tmp):
    """Phases 14-17 (the audio-rate kernels, NEWT.fused = "full_lane") -> the
    two kernels' numbers."""
    # 14. train through the CLI a user calls, catching the first step's
    # kernel inputs; the counts are zeroed just before and read just after
    cli = load_train_cli()
    args = ["--gin-file", "gin/train/train_newt.gin", "--dataset-path", root, "--device", "cuda",
            "--checkpoint-dir", str(tmp / "cli_ckpt"), "--log-dir", str(tmp / "cli_logs"),
            "-b", "NEWT.fused = 'full_lane'", "-b", f"TrainConfig.max_steps = {CLI_STEPS}",
            "-b", f"TrainConfig.val_every_n_steps = {CLI_VAL_EVERY}",
            "-b", "TrainConfig.log_every_n_steps = 5"]
    step_fwd, step_bwd = [], []
    reset_counts()
    t0 = time.perf_counter()
    try:
        step_bwd.extend(caught_launches("_launch_backward_fl", lambda: step_fwd.extend(
            caught_launches("_launch_forward_fl", lambda: cli.main(args), first=1)), first=1))
        torch.cuda.synchronize()
    finally:
        gin.clear_config()
    cli_s = time.perf_counter() - t0
    got = counts()
    with open(tmp / "cli_logs" / "metrics.csv") as f:
        reader = csv.DictReader(f)
        table = list(reader)
    losses = [float(r["train/loss"]) for r in table if r["train/loss"]]
    val = [float(r["val/loss"]) for r in table if r["val/loss"]]
    val_batches = len(list(GeneralDataModule(root, batch_size=8).val_batches()))
    expect = {"fl": CLI_STEPS + val_batches * (CLI_STEPS // CLI_VAL_EVERY), "fl_bwd": CLI_STEPS,
              "cr": 0, "bwd": 0}
    ckpts = sorted(p.name for p in (tmp / "cli_ckpt").glob("*.ckpt"))
    emit({"phase": "train_cli", "steps": CLI_STEPS, "seconds": cli_s, "launches": got,
          "expected_launches": expect, "train_loss_windows": losses, "val_loss": val,
          "csv_columns": reader.fieldnames, "checkpoints": ckpts})
    if any(got[k] != v for k, v in expect.items()):
        raise RuntimeError(f"train_cli launches {got}, expected {expect}")
    if reader.fieldnames != JAX_CSV_COLUMNS or not losses or not val:
        raise RuntimeError(f"metrics.csv columns {reader.fieldnames}, {len(losses)} train rows")
    if not np.all(np.isfinite(losses + val)):
        raise RuntimeError("the CLI's losses are not finite")
    kept = [f"step={s}.ckpt" for s in range(CLI_VAL_EVERY, CLI_STEPS + 1, CLI_VAL_EVERY)][-2:]
    if ckpts != ["best.ckpt", "last.ckpt"] + kept:
        raise RuntimeError(f"the CLI wrote {ckpts}")
    launches = {"fl": got["fl"], "fl_bwd": got["fl_bwd"]}

    # ... and serve its checkpoint with the audio-rate kernel and with "cr"
    served = Synthesizer.from_checkpoint(str(tmp / "cli_ckpt" / "best.ckpt"), device="cuda")
    request = make_requests([4], seed=9)
    (fl_audio,), fl_got = render_with(served, request, "full_lane")
    (cr_audio,), cr_got = render_with(served, request, "cr")
    launches["fl"] += fl_got["fl"]
    fl_vs_cr = nrms(fl_audio, cr_audio)
    emit({"phase": "serve_cli_checkpoint", "samples": int(fl_audio.shape[0]), "nrms_fl_vs_cr": fl_vs_cr,
          "bar": 1e-5, "launches_full_lane": fl_got, "launches_cr": cr_got,
          "rms": float(np.sqrt(np.mean(fl_audio**2)))})
    if not np.all(np.isfinite(fl_audio)) or not fl_vs_cr <= 1e-5:
        raise RuntimeError(f"the CLI checkpoint renders differ: nRMS {fl_vs_cr}")
    if (fl_got["fl"], fl_got["cr"], cr_got["fl"], cr_got["cr"]) != (1, 0, 0, 1):
        raise RuntimeError(f"serve launches: full_lane {fl_got}, cr {cr_got}")

    # 15. the forward kernel on the inputs the path hands it: full_lane
    # renders at batch 1 and 8 x 4 s, the CLI's first step, the
    # "full_lane_cr" fallback at a non-integer hop; then made-up shapes
    newt = synth.model.newt
    renders = {}
    for label, requests in (("render_b1_4s", make_requests([4], 5)), ("render_b8_4s", make_requests([4] * 8, 6))):
        film_c = {}
        hook = newt.mlp.register_forward_hook(lambda m, a, out: film_c.__setitem__("c", out.clone()))
        try:
            renders[label] = caught_launches(
                "_launch_forward_fl", lambda: render_with(synth, requests, "full_lane"))[0] + (film_c["c"],)
        finally:
            hook.remove()
    rng = np.random.default_rng(12)
    emb = torch.from_numpy(rng.standard_normal((1, 4, 128)).astype(np.float32)).to(dev)
    exc130 = torch.from_numpy((rng.standard_normal((1, 130, 64)) * 0.5).astype(np.float32)).to(dev)
    with torch.inference_mode():
        fallback = caught_launches("_launch_forward_fl", lambda: newt(exc130, emb, fused="full_lane_cr"))
    with torch.no_grad():
        packed = newt._packed_shaper()
    cases = [(label, *renders[label][:3]) for label in renders]
    cases += [("cli_train_step", *step_fwd[0]), ("full_lane_cr_fallback_130_4", *fallback[0])]
    for label, b, ta in (("odd_rows", 3, 333), ("ragged_block", 2, 1025)):
        e = torch.from_numpy((rng.standard_normal((b, ta, 64)) * 0.5).astype(np.float32)).to(dev)
        f = torch.from_numpy(rng.standard_normal((b, ta, 256)).astype(np.float32)).to(dev)
        cases.append((label, e, f, packed))
    max_err = max(check_fl(label, e, f, w) for label, e, f, w in cases)
    # kernel 1 on the control-rate FiLM vs the audio-rate kernel on its upsample (JAX
    # test_cr_forward_matches_fl_kernel's bar)
    exc, film_a, w, film_c = renders["render_b8_4s"]
    hop = exc.shape[1] // film_c.shape[1]
    with torch.inference_mode():
        fl_out = nf._launch_forward_fl(exc, film_a, w)
        cr_out = nf._launch_forward(exc, film_c, w, hop)
    torch.cuda.synchronize()
    cr_vs_fl = float((fl_out - cr_out).abs().max())
    emit({"phase": "kernel_fl_vs_cr", "case": "render_b8_4s", "max_abs_diff": cr_vs_fl,
          "rtol": 1e-5, "atol": 2e-6, "bit_identical": bool(torch.equal(fl_out, cr_out))})
    np.testing.assert_allclose(fl_out.cpu().numpy(), cr_out.cpu().numpy(), rtol=1e-5, atol=2e-6)
    del fl_out, cr_out, cases

    # 16. the backward kernel on the CLI step's inputs and made-up shapes: a
    # ragged last chunk of 32 samples, fewer samples than one chunk, chunks
    # that cross clip boundaries (samples 47 and 94 of 3 x 47)
    bwd_cases = [("cli_train_step", *step_bwd[0])]
    for label, b, ta in (("odd_rows", 3, 333), ("ragged_block", 2, 1025), ("full_lane_cr_fallback", 1, 130),
                         ("under_one_chunk", 1, 31), ("chunks_across_clips", 3, 47)):
        e = torch.from_numpy((rng.standard_normal((b, ta, 64)) * 0.5).astype(np.float32)).to(dev)
        f = torch.from_numpy(rng.standard_normal((b, ta, 256)).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((b, ta, 64)).astype(np.float32)).to(dev)
        bwd_cases.append((label, e, f, packed, g))
    bwd_err = max(check_fl_backward(*case) for case in bwd_cases)
    del bwd_cases[1:]
    torch.cuda.empty_cache()

    # 17. timing: both kernels and their plain versions on the main path's
    # batch-8 inputs; the step and the batch-8 forward at full_lane vs cr
    with torch.inference_mode():
        fwd_ms = cuda_median_ms(lambda: nf._launch_forward_fl(exc, film_a, w))
        fwd_plain_ms = cuda_median_ms(lambda: nf.film_shaper_fl_plain(exc, film_a, nf.unpack_weight_grads(w)))
    n_el = exc.numel()
    fwd_flop, fwd_bytes = n_el * FL_FLOP_PER_ELEMENT, 4 * (2 * n_el + film_a.numel() + w.numel())
    fwd_bound_ms, fwd_bound_by = bound(fwd_flop, fwd_bytes)
    _, b_exc, b_film, b_w, b_dy = bwd_cases[0]
    bwd_ms = cuda_median_ms(lambda: nf._launch_backward_fl(b_exc, b_film, b_w, b_dy))
    bwd_plain_ms = cuda_median_ms(
        lambda: nf.film_shaper_fl_grad_plain(b_exc, b_film, nf.unpack_weight_grads(b_w), b_dy))
    b_el = b_exc.numel()
    bwd_flop, bwd_bytes = b_el * FL_BWD_FLOP_PER_ELEMENT, 4 * (3 * b_el + 2 * b_film.numel() + 2 * b_w.numel())
    bwd_bound_ms, bwd_bound_by = bound(bwd_flop, bwd_bytes)
    del renders, exc, film_a, b_exc, b_film, b_dy, bwd_cases
    torch.cuda.empty_cache()

    dm = GeneralDataModule(root, batch_size=8)
    batch = dm.dataset("train").batch(np.arange(8))
    trainer = Trainer(NeuralWaveshaping(generator=torch.Generator().manual_seed(0)),
                      TrainConfig(), device="cuda")
    f0_b, ctrl_b, _ = synth.prepare(make_requests([4] * 8, 6))
    f0_t, ctrl_t = torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev)
    step, peak, fwd8 = {}, {}, {}
    for fused in ("cr", "full_lane", "full_lane", "cr"):  # in turns
        trainer.model.newt.fused = synth.model.newt.fused = fused
        step.setdefault(fused, []).append(cuda_median_ms(lambda: trainer.train_step(batch)))
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(batch)
        peak[fused] = torch.cuda.max_memory_allocated()
        gen = torch.Generator().manual_seed(0)
        with torch.inference_mode():
            fwd8.setdefault(fused, []).append(cuda_median_ms(lambda: synth.model(f0_t, ctrl_t, generator=gen)))
    synth.model.newt.fused = "cr"
    emit({"phase": "timing_fl", "fwd_shape": [8, f0_b.shape[1] * HOP, 64],
          "fwd_kernel_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms, "fwd_flop": fwd_flop,
          "fwd_bytes": fwd_bytes, "fwd_bound_ms": fwd_bound_ms, "fwd_bound_by": fwd_bound_by,
          "fwd_share_of_bound": fwd_bound_ms / fwd_ms,
          "bwd_shape": list(step_bwd[0][0].shape), "bwd_kernel_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
          "bwd_flop": bwd_flop, "bwd_bytes": bwd_bytes, "bwd_bound_ms": bwd_bound_ms,
          "bwd_bound_by": bwd_bound_by, "bwd_share_of_bound": bwd_bound_ms / bwd_ms,
          "step_ms": step, "step_peak_mem_bytes": peak, "forward_b8_4s_ms": fwd8,
          "order": ["cr", "full_lane", "full_lane", "cr"]})
    del trainer, step_fwd, step_bwd
    torch.cuda.empty_cache()
    return {"fwd_launches": launches["fl"], "bwd_launches": launches["fl_bwd"],
            "fwd_max_abs_err": max_err, "bwd_max_abs_err": bwd_err,
            "fwd": (fwd_ms, fwd_plain_ms, fwd_bound_ms, fwd_bound_by),
            "bwd": (bwd_ms, bwd_plain_ms, bwd_bound_ms, bwd_bound_by)}


def reset_counts():
    nf.film_shaper_cr.launches = nf.film_shaper_cr.bwd_launches = 0
    nf.film_shaper_cr.launches_bf16 = nf.film_shaper_cr.bwd_launches_bf16 = 0
    nf.film_shaper_cr.launches_bf16_f32 = nf.film_shaper_cr.bwd_launches_bf16_f32 = 0
    nf.film_shaper_fl.launches = nf.film_shaper_fl.bwd_launches = 0
    nf.film_shaper_fl.launches_bf16 = nf.film_shaper_fl.bwd_launches_bf16 = 0
    nf.film_shaper_stream.launches = fast_newt.fast_newt_lookup.launches = 0
    fast_newt.fast_newt_lookup.launches_bf16 = 0
    roofline.fma_chain.launches = roofline.fma_chain.launches_ilp4 = 0
    roofline.psin_chain.launches = roofline.psin_chain.launches_ilp4 = 0
    for wrapper in (nf.bank_film_shaper_xcr, nf.bank_newt_xfull):
        for io in ("", "_bf16", "_bf16_f32"):
            setattr(wrapper, "launches" + io, 0)
            setattr(wrapper, "bwd_launches" + io, 0)


def counts():
    got = {"cr": nf.film_shaper_cr.launches, "bwd": nf.film_shaper_cr.bwd_launches,
           "fl": nf.film_shaper_fl.launches, "fl_bwd": nf.film_shaper_fl.bwd_launches,
           "stream": nf.film_shaper_stream.launches, "lookup": fast_newt.fast_newt_lookup.launches,
           "lookup_bf16": fast_newt.fast_newt_lookup.launches_bf16,
           "cr_bf16": nf.film_shaper_cr.launches_bf16, "bwd_bf16": nf.film_shaper_cr.bwd_launches_bf16,
           "cr_bf16_f32": nf.film_shaper_cr.launches_bf16_f32,
           "bwd_bf16_f32": nf.film_shaper_cr.bwd_launches_bf16_f32,
           "fl_bf16": nf.film_shaper_fl.launches_bf16, "fl_bwd_bf16": nf.film_shaper_fl.bwd_launches_bf16,
           "chain_fma": roofline.fma_chain.launches,
           "chain_fma_ilp4": roofline.fma_chain.launches_ilp4,
           "chain_sin": roofline.psin_chain.launches,
           "chain_sin_ilp4": roofline.psin_chain.launches_ilp4}
    for kind, wrapper in (("xcr", nf.bank_film_shaper_xcr), ("xfull", nf.bank_newt_xfull)):
        for io in ("", "_bf16", "_bf16_f32"):  # e.g. xcr, xcr_bwd, xcr_bf16, xcr_bwd_bf16
            got[kind + io] = getattr(wrapper, "launches" + io)
            got[kind + "_bwd" + io] = getattr(wrapper, "bwd_launches" + io)
    return got


def caught_lookups(fn):
    """Run ``fn`` with a hook on the lookup kernel's launch -> the (table,
    x) of each launch, cloned: what the FastNEWT path hands the kernel."""
    got, launch = [], fast_newt._launch

    def catch(table, x):
        got.append((table.clone(), x.clone()))
        return launch(table, x)

    fast_newt._launch = catch
    try:
        fn()
    finally:
        fast_newt._launch = launch
    return got


def harmonic_peak_hz(audio):
    """The spectral peak above 50 Hz of samples 8000-24000 (the DC hump of
    the uniform noise excitation ignored), as tests/test_timbre_transfer.py."""
    spec = np.abs(np.fft.rfft(audio[8000:24000] * np.hanning(16000)))
    freqs = np.fft.rfftfreq(16000, 1 / SR)
    spec[freqs < 50.0] = 0.0
    return float(freqs[np.argmax(spec)])


def timbre_inputs(tmp: Path):
    """The repo's 4-s wav, and a 2-s 330-Hz tone written here as a 44.1-kHz
    int16 stereo wav and read back -> {name: (audio, rate, sliders)}."""
    sr_wav, wav = wavfile.read(WAV)
    t = np.arange(2 * 44100) / 44100
    tone = 0.4 * np.sin(2 * np.pi * 330 * t) * (0.5 + 0.5 * np.sin(np.pi * t))
    path = tmp / "tone_44k_stereo.wav"
    wavfile.write(path, 44100, (np.stack([tone, 0.5 * tone], axis=-1) * 32767).astype(np.int16))
    sr_tone, tone_pcm = wavfile.read(path)
    return {"wav_16k": (wav, sr_wav, ControlAdjustments()),
            "tone_44k_stereo": (tone_pcm, sr_tone, ControlAdjustments(octave_shift=1, loudness_scale=2.0))}


def check_lookup(label, table, x, expected_path):
    """Lookup kernel vs plain on the same CUDA tensors, and the kernel's
    path (``fast_newt._lookup_path``) against the one expected -> max abs
    error."""
    with torch.inference_mode():
        out = fast_newt._launch(table, x)
        ref = fast_newt.fast_newt_lookup_plain(table, x)
    torch.cuda.synchronize()
    path = fast_newt._lookup_path(x, out)
    err = float((out - ref).abs().max())
    n_diff = int((out != ref).sum())
    emit({"phase": "kernel_fast_newt", "name": "fast_newt_lookup_pallas", "case": label,
          "x_shape": list(x.shape), "S": table.shape[0], "x_offset_bytes": x.data_ptr() % 16, "path": path,
          "expected_path": expected_path, "max_abs_err": err, "elements_not_bit_exact": n_diff,
          "elements": x.numel(), "rtol": 0.0, "atol": 1e-6})
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-6, err_msg=label)
    if path != expected_path:
        raise RuntimeError(f"{label}: the lookup took the {path} path, expected {expected_path}")
    return err


def timbre_phases(dev, synth, cpu_synth):
    """Phases 10-13 (timbre transfer) -> the lookup kernel's numbers."""
    with tempfile.TemporaryDirectory() as tmp:
        inputs = timbre_inputs(Path(tmp))
    wav, wav_sr, _ = inputs["wav_16k"]

    # 10. the lookup kernel on the path's own inputs, then made-up ones
    cases = [("timbre_transfer_4s", *caught_lookups(
        lambda: timbre_transfer(synth, wav, wav_sr, use_fast_newt=True))[0])]
    f0_b, ctrl_b, _ = synth.prepare(make_requests([4] * 8, 6))
    f0_t, ctrl_t = torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev)
    with torch.inference_mode():
        table = synth.model.newt.bake_lookup_table()

        def render_b8():
            return synth.model(f0_t, ctrl_t, generator=torch.Generator().manual_seed(0),
                               lookup_table=table)

        cases.append(("render_b8_4s", *caught_lookups(render_b8)[0]))
    rng = np.random.default_rng(7)
    for label, s, shape in (("beyond_edges", 4096, (2, 4000, 64)), ("grid_points", 4096, (1, 64, 64)),
                            ("s256", 256, (2, 1000, 64)), ("ragged_rows", 4096, (3, 333, 64)),
                            ("offset1_view", 4096, (2, 1000, 64))):
        x = rng.uniform(-4, 4, shape).astype(np.float32)
        if label == "grid_points":
            x = (np.float32(-3) + np.arange(64 * 64, dtype=np.float32) * np.float32(6 / 4096)).reshape(shape)
        t = table if s == 4096 else torch.from_numpy(rng.standard_normal((s, 64)).astype(np.float32)).to(dev)
        x = torch.from_numpy(x).to(dev)
        if label == "offset1_view":  # contiguous, 4 B past 16-B alignment: the scalar path
            x = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
        cases.append((label, t, x))
    # the main path's inputs (the first two) must take the vec4 path
    max_err = max(check_lookup(label, t, x, "scalar" if label == "offset1_view" else "vec4")
                  for label, t, x in cases)
    timed_table, timed_x = cases[1][1], cases[1][2]
    del cases

    # 11. the entry points a user calls; counts zeroed before each run
    launches = 0
    for name, (audio, sr, adj) in inputs.items():
        for mode in ("offline", "fast_newt", "stream"):
            reset_counts()
            if mode == "stream":
                out, stats = stream_timbre_transfer(synth, audio, sr, adj, buffer_size=1024, pipeline_depth=4)
                speed = stats["x_realtime"]
            else:
                out, speed = timbre_transfer(synth, audio, sr, adj, use_fast_newt=mode == "fast_newt")
                stats = None
            got = counts()
            launches += got["lookup"]
            n = len(audio) if np.asarray(audio).ndim == 1 else np.asarray(audio).shape[0]
            tc = 1 + int(n * SR / sr) // HOP
            rms = float(np.sqrt(np.mean(out**2)))
            peak = harmonic_peak_hz(out) if name == "tone_44k_stereo" else None
            emit({"phase": "timbre_transfer", "input": name, "mode": mode, "samples": int(out.shape[0]),
                  "Tc": tc, "rms": rms, "x_realtime": speed, "launches": got, "peak_hz": peak,
                  "stream_stats": stats})
            if out.shape != (tc * HOP,) or not np.all(np.isfinite(out)) or rms < 1e-4:
                raise RuntimeError(f"{name} {mode}: bad audio ({out.shape}, rms {rms})")
            if peak is not None and not any(abs(peak - h * 660.0) < 15.0 for h in (1, 2, 3)):
                raise RuntimeError(f"{name} {mode}: the spectrum peaks at {peak} Hz")
            expect = {"offline": got["cr"] >= 1 and got["lookup"] == 0 and got["stream"] == 0,
                      "fast_newt": got["lookup"] >= 1 and got["cr"] == 0 and got["stream"] == 0,
                      "stream": got["stream"] >= 1 and got["cr"] == 0 and got["lookup"] == 0}[mode]
            if not expect or got["bwd"]:
                raise RuntimeError(f"{name} {mode}: launches {got}")

    # 12. card vs CPU: features, and one FastNEWT render with injected randomness
    for name, (audio, sr, adj) in inputs.items():
        card = extract_features(audio, sr, device=dev)
        cpu = extract_features(audio, sr, device="cpu")
        voiced = cpu[2] > 0.5
        loud_err = float(np.max(np.abs(card[3] - cpu[3])))
        f0_rel = float(np.max(np.abs(card[1] - cpu[1])[voiced] / cpu[1][voiced]))
        emit({"phase": "timbre_card_vs_cpu", "input": name, "frames": int(len(cpu[1])),
              "voiced_frames": int(voiced.sum()), "loudness_max_abs": loud_err,
              "f0_voiced_max_rel": f0_rel, "bars": {"loudness_atol": 1e-4, "f0_rtol": 1e-4}})
        if not voiced.any() or loud_err > 1e-4 or f0_rel > 1e-4:
            raise RuntimeError(f"{name}: features on the card differ from the CPU")
    f0_hz, control = adjust_controls(*card[1:], synth.data_mean, synth.data_std, adj)
    rng = np.random.default_rng(8)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, f0_hz.shape[0] * HOP - 1).astype(np.float32)
    outs = []
    for s in (synth, cpu_synth):
        with torch.inference_mode():
            y = s.model(torch.from_numpy(f0_hz[None]).to(s.device), torch.from_numpy(control[None]).to(s.device),
                        phase_offset=torch.from_numpy(offset).to(s.device),
                        noise=torch.from_numpy(noise).to(s.device),
                        lookup_table=s.model.newt.bake_lookup_table())
        outs.append(y.cpu().numpy())
    fast_vs_cpu = nrms(outs[0], outs[1])
    emit({"phase": "timbre_card_vs_cpu", "input": "tone_44k_stereo", "render": "fast_newt",
          "frames": int(f0_hz.shape[0]), "nrms": fast_vs_cpu, "bar": 1e-3})
    if not fast_vs_cpu <= 1e-3:
        raise RuntimeError(f"FastNEWT renders on the card and the CPU differ: nRMS {fast_vs_cpu}")

    # 13. timing: the feature stages, timbre_transfer end to end, the kernel
    tone_44k = torch.from_numpy(np.tile(inputs["tone_44k_stereo"][0][:, 0].astype(np.float32) / 32767, 2)).to(dev)
    x16 = resample_audio(tone_44k, 44100, SR)
    stages = {
        "resample_ms": cuda_median_ms(lambda: resample_audio(tone_44k, 44100, SR)),
        "yin_ms": cuda_median_ms(lambda: extract_f0_with_yin(x16, maximum_frequency=1000.0)),
        "loudness_ms": cuda_median_ms(lambda: extract_perceptual_loudness(x16, n_fft=1024, hop_length=128)),
    }
    speeds = {}
    for mode in ("offline", "fast_newt"):
        runs = [timbre_transfer(synth, wav, wav_sr, use_fast_newt=mode == "fast_newt")[1]
                for _ in range(N_TIMED)]
        speeds[mode] = statistics.median(runs)
        speeds[mode + "_call_ms"] = host_median_ms(
            lambda: timbre_transfer(synth, wav, wav_sr, use_fast_newt=mode == "fast_newt"), n=5)
    with torch.inference_mode():
        kernel_ms = cuda_median_ms(lambda: fast_newt.fast_newt_lookup(timed_table, timed_x))
        plain_ms = cuda_median_ms(lambda: fast_newt.fast_newt_lookup_plain(timed_table, timed_x))
        bake_ms = cuda_median_ms(synth.model.newt.bake_lookup_table)
        gen = torch.Generator().manual_seed(0)
        b8_ms = {mode: cuda_median_ms(lambda: synth.model(f0_t, ctrl_t, generator=gen, lookup_table=lookup))
                 for mode, lookup in (("offline", None), ("fast_newt", timed_table))}
    n_el = timed_x.numel()
    flop = n_el * LOOKUP_FLOP_PER_ELEMENT
    nbytes = 4 * (2 * n_el + timed_table.numel())
    bound_ms, bound_by = bound(flop, nbytes)
    emit({"phase": "timing_timbre", "audio_s": 4.0, "input_rate": 44100, **stages,
          "timbre_transfer_x_realtime": speeds["offline"],
          "timbre_transfer_fast_newt_x_realtime": speeds["fast_newt"],
          "timbre_transfer_call_ms": speeds["offline_call_ms"],
          "timbre_transfer_fast_newt_call_ms": speeds["fast_newt_call_ms"], "bake_ms": bake_ms,
          "forward_b8_4s_ms": b8_ms["offline"], "forward_b8_4s_fast_newt_ms": b8_ms["fast_newt"],
          "lookup_x_shape": list(timed_x.shape), "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "flop": flop, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "share_of_bound": bound_ms / kernel_ms})
    del timed_table, timed_x
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def x_flop(args, backward):
    """The exciter-fused kernel's operations on these launch arguments (the
    bank's unmasked harmonics counted from the run's f0)."""
    phase, f0, _, _, _, _, _, w_out, h, sample_rate, _ = args[:11]
    xfull = w_out is not None
    per_el = {(False, False): XCR_FLOP_PER_ELEMENT, (False, True): XCR_BWD_FLOP_PER_ELEMENT,
              (True, False): XFULL_FLOP_PER_ELEMENT, (True, True): XFULL_BWD_FLOP_PER_ELEMENT}
    k = torch.arange(1, h + 1, dtype=torch.float32, device=f0.device)
    live = int(sum(int(((row[:, None] * k) < sample_rate / 2.0).sum()) for row in f0))
    n_samples = f0.numel()
    mix = X_MIX_FLOP_PER_HARMONIC * h * (2 if backward else 1)
    return (n_samples * 64 * (per_el[(xfull, backward)] + mix)
            + n_samples * X_MASK_FLOP_PER_HARMONIC * h + live * X_SINE_FLOP)


def x_bytes(args, backward):
    """Each input read once and each output written once, at the tensors'
    own element sizes: phase and f0, the film, offsets, mixer, planes (and
    w_out); out (or dy, d_film and the float32 summed gradient table). bf16
    halves the mixer, the film and out or dy."""
    phase, f0, off, film_c, w, b, packed, w_out = args[:8]
    inputs = (phase, f0, off, film_c, w, b, packed, w_out)
    n = sum(t.numel() * t.element_size() for t in inputs if t is not None)
    out = phase.numel() * (1 if w_out is not None else 64) * w.element_size()
    if backward:  # dy in; d_film and the (170 + H + 1 [+ 1], 64) table out
        out += film_c.numel() * film_c.element_size() + 4 * (
            packed.numel() + w.numel() + b.numel() + (0 if w_out is None else 64))
    return n + out


def x_plain(args):
    """The plain version of the exciter-fused forward on launch arguments."""
    phase, f0, off, film_c, w, b, packed, w_out, h, sample_rate, hop = args
    mixer, shaper = {"w": w, "b": b}, nf.unpack_weight_grads(packed)
    if w_out is None:
        return nf.bank_film_shaper_xcr_plain(phase, f0, off, film_c, mixer, shaper, h, sample_rate, hop)
    return nf.bank_newt_xfull_plain(phase, f0, off, film_c, mixer, w_out, shaper, h, sample_rate, hop)


def x_grad_plain(args):
    phase, f0, off, film_c, w, b, packed, w_out, h, sample_rate, hop, dy = args
    mixer, shaper = {"w": w, "b": b}, nf.unpack_weight_grads(packed)
    if w_out is None:
        return nf.bank_film_shaper_xcr_grad_plain(phase, f0, off, film_c, mixer, shaper, h,
                                                  sample_rate, hop, dy)
    return nf.bank_newt_xfull_grad_plain(phase, f0, off, film_c, mixer, w_out, shaper, h,
                                         sample_rate, hop, dy)


def check_x(label, args):
    """Exciter-fused forward kernel vs its plain version -> max abs error."""
    with torch.inference_mode():
        out = nf._launch_forward_x(*args)
        ref = x_plain(args)
    torch.cuda.synchronize()
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    err = float(np.max(np.abs(out - ref)))
    xfull = args[7] is not None
    emit({"phase": "kernel_xfull" if xfull else "kernel_xcr",
          "name": "bank_newt_fused_xfull" if xfull else "bank_film_shaper_fused_xcr", "case": label,
          "B": args[0].shape[0], "Tc": args[3].shape[1], "hop": args[10], "H": args[8],
          "max_abs_err": err, "rtol": RTOL, "atol": ATOL})
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL, err_msg=label)
    return err


def check_x_film_lerp(label, args):
    """xcr with the film's gamma_out planes zeroed: its output is the
    in-kernel beta_out lerp (0 * y + beta_out is exact), bit for bit
    ``linear_upsample`` on the CPU."""
    film_z = args[3].clone()
    film_z[..., 128:192] = 0.0
    with torch.inference_mode():
        lerp = nf._launch_forward_x(*args[:3], film_z, *args[4:]).cpu()
    expect = linear_upsample(film_z.cpu(), args[0].shape[1])[..., 192:]
    n_diff = int((lerp != expect).sum())
    emit({"phase": "kernel_x_film_lerp", "case": label, "B": args[0].shape[0],
          "Tc": film_z.shape[1], "hop": args[10], "elements_not_bit_exact": n_diff})
    if n_diff:
        raise RuntimeError(f"{label}: the exciter-fused kernel's FiLM interpolation is not bit-exact")


def check_x_backward(label, args):
    """Exciter-fused backward kernel vs autograd through the plain version,
    every output, and two calls bit-identical -> max abs error."""
    out = nf._launch_backward_x(*args)
    again = nf._launch_backward_x(*args)
    ref = x_grad_plain(args)
    torch.cuda.synchronize()
    bit_identical = all(torch.equal(a, b) for a, b in zip(out, again))
    errs = {}
    for name, o, r in zip(("d_film_c", "d_w", "d_b", "d_planes", "d_w_out"), out, ref):
        o, r = o.cpu().numpy(), r.cpu().numpy()
        errs[name] = (float(np.max(np.abs(o - r))), float(np.max(np.abs(r))))
        np.testing.assert_allclose(o, r, rtol=BWD_RTOL, atol=BWD_RTOL * errs[name][1],
                                   err_msg=f"{label} {name}")
    xfull = args[7] is not None
    emit({"phase": "kernel_xfull_bwd" if xfull else "kernel_xcr_bwd",
          "name": "_fused_bwd_xfull" if xfull else "_fused_bwd_xcr", "case": label,
          "B": args[0].shape[0], "Tc": args[3].shape[1], "hop": args[10], "H": args[8],
          "outputs": len(out), "max_abs_err": {k: v[0] for k, v in errs.items()},
          "max_abs_plain": {k: v[1] for k, v in errs.items()}, "rtol": BWD_RTOL,
          "bit_identical_repeat": bit_identical})
    if len(out) != len(ref) or len(out) != (5 if xfull else 4):
        raise RuntimeError(f"{label}: {len(out)} backward outputs, plain {len(ref)}")
    if not bit_identical:
        raise RuntimeError(f"{label}: two exciter-fused backward calls gave different bits")
    return max(v[0] for v in errs.values())


def made_up_x_args(b, tc, hop, h, seed, dev, packed, xfull, backward=False):
    """Launch arguments of made-up inputs: f0 from 110 Hz to ~2 kHz (the
    antialias mask cuts real harmonics), its wrapped phase, offsets, film,
    a 0.1-scaled mixer and w_out, the given planes."""
    rng = np.random.default_rng(seed)
    f0 = (110.0 * 2.0 ** rng.uniform(0, np.log2(2000 / 110), (b, tc * hop))).astype(np.float32)
    phase = np.mod(2 * np.pi * np.cumsum(f0.astype(np.float64), -1) / SR, 2 * np.pi).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (
        phase, f0, rng.uniform(-np.pi, np.pi, h).astype(np.float32),
        rng.standard_normal((b, tc, 256)).astype(np.float32),
        (rng.standard_normal((h, 64)) * 0.1).astype(np.float32),
        (rng.standard_normal(64) * 0.1).astype(np.float32),
        (rng.standard_normal(64) * 0.1).astype(np.float32))]
    args = (*t[:6], packed, t[6] if xfull else None, h, float(SR), hop)
    if not backward:
        return args
    shape = (b, tc * hop) if xfull else (b, tc * hop, 64)
    return (*args, torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev))


X_FIELDS = {"xcr": {"fuse_exciter": True}, "xfull": {"fuse_exciter": True, "fuse_out_mixer": True}}


def synth_with(fields, device="cuda"):
    """``Synthesizer.from_checkpoint`` with the fields bound through gin, as a
    user binds them; the bindings are cleared after."""
    gin.clear_config()
    for name, value in fields.items():
        gin.bind_parameter(f"NeuralWaveshaping.{name}", value)
    try:
        return Synthesizer.from_checkpoint(CKPT, device=device)
    finally:
        gin.clear_config()


def set_fields(model, fields):
    model.fuse_exciter = fields.get("fuse_exciter", False)
    model.fuse_out_mixer = fields.get("fuse_out_mixer", False)


def exciter_fused_phases(dev, synth, root, tmp, batch_requests, single_requests):
    """Phases 18-23 (the exciter-fused kernels, NeuralWaveshaping.fuse_exciter
    and fuse_out_mixer) -> the four kernels' numbers."""
    synths = {kind: synth_with(fields) for kind, fields in X_FIELDS.items()}
    launches = {"xcr": 0, "xcr_bwd": 0, "xfull": 0, "xfull_bwd": 0}

    # 18. serve through the entry point a user calls, with the fields bound
    for kind, s in synths.items():
        rms = []
        for requests in (batch_requests, single_requests):
            reset_counts()
            audio = s.render(requests, seed=0)
            got = counts()
            launches[kind] += got[kind]
            expect = {k: int(k == kind) for k in ("xcr", "xfull", "cr", "fl", "lookup")}
            if {k: got[k] for k in expect} != expect or got["bwd"] or got["xcr_bwd"] or got["xfull_bwd"]:
                raise RuntimeError(f"serve_fused {kind}: launches {got}, expected {expect}")
            for (f0, _), a in zip(requests, audio):
                rms.append(float(np.sqrt(np.mean(a**2))))
                if a.shape != (f0.shape[0] * HOP,) or not np.all(np.isfinite(a)) or rms[-1] < 1e-4:
                    raise RuntimeError(f"serve_fused {kind}: bad render ({a.shape}, rms {rms[-1]})")
        # fused vs unfused on the card and fused on the card vs the CPU, one
        # request with injected offsets and noise; then (B, H) offsets fall back
        f0_b, ctrl_b, _ = synth.prepare(make_requests([4, 2], seed=3))
        rng = np.random.default_rng(4)
        offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
        noise = torch.from_numpy(rng.uniform(0, 1, f0_b.shape[1] * HOP - 1).astype(np.float32))
        cpu = synth_with(X_FIELDS[kind], device="cpu")
        outs = {}
        for name, model, d in (("fused", s.model, dev), ("unfused", synth.model, dev), ("cpu", cpu.model, "cpu")):
            reset_counts()
            with torch.inference_mode():
                y = model(torch.from_numpy(f0_b).to(d), torch.from_numpy(ctrl_b).to(d),
                          phase_offset=offset.to(d), noise=noise.to(d))
            outs[name] = (y.cpu().numpy(), counts())
        with torch.inference_mode():
            reset_counts()
            s.model(torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev),
                    phase_offset=offset.to(dev)[None].repeat(f0_b.shape[0], 1), noise=noise.to(dev))
            per_batch = counts()
        fused_vs_unfused = float(np.max(np.abs(outs["fused"][0] - outs["unfused"][0])))
        card_vs_cpu = nrms(outs["fused"][0], outs["cpu"][0])
        emit({"phase": "serve_fused", "kind": kind, "fields": X_FIELDS[kind], "requests_s": [2, 4, 4, 7, 4],
              "rms": rms, "launches": launches[kind], "fused_vs_unfused_max_abs": fused_vs_unfused,
              "card_vs_cpu_nrms": card_vs_cpu, "bars": {"rtol": RTOL, "atol": ATOL, "nrms": 1e-3},
              "launches_fused": outs["fused"][1], "launches_unfused": outs["unfused"][1],
              "launches_per_batch_offsets": per_batch})
        np.testing.assert_allclose(outs["fused"][0], outs["unfused"][0], rtol=RTOL, atol=ATOL)
        if not card_vs_cpu <= 1e-3:
            raise RuntimeError(f"serve_fused {kind}: card vs CPU nRMS {card_vs_cpu}")
        if (outs["fused"][1][kind], outs["fused"][1]["cr"], outs["unfused"][1]["cr"]) != (1, 0, 1):
            raise RuntimeError(f"serve_fused {kind}: launches {outs['fused'][1]}, {outs['unfused'][1]}")
        if (per_batch["cr"], per_batch["xcr"], per_batch["xfull"]) != (1, 0, 0):
            raise RuntimeError(f"serve_fused {kind}: (B, H) offsets launched {per_batch}")
        del cpu
    # a geometry supports_xcr refuses (H = 129 harmonics) takes the unfused path
    gin.parse_config("HarmonicOscillator.n_harmonics = 129")
    try:
        wide = NeuralWaveshaping(fuse_exciter=True, generator=torch.Generator().manual_seed(0)).to(dev)
    finally:
        gin.clear_config()
    reset_counts()
    with torch.inference_mode():
        wide(torch.full((1, 64), 220.0, device=dev), torch.zeros(1, 64, 2, device=dev),
             generator=torch.Generator().manual_seed(0))
    got = counts()
    emit({"phase": "serve_fused_refused_geometry", "H": 129, "launches": got})
    if (got["cr"], got["xcr"], got["xfull"]) != (1, 0, 0):
        raise RuntimeError(f"H = 129 launched {got}")
    del wide

    # 19. the forward kernels on the inputs the path hands them, then made-up ones
    renders = {}
    for kind, s in synths.items():
        for label, requests in (("render_b8_4s", make_requests([4] * 8, 6)), ("render_b1_4s", make_requests([4], 5))):
            renders[(kind, label)] = caught_launches(
                "_launch_forward_x", lambda: s.render(requests, seed=0))[0]
    with torch.no_grad():
        packed = synth.model.newt._packed_shaper()
    cases = [(f"{label}_{kind}", args) for (kind, label), args in renders.items()]
    for kind in X_FIELDS:
        xfull = kind == "xfull"
        for label, b, tc, hop, h in (("odd_tc", 1, 37, HOP, 101), ("hop_64", 2, 50, 64, 101),
                                     ("h2", 2, 8, HOP, 2), ("h128", 2, 8, HOP, 128),
                                     ("ragged_block", 1, 37, 5, 101), ("straddle", 3, 1, 3, 101)):
            cases.append((f"{label}_{kind}", made_up_x_args(b, tc, hop, h, 50 + tc + h, dev, packed, xfull)))
    fwd_err = {"xcr": 0.0, "xfull": 0.0}
    for label, args in cases:
        kind = "xfull" if args[7] is not None else "xcr"
        fwd_err[kind] = max(fwd_err[kind], check_x(label, args))
    # with gamma_out = 0 xcr's output is its in-register beta_out lerp, which
    # must equal linear_upsample on the CPU bit for bit
    for label, args in cases:
        if args[7] is None and label.startswith(("render", "straddle")):
            check_x_film_lerp(label, args)
    # xfull plus the output mix's bias against xcr followed by NEWT's mixer
    xcr_args = renders[("xcr", "render_b8_4s")]
    newt = synth.model.newt
    with torch.inference_mode():
        shaped = nf._launch_forward_x(*xcr_args)
        ref = newt.mixer(shaped)[..., 0]
        xfull_out = nf._launch_forward_x(*xcr_args[:7], newt.mixer.w[:, 0].contiguous(), *xcr_args[8:])
        xfull_out = xfull_out + newt.mixer.b[0]
    torch.cuda.synchronize()
    diff = float((xfull_out - ref).abs().max())
    emit({"phase": "kernel_xfull_vs_xcr", "case": "render_b8_4s", "max_abs_diff": diff,
          "rtol": RTOL, "atol": ATOL})
    np.testing.assert_allclose(xfull_out.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
    del cases, shaped, ref, xfull_out

    # 20. the backward kernels on the inputs one Trainer step at batch 8 x 4 s
    # hands them (counts zeroed just before, read just after), then made-up ones
    dm = GeneralDataModule(root, batch_size=8)
    batch = dm.dataset("train").batch(np.arange(8))
    trainer = Trainer(NeuralWaveshaping(generator=torch.Generator().manual_seed(0)),
                      TrainConfig(), device="cuda")
    step_args = {}
    for kind, fields in X_FIELDS.items():
        set_fields(trainer.model, fields)
        reset_counts()
        step_args[kind] = caught_launches("_launch_backward_x", lambda: trainer.train_step(batch))[0]
        torch.cuda.synchronize()
        got = counts()
        expect = {kind: 1, f"{kind}_bwd": 1, "cr": 0, "bwd": 0, "fl": 0, "fl_bwd": 0}
        emit({"phase": "train_step_fused", "kind": kind, "B": 8, "launches": got})
        if any(got[k] != v for k, v in expect.items()):
            raise RuntimeError(f"a {kind} training step launched {got}, expected {expect}")
        launches[kind] += got[kind]
        launches[f"{kind}_bwd"] += got[f"{kind}_bwd"]
    set_fields(trainer.model, {})
    bwd_err = {"xcr": 0.0, "xfull": 0.0}
    for kind in X_FIELDS:
        xfull = kind == "xfull"
        bwd_cases = [("train_step_b8_4s", step_args[kind])]
        for label, b, tc, hop, h in (("odd_tc", 1, 37, HOP, 101), ("hop_64", 2, 50, 64, 101),
                                     ("h2", 1, 8, HOP, 2), ("h128", 1, 8, HOP, 128),
                                     ("hop_33", 2, 40, 33, 101), ("hop_300", 1, 30, 300, 101)):
            bwd_cases.append((label, made_up_x_args(b, tc, hop, h, 70 + tc + h, dev, packed, xfull, True)))
        bwd_err[kind] = max(check_x_backward(f"{label}_{kind}", args) for label, args in bwd_cases)
        torch.cuda.empty_cache()

    # 21. one step's loss and gradients, card against CPU, with each field set
    clip = dm.dataset("train").batch(np.arange(1))
    tc2 = min(2 * SR // HOP, clip["f0"].shape[1])
    small = {k: torch.from_numpy(np.ascontiguousarray(clip[k][:, : tc2 * HOP if k == "audio" else tc2]))
             for k in ("audio", "f0", "control")}
    rng = np.random.default_rng(11)
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc2 * HOP - 1).astype(np.float32))
    base = NeuralWaveshaping(generator=torch.Generator().manual_seed(1))
    for kind, fields in X_FIELDS.items():
        results = []
        for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                              (torch.device("cpu"), torch.float64)):
            model = copy.deepcopy(base).to(device, dtype)
            set_fields(model, fields)
            reset_counts()
            loss = compute_loss(model, {k: v.to(device, dtype) for k, v in small.items()},
                                phase_offset=offset.to(device, dtype), noise=noise.to(device, dtype))
            loss.backward()
            results.append((float(loss.detach()), leaf_grads(model), counts()))
        (card_loss, card, got), (cpu_loss, cpu, _), (exact_loss, exact, _) = results
        rel, witness, failed, zero = grad_rule(card, cpu, exact)
        worst = max(rel, key=rel.get)
        expect = {kind: 1, f"{kind}_bwd": 1, "cr": 0, "bwd": 0}
        launched = {k: got[k] for k in expect}
        emit({"phase": "train_fused_card_vs_cpu", "kind": kind, "B": 1, "Tc": tc2, "loss_card": card_loss,
              "loss_cpu": cpu_loss, "loss_cpu_f64": exact_loss,
              "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss), "leaves": len(rel),
              "worst_leaf": worst, "worst_rel": rel[worst],
              "rel_harmonic_mixer": {n: rel[n] for n in rel if n.startswith("harmonic_mixer")},
              "rel_newt_mixer_w": rel["newt.mixer.w"], "leaves_over_1e-3": witness,
              "leaves_failed": failed, "zero_grad_leaves": zero, "launches": launched})
        if abs(card_loss - cpu_loss) > 1e-4 * abs(cpu_loss) or zero or failed:
            raise RuntimeError(f"train_fused_card_vs_cpu {kind}: the card differs from the CPU")
        if launched != expect:
            raise RuntimeError(f"train_fused_card_vs_cpu {kind}: launches {launched}, expected {expect}")

    # 22. train through the CLI a user calls with both fields bound; counts
    # zeroed just before and read just after; then serve its checkpoint
    cli = load_train_cli()
    args = ["--gin-file", "gin/train/train_newt.gin", "--dataset-path", root, "--device", "cuda",
            "--checkpoint-dir", str(tmp / "cli_x_ckpt"), "--log-dir", str(tmp / "cli_x_logs"),
            "-b", "NeuralWaveshaping.fuse_exciter = True", "-b", "NeuralWaveshaping.fuse_out_mixer = True",
            "-b", f"TrainConfig.max_steps = {CLI_STEPS}",
            "-b", f"TrainConfig.val_every_n_steps = {CLI_VAL_EVERY}",
            "-b", "TrainConfig.log_every_n_steps = 5"]
    reset_counts()
    t0 = time.perf_counter()
    try:
        cli.main(args)
        torch.cuda.synchronize()
    finally:
        gin.clear_config()
    cli_s = time.perf_counter() - t0
    got = counts()
    with open(tmp / "cli_x_logs" / "metrics.csv") as f:
        table = list(csv.DictReader(f))
    losses = [float(r["train/loss"]) for r in table if r["train/loss"]]
    val = [float(r["val/loss"]) for r in table if r["val/loss"]]
    val_batches = len(list(dm.val_batches()))
    expect = {"xfull": CLI_STEPS + val_batches * (CLI_STEPS // CLI_VAL_EVERY), "xfull_bwd": CLI_STEPS,
              "xcr": 0, "xcr_bwd": 0, "cr": 0, "bwd": 0, "fl": 0, "fl_bwd": 0}
    served = Synthesizer.from_checkpoint(str(tmp / "cli_x_ckpt" / "best.ckpt"), device="cuda")
    audio = served.render(make_requests([4], seed=9), seed=0)[0]
    emit({"phase": "train_cli_fused", "steps": CLI_STEPS, "seconds": cli_s, "launches": got,
          "expected_launches": expect, "train_loss_windows": losses, "val_loss": val,
          "served_rms": float(np.sqrt(np.mean(audio**2)))})
    if any(got[k] != v for k, v in expect.items()):
        raise RuntimeError(f"train_cli_fused launches {got}, expected {expect}")
    if not losses or not val or not np.all(np.isfinite(losses + val)) or not np.all(np.isfinite(audio)):
        raise RuntimeError("the fused CLI's losses or its checkpoint's render are not finite")
    launches["xfull"] += got["xfull"]
    launches["xfull_bwd"] += got["xfull_bwd"]

    # 23. timing: the four kernels and their plain versions on the main path's
    # batch-8 inputs; in turns, the forward at batch 1 and 8 x 4 s, the step and
    # its peak memory, fusion off (bank, mixer, kernel 1 or 2), xcr and xfull
    numbers = {}
    for kind in X_FIELDS:
        fa = renders[(kind, "render_b8_4s")]
        ba = step_args[kind]
        with torch.inference_mode():
            f_ms = cuda_median_ms(lambda: nf._launch_forward_x(*fa))
            f_plain = cuda_median_ms(lambda: x_plain(fa))
        b_ms = cuda_median_ms(lambda: nf._launch_backward_x(*ba))
        b_plain = cuda_median_ms(lambda: x_grad_plain(ba))
        f_flop, f_bytes = x_flop(fa, False), x_bytes(fa, False)
        b_flop, b_bytes = x_flop(ba, True), x_bytes(ba, True)
        numbers[kind] = ((f_ms, f_plain, *bound(f_flop, f_bytes)), (b_ms, b_plain, *bound(b_flop, b_bytes)))
        emit({"phase": "timing_kernel_fused", "kind": kind, "fwd_shape": list(fa[0].shape),
              "fwd_kernel_ms": f_ms, "fwd_plain_ms": f_plain, "fwd_flop": f_flop, "fwd_bytes": f_bytes,
              "fwd_bound_ms": numbers[kind][0][2], "fwd_bound_by": numbers[kind][0][3],
              "fwd_share_of_bound": numbers[kind][0][2] / f_ms,
              "bwd_shape": list(ba[0].shape), "bwd_kernel_ms": b_ms, "bwd_plain_ms": b_plain,
              "bwd_flop": b_flop, "bwd_bytes": b_bytes, "bwd_bound_ms": numbers[kind][1][2],
              "bwd_bound_by": numbers[kind][1][3], "bwd_share_of_bound": numbers[kind][1][2] / b_ms})
    del renders, step_args
    torch.cuda.empty_cache()
    arms = {"off": {}, **X_FIELDS}
    order = ["off", "xcr", "xfull", "xfull", "xcr", "off"]
    inputs = {}
    for label, requests in (("b1", make_requests([4], 5)), ("b8", make_requests([4] * 8, 6))):
        f0_b, ctrl_b, _ = synth.prepare(requests)
        inputs[label] = (torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev))
    fwd = {"b1": {}, "b8": {}}
    step, peak = {}, {}
    for arm in order:
        set_fields(synth.model, arms[arm])
        set_fields(trainer.model, arms[arm])
        for label, (f0_t, ctrl_t) in inputs.items():
            gen = torch.Generator().manual_seed(0)
            with torch.inference_mode():
                fwd[label].setdefault(arm, []).append(
                    cuda_median_ms(lambda: synth.model(f0_t, ctrl_t, generator=gen)))
        step.setdefault(arm, []).append(cuda_median_ms(lambda: trainer.train_step(batch)))
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(batch)
        peak[arm] = torch.cuda.max_memory_allocated()
    set_fields(synth.model, {})
    emit({"phase": "timing_fused", "order": order, "forward_b1_4s_ms": fwd["b1"],
          "forward_b8_4s_ms": fwd["b8"], "step_ms": step, "step_peak_mem_bytes": peak,
          "x_realtime_b1": {a: [4.0 / (t / 1e3) for t in v] for a, v in fwd["b1"].items()},
          "x_realtime_b8": {a: [32.0 / (t / 1e3) for t in v] for a, v in fwd["b8"].items()}})
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "fwd_err": fwd_err, "bwd_err": bwd_err, "numbers": numbers}


def cr_bytes(exc, film_c, planes, backward=False):
    """The bytes kernel 1 or 5 (or 2 or 6) must move, at the tensors' own
    element sizes: exciter in and out (and dy in), the FiLM in (and d_film
    out), the float32 planes in (and d_planes out). bf16 halves the exciter,
    dy and outputs."""
    return roofline.shaper_bytes(exc.numel() * exc.element_size(),
                                 film_c.numel() * film_c.element_size(),
                                 planes.numel() * planes.element_size(), backward)


def instance_of(exc, film_c):
    return "f32" if exc.dtype == torch.float32 else ("bf16" if film_c.dtype == BF16 else "bf16_f32")


def check_bf16_forward(label, exc, film_c, packed):
    """Kernel 1's bf16 instance vs its plain version (float32 between bf16
    load and store) within one bf16 ulp, and with gamma_out = 0 its output
    against linear_upsample of the widened FiLM rounded to bf16, bit for bit
    -> max abs error."""
    b, ta, _ = exc.shape
    hop = ta // film_c.shape[1]
    with torch.inference_mode():
        out = nf._launch_forward(exc, film_c, packed, hop)
        ref = nf.film_shaper_cr_plain(exc, film_c, nf.unpack_weight_grads(packed), hop)
        film_z = film_c.clone()
        film_z[..., 128:192] = 0.0
        lerp = nf._launch_forward(exc, film_z, packed, hop).cpu()
    torch.cuda.synchronize()
    expect = linear_upsample(film_z.float().cpu(), ta)[..., 192:].to(BF16)
    o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
    err = float(np.max(np.abs(o - r)))
    n_lerp = int((lerp != expect).sum())
    emit({"phase": "kernel_bf16", "name": "film_shaper_fused_cr", "io": instance_of(exc, film_c),
          "case": label, "B": b, "Tc": film_c.shape[1], "hop": hop, "max_abs_err": err,
          "elements_not_bit_identical": int((o != r).sum()), "elements": int(o.size),
          "rtol": BF16_RTOL, "atol": ATOL, "film_lerp_elements_not_bit_exact": n_lerp})
    if out.dtype != BF16:
        raise RuntimeError(f"{label}: the bf16 instance returned {out.dtype}")
    np.testing.assert_allclose(o, r, rtol=BF16_RTOL, atol=ATOL, err_msg=label)
    if n_lerp:
        raise RuntimeError(f"{label}: the bf16 instance's FiLM lerp is not bit-exact")
    return err


def check_bf16_backward(label, exc, film_c, planes, dy, hop):
    """Kernel 2's bf16 instance vs autograd through the plain version:
    d_exciter and d_film one bf16 ulp beyond the float32 gradient bar (rtol
    1e-3 + 2^-7, atol 1e-3 * max|plain|), d_planes (float32) at that bar;
    two calls bit-identical -> max abs error."""
    out = nf._launch_backward(exc, film_c, planes, dy, hop)
    again = nf._launch_backward(exc, film_c, planes, dy, hop)
    ref = nf.film_shaper_cr_grad_plain(exc, film_c, nf.unpack_weight_grads(planes), hop, dy)
    torch.cuda.synchronize()
    bit_identical = all(torch.equal(a, b) for a, b in zip(out, again))
    errs = {}
    for name, o, r, rtol in zip(("d_exciter", "d_film_c", "d_planes"), out, ref,
                                (BWD_RTOL + BF16_RTOL, BWD_RTOL + BF16_RTOL, BWD_RTOL)):
        if o.dtype != r.dtype:
            raise RuntimeError(f"{label} {name}: {o.dtype}, the plain version's {r.dtype}")
        o, r = o.float().cpu().numpy(), r.float().cpu().numpy()
        errs[name] = (float(np.max(np.abs(o - r))), float(np.max(np.abs(r))))
        np.testing.assert_allclose(o, r, rtol=rtol, atol=BWD_RTOL * errs[name][1],
                                   err_msg=f"{label} {name}")
    emit({"phase": "kernel_bwd_bf16", "name": "_fused_bwd_cr", "io": instance_of(exc, film_c),
          "case": label, "B": exc.shape[0], "Tc": film_c.shape[1], "hop": hop,
          "dtypes": [str(t.dtype) for t in out],
          "max_abs_err": {k: v[0] for k, v in errs.items()},
          "max_abs_plain": {k: v[1] for k, v in errs.items()},
          "rtol": {"d_exciter": BWD_RTOL + BF16_RTOL, "d_film_c": BWD_RTOL + BF16_RTOL,
                   "d_planes": BWD_RTOL},
          "bit_identical_repeat": bit_identical})
    if not bit_identical:
        raise RuntimeError(f"{label}: two bf16 backward calls gave different bits")
    return max(v[0] for v in errs.values())


def in_turns(fns, order):
    """CUDA-event medians of ``fns[k]`` for k in ``order`` (each arm timed
    where it stands in the order) -> {k: [ms, ...]}."""
    out = {}
    for k in order:
        out.setdefault(k, []).append(cuda_median_ms(fns[k]))
    return out


def mixed_precision_phases(dev, root, tmp):
    """Phases 24-28 (mixed precision: the model's compute_dtype = "bfloat16"
    and kernels 1 and 2's bf16 instances) -> the four instances' numbers."""
    synth16 = synth_with({"compute_dtype": "bfloat16"})
    synth32 = Synthesizer.from_checkpoint(CKPT, device="cuda")
    newt = synth16.model.newt
    with torch.no_grad():
        packed = newt._packed_shaper(BF16)
    batch_requests, single_requests = make_requests([2, 4, 4, 7], seed=1), make_requests([4], seed=2)
    timed = make_requests([4] * 8, 6)

    # 24. kernel 1's bf16 instances on the inputs a bf16 Synthesizer's render
    # hands them (caught by wrapping the launch), with the FiLM in bf16 and,
    # with cr_film_f32, in float32; then made-up shapes
    cases, fwd_err = [], {"bf16": 0.0, "bf16_f32": 0.0}
    timed_inputs = {}
    for film_f32 in (False, True):
        newt.cr_film_f32 = film_f32
        for label, requests in (("serve_batch", batch_requests), ("serve_single", single_requests),
                                ("timed_batch8", timed)):
            (exc, film_c, _, _), = caught_launches(
                "_launch_forward", lambda: synth16.render(requests, seed=0))
            cases.append((label, exc, film_c))
            if label == "timed_batch8":
                timed_inputs[instance_of(exc, film_c)] = (exc, film_c)
    newt.cr_film_f32 = False
    for label, b, tc, hop in (("odd_tc", 1, 37, HOP), ("hop_64", 2, 500, 64), ("straddle", 3, 1, 3)):
        exc, film_c = made_up_kernel_inputs(b, tc, hop, 20 + tc, dev)
        cases += [(label, exc.to(BF16), film_c.to(BF16)), (label, exc.to(BF16), film_c)]
    for label, exc, film_c in cases:
        key = instance_of(exc, film_c)
        fwd_err[key] = max(fwd_err[key], check_bf16_forward(label, exc, film_c, packed))
    del cases
    torch.cuda.empty_cache()

    # 25. serve through the entry point a user calls: each render launches the
    # bf16 instance (counts zeroed just before, read just after); one render
    # with cr_film_f32; the card against the CPU and the bf16 render against
    # the float32 one, from the same offsets and noise
    reset_counts()
    renders = [synth16.render(requests, seed=0) for requests in (batch_requests, single_requests)]
    got = counts()
    newt.cr_film_f32 = True
    reset_counts()
    renders.append(synth16.render(single_requests, seed=0))
    got_f32_film = counts()
    newt.cr_film_f32 = False
    launches = {"cr_bf16": got["cr_bf16"], "cr_bf16_f32": got_f32_film["cr_bf16_f32"]}
    if (got["cr_bf16"], got["cr"], got["cr_bf16_f32"]) != (2, 0, 0) or (
            got_f32_film["cr_bf16_f32"], got_f32_film["cr"], got_f32_film["cr_bf16"]) != (1, 0, 0):
        raise RuntimeError(f"bf16 serve launches {got}, with cr_film_f32 {got_f32_film}")
    for audio in renders:
        for a in audio:
            if not np.all(np.isfinite(a)) or np.sqrt(np.mean(a**2)) < 1e-4:
                raise RuntimeError("a bf16 render is not finite or silent")
    f0_b, ctrl_b, _ = synth16.prepare(make_requests([2], seed=3))
    rng = np.random.default_rng(4)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, f0_b.shape[1] * HOP - 1).astype(np.float32)
    outs = {}
    for label, s in (("card_bf16", synth16), ("cpu_bf16", synth_with({"compute_dtype": "bfloat16"}, "cpu")),
                     ("card_f32", synth32)):
        with torch.inference_mode():
            y = s.model(torch.from_numpy(f0_b).to(s.device), torch.from_numpy(ctrl_b).to(s.device),
                        phase_offset=torch.from_numpy(offset).to(s.device),
                        noise=torch.from_numpy(noise).to(s.device))
        outs[label] = y.cpu().numpy()
    card_vs_cpu = nrms(outs["card_bf16"], outs["cpu_bf16"])
    vs_f32 = nrms(outs["card_bf16"], outs["card_f32"])
    emit({"phase": "serve_bf16", "requests_s": [2, 4, 4, 7, 4, 4], "launches": got,
          "launches_cr_film_f32": got_f32_film, "output_dtype": str(outs["card_bf16"].dtype),
          "rms": [float(np.sqrt(np.mean(a**2))) for au in renders for a in au],
          "nrms_card_vs_cpu": card_vs_cpu, "bar_card_vs_cpu": BF16_CARD_VS_CPU,
          "nrms_bf16_vs_f32": vs_f32, "bar_bf16_vs_f32": BF16_VS_F32, "floor_bf16_vs_f32": BF16_FLOOR})
    if outs["card_bf16"].dtype != np.float32:
        raise RuntimeError("the bf16 model does not return float32")
    if not card_vs_cpu <= BF16_CARD_VS_CPU or not BF16_FLOOR < vs_f32 < BF16_VS_F32:
        raise RuntimeError(f"bf16 render: card vs CPU {card_vs_cpu}, bf16 vs f32 {vs_f32}")
    del renders

    # 26. kernel 2's bf16 instances on the inputs one bf16 training step with
    # NEWT.fused = "full_lane_cr" hands them (without and with cr_film_f32),
    # then a hop whose last 32-sample lane group is partial
    dm = GeneralDataModule(root, batch_size=8)
    batch = dm.dataset("train").batch(np.arange(8))
    bwd_inputs, bwd_err = {}, {"bf16": 0.0, "bf16_f32": 0.0}
    for film_f32 in (False, True):
        model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0), compute_dtype="bfloat16")
        model.newt.fused, model.newt.cr_film_f32 = "full_lane_cr", film_f32
        trainer = Trainer(model, TrainConfig(), device="cuda")
        (exc, film_c, planes, dy, hop), = caught_launches(
            "_launch_backward", lambda: trainer.train_step(batch), first=1)
        key = instance_of(exc, film_c)
        bwd_inputs[key] = (exc, film_c, planes, dy, hop)
        bwd_err[key] = max(bwd_err[key], check_bf16_backward("train_step_b8_4s", exc, film_c, planes, dy, hop))
        e, f = made_up_kernel_inputs(2, 40, 33, 30 + film_f32, dev)
        g = torch.randn(e.shape, generator=torch.Generator().manual_seed(31)).to(dev, BF16)
        f = f if film_f32 else f.to(BF16)
        bwd_err[key] = max(bwd_err[key], check_bf16_backward("hop_33", e.to(BF16), f, planes, g, 33))
        del trainer, model
    torch.cuda.empty_cache()

    # 27. train through the CLI a user calls with the bf16 recipe as written
    # (the chain), with NEWT.fused = 'full_lane_cr', and with cr_film_f32 as
    # well: counts zeroed just before each run and read just after
    cli = load_train_cli()
    val_batches = len(list(dm.val_batches()))
    n_fwd = CLI_STEPS + val_batches * (CLI_STEPS // CLI_VAL_EVERY)
    zero = {k: 0 for k in ("cr", "bwd", "fl", "fl_bwd", "xcr", "xcr_bwd", "xfull", "xfull_bwd",
                           "cr_bf16", "bwd_bf16", "cr_bf16_f32", "bwd_bf16_f32")}
    runs = {"recipe": ([], zero),
            "full_lane_cr": (["-b", "NEWT.fused = 'full_lane_cr'"],
                             {**zero, "cr_bf16": n_fwd, "bwd_bf16": CLI_STEPS}),
            "full_lane_cr_film_f32": (["-b", "NEWT.fused = 'full_lane_cr'", "-b", "NEWT.cr_film_f32 = True"],
                                      {**zero, "cr_bf16_f32": n_fwd, "bwd_bf16_f32": CLI_STEPS})}
    for label, (extra, expect) in runs.items():
        args = ["--gin-file", "gin/train/train_newt_bf16.gin", "--dataset-path", root, "--device", "cuda",
                "--checkpoint-dir", str(tmp / f"cli_{label}_ckpt"), "--log-dir", str(tmp / f"cli_{label}_logs"),
                "-b", f"TrainConfig.max_steps = {CLI_STEPS}",
                "-b", f"TrainConfig.val_every_n_steps = {CLI_VAL_EVERY}",
                "-b", "TrainConfig.log_every_n_steps = 5", *extra]
        reset_counts()
        t0 = time.perf_counter()
        try:
            first = caught_launches("_launch_forward", lambda: cli.main(args), first=1)
            torch.cuda.synchronize()
        finally:
            gin.clear_config()
        cli_s = time.perf_counter() - t0
        got = counts()
        with open(tmp / f"cli_{label}_logs" / "metrics.csv") as f:
            table = list(csv.DictReader(f))
        losses = [float(r["train/loss"]) for r in table if r["train/loss"]]
        val = [float(r["val/loss"]) for r in table if r["val/loss"]]
        emit({"phase": "train_cli_bf16", "run": label, "steps": CLI_STEPS, "seconds": cli_s,
              "launches": got, "expected_launches": expect,
              "first_launch_io": instance_of(*first[0][:2]) if first else None,
              "train_loss_windows": losses, "val_loss": val})
        if any(got[k] != v for k, v in expect.items()):
            raise RuntimeError(f"train_cli_bf16 {label}: launches {got}, expected {expect}")
        if not losses or not val or not np.all(np.isfinite(losses + val)):
            raise RuntimeError(f"train_cli_bf16 {label}: the losses are not finite")
        for k in ("cr_bf16", "bwd_bf16", "cr_bf16_f32", "bwd_bf16_f32"):
            launches[k] = launches.get(k, 0) + got[k]

    # 28. timing: both kernels' bf16 instances beside their float32 instance
    # on the same shapes (the float32 copies of the same inputs), in turns,
    # with their plain versions and bounds; the training step (batch 8 x 4 s)
    # in float32 (full_lane_cr), in bf16 with the recipe's chain and with
    # full_lane_cr, in turns, with each arm's peak memory
    order = ["f32", "bf16", "bf16_f32", "bf16_f32", "bf16", "f32"]
    exc, film_c = timed_inputs["bf16"]
    hop = exc.shape[1] // film_c.shape[1]
    fwd_in = {"f32": (exc.float(), film_c.float()), "bf16": (exc, film_c),
              "bf16_f32": timed_inputs["bf16_f32"]}
    tree = nf.unpack_weight_grads(packed)
    with torch.inference_mode():
        fwd_ms = in_turns({k: (lambda e=e, f=f: nf._launch_forward(e, f, packed, hop))
                           for k, (e, f) in fwd_in.items()}, order)
        fwd_plain = {k: cuda_median_ms(lambda: nf.film_shaper_cr_plain(e, f, tree, hop))
                     for k, (e, f) in fwd_in.items()}
    e, f, planes, dy, bhop = bwd_inputs["bf16"]
    bwd_in = {"f32": (e.float(), f.float(), planes, dy.float(), bhop), "bf16": bwd_inputs["bf16"],
              "bf16_f32": bwd_inputs["bf16_f32"]}
    bwd_ms = in_turns({k: (lambda a=a: nf._launch_backward(*a)) for k, a in bwd_in.items()}, order)
    bwd_plain = {k: cuda_median_ms(lambda: nf.film_shaper_cr_grad_plain(
        a[0], a[1], nf.unpack_weight_grads(a[2]), a[4], a[3])) for k, a in bwd_in.items()}
    numbers = {}
    for k in ("f32", "bf16", "bf16_f32"):
        e, f = fwd_in[k]
        fb = bound(e.numel() * CR_FLOP_PER_ELEMENT, cr_bytes(e, f, packed))
        be, bf, bp, _, _ = bwd_in[k]
        bb = bound(be.numel() * CR_BWD_FLOP_PER_ELEMENT, cr_bytes(be, bf, bp, backward=True))
        numbers[k] = ((statistics.mean(fwd_ms[k]), fwd_plain[k], *fb),
                      (statistics.mean(bwd_ms[k]), bwd_plain[k], *bb))
    emit({"phase": "timing_kernel_bf16", "order": order, "fwd_shape": list(exc.shape), "hop": hop,
          "bwd_shape": list(bwd_in["bf16"][0].shape), "fwd_kernel_ms": fwd_ms, "fwd_plain_ms": fwd_plain,
          "bwd_kernel_ms": bwd_ms, "bwd_plain_ms": bwd_plain,
          "fwd_bound_ms": {k: v[0][2] for k, v in numbers.items()},
          "fwd_bound_by": {k: v[0][3] for k, v in numbers.items()},
          "bwd_bound_ms": {k: v[1][2] for k, v in numbers.items()},
          "bwd_bound_by": {k: v[1][3] for k, v in numbers.items()},
          "fwd_bytes": {k: cr_bytes(*fwd_in[k], packed) for k in fwd_in},
          "bwd_bytes": {k: cr_bytes(a[0], a[1], a[2], backward=True) for k, a in bwd_in.items()}})
    del timed_inputs, fwd_in, bwd_in, bwd_inputs
    torch.cuda.empty_cache()
    arms = {"f32_full_lane_cr": ("float32", "full_lane_cr"), "bf16_chain": ("bfloat16", None),
            "bf16_full_lane_cr": ("bfloat16", "full_lane_cr")}
    trainers = {}
    for arm, (cd, fused) in arms.items():
        model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0), compute_dtype=cd)
        model.newt.fused = fused
        trainers[arm] = Trainer(model, TrainConfig(), device="cuda")
    step, peak = {}, {}
    turns = ["f32_full_lane_cr", "bf16_chain", "bf16_full_lane_cr", "bf16_full_lane_cr", "bf16_chain",
             "f32_full_lane_cr"] * 3
    for arm in turns:
        step.setdefault(arm, []).append(cuda_median_ms(lambda: trainers[arm].train_step(batch)))
        torch.cuda.reset_peak_memory_stats()
        trainers[arm].train_step(batch)
        torch.cuda.synchronize()
        peak.setdefault(arm, []).append(torch.cuda.max_memory_allocated())
    emit({"phase": "timing_bf16_step", "batch": [8, int(batch["f0"].shape[1])], "order": turns, "step_ms": step,
          "step_peak_mem_bytes": peak,
          "x_realtime": {a: [32.0 / (t / 1e3) for t in v] for a, v in step.items()}})
    del trainers
    torch.cuda.empty_cache()
    return {"launches": launches, "fwd_err": fwd_err, "bwd_err": bwd_err, "numbers": numbers}


def recipe_model(seed):
    """The shipped architecture from a seeded init, with the recipe's
    ``NEWT.fused = 'full_lane_cr'`` (kernels 1 and 2 at hop 128)."""
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(seed))
    model.newt.fused = "full_lane_cr"
    return model


def train_state_snapshot(trainer):
    """Every tensor and counter of a trainer's training state, on the CPU."""
    opt = trainer.optimizer
    snap = {f"param{i}": p.detach().cpu().clone() for i, p in enumerate(opt.params)}
    for i, p in enumerate(opt.params):
        for key, value in opt.adam.state[p].items():
            snap[f"adam{i}/{key}"] = value.detach().cpu().clone()
    snap["lr"] = opt.adam.param_groups[0]["lr"]
    snap["schedule"] = opt.schedule.state_dict()
    snap["step"] = trainer.step
    return snap


def snapshot_differences(a, b):
    """The entries of two snapshots that are not the same bits."""
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        return x == y
    return sorted(k for k in a.keys() | b.keys() if k not in a or k not in b or not same(a[k], b[k]))


def max_rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def counted(fn, expect):
    """Run fn with every count zeroed just before and read just after ->
    (its result, the counts, seconds); raises unless the counts are
    ``expect`` and every other kernel's is 0."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    wrong = {k: v for k, v in got.items() if v != expect.get(k, 0)}
    if wrong:
        raise RuntimeError(f"launches {got}, expected {expect}")
    return out, got, seconds


def runtime_phases(dev, root, tmp):
    """Phases 29-31 (the training runtime: resume, lazy loading, batch
    resynthesis) -> the launches of kernels 1, 2 and 4 in them."""
    launches = {"cr": 0, "bwd": 0, "lookup": 0}
    dm = GeneralDataModule(root, batch_size=8)
    val_batches = dm.n_batches("val")

    def cfg(steps, folder):
        return TrainConfig(max_steps=steps, val_every_n_steps=RESUME_VAL_EVERY,
                           log_every_n_steps=RESUME_VAL_EVERY, keep_n_checkpoints=2,
                           checkpoint_dir=str(tmp / folder))

    def fit(trainer, steps, restore=False):
        vals = steps // RESUME_VAL_EVERY
        history, got, seconds = counted(lambda: trainer.fit(dm, restore=restore),
                                        {"cr": steps + val_batches * vals, "bwd": steps})
        launches["cr"] += got["cr"]
        launches["bwd"] += got["bwd"]
        return history, seconds

    # 29. train_resume: uninterrupted twice, then to RESUME_AT and, from a
    # model of another seed, fit(restore=True) to RESUME_STEPS
    twins = []
    for name in ("twin_a", "twin_b"):
        history, seconds = fit(Trainer(recipe_model(0), cfg(RESUME_STEPS, name), device="cuda"),
                               RESUME_STEPS)
        twins.append((history, seconds))
    first = Trainer(recipe_model(0), cfg(RESUME_AT, "parts"), device="cuda")
    head, head_s = fit(first, RESUME_AT)
    saved = train_state_snapshot(first)
    probe = Trainer(recipe_model(5), cfg(RESUME_STEPS, "parts"), device="cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        probe.restore()
    restored_diff = snapshot_differences(saved, train_state_snapshot(probe))
    del probe
    resumed = Trainer(recipe_model(5), cfg(RESUME_STEPS, "parts"), device="cuda")
    tail, tail_s = fit(resumed, RESUME_STEPS - RESUME_AT, restore=True)
    a, b = twins[0][0]["loss"], twins[1][0]["loss"]
    twins_bitwise = a == b
    twins_rel = max_rel(b, a)
    resumed_rel = max_rel(tail["loss"], a[RESUME_AT:])
    head_rel = max_rel(head["loss"], a[:RESUME_AT])
    bar = 0.0 if twins_bitwise else 2 * twins_rel + 1e-6
    files = sorted(p.name for p in (tmp / "parts").glob("*.ckpt"))
    emit({"phase": "train_resume", "B": 8, "clip_s": 4.0, "steps": RESUME_STEPS,
          "resumed_at": RESUME_AT, "val_every": RESUME_VAL_EVERY, "keep_n": 2,
          "restored_entries": len(saved), "restored_not_bit_equal": restored_diff,
          "twins_bit_identical": twins_bitwise, "twins_max_rel": twins_rel,
          "resumed_max_rel": resumed_rel, "head_max_rel": head_rel, "bar": bar,
          "resumed_bit_identical": tail["loss"] == a[RESUME_AT:],
          "fit_s": {"twin_a": twins[0][1], "twin_b": twins[1][1], "head": head_s, "tail": tail_s},
          "val": {"twin_a": twins[0][0]["val"], "resumed": head["val"] + tail["val"]},
          "checkpoints": files, "step": resumed.step})
    if restored_diff:
        raise RuntimeError(f"train_resume: restored state differs from the saved one in {restored_diff}")
    if resumed.step != RESUME_STEPS or len(tail["loss"]) != RESUME_STEPS - RESUME_AT:
        raise RuntimeError(f"train_resume: ended at step {resumed.step}")
    if not np.all(np.isfinite(a + b + tail["loss"])) or resumed_rel > bar:
        raise RuntimeError(f"train_resume: resumed losses {resumed_rel} from the uninterrupted run, bar {bar}")

    # ... and what a validation's checkpoints cost: last.ckpt written, the
    # step save and best.ckpt copied from it (each call a new best)
    resumed.cfg = dataclasses.replace(resumed.cfg, checkpoint_dir=str(tmp / "write_probe"))
    resumed.saves, resumed.best_val_loss = {}, float("inf")
    train = dm.dataset("train")
    write_ms = []
    for i in range(7):
        resumed.step = RESUME_STEPS + i
        t0 = time.perf_counter()
        resumed.write_checkpoints(1.0 - 0.01 * i, train.data_mean, train.data_std)
        write_ms.append((time.perf_counter() - t0) * 1e3)
    ckpt_bytes = (tmp / "write_probe" / "last.ckpt").stat().st_size
    emit({"phase": "checkpoint_write", "files_per_validation": 3, "ckpt_bytes": ckpt_bytes,
          "write_ms_median": statistics.median(write_ms[2:]), "write_ms": write_ms})
    del resumed, first

    # 30. train_cli_resume: the CLI with the recipe, 10 steps in memory and
    # lazily, then the lazy run restored to 20
    cli = load_train_cli()

    def cli_run(folder, steps, *extra):
        args = ["--gin-file", "gin/train/train_newt.gin", "--dataset-path", root, "--device", "cuda",
                "--checkpoint-dir", str(tmp / folder / "ck"), "--log-dir", str(tmp / folder / "logs"),
                "-b", f"TrainConfig.max_steps = {steps}",
                "-b", f"TrainConfig.val_every_n_steps = {RESUME_VAL_EVERY}",
                "-b", f"TrainConfig.log_every_n_steps = {RESUME_VAL_EVERY}", *extra]
        out = io.StringIO()
        vals = RESUME_AT // RESUME_VAL_EVERY
        try:
            with contextlib.redirect_stdout(out):
                _, got, seconds = counted(lambda: cli.main(args),
                                          {"cr": RESUME_AT + val_batches * vals, "bwd": RESUME_AT})
        finally:
            gin.clear_config()
        launches["cr"] += got["cr"]
        launches["bwd"] += got["bwd"]
        with open(tmp / folder / "logs" / "metrics.csv") as f:
            table = list(csv.DictReader(f))
        return out.getvalue(), table, seconds

    def steps_s(table, first_step):
        """The train windows' seconds from their steps_per_sec."""
        rows = [r for r in table if r["train/loss"] and int(r["step"]) > first_step]
        return sum(RESUME_VAL_EVERY / float(r["train/steps_per_sec"]) for r in rows)

    # eager and lazy 10-step runs in turns, each in a directory of its own;
    # the last lazy run's directory is the one resumed
    loader_s = {"eager": [], "lazy": []}
    for turn in range(CLI_TURNS):
        for loader in ("eager", "lazy"):
            folder = "cli_lazy" if (loader, turn) == ("lazy", CLI_TURNS - 1) else f"cli_{loader}{turn}"
            extra = ("--no-load-data-to-memory",) if loader == "lazy" else ()
            _, head_table, _ = cli_run(folder, RESUME_AT, *extra)
            loader_s[loader].append(steps_s(head_table, 0))
    text, table, resume_s = cli_run("cli_lazy", RESUME_STEPS, "--no-load-data-to-memory",
                                    "--restore-checkpoint")
    train_steps = [int(r["step"]) for r in table if r["train/loss"]]
    val_rows = [(int(r["step"]), float(r["val/loss"])) for r in table if r["val/loss"]]
    best_step, best_val = (load_lightning_checkpoint(str(tmp / "cli_lazy" / "ck" / "best.ckpt"))[k]
                           for k in ("global_step", "val_loss"))
    losses = [float(r["train/loss"]) for r in table if r["train/loss"]]
    resumed_line = f"[trainer] resumed from step {RESUME_AT}"
    emit({"phase": "train_cli_resume", "resumed": resumed_line in text,
          "finished": f"[train] finished at step {RESUME_STEPS}" in text,
          "train_steps": train_steps, "val": val_rows, "best": [best_step, best_val],
          "checkpoints": sorted(p.name for p in (tmp / "cli_lazy" / "ck").glob("*.ckpt")),
          "turns": CLI_TURNS, "eager_10_steps_s": loader_s["eager"],
          "lazy_10_steps_s": loader_s["lazy"],
          "eager_10_steps_s_median": statistics.median(loader_s["eager"]),
          "lazy_10_steps_s_median": statistics.median(loader_s["lazy"]),
          "resumed_10_steps_s": steps_s(table, RESUME_AT), "resume_call_s": resume_s})
    expect_steps = list(range(RESUME_VAL_EVERY, RESUME_STEPS + 1, RESUME_VAL_EVERY))
    if resumed_line not in text or f"[train] finished at step {RESUME_STEPS}" not in text:
        raise RuntimeError("train_cli_resume: the CLI did not resume at step 10 and end at 20")
    if train_steps != expect_steps or [s for s, _ in val_rows] != expect_steps:
        raise RuntimeError(f"train_cli_resume: CSV steps {train_steps}, val {val_rows}")
    if best_val != min(v for _, v in val_rows) or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"train_cli_resume: best.ckpt val_loss {best_val}, logged {val_rows}")

    # 31. resynth_cli: the test split (two batches of the script's default
    # 8) through the lazy run's best-on-val save, with kernel 1 and with
    # FastNEWT (kernel 4): once on the CPU, then one untimed and
    # RESYNTH_CALLS timed calls of each arm on the card, in turns
    spec = importlib.util.spec_from_file_location(
        "torch_resynthesise_dataset", REPO / "scripts" / "torch_resynthesise_dataset.py")
    resynth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(resynth)
    n_test = len(dm.dataset("test"))
    batches = -(-n_test // 8)
    arms = {"cr": False, "fast_newt": True}

    def resynth_run(label, device):
        argv = ["--dataset-path", root, "--checkpoint", str(tmp / "cli_lazy" / "ck"),
                "--output-path", str(tmp / f"resynth_{label}_{device}"), "--device", device]
        argv += ["--use-fast-newt"] if arms[label] else []
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                if device == "cpu":
                    return resynth.run(argv)
                expect = {"lookup": batches} if arms[label] else {"cr": batches}
                result, got, _ = counted(lambda: resynth.run(argv), expect)
        finally:
            gin.clear_config()
        launches["cr"] += got["cr"]
        launches["lookup"] += got["lookup"]
        return result

    cpu = {label: resynth_run(label, "cpu") for label in arms}
    card = {label: [] for label in arms}
    for _ in range(1 + RESYNTH_CALLS):
        for label in arms:
            card[label].append(resynth_run(label, "cuda"))
    clip_s = len(cpu["cr"]["outputs"][0]) / SR
    medians = {}
    for label in arms:
        runs = card[label]
        warm = runs[1:]
        call_x = [n_test * clip_s / r["render_s"] for r in warm]
        batch_x = [min(8, n_test - 8 * k) * clip_s / t for r in warm for k, t in enumerate(r["batch_s"])]
        medians[label] = statistics.median(call_x)
        per_clip = [nrms(x, y) for x, y in zip(runs[-1]["outputs"], cpu[label]["outputs"])]
        wavs = sorted(p.name for p in (tmp / f"resynth_{label}_cuda").iterdir())
        emit({"phase": "resynth_cli", "case": label, "clips": n_test, "clip_s": clip_s,
              "batch_size": 8, "checkpoint": Path(runs[-1]["checkpoint"]).name,
              "launches_per_call": batches, "nrms_card_vs_cpu_max": max(per_clip), "bar": 1e-3,
              "mean_stft_distance": float(np.mean(runs[-1]["distances"])),
              "mean_stft_distance_cpu": float(np.mean(cpu[label]["distances"])),
              "warm_calls": len(warm), "x_realtime_calls": call_x,
              "x_realtime_median": medians[label], "x_realtime_min": min(call_x),
              "x_realtime_max": max(call_x), "x_realtime_batch_median": statistics.median(batch_x),
              "x_realtime_first_call": n_test * clip_s / runs[0]["render_s"],
              "cpu_render_s": cpu[label]["render_s"], "wavs": len(wavs)})
        if Path(runs[-1]["checkpoint"]).name != "best.ckpt" or len(wavs) != 2 * n_test:
            raise RuntimeError(f"resynth_cli {label}: {runs[-1]['checkpoint']}, {len(wavs)} wavs")
        if any(r["distances"] != runs[0]["distances"] for r in runs):
            raise RuntimeError(f"resynth_cli {label}: the calls on the card differ")
        if not max(per_clip) <= 1e-3 or not np.all(np.isfinite(runs[-1]["distances"])):
            raise RuntimeError(f"resynth_cli {label}: card vs CPU nRMS {per_clip}")
    emit({"phase": "resynth_cli", "case": "fast_newt_over_cr",
          "x_realtime_median_ratio": medians["fast_newt"] / medians["cr"]})
    return launches


def write_wav_corpus(root: Path, seed=0) -> list:
    """A small wav corpus made here with numpy and scipy -> its files:
    four 16-s 16-kHz int16 mono tones (five harmonics, f0 gliding within
    110-660 Hz) with a 1-s rest of faint noise in their second 4-s window,
    a 12-s 44.1-kHz int16 stereo tone (so the resampler and the downmix
    run) and 8 s of noise (which the confidence filter drops)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for i in range(4):
        f0 = np.geomspace(*np.sort(rng.uniform(110.0, 660.0, 2)), 16 * SR)
        phase = 2 * np.pi * np.cumsum(f0) / SR
        x = (0.15 + 0.1 * rng.uniform()) * sum(np.sin(k * phase) / k for k in range(1, 6))
        x[5 * SR : 6 * SR] = 1e-4 * rng.standard_normal(SR)
        wavfile.write(root / f"tone{i}.wav", SR, (x * 32767).astype(np.int16))
    t = np.arange(12 * 44100) / 44100
    stereo = np.stack([0.5 * np.sin(2 * np.pi * 247 * t) + 0.1 * np.sin(2 * np.pi * 494 * t),
                       0.3 * np.sin(2 * np.pi * 370 * t)], axis=-1)
    wavfile.write(root / "stereo44k.wav", 44100, (stereo * 32767).astype(np.int16))
    wavfile.write(root / "noise.wav", SR, (0.05 * rng.standard_normal(8 * SR) * 32767).astype(np.int16))
    return sorted(str(p) for p in root.iterdir())


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def shards_of(root: Path) -> dict:
    """A shard tree -> {relative path: array}, the control shards back in
    physical units with the tree's own statistics."""
    mean, std = np.load(root / "data_mean.npy"), np.load(root / "data_std.npy")
    out = {}
    for p in sorted(root.rglob("*.npy")):
        name = str(p.relative_to(root))
        if not name.startswith("data_"):
            x = np.load(p)
            out[name] = x * std + mean if "/control/" in name else x
    return out


def tree_differences(card: Path, cpu: Path) -> dict:
    """The card's shard tree against the CPU's, per quantity: the largest
    difference, over voiced frames (the CPU's confidence > 0.5) for f0
    (relative) and confidence."""
    a, b = shards_of(card), shards_of(cpu)
    if sorted(a) != sorted(b):
        raise RuntimeError(f"preprocess_dataset: the trees hold different files: {sorted(set(a) ^ set(b))}")
    diff = {"audio": 0.0, "f0_rel": 0.0, "loudness": 0.0, "confidence": 0.0, "mfcc": 0.0}
    for name, x in a.items():
        y = b[name]
        if x.shape != y.shape or not np.all(np.isfinite(x)):
            raise RuntimeError(f"preprocess_dataset: {name} {x.shape} vs {y.shape}")
        if "/audio/" in name:
            diff["audio"] = max(diff["audio"], float(np.abs(x - y).max()))
            continue
        voiced = y[2] > 0.5
        diff["f0_rel"] = max(diff["f0_rel"], float((np.abs(x[0] - y[0]) / y[0])[voiced].max(initial=0.0)))
        diff["loudness"] = max(diff["loudness"], float(np.abs(x[1] - y[1]).max()))
        diff["confidence"] = max(diff["confidence"], float(np.abs(x[2] - y[2])[voiced].max(initial=0.0)))
        diff["mfcc"] = max(diff["mfcc"], float(np.abs(x[3:] - y[3:]).max()))
    (mean_a, std_a), (mean_b, std_b) = ((np.load(r / "data_mean.npy"), np.load(r / "data_std.npy"))
                                        for r in (card, cpu))
    diff["data_mean_per_std"] = float((np.abs(mean_a - mean_b) / std_b).max())  # means near 0 too
    diff["data_std_rel"] = float((np.abs(std_a - std_b) / std_b).max())
    return diff


def decoded(fn):
    """Run fn with ``models.crepe.viterbi_decode`` wrapped -> (its result,
    the posteriorgrams and the bins of every decode in it, on the host)."""
    seen = []
    decode = crepe.viterbi_decode

    def spy(probs, *args, **kwargs):
        bins = decode(probs, *args, **kwargs)
        seen.append((probs.detach().clone(), bins.cpu().numpy()))
        return bins

    crepe.viterbi_decode = spy
    try:
        return fn(), seen
    finally:
        crepe.viterbi_decode = decode


def compare_f0(label, card, cpu, periodicity_atol) -> dict:
    """An extractor's ((f0, periodicity), decodes) on the card against the
    CPU's: the share of frames whose bin differs, f0 relative and
    periodicity absolute differences where the bins agree."""
    (f0_a, per_a), dec_a = card
    (f0_b, per_b), dec_b = cpu
    n = f0_a.shape[0]  # pYIN decodes the frames of the clip's padding too
    bins_a, bins_b = dec_a[-1][1][:n], dec_b[-1][1][:n]
    same = bins_a == bins_b
    f0_a, per_a, f0_b, per_b = (t.cpu().numpy() for t in (f0_a, per_a, f0_b, per_b))
    out = {"frames": int(len(bins_a)), "bins_differ": float(1.0 - same.mean()),
           "f0_rel": float((np.abs(f0_a - f0_b) / f0_b)[same].max()),
           "periodicity": float(np.abs(per_a - per_b)[same].max()), "bar_periodicity": periodicity_atol,
           "bar_f0_rel": PRE_BARS["f0_rtol"], "bar_bins_differ": PRE_BARS["bins_differ_max"]}
    if not (out["bins_differ"] <= PRE_BARS["bins_differ_max"] and out["f0_rel"] <= PRE_BARS["f0_rtol"]
            and out["periodicity"] <= periodicity_atol and np.all(np.isfinite(f0_a))):
        raise RuntimeError(f"{label}: card vs CPU {out}")
    return out


def random_crepe_pth(path: Path, seed=0) -> str:
    """Random full-capacity CREPE weights in torchcrepe's state-dict layout
    (the repo holds no pretrained ones), saved as a .pth."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in crepe.Crepe("full").state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith("running_var"):
            v = 1.0 + 0.1 * rng.random(t.shape)
        elif name.endswith("BN.weight"):
            v = 1.0 + 0.1 * rng.standard_normal(t.shape)
        else:
            v = 0.05 * rng.standard_normal(t.shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    torch.save(sd, path)
    return str(path)


def vibrato_tone(seconds, seed):
    """A 16-kHz tone with vibrato, five harmonics and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 220.0 * 2 ** (np.sin(2 * np.pi * 0.1 * t) + 0.02 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = 0.3 * sum(np.sin(k * phase) / k for k in range(1, 6)) + 3e-3 * rng.standard_normal(t.shape)
    return torch.from_numpy(x.astype(np.float32))


def synced_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def median_s(fn, runs=PRE_TIMED_RUNS):
    fn()  # warm-up: cuDNN plans, allocator
    return statistics.median(synced_s(fn)[1] for _ in range(runs))


def launches_of(fn):
    """Device kernels one call launches, from the profiler's trace (None
    where the trace shows no device event)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def preprocess_phases(dev, tmp):
    """Phases 32-36 (preprocessing: wavs to shards on the card, pYIN and
    CREPE card vs CPU, training from the created shards, the extractors'
    times) -> the launches of kernels 1 and 2 in the training run."""
    files = write_wav_corpus(tmp / "wavs")
    audio_s = sum(len(a) / sr for sr, a in map(wavfile.read, files))
    create = load_script("torch_create_dataset")

    def create_cli(out, device, *extra):
        args = ["--data-directory", str(tmp / "wavs"), "--output-directory", str(out),
                "--device", device, "-b", "preprocess_audio.verbose = False", *extra]
        gin.clear_config()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                return synced_s(lambda: create.main(args))[1]
        finally:
            gin.clear_config()

    # 32. preprocess_dataset: the data gin file with YIN, on the card (the
    # process's first build, then again warm) and on the CPU, through
    # scripts/torch_create_dataset.py
    build_s = {name: create_cli(tmp / f"shards_{name}", device, "--f0-extractor", "yin")
               for name, device in (("cold", "cuda"), ("cuda", "cuda"), ("cpu", "cpu"))}
    card_root, cpu_root = tmp / "shards_cuda", tmp / "shards_cpu"
    n = {s: len(list((card_root / s / "audio").iterdir())) for s in ("train", "val", "test")}
    diff = tree_differences(card_root, cpu_root)
    repeat_differs = sum((card_root / p.relative_to(tmp / "shards_cold")).read_bytes() != p.read_bytes()
                         for p in (tmp / "shards_cold").rglob("*.npy"))
    bars = {"audio": PRE_BARS["audio_atol"], "f0_rel": PRE_BARS["f0_rtol"],
            "loudness": PRE_BARS["loudness_atol"], "confidence": PRE_BARS["confidence_atol"],
            "mfcc": PRE_BARS["mfcc_atol"], "data_mean_per_std": PRE_BARS["stats_rtol"],
            "data_std_rel": PRE_BARS["stats_rtol"]}
    emit({"phase": "preprocess_dataset", "extractor": "yin", "files": len(files), "audio_s": audio_s,
          "segments": n, "card_cold_s": build_s["cold"], "card_s": build_s["cuda"],
          "cpu_s": build_s["cpu"], "card_vs_cpu": diff, "bars": bars,
          "card_repeat_files_not_bit_identical": repeat_differs})
    if n["train"] < 8 or n["val"] < 1 or any(diff[k] > bars[k] for k in bars):
        raise RuntimeError(f"preprocess_dataset: segments {n}, card vs CPU {diff}")

    # 33. preprocess_pyin: the extractor on the card against the CPU
    clip = vibrato_tone(4, 1)
    pyin = {d: decoded(lambda d=d: extract_f0_with_pyin(clip.to(d))) for d in ("cuda", "cpu")}
    emit({"phase": "preprocess_pyin", "clip_s": 4,
          **compare_f0("preprocess_pyin", pyin["cuda"], pyin["cpu"], PRE_BARS["periodicity_atol"])})

    # 34. preprocess_crepe: random full weights in torchcrepe's layout from a
    # .pth, bound as --crepe-weights binds them: the extractor on the card
    # against the CPU, then the CLI on the card with CREPE
    pth = random_crepe_pth(tmp / "crepe_full.pth")
    gin.bind_parameter("extract_f0_with_crepe.weights_path", pth)
    try:
        short = clip[:SR]
        crepe_out = {d: decoded(lambda d=d: extract_f0_with_crepe(short.to(d))) for d in ("cuda", "cpu")}
    finally:
        gin.clear_config()
    crepe_cmp = compare_f0("preprocess_crepe", crepe_out["cuda"], crepe_out["cpu"],
                           PRE_BARS["crepe_periodicity_atol"])
    crepe_s = create_cli(tmp / "shards_crepe", "cuda", "--f0-extractor", "crepe", "--crepe-weights", pth,
                         "-b", "preprocess_audio.confidence_threshold = -1.0")
    crepe_shards = shards_of(tmp / "shards_crepe")
    f0_finite = all(np.all(np.isfinite(x)) for x in crepe_shards.values())
    emit({"phase": "preprocess_crepe", "capacity": "full", "clip_s": 1, **crepe_cmp,
          "cli_card_s": crepe_s, "cli_shards": len(crepe_shards), "cli_finite": f0_finite})
    if not crepe_shards or not f0_finite:
        raise RuntimeError(f"preprocess_crepe: the CLI wrote {len(crepe_shards)} shards, finite {f0_finite}")

    # 35. train_from_created: 5 CLI steps on the card from the YIN tree
    cli = load_train_cli()
    val_batches = GeneralDataModule(str(card_root), batch_size=8).n_batches("val")
    args = ["--gin-file", "gin/train/train_newt.gin", "--dataset-path", str(card_root),
            "--device", "cuda", "--checkpoint-dir", str(tmp / "created" / "ck"),
            "--log-dir", str(tmp / "created" / "logs"), "-b", "TrainConfig.max_steps = 5",
            "-b", "TrainConfig.val_every_n_steps = 5", "-b", "TrainConfig.log_every_n_steps = 1"]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, got, seconds = counted(lambda: cli.main(args), {"cr": 5 + val_batches, "bwd": 5})
    finally:
        gin.clear_config()
    with open(tmp / "created" / "logs" / "metrics.csv") as f:
        losses = [float(r["train/loss"]) for r in csv.DictReader(f) if r["train/loss"]]
    emit({"phase": "train_from_created", "steps": 5, "batch": 8, "losses": losses,
          "launches": got, "seconds": seconds})
    if len(losses) != 5 or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"train_from_created: losses {losses}")

    # 36. timing_preprocess: seconds per second of audio of each extractor
    # on the card at 4 and 60 s, and the Viterbi decode's share of it
    model = crepe.load_weights(pth).to(dev)
    gin.bind_parameter("extract_f0_with_crepe.weights_path", pth)
    try:
        for seconds_ in PRE_TIMED_S:
            x = vibrato_tone(seconds_, 2).to(dev)
            row = {"phase": "timing_preprocess", "clip_s": seconds_, "frames": 1 + x.shape[0] // HOP}
            for name, fn in (("yin", extract_f0_with_yin), ("pyin", extract_f0_with_pyin),
                             ("crepe_full", extract_f0_with_crepe)):
                row[name + "_s_per_s"] = median_s(lambda fn=fn: fn(x)) / seconds_
                if name != "yin":
                    probs = decoded(lambda fn=fn: fn(x))[1][-1][0]
                    viterbi_s = median_s(lambda: crepe.viterbi_decode(probs))
                    row[name + "_viterbi_s"] = viterbi_s
                    row[name + "_viterbi_share"] = viterbi_s / (row[name + "_s_per_s"] * seconds_)
            frames = crepe.frame_audio(x, HOP)
            with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                cnn_s = median_s(lambda: torch.cat([model(frames[i : i + 2048])
                                                    for i in range(0, frames.shape[0], 2048)]))
            row["crepe_full_cnn_s"] = cnn_s
            row["crepe_full_cnn_tflop_per_s"] = CREPE_FULL_FLOP_PER_FRAME * frames.shape[0] / cnn_s / 1e12
            if seconds_ == PRE_TIMED_S[0]:
                row["viterbi_launches"] = launches_of(lambda: crepe.viterbi_decode(probs))
            emit(row)
    finally:
        gin.clear_config()
    emit({"phase": "timing_preprocess", "case": "create_dataset_yin", "audio_s": audio_s,
          "card_cold_s_per_s": build_s["cold"] / audio_s,
          "card_s_per_s": build_s["cuda"] / audio_s, "cpu_s_per_s": build_s["cpu"] / audio_s,
          "crepe_cli_card_s_per_s": crepe_s / audio_s,
          "crepe_full_flop_per_frame": CREPE_FULL_FLOP_PER_FRAME})
    return {"cr": got["cr"], "bwd": got["bwd"]}


def audio_rate_bf16_phases(dev, root, tmp):
    """Phases 37-40 (kernels 5 and 6's bf16 instances: NEWT's audio-rate
    path under compute_dtype = "bfloat16") -> their numbers."""
    synth16 = synth_with({"compute_dtype": "bfloat16"})
    synth32 = Synthesizer.from_checkpoint(CKPT, device="cuda")
    newt = synth16.model.newt
    with torch.no_grad():
        packed = newt._packed_shaper(BF16)
    batch_requests, single_requests = make_requests([2, 4, 4, 7], seed=1), make_requests([4], seed=2)
    timed = make_requests([4] * 8, 6)
    launches = {"fl_bf16": 0, "fl_bwd_bf16": 0}

    def run_counted(fn, **expect):  # counted, every other kernel 0, and summed
        out, got, _ = counted(fn, expect)
        for k in launches:
            launches[k] += got[k]
        return out

    # 37. serve_bf16_fl: a bf16 Synthesizer renders with NEWT.fused =
    # "full_lane" (one launch of kernel 5's bf16 instance a render, nothing
    # else); the card against the CPU (its plain version) and the bf16 render
    # against the float32 one, from the same offsets and noise
    renders = [run_counted(lambda r=r: render_with(synth16, r, "full_lane")[0], fl_bf16=1)
               for r in (batch_requests, single_requests)]
    for audio in renders:
        for a in audio:
            if not np.all(np.isfinite(a)) or np.sqrt(np.mean(a**2)) < 1e-4:
                raise RuntimeError("a bf16 full_lane render is not finite or silent")
    f0_b, ctrl_b, _ = synth16.prepare(make_requests([2], seed=3))
    rng = np.random.default_rng(4)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, f0_b.shape[1] * HOP - 1).astype(np.float32)
    outs = {}
    for label, s in (("card_bf16", synth16), ("cpu_bf16", synth_with({"compute_dtype": "bfloat16"}, "cpu")),
                     ("card_f32", synth32)):
        s.model.newt.fused = "full_lane"
        try:
            with torch.inference_mode():
                y = s.model(torch.from_numpy(f0_b).to(s.device), torch.from_numpy(ctrl_b).to(s.device),
                            phase_offset=torch.from_numpy(offset).to(s.device),
                            noise=torch.from_numpy(noise).to(s.device))
        finally:
            s.model.newt.fused = "cr"
        outs[label] = y.cpu().numpy()
    card_vs_cpu = nrms(outs["card_bf16"], outs["cpu_bf16"])
    vs_f32 = nrms(outs["card_bf16"], outs["card_f32"])
    emit({"phase": "serve_bf16_fl", "requests_s": [2, 4, 4, 7, 4], "launches_fl_bf16": launches["fl_bf16"],
          "rms": [float(np.sqrt(np.mean(a**2))) for au in renders for a in au],
          "nrms_card_vs_cpu": card_vs_cpu, "bar_card_vs_cpu": BF16_CARD_VS_CPU,
          "nrms_bf16_vs_f32": vs_f32, "bar_bf16_vs_f32": BF16_VS_F32, "floor_bf16_vs_f32": BF16_FLOOR})
    if not card_vs_cpu <= BF16_CARD_VS_CPU or not BF16_FLOOR < vs_f32 < BF16_VS_F32:
        raise RuntimeError(f"bf16 full_lane render: card vs CPU {card_vs_cpu}, bf16 vs f32 {vs_f32}")
    del renders

    # 38. train_cli_bf16_fl: the bf16 recipe through the CLI with NEWT.fused =
    # 'full_lane', 20 steps with validation: kernels 5 and 6's bf16 instances
    # only, counted; the first step's kernel inputs caught. Then the
    # "full_lane_cr" fallback at Ta=130, Tc=4: one bf16 NEWT step, counted
    cli = load_train_cli()
    val_batches = len(list(GeneralDataModule(root, batch_size=8).val_batches()))
    n_fwd = CLI_STEPS + val_batches * (CLI_STEPS // CLI_VAL_EVERY)
    args = ["--gin-file", "gin/train/train_newt_bf16.gin", "--dataset-path", root, "--device", "cuda",
            "--checkpoint-dir", str(tmp / "cli_bf16_fl_ckpt"), "--log-dir", str(tmp / "cli_bf16_fl_logs"),
            "-b", "NEWT.fused = 'full_lane'", "-b", f"TrainConfig.max_steps = {CLI_STEPS}",
            "-b", f"TrainConfig.val_every_n_steps = {CLI_VAL_EVERY}",
            "-b", "TrainConfig.log_every_n_steps = 5"]
    step_fwd, step_bwd = [], []
    t0 = time.perf_counter()
    try:
        run_counted(lambda: step_bwd.extend(caught_launches(
            "_launch_backward_fl", lambda: step_fwd.extend(
                caught_launches("_launch_forward_fl", lambda: cli.main(args), first=1)), first=1)),
            fl_bf16=n_fwd, fl_bwd_bf16=CLI_STEPS)
    finally:
        gin.clear_config()
    cli_s = time.perf_counter() - t0
    with open(tmp / "cli_bf16_fl_logs" / "metrics.csv") as f:
        table = list(csv.DictReader(f))
    losses = [float(r["train/loss"]) for r in table if r["train/loss"]]
    val = [float(r["val/loss"]) for r in table if r["val/loss"]]
    emit({"phase": "train_cli_bf16_fl", "steps": CLI_STEPS, "seconds": cli_s,
          "launches": {"fl_bf16": n_fwd, "fl_bwd_bf16": CLI_STEPS},
          "first_launch_dtypes": [str(t.dtype) for t in step_fwd[0][:2]],
          "train_loss_windows": losses, "val_loss": val})
    if not losses or not val or not np.all(np.isfinite(losses + val)):
        raise RuntimeError("train_cli_bf16_fl: the losses are not finite")
    rng = np.random.default_rng(12)
    emb = torch.from_numpy(rng.standard_normal((1, 4, 128)).astype(np.float32)).to(dev)
    exc130 = torch.from_numpy((rng.standard_normal((1, 130, 64)) * 0.5).astype(np.float32)).to(dev, BF16)
    fallback = NeuralWaveshaping(generator=torch.Generator().manual_seed(0), compute_dtype="bfloat16").newt
    fallback.fused = "full_lane_cr"
    fallback.to(dev)

    fb_out = []

    def fallback_step():
        fb_out.append(fallback(exc130, emb))
        fb_out[0].float().square().sum().backward()

    fb_fwd, fb_bwd = [], []
    run_counted(lambda: fb_bwd.extend(caught_launches(
        "_launch_backward_fl", lambda: fb_fwd.extend(caught_launches("_launch_forward_fl", fallback_step)))),
        fl_bf16=1, fl_bwd_bf16=1)
    emit({"phase": "full_lane_cr_fallback_bf16", "Ta": 130, "Tc": 4, "output_dtype": str(fb_out[0].dtype),
          "launches": {"fl_bf16": 1, "fl_bwd_bf16": 1},
          "grads_finite": all(bool(torch.isfinite(t.grad).all()) for t in fallback.parameters())})
    if fb_out[0].dtype != BF16 or not all(bool(torch.isfinite(t.grad).all()) for t in fallback.parameters()):
        raise RuntimeError("the bf16 full_lane_cr fallback step is not bf16 or its gradients not finite")

    # 39. kernel_fl_bf16, kernel_fl_bwd_bf16: both bf16 instances against
    # their plain versions on the inputs those paths handed them, then an odd
    # B*Ta and a ragged last chunk (and, backward, fewer samples than one
    # chunk and chunks across clips)
    renders = {}
    for label, requests in (("render_b1_4s", single_requests), ("render_b8_4s", timed)):
        renders[label] = caught_launches(
            "_launch_forward_fl", lambda: render_with(synth16, requests, "full_lane"))[0]
    cases = [(label, *renders[label]) for label in renders]
    cases += [("cli_train_step", *step_fwd[0]), ("full_lane_cr_fallback_130_4", *fb_fwd[0])]
    bwd_cases = [("cli_train_step", *step_bwd[0]), ("full_lane_cr_fallback_130_4", *fb_bwd[0])]
    for label, b, ta in (("odd_rows", 3, 333), ("ragged_block", 2, 1025), ("under_one_chunk", 1, 31),
                         ("chunks_across_clips", 3, 47)):
        e = torch.from_numpy((rng.standard_normal((b, ta, 64)) * 0.5).astype(np.float32)).to(dev, BF16)
        f = torch.from_numpy(rng.standard_normal((b, ta, 256)).astype(np.float32)).to(dev, BF16)
        g = torch.from_numpy(rng.standard_normal((b, ta, 64)).astype(np.float32)).to(dev, BF16)
        if label in ("odd_rows", "ragged_block"):
            cases.append((label, e, f, packed))
        bwd_cases.append((label, e, f, packed, g))
    for label, e, f, *_ in cases + bwd_cases:
        if (e.dtype, f.dtype) != (BF16, BF16):
            raise RuntimeError(f"{label}: the bf16 path handed the kernel {e.dtype}, {f.dtype}")
    fwd_err = max(check_fl(*case) for case in cases)
    bwd_err = max(check_fl_backward(*case) for case in bwd_cases)

    # 40. timing_fl_bf16: both bf16 instances beside the float32 instance on
    # the same shapes (float32 copies of the same inputs), in turns, with
    # their plain versions and bounds (the bytes at the tensors' own sizes);
    # the training step at batch 8 x 4 s at full_lane in float32 and bf16, in
    # turns (three medians of 20 each), with each arm's peak memory
    order = ["f32", "bf16", "bf16", "f32"]
    exc, film_a, w = renders["render_b8_4s"]
    fwd_in = {"f32": (exc.float(), film_a.float()), "bf16": (exc, film_a)}
    tree = nf.unpack_weight_grads(w)
    with torch.inference_mode():
        fwd_ms = in_turns({k: (lambda e=e, f=f: nf._launch_forward_fl(e, f, w))
                           for k, (e, f) in fwd_in.items()}, order)
        fwd_plain = {k: cuda_median_ms(lambda e=e, f=f: nf.film_shaper_fl_plain(e, f, tree))
                     for k, (e, f) in fwd_in.items()}
    be, bf, bw, bdy = step_bwd[0]
    bwd_in = {"f32": (be.float(), bf.float(), bw, bdy.float()), "bf16": (be, bf, bw, bdy)}
    bwd_ms = in_turns({k: (lambda a=a: nf._launch_backward_fl(*a)) for k, a in bwd_in.items()}, order)
    bwd_plain = {k: cuda_median_ms(lambda a=a: nf.film_shaper_fl_grad_plain(
        a[0], a[1], nf.unpack_weight_grads(a[2]), a[3])) for k, a in bwd_in.items()}
    numbers = {}
    for k in ("f32", "bf16"):
        e, f = fwd_in[k]
        fb = bound(e.numel() * FL_FLOP_PER_ELEMENT, cr_bytes(e, f, w))
        bb = bound(bwd_in[k][0].numel() * FL_BWD_FLOP_PER_ELEMENT,
                   cr_bytes(bwd_in[k][0], bwd_in[k][1], bw, backward=True))
        numbers[k] = ((statistics.mean(fwd_ms[k]), fwd_plain[k], *fb),
                      (statistics.mean(bwd_ms[k]), bwd_plain[k], *bb))
    emit({"phase": "timing_kernel_fl_bf16", "order": order, "fwd_shape": list(exc.shape),
          "bwd_shape": list(be.shape), "fwd_kernel_ms": fwd_ms, "fwd_plain_ms": fwd_plain,
          "bwd_kernel_ms": bwd_ms, "bwd_plain_ms": bwd_plain,
          "fwd_bound_ms": {k: v[0][2] for k, v in numbers.items()},
          "fwd_bound_by": {k: v[0][3] for k, v in numbers.items()},
          "bwd_bound_ms": {k: v[1][2] for k, v in numbers.items()},
          "bwd_bound_by": {k: v[1][3] for k, v in numbers.items()},
          "fwd_bytes": {k: cr_bytes(*fwd_in[k], w) for k in fwd_in},
          "bwd_bytes": {k: cr_bytes(a[0], a[1], bw, backward=True) for k, a in bwd_in.items()}})
    del renders, cases, bwd_cases, fwd_in, bwd_in, step_fwd, step_bwd, exc, film_a, be, bf, bdy
    torch.cuda.empty_cache()
    batch = GeneralDataModule(root, batch_size=8).dataset("train").batch(np.arange(8))
    trainers = {}
    for arm, cd in (("f32_full_lane", "float32"), ("bf16_full_lane", "bfloat16")):
        model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0), compute_dtype=cd)
        model.newt.fused = "full_lane"
        trainers[arm] = Trainer(model, TrainConfig(), device="cuda")
    step, peak = {}, {}
    turns = ["f32_full_lane", "bf16_full_lane", "bf16_full_lane", "f32_full_lane", "f32_full_lane",
             "bf16_full_lane"]
    for arm in turns:
        step.setdefault(arm, []).append(cuda_median_ms(lambda: trainers[arm].train_step(batch)))
        torch.cuda.reset_peak_memory_stats()
        trainers[arm].train_step(batch)
        torch.cuda.synchronize()
        peak.setdefault(arm, []).append(torch.cuda.max_memory_allocated())
    emit({"phase": "timing_bf16_fl_step", "batch": [8, int(batch["f0"].shape[1])], "order": turns,
          "step_ms": step, "step_peak_mem_bytes": peak,
          "x_realtime": {a: [32.0 / (t / 1e3) for t in v] for a, v in step.items()}})
    del trainers
    torch.cuda.empty_cache()
    return {"launches": launches, "fwd_err": fwd_err, "bwd_err": bwd_err, "numbers": numbers["bf16"]}


def x_instance(args):
    """The exciter-fused instance of these launch arguments: "f32", "bf16"
    (bf16 mixer and FiLM) or "bf16_f32" (bf16 mixer, float32 FiLM)."""
    return "f32" if args[4].dtype == torch.float32 else ("bf16" if args[3].dtype == BF16 else "bf16_f32")


def x_as(args, io):
    """Launch arguments cast to instance ``io``: the mixer (w, b, w_out), the
    output's cotangent (if any) and the FiLM; phase, f0, offsets, planes kept."""
    mixer = torch.float32 if io == "f32" else BF16
    film = BF16 if io == "bf16" else torch.float32
    phase, f0, off, film_c, w, b, packed, w_out, h, sr, hop = args[:11]
    out = (phase, f0, off, film_c.to(film), w.to(mixer), b.to(mixer), packed,
           None if w_out is None else w_out.to(mixer), h, sr, hop)
    return out + tuple(dy.to(mixer) for dy in args[11:])


def check_x_bf16(label, args):
    """A bf16 instance of the exciter-fused forward vs its plain version
    (float32 between bf16 load and store, rounded once) within one bf16 ulp
    (rtol 2^-7, atol 1e-5) -> max abs error."""
    with torch.inference_mode():
        out = nf._launch_forward_x(*args)
        ref = x_plain(args)
    torch.cuda.synchronize()
    o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
    err = float(np.max(np.abs(o - r)))
    xfull = args[7] is not None
    emit({"phase": "kernel_x_bf16", "name": "bank_newt_fused_xfull" if xfull else "bank_film_shaper_fused_xcr",
          "io": x_instance(args), "case": label, "B": args[0].shape[0], "Tc": args[3].shape[1],
          "hop": args[10], "H": args[8], "max_abs_err": err,
          "elements_not_bit_identical": int((o != r).sum()), "elements": int(o.size),
          "rtol": BF16_RTOL, "atol": ATOL})
    if out.dtype != BF16 or ref.dtype != BF16:
        raise RuntimeError(f"{label}: the bf16 instance returned {out.dtype}, its plain version {ref.dtype}")
    np.testing.assert_allclose(o, r, rtol=BF16_RTOL, atol=ATOL, err_msg=label)
    return err


def check_x_bwd_bf16(label, args):
    """A bf16 instance of the exciter-fused backward vs autograd through the
    plain version: d_film, d_w, d_b (and d_w_out) one bf16 ulp beyond the
    float32 gradient bar (rtol 1e-3 + 2^-7, atol 1e-3 * max|plain|), d_planes
    (float32) at that bar, each in its plain version's dtype; two calls
    bit-identical -> max abs error."""
    out = nf._launch_backward_x(*args)
    again = nf._launch_backward_x(*args)
    ref = x_grad_plain(args)
    torch.cuda.synchronize()
    bit_identical = all(torch.equal(a, b) for a, b in zip(out, again))
    errs = {}
    for name, o, r in zip(("d_film_c", "d_w", "d_b", "d_planes", "d_w_out"), out, ref):
        if o.dtype != r.dtype:
            raise RuntimeError(f"{label} {name}: {o.dtype}, the plain version's {r.dtype}")
        rtol = BWD_RTOL if name == "d_planes" else BWD_RTOL + BF16_RTOL
        o, r = o.float().cpu().numpy(), r.float().cpu().numpy()
        errs[name] = (float(np.max(np.abs(o - r))), float(np.max(np.abs(r))))
        np.testing.assert_allclose(o, r, rtol=rtol, atol=BWD_RTOL * errs[name][1], err_msg=f"{label} {name}")
    xfull = args[7] is not None
    emit({"phase": "kernel_x_bwd_bf16", "name": "_fused_bwd_xfull" if xfull else "_fused_bwd_xcr",
          "io": x_instance(args), "case": label, "B": args[0].shape[0], "Tc": args[3].shape[1],
          "hop": args[10], "H": args[8], "dtypes": [str(t.dtype) for t in out],
          "max_abs_err": {k: v[0] for k, v in errs.items()},
          "max_abs_plain": {k: v[1] for k, v in errs.items()},
          "rtol": {"d_planes": BWD_RTOL, "others": BWD_RTOL + BF16_RTOL}, "bit_identical_repeat": bit_identical})
    if len(out) != len(ref) or len(out) != (5 if xfull else 4):
        raise RuntimeError(f"{label}: {len(out)} backward outputs, plain {len(ref)}")
    if not bit_identical:
        raise RuntimeError(f"{label}: two bf16 exciter-fused backward calls gave different bits")
    return max(v[0] for v in errs.values())


def check_lookup_bf16(label, table, x, expected_path):
    """The lookup's bf16-x instance vs its plain version on the same CUDA
    tensors: bit for bit (the bf16 index rounded after each operation, the
    interpolation float32), and the path expected -> max abs error (0)."""
    with torch.inference_mode():
        out = fast_newt._launch(table, x)
        ref = fast_newt.fast_newt_lookup_plain(table, x)
        widened = fast_newt.fast_newt_lookup_plain(table, x.float())
    torch.cuda.synchronize()
    path = fast_newt._lookup_path(x, out)
    err = float((out - ref).abs().max())
    n_diff = int((out != ref).sum())
    emit({"phase": "kernel_fast_newt_bf16", "name": "fast_newt_lookup_pallas", "io": "bf16 x",
          "case": label, "x_shape": list(x.shape), "S": table.shape[0], "x_offset_bytes": x.data_ptr() % 16,
          "path": path, "expected_path": expected_path, "output_dtype": str(out.dtype), "max_abs_err": err,
          "elements_not_bit_exact": n_diff, "elements": x.numel(),
          "elements_off_the_float32_index": int((ref != widened).sum())})
    if x.dtype != BF16 or out.dtype != torch.float32 or n_diff:
        raise RuntimeError(f"{label}: the bf16 lookup ({x.dtype} -> {out.dtype}) differs from its plain "
                           f"version in {n_diff} elements")
    if path != expected_path:
        raise RuntimeError(f"{label}: the lookup took the {path} path, expected {expected_path}")
    return err


X_BF16_COUNTERS = [f"{kind}{bwd}_{io}" for kind in ("xcr", "xfull") for bwd in ("", "_bwd")
                   for io in ("bf16", "bf16_f32")]


def exciter_fused_bf16_phases(dev, root, tmp):
    """Phases 41-46 (kernels 7 and 8's bf16 instances under
    NeuralWaveshaping.fuse_exciter / fuse_out_mixer, and kernel 4's bf16-x
    instance under FastNEWT, at compute_dtype = "bfloat16") -> their
    numbers."""
    launches = {k: 0 for k in X_BF16_COUNTERS + ["lookup_bf16"]}

    def run_counted(fn, **expect):  # counted, every other kernel 0, and summed
        out, got, _ = counted(fn, expect)
        for k in launches:
            launches[k] += got[k]
        return out

    synths = {kind: synth_with({"compute_dtype": "bfloat16", **fields}) for kind, fields in X_FIELDS.items()}
    with torch.no_grad():
        packed = synths["xcr"].model.newt._packed_shaper(BF16)
    batch8, single = make_requests([4] * 8, 6), make_requests([4], 5)

    # 41. serve_bf16_fused: a bf16 Synthesizer with fuse_exciter (xcr) and with
    # fuse_out_mixer (xfull) renders 4-s requests at batch 8 and 1 (one launch
    # of the (bf16, bf16) instance a render and nothing else), then with
    # NEWT.cr_film_f32 one request (the (bf16, f32) instance); the card against
    # the CPU (its plain versions) and the float32 fused render, from the same
    # offsets and noise
    renders = {}
    for kind, s in synths.items():
        rms = []
        for label, requests, film_f32 in (("render_b8_4s", batch8, False), ("render_b1_4s", single, False),
                                          ("render_b1_4s_film_f32", single, True)):
            s.model.newt.cr_film_f32 = film_f32
            audio = []
            try:
                renders[(kind, label)] = run_counted(lambda: caught_launches(
                    "_launch_forward_x", lambda: audio.extend(s.render(requests, seed=0))),
                    **{f"{kind}_{'bf16_f32' if film_f32 else 'bf16'}": 1})[0]
            finally:
                s.model.newt.cr_film_f32 = False
            for (f0, _), a in zip(requests, audio):
                rms.append(float(np.sqrt(np.mean(a**2))))
                if a.shape != (f0.shape[0] * HOP,) or not np.all(np.isfinite(a)) or rms[-1] < 1e-4:
                    raise RuntimeError(f"serve_bf16_fused {kind}: bad render ({a.shape}, rms {rms[-1]})")
        f0_b, ctrl_b, _ = s.prepare(make_requests([2], seed=3))
        rng = np.random.default_rng(4)
        offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
        noise = rng.uniform(0, 1, f0_b.shape[1] * HOP - 1).astype(np.float32)
        outs = {}
        for label, model in (("card_bf16", s.model),
                             ("cpu_bf16", synth_with({"compute_dtype": "bfloat16", **X_FIELDS[kind]}, "cpu").model),
                             ("card_f32", synth_with(X_FIELDS[kind]).model)):
            d = next(model.parameters()).device
            with torch.inference_mode():
                y = model(torch.from_numpy(f0_b).to(d), torch.from_numpy(ctrl_b).to(d),
                          phase_offset=torch.from_numpy(offset).to(d), noise=torch.from_numpy(noise).to(d))
            outs[label] = y.cpu().numpy()
        card_vs_cpu = nrms(outs["card_bf16"], outs["cpu_bf16"])
        vs_f32 = nrms(outs["card_bf16"], outs["card_f32"])
        emit({"phase": "serve_bf16_fused", "kind": kind, "fields": X_FIELDS[kind], "requests_s": [4] * 8 + [4, 4],
              "launches": {k: launches[k] for k in launches if k.startswith(kind + "_b")}, "rms": rms,
              "output_dtype": str(outs["card_bf16"].dtype), "nrms_card_vs_cpu": card_vs_cpu,
              "bar_card_vs_cpu": BF16_CARD_VS_CPU, "nrms_bf16_vs_f32": vs_f32, "bar_bf16_vs_f32": BF16_VS_F32,
              "floor_bf16_vs_f32": BF16_FLOOR})
        if outs["card_bf16"].dtype != np.float32:
            raise RuntimeError("the bf16 fused model does not return float32")
        if not card_vs_cpu <= BF16_CARD_VS_CPU or not BF16_FLOOR < vs_f32 < BF16_VS_F32:
            raise RuntimeError(f"bf16 {kind} render: card vs CPU {card_vs_cpu}, bf16 vs f32 {vs_f32}")

    # 42. train_cli_bf16_fused: the bf16 recipe through the CLI with NEWT.fused
    # = 'full_lane_cr' and fuse_exciter, 20 steps with validation: kernels 7 and
    # 8's (bf16, bf16) xcr instances only, counted; the first step's kernel
    # inputs caught. Then one Trainer step at batch 8 x 4 s per field and FiLM
    # dtype (cr_film_f32), counted, its backward inputs caught
    cli = load_train_cli()
    dm = GeneralDataModule(root, batch_size=8)
    val_batches = len(list(dm.val_batches()))
    n_fwd = CLI_STEPS + val_batches * (CLI_STEPS // CLI_VAL_EVERY)
    args = ["--gin-file", "gin/train/train_newt_bf16.gin", "--dataset-path", root, "--device", "cuda",
            "--checkpoint-dir", str(tmp / "cli_bf16_x_ckpt"), "--log-dir", str(tmp / "cli_bf16_x_logs"),
            "-b", "NEWT.fused = 'full_lane_cr'", "-b", "NeuralWaveshaping.fuse_exciter = True",
            "-b", f"TrainConfig.max_steps = {CLI_STEPS}", "-b", f"TrainConfig.val_every_n_steps = {CLI_VAL_EVERY}",
            "-b", "TrainConfig.log_every_n_steps = 5"]
    step_fwd, step_bwd = [], []
    t0 = time.perf_counter()
    try:
        run_counted(lambda: step_bwd.extend(caught_launches(
            "_launch_backward_x", lambda: step_fwd.extend(
                caught_launches("_launch_forward_x", lambda: cli.main(args), first=1)), first=1)),
            xcr_bf16=n_fwd, xcr_bwd_bf16=CLI_STEPS)
    finally:
        gin.clear_config()
    cli_s = time.perf_counter() - t0
    with open(tmp / "cli_bf16_x_logs" / "metrics.csv") as f:
        table = list(csv.DictReader(f))
    losses = [float(r["train/loss"]) for r in table if r["train/loss"]]
    val = [float(r["val/loss"]) for r in table if r["val/loss"]]
    emit({"phase": "train_cli_bf16_fused", "steps": CLI_STEPS, "seconds": cli_s,
          "launches": {"xcr_bf16": n_fwd, "xcr_bwd_bf16": CLI_STEPS},
          "first_launch_io": x_instance(step_fwd[0]), "train_loss_windows": losses, "val_loss": val})
    if not losses or not val or not np.all(np.isfinite(losses + val)):
        raise RuntimeError("train_cli_bf16_fused: the losses are not finite")
    batch = dm.dataset("train").batch(np.arange(8))
    trainer = Trainer(NeuralWaveshaping(generator=torch.Generator().manual_seed(0), compute_dtype="bfloat16"),
                      TrainConfig(), device="cuda")
    step_args = {}
    for kind, fields in X_FIELDS.items():
        for io in ("bf16", "bf16_f32"):
            set_fields(trainer.model, fields)
            trainer.model.newt.cr_film_f32 = io == "bf16_f32"
            metrics = {}
            step_args[(kind, io)] = run_counted(lambda: caught_launches(
                "_launch_backward_x", lambda: metrics.update(trainer.train_step(batch))),
                **{f"{kind}_{io}": 1, f"{kind}_bwd_{io}": 1})[0]
            loss = float(metrics["loss"])
            emit({"phase": "train_step_bf16_fused", "kind": kind, "io": io, "B": 8, "loss": loss})
            if not np.isfinite(loss) or x_instance(step_args[(kind, io)]) != io:
                raise RuntimeError(f"a bf16 {kind} step: loss {loss}, instance {x_instance(step_args[(kind, io)])}")
    set_fields(trainer.model, {})
    trainer.model.newt.cr_film_f32 = False

    # 43. timbre_bf16_fast_newt: bf16 FastNEWT timbre transfer of the repo's
    # 4-s wav (two launches of the lookup's bf16 instance, its warm-up and
    # timed forwards, and nothing else) and a batch-8 FastNEWT render (one),
    # their lookups caught; a FastNEWT render of the wav's controls on the card
    # against the CPU and the float32 one
    synth16 = synth_with({"compute_dtype": "bfloat16"})
    sr_wav, wav = wavfile.read(WAV)
    got_audio = []
    lookups = run_counted(lambda: caught_lookups(lambda: got_audio.append(
        timbre_transfer(synth16, wav, sr_wav, use_fast_newt=True))), lookup_bf16=2)[:1]
    out, speed = got_audio[0]
    f0_b, ctrl_b, _ = synth16.prepare(batch8)
    with torch.inference_mode():
        table = synth16.model.newt.bake_lookup_table()
        f0_t, ctrl_t = torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev)
        lookups += run_counted(lambda: caught_lookups(lambda: synth16.model(
            f0_t, ctrl_t, generator=torch.Generator().manual_seed(0), lookup_table=table)), lookup_bf16=1)
    feats = extract_features(wav, sr_wav, device=dev)
    f0_hz, control = adjust_controls(*feats[1:], synth16.data_mean, synth16.data_std, ControlAdjustments())
    rng = np.random.default_rng(8)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, f0_hz.shape[0] * HOP - 1).astype(np.float32)
    outs = {}
    for label, model in (("card_bf16", synth16.model),
                         ("cpu_bf16", synth_with({"compute_dtype": "bfloat16"}, "cpu").model),
                         ("card_f32", Synthesizer.from_checkpoint(CKPT, device="cuda").model)):
        d = next(model.parameters()).device
        with torch.inference_mode():
            y = model(torch.from_numpy(f0_hz[None]).to(d), torch.from_numpy(control[None]).to(d),
                      phase_offset=torch.from_numpy(offset).to(d), noise=torch.from_numpy(noise).to(d),
                      lookup_table=model.newt.bake_lookup_table())
        outs[label] = y.cpu().numpy()
    card_vs_cpu = nrms(outs["card_bf16"], outs["cpu_bf16"])
    vs_f32 = nrms(outs["card_bf16"], outs["card_f32"])
    rms = float(np.sqrt(np.mean(out**2)))
    emit({"phase": "timbre_bf16_fast_newt", "input": "wav_16k", "samples": int(out.shape[0]), "rms": rms,
          "x_realtime": speed, "launches_lookup_bf16": 3, "nrms_card_vs_cpu": card_vs_cpu,
          "bar_card_vs_cpu": BF16_FAST_NEWT_CARD_VS_CPU, "nrms_bf16_vs_f32": vs_f32,
          "bar_bf16_vs_f32": BF16_VS_F32, "floor_bf16_vs_f32": BF16_FLOOR,
          "output_dtype": str(outs["card_bf16"].dtype)})
    if not np.all(np.isfinite(out)) or rms < 1e-4:
        raise RuntimeError(f"bf16 FastNEWT timbre transfer: bad audio (rms {rms})")
    if not card_vs_cpu <= BF16_FAST_NEWT_CARD_VS_CPU or not BF16_FLOOR < vs_f32 < BF16_VS_F32:
        raise RuntimeError(f"bf16 FastNEWT render: card vs CPU {card_vs_cpu}, bf16 vs f32 {vs_f32}")

    # 44. kernel_x_bf16, kernel_x_bwd_bf16, kernel_fast_newt_bf16: each bf16
    # instance against its plain version on the inputs those paths handed it,
    # then made-up shapes (odd Tc, hop 64, H = 2 and 128, a ragged last pass,
    # groups across clips; backward hops 33 and 300)
    fwd_err = {(kind, io): 0.0 for kind in X_FIELDS for io in ("bf16", "bf16_f32")}
    bwd_err = dict(fwd_err)
    cases = [(f"{label}_{kind}", a) for (kind, label), a in renders.items()]
    cases.append(("cli_train_step_xcr", step_fwd[0]))
    bwd_cases = [("cli_train_step_xcr", step_bwd[0])]
    bwd_cases += [(f"train_step_b8_4s_{kind}", a) for (kind, _), a in step_args.items()]
    for kind in X_FIELDS:
        xfull = kind == "xfull"
        for io in ("bf16", "bf16_f32"):
            for label, b, tc, hop, h in (("odd_tc", 1, 37, HOP, 101), ("hop_64", 2, 50, 64, 101),
                                         ("h2", 2, 8, HOP, 2), ("h128", 2, 8, HOP, 128),
                                         ("ragged_block", 1, 37, 5, 101), ("straddle", 3, 1, 3, 101)):
                a = made_up_x_args(b, tc, hop, h, 80 + tc + h, dev, packed, xfull)
                cases.append((f"{label}_{kind}", x_as(a, io)))
            for label, b, tc, hop, h in (("odd_tc", 1, 37, HOP, 101), ("h2", 1, 8, HOP, 2),
                                         ("hop_33", 2, 40, 33, 128), ("hop_300", 1, 30, 300, 101)):
                a = made_up_x_args(b, tc, hop, h, 90 + tc + h, dev, packed, xfull, True)
                bwd_cases.append((f"{label}_{kind}", x_as(a, io)))
    for label, a in cases:
        key = ("xfull" if a[7] is not None else "xcr", x_instance(a))
        fwd_err[key] = max(fwd_err[key], check_x_bf16(label, a))
    for label, a in bwd_cases:
        key = ("xfull" if a[7] is not None else "xcr", x_instance(a))
        bwd_err[key] = max(bwd_err[key], check_x_bwd_bf16(label, a))
    del cases, bwd_cases
    torch.cuda.empty_cache()
    lookup_cases = [("timbre_transfer_4s", *lookups[0]), ("render_b8_4s", *lookups[1])]
    rng = np.random.default_rng(17)
    for label, s, shape, offset_el, path in (("beyond_edges", 4096, (2, 4000, 64), 0, "vec4"),
                                             ("s256", 256, (2, 1000, 64), 0, "vec4"),
                                             ("ragged_rows", 4096, (3, 333, 64), 0, "vec4"),
                                             ("offset1_view", 4096, (2, 1000, 64), 1, "scalar"),
                                             ("offset4_view", 4096, (2, 1000, 64), 4, "vec4")):
        t = table if s == 4096 else torch.from_numpy(rng.standard_normal((s, 64)).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.uniform(-4, 4, shape).astype(np.float32)).to(dev, BF16)
        x = torch.empty(x.numel() + offset_el, dtype=BF16, device=dev)[offset_el:].view(shape).copy_(x)
        lookup_cases.append((label, t, x, path))
    lookup_err = max(check_lookup_bf16(label, t, x, "vec4" if len(rest) == 0 else rest[0])
                     for label, t, x, *rest in lookup_cases)

    # 45. timing_kernel_x_bf16: the bf16 instances beside the float32 instance
    # on the same shapes (the batch-8 render's and the training step's inputs
    # cast), in turns, with plain versions and bounds (the bytes at the
    # tensors' own sizes); the lookup's bf16-x instance beside its float32 one
    order = ["f32", "bf16", "bf16_f32", "bf16_f32", "bf16", "f32"]
    numbers, timing = {}, {}
    for kind in X_FIELDS:
        fa = renders[(kind, "render_b8_4s")]
        ba = step_args[(kind, "bf16")]
        fwd_in = {io: x_as(fa, io) for io in ("f32", "bf16", "bf16_f32")}
        bwd_in = {io: x_as(ba, io) for io in ("f32", "bf16", "bf16_f32")}
        with torch.inference_mode():
            f_ms = in_turns({io: (lambda a=a: nf._launch_forward_x(*a)) for io, a in fwd_in.items()}, order)
            f_plain = {io: cuda_median_ms(lambda a=a: x_plain(a)) for io, a in fwd_in.items()}
        b_ms = in_turns({io: (lambda a=a: nf._launch_backward_x(*a)) for io, a in bwd_in.items()}, order)
        b_plain = {io: cuda_median_ms(lambda a=a: x_grad_plain(a)) for io, a in bwd_in.items()}
        for io in ("f32", "bf16", "bf16_f32"):
            fb = bound(x_flop(fwd_in[io], False), x_bytes(fwd_in[io], False))
            bb = bound(x_flop(bwd_in[io], True), x_bytes(bwd_in[io], True))
            numbers[(kind, io)] = ((statistics.mean(f_ms[io]), f_plain[io], *fb),
                                   (statistics.mean(b_ms[io]), b_plain[io], *bb))
        timing[kind] = {"fwd_shape": list(fa[0].shape), "bwd_shape": list(ba[0].shape), "fwd_kernel_ms": f_ms,
                        "fwd_plain_ms": f_plain, "bwd_kernel_ms": b_ms, "bwd_plain_ms": b_plain,
                        "fwd_bound_ms": {io: numbers[(kind, io)][0][2] for io in fwd_in},
                        "fwd_bound_by": {io: numbers[(kind, io)][0][3] for io in fwd_in},
                        "bwd_bound_ms": {io: numbers[(kind, io)][1][2] for io in bwd_in},
                        "bwd_bound_by": {io: numbers[(kind, io)][1][3] for io in bwd_in},
                        "fwd_bytes": {io: x_bytes(a, False) for io, a in fwd_in.items()},
                        "bwd_bytes": {io: x_bytes(a, True) for io, a in bwd_in.items()}}
        emit({"phase": "timing_kernel_x_bf16", "kind": kind, "order": order, **timing[kind]})
        del fwd_in, bwd_in
    lt, lx = lookups[1]
    with torch.inference_mode():
        lx32 = lx.float()
        lookup_ms = in_turns({"f32": lambda: fast_newt._launch(lt, lx32),
                              "bf16": lambda: fast_newt._launch(lt, lx)}, ["f32", "bf16", "bf16", "f32"])
        lookup_plain = cuda_median_ms(lambda: fast_newt.fast_newt_lookup_plain(lt, lx))
    n_el = lx.numel()
    lookup_bound = bound(n_el * LOOKUP_FLOP_PER_ELEMENT, n_el * (2 + 4) + 4 * lt.numel())
    emit({"phase": "timing_kernel_fast_newt_bf16", "x_shape": list(lx.shape), "order": ["f32", "bf16", "bf16", "f32"],
          "kernel_ms": lookup_ms, "plain_ms_bf16": lookup_plain,
          "bytes": {"f32": n_el * 8 + 4 * lt.numel(), "bf16": n_el * 6 + 4 * lt.numel()},
          "bound_ms": {"f32": bound(n_el * LOOKUP_FLOP_PER_ELEMENT, n_el * 8 + 4 * lt.numel())[0],
                       "bf16": lookup_bound[0]}, "bound_by": lookup_bound[1]})
    del renders, step_args, step_fwd, step_bwd, lookups, lookup_cases
    torch.cuda.empty_cache()

    # 46. timing_bf16_fused: the fused forward (batch 8 x 4 s) and training step
    # (batch 8 x 4 s) in float32 and bf16, xcr and xfull, in turns, with each
    # arm's peak memory
    arms = {f"{cd}_{kind}": (cd, kind) for kind in X_FIELDS for cd in ("f32", "bf16")}
    models, trainers = {}, {}
    for arm, (cd, kind) in arms.items():
        model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0),
                                  compute_dtype="bfloat16" if cd == "bf16" else "float32")
        model.newt.fused = "full_lane_cr"
        set_fields(model, X_FIELDS[kind])
        trainers[arm] = Trainer(model, TrainConfig(), device="cuda")
        models[arm] = trainers[arm].model
    turns = ["f32_xcr", "bf16_xcr", "f32_xfull", "bf16_xfull", "bf16_xfull", "f32_xfull", "bf16_xcr", "f32_xcr"]
    fwd, step, peak = {}, {}, {}
    for arm in turns:
        gen = torch.Generator().manual_seed(0)
        with torch.inference_mode():
            fwd.setdefault(arm, []).append(cuda_median_ms(lambda: models[arm](f0_t, ctrl_t, generator=gen)))
        step.setdefault(arm, []).append(cuda_median_ms(lambda: trainers[arm].train_step(batch)))
        torch.cuda.reset_peak_memory_stats()
        trainers[arm].train_step(batch)
        torch.cuda.synchronize()
        peak.setdefault(arm, []).append(torch.cuda.max_memory_allocated())
    emit({"phase": "timing_bf16_fused", "batch": [8, int(batch["f0"].shape[1])], "order": turns,
          "forward_b8_4s_ms": fwd, "step_ms": step, "step_peak_mem_bytes": peak,
          "x_realtime_forward": {a: [32.0 / (t / 1e3) for t in v] for a, v in fwd.items()},
          "x_realtime_step": {a: [32.0 / (t / 1e3) for t in v] for a, v in step.items()}})
    del trainers, models, trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "fwd_err": fwd_err, "bwd_err": bwd_err, "numbers": numbers,
            "lookup": {"launches": launches["lookup_bf16"], "max_abs_err": lookup_err,
                       "ms": statistics.mean(lookup_ms["bf16"]), "plain_ms": lookup_plain,
                       "bound_ms": lookup_bound[0], "bound_by": lookup_bound[1]}}


# ---------------------------------------------------------------------------
# phases 47-50: data parallelism over a process group, time-sharded rendering
# ---------------------------------------------------------------------------
def ddp_cfg(folder) -> TrainConfig:
    return TrainConfig(max_steps=DDP_STEPS, val_every_n_steps=DDP_STEPS, log_every_n_steps=1,
                       checkpoint_dir=str(folder))


def ddp_run(trainer, dm):
    """Step 0's loss and summed gradient (no update) on the first global
    batch of epoch 0, then ``fit`` for DDP_STEPS steps, then DDP_TIMED timed
    steps -> the results, the kernels counted over step 0 and the fit."""
    mesh, model = trainer.mesh, trainer.model
    reset_counts()
    batch = trainer.to_device(next(dm.train_batches((trainer.cfg.seed, 2, 0), mesh=mesh)))
    loss = compute_loss(model, batch, step_generator(trainer.cfg.seed, 0, 0), mesh=mesh)
    loss.backward()
    loss0 = float(loss.detach())
    # the step's autograd graph goes with its loss: alive, it would keep the
    # gradient accumulators on this stream, where fit's graph capture cannot
    # reach them
    del loss
    all_reduce_sum_([p.grad for p in model.parameters()], mesh)
    grads0 = leaf_grads(model)
    trainer.optimizer.zero_grad()
    history = trainer.fit(dm)
    torch.cuda.synchronize()
    got = counts()
    params = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()
    local = next(dm.train_batches((trainer.cfg.seed, 2, 0), mesh=mesh))
    torch.cuda.reset_peak_memory_stats()
    step_ms = [1e3 * synced_s(lambda: trainer.train_step(local))[1] for _ in range(DDP_TIMED)]
    return {"loss0": loss0, "grads0": grads0, "loss": history["loss"],
            "val": history["val"], "counts": got, "params": params, "step_ms": step_ms,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def ddp_rank(rank, world_size, init_file, root, out):
    """One rank of phase 47: gloo on cuda:0, the recipe's model from seed 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size)
    try:
        mesh = create_mesh(devices=["cuda:0"])
        trainer = Trainer(recipe_model(0), ddp_cfg(Path(out) / "ck"), device="cuda", mesh=mesh)
        result = ddp_run(trainer, GeneralDataModule(root, batch_size=8))
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def step0_f64_grads(root):
    """Step 0's gradient on the CPU in float64 (the witness of the card rule):
    the same global batch and draws as :func:`ddp_run`."""
    dm = GeneralDataModule(root, batch_size=8)
    trainer = Trainer(recipe_model(0).double(), ddp_cfg("unused"), device="cpu")
    batch = trainer.to_device(next(dm.train_batches((trainer.cfg.seed, 2, 0))))
    compute_loss(trainer.model, batch, step_generator(trainer.cfg.seed, 0, 0)).backward()
    return leaf_grads(trainer.model)


def ddp_train_phase(root, tmp):
    """Phase 47 -> the launches of kernels 1 and 2 (both ranks and the one
    process)."""
    dm = GeneralDataModule(root, batch_size=8)
    one = ddp_run(Trainer(recipe_model(0), ddp_cfg(tmp / "ddp_one"), device="cuda"), dm)
    work = tmp / "ddp_two"
    work.mkdir()
    t0 = time.perf_counter()
    run_ranks(ddp_rank, DDP_WORLD, (str(work / "rdzv"), root, str(work)), CHILD_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(DDP_WORLD)]
    two = ranks[0]
    # the card rule (ROADMAP.md section 3) with the one-process card step as
    # the float32 reference: a leaf beyond 1e-3 passes only if the 2-rank
    # gradient is no farther from the float64 one than the one process's + 1e-3
    rel = {n: relnorm(two["grads0"][n], one["grads0"][n]) for n in one["grads0"]}
    witness, failed = {}, []
    if max(rel.values()) > 1e-3:
        exact = step0_f64_grads(root)
        for n in (n for n, r in rel.items() if r > 1e-3):
            witness[n] = {"two_vs_one": rel[n], "two_vs_f64": relnorm(two["grads0"][n], exact[n]),
                          "one_vs_f64": relnorm(one["grads0"][n], exact[n])}
            if witness[n]["two_vs_f64"] > witness[n]["one_vs_f64"] + 1e-3:
                failed.append(n)
    loss0_rel = abs(two["loss0"] - one["loss0"]) / abs(one["loss0"])
    step_rel = [abs(a - b) / abs(b) for a, b in zip(two["loss"], one["loss"])]
    expect = {"cr": 1 + DDP_STEPS + dm.n_batches("val"), "bwd": 1 + DDP_STEPS}
    launches = [{k: r["counts"][k] for k in expect} for r in ranks + [one]]
    wrong = [r["counts"] for r in ranks + [one]
             if {k: v for k, v in r["counts"].items() if v} != expect]
    same_params = all(torch.equal(r["params"], two["params"]) for r in ranks)
    worst = max(rel, key=rel.get)
    emit({"phase": "ddp_train", "ranks": DDP_WORLD, "backend": "gloo", "device": "cuda:0",
          "global_batch": 8, "clip_s": 4, "steps": DDP_STEPS,
          "loss0": [r["loss0"] for r in ranks], "loss0_one": one["loss0"], "loss0_rel": loss0_rel,
          "worst_leaf": worst, "worst_rel": rel[worst], "leaves_over_1e-3": witness,
          "leaves_failed": failed, "loss": two["loss"], "loss_one": one["loss"],
          "step_rel": step_rel, "val": two["val"], "val_one": one["val"],
          "params_bit_identical": same_params, "launches_per_process": launches,
          "step_ms_two": [r["step_ms"] for r in ranks], "step_ms_one": one["step_ms"],
          "step_ms_two_median": statistics.median(two["step_ms"]),
          "step_ms_one_median": statistics.median(one["step_ms"]),
          "peak_bytes_two": [r["peak_bytes"] for r in ranks], "peak_bytes_one": one["peak_bytes"],
          "ranks_wall_s": ranks_s})
    if loss0_rel > 1e-4 or any(r["loss0"] != two["loss0"] for r in ranks) or failed:
        raise RuntimeError("ddp_train: step 0 on 2 ranks differs from one process")
    if max(step_rel) > 2e-3 or not same_params:
        raise RuntimeError("ddp_train: the 2-rank run left the one-process run or its ranks parted")
    if wrong:
        raise RuntimeError(f"ddp_train: launches {wrong}, expected {expect}")
    return {k: sum(r["counts"][k] for r in ranks + [one]) for k in ("cr", "bwd")}


def train_cli_child(out, argv):
    """``chip_smoke.py --train-cli <out> <CLI args>``: run
    ``scripts/torch_train.py`` in this process (under torchrun or not) with
    the counts zeroed just before and read just after, into ``<out>.<rank>``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts()
    rc = load_train_cli().main(argv)
    torch.cuda.synchronize()
    with open(f"{out}.{os.environ.get('RANK', '0')}", "w") as f:
        json.dump({"rc": rc, "counts": counts()}, f)
    return rc


def ddp_nccl_phase(root, tmp):
    """Phase 48 -> the launches of kernels 1 and 2 in the two CLI runs."""
    runs = {}
    for name, launcher in (("plain", []), ("torchrun", ["-m", "torch.distributed.run",
                                                        "--standalone", "--nproc_per_node", "1"])):
        folder = tmp / f"nccl_{name}"
        args = ["--gin-file", "gin/train/train_newt.gin", "--dataset-path", root,
                "--checkpoint-dir", str(folder / "ck"), "--log-dir", str(folder / "logs"),
                "-b", f"TrainConfig.max_steps = {DDP_STEPS}",
                "-b", f"TrainConfig.val_every_n_steps = {DDP_STEPS}",
                "-b", "TrainConfig.log_every_n_steps = 1"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *launcher, str(REPO / "chip_smoke.py"), "--train-cli",
                               str(folder / "counts"), *args], cwd=REPO, capture_output=True,
                              text=True, timeout=CHILD_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"ddp_nccl {name}: rc {proc.returncode}\n{proc.stderr[-4000:]}")
        with open(folder / "counts.0") as f:
            child = json.load(f)
        with open(folder / "logs" / "metrics.csv") as f:
            table = list(csv.DictReader(f))
        line = next(l for l in proc.stdout.splitlines() if l.startswith("[train] data-parallel"))
        state = load_lightning_checkpoint(str(folder / "ck" / "last.ckpt"))["state_dict"]
        runs[name] = {"counts": child["counts"], "seconds": seconds, "line": line,
                      "loss": [r["train/loss"] for r in table if r["train/loss"]],
                      "val": [r["val/loss"] for r in table if r["val/loss"]],
                      "params": np.concatenate([np.ravel(v) for _, v in sorted(state.items())])}
    plain, nccl = runs["plain"], runs["torchrun"]
    expect = {"cr": DDP_STEPS + GeneralDataModule(root, 8).n_batches("val"), "bwd": DDP_STEPS}
    wrong = [r["counts"] for r in runs.values() if {k: v for k, v in r["counts"].items() if v} != expect]
    same = nccl["loss"] == plain["loss"] and nccl["val"] == plain["val"]
    same_params = np.array_equal(nccl["params"], plain["params"])
    emit({"phase": "ddp_nccl", "backend": "nccl", "world_size": 1, "steps": DDP_STEPS,
          "lines": [plain["line"], nccl["line"]], "loss": nccl["loss"], "loss_plain": plain["loss"],
          "val": nccl["val"], "losses_bit_identical": same, "checkpoint_bit_identical": same_params,
          "launches": [r["counts"][k] for r in runs.values() for k in expect],
          "seconds": {k: r["seconds"] for k, r in runs.items()}})
    if "over 1 device(s); cuda:0" not in nccl["line"] or not same or not same_params:
        raise RuntimeError("ddp_nccl: the CLI under torchrun differs from the plain CLI")
    if wrong or len(nccl["loss"]) != DDP_STEPS:
        raise RuntimeError(f"ddp_nccl: launches {wrong} or losses {nccl['loss']}, expected {expect}")
    return {k: sum(r["counts"][k] for r in runs.values()) for k in ("cr", "bwd")}


def plain_calls(fn):
    """Run ``fn`` counting the calls of the kernels' plain versions (NEWT's
    chain, the cr, audio-rate and stream kernels' and the FastNEWT lookup's)
    -> (its result, the count)."""
    names = [(nf, n) for n in ("film_shaper_fl_plain", "film_shaper_cr_plain", "film_shaper_chain",
                               "film_shaper_stream_plain")] + [(fast_newt, "fast_newt_lookup_plain")]
    real = {n: getattr(m, n) for m, n in names}
    calls = []
    for m, n in names:
        setattr(m, n, lambda *a, _f=real[n], **k: calls.append(1) or _f(*a, **k))
    try:
        return fn(), len(calls)
    finally:
        for m, n in names:
            setattr(m, n, real[n])


def time_shard_phase(dev, synth, cpu_synth):
    """Phase 49 -> the launches of kernels 1 and 5 in the renders, kernel 5's
    largest error on the chunks' inputs."""
    model = synth.model
    f0_b, ctrl_b, _ = synth.prepare(make_requests([TIME_SHARD_S], seed=21))
    f0_t, ctrl_t = torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev)
    arms = {"unsharded": lambda g: model(f0_t, ctrl_t, generator=g)}
    for k in TIME_SHARD_CHUNKS:
        render = make_time_sharded_renderer(model, create_mesh(devices=[dev] * k))
        arms[f"chunks_{k}"] = lambda g, r=render: r(f0_t, ctrl_t, generator=g)
    expects = {"unsharded": {"cr": 1}, **{f"chunks_{k}": {"fl": k} for k in TIME_SHARD_CHUNKS}}
    launches = {"cr": 0, "fl": 0}

    def run(name):
        with torch.inference_mode():
            (y, n_plain), got, _ = counted(
                lambda: plain_calls(lambda: arms[name](torch.Generator().manual_seed(0))),
                expects[name])
        if n_plain:
            raise RuntimeError(f"time_shard {name}: {n_plain} plain-version calls on the card")
        for k in launches:
            launches[k] += got[k]
        return y

    outs = {name: run(name).cpu().numpy() for name in arms}
    ref = outs["unsharded"]
    dist_nrms = {name: nrms(y, ref) for name, y in outs.items() if name != "unsharded"}
    finite = all(np.all(np.isfinite(y)) and y.shape == ref.shape for y in outs.values())
    # kernel 5 against its plain version on the first and last chunk of 8
    caught = caught_launches("_launch_forward_fl", lambda: run("chunks_8"))
    packed = model.newt._packed_shaper()
    fl_err = max(check_fl(f"time_shard_chunk{i}", *caught[i][:2], packed) for i in (0, -1))
    del caught
    # render ms and peak memory per arm, in turns
    order = list(arms) + list(reversed(arms))
    ms, peak = {n: [] for n in arms}, {n: [] for n in arms}
    for name in order:
        torch.cuda.reset_peak_memory_stats()
        times = [1e3 * synced_s(lambda: run(name))[1] for _ in range(TIME_SHARD_TIMED)]
        ms[name].append(statistics.median(times))
        peak[name].append(torch.cuda.max_memory_allocated())
    # a short clip, card against CPU, 2 chunks each
    f0_s, ctrl_s, _ = synth.prepare(make_requests([4], seed=22))
    short = []
    for s, device in ((synth, dev), (cpu_synth, torch.device("cpu"))):
        render = make_time_sharded_renderer(s.model, create_mesh(devices=[device] * 2))
        with torch.inference_mode():
            y = render(torch.from_numpy(f0_s).to(device), torch.from_numpy(ctrl_s).to(device),
                       generator=torch.Generator().manual_seed(1))
        short.append(y.cpu().numpy())
    card_vs_cpu = nrms(short[0], short[1])
    emit({"phase": "time_shard", "clip_s": TIME_SHARD_S, "frames": int(f0_b.shape[1]),
          "chunks": list(TIME_SHARD_CHUNKS), "nrms_vs_unsharded": dist_nrms, "bar": 1e-3,
          "kernel_fl_max_abs_err": fl_err, "render_ms": ms, "peak_bytes": peak,
          "order": order, "short_clip_card_vs_cpu_nrms": card_vs_cpu, "launches": launches})
    if not finite or max(dist_nrms.values()) > 1e-3 or card_vs_cpu > 1e-3:
        raise RuntimeError("time_shard: a sharded render left the unsharded one or the CPU's")
    return {**launches, "fl_err": fl_err}


def timbre_time_shard_phase(tmp):
    """Phase 50 -> kernel 5's launches in the CLI's two renders."""
    cli = load_script("torch_timbre_transfer")
    out_wav = tmp / "time_shard.wav"
    args = ["--input", WAV, "--output", str(out_wav), "--checkpoint", CKPT,
            "--time-shard-devices", "1"]
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            rc, got, seconds = counted(lambda: cli.main(args), {"fl": 2})
    finally:
        gin.clear_config()
    _, audio = wavfile.read(out_wav)
    line = text.getvalue().strip().splitlines()[-1]
    emit({"phase": "timbre_time_shard", "rc": rc, "line": line, "samples": int(audio.shape[0]),
          "peak": int(np.abs(audio).max()), "launches": {"fl": got["fl"]}, "seconds": seconds})
    if rc != 0 or "in 1 time chunk(s)" not in line or not np.abs(audio).max():
        raise RuntimeError("timbre_time_shard: the CLI did not render in one time chunk")
    return got["fl"]


def parallel_phases(dev, synth, cpu_synth, root, tmp):
    """Phases 47-50 -> the launches of kernels 1, 2 and 5 in them."""
    ddp = ddp_train_phase(root, tmp)
    nccl = ddp_nccl_phase(root, tmp)
    ts = time_shard_phase(dev, synth, cpu_synth)
    timbre_fl = timbre_time_shard_phase(tmp)
    return {"cr": ddp["cr"] + nccl["cr"] + ts["cr"], "bwd": ddp["bwd"] + nccl["bwd"],
            "fl": ts["fl"] + timbre_fl, "fl_err": ts["fl_err"]}


# ---------------------------------------------------------------------------
# phases 51-56: the measurement CLIs on the card
# ---------------------------------------------------------------------------
MEASURE_KEYS = ("cr", "bwd", "stream", "lookup", "fl", "fl_bwd")


def run_cli(name, argv, expect, env=None, plain_ok=False):
    """``scripts/<name>.py``'s ``main(argv)`` in this process, with ``env``
    set for the call and every launch counter zeroed just before and read
    just after -> (its standard output, the counts, seconds). Raises unless
    it returns 0, each kernel of ``expect`` (keys of ``counts()``) launched,
    no other kernel did and, unless ``plain_ok`` (a CLI that times a plain
    version beside the kernel on purpose), no plain version ran."""
    scripts = str(REPO / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)  # the scripts import their siblings
    module = load_script(name)
    out = io.StringIO()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    gin.clear_config()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc, n_plain = plain_calls(lambda: module.main(argv))
        torch.cuda.synchronize()
    finally:
        gin.clear_config()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    got = counts()
    moved = {k for k, v in got.items() if v}
    if rc != 0 or (n_plain and not plain_ok) or not set(expect) <= moved or moved - set(expect):
        raise RuntimeError(f"{name} {argv}: rc {rc}, plain versions {n_plain}, launches "
                           f"{ {k: got[k] for k in moved} }, expected {list(expect)}\n"
                           f"{out.getvalue()[-3000:]}")
    return out.getvalue(), got, seconds


def lines_with(text, *needles):
    return [line.strip() for line in text.splitlines() if any(n in line for n in needles)]


def measure_cli_phases(dev, root, tmp):
    """Phases 51-56 -> the launches of kernels 1-6 in them."""
    launches = dict.fromkeys(MEASURE_KEYS, 0)

    def cli(phase, name, argv, expect, env=None, **fields):
        text, got, seconds = run_cli(name, argv, expect, env)
        for k in MEASURE_KEYS:
            launches[k] += got[k]
        record = {"phase": phase, **fields, "seconds": seconds,
                  "launches": {k: got[k] for k in expect}}
        return text, record

    # 51. the forward pass at batch 1 and 8 x 4 s, kernel 1 and FastNEWT
    for batch in (1, 8):
        for fast in (False, True):
            text, record = cli("cli_time_forward_pass", "torch_time_forward_pass",
                               ["--batch-size", str(batch), "--iterations", "20"]
                               + (["--use-fast-newt"] if fast else []),
                               ["lookup"] if fast else ["cr"], batch=batch, fast_newt=fast)
            emit({**record, "lines": lines_with(text, "Queued loop", "DescribeResult",
                                                   "RTF:", "[launches]")})

    # 52. the streaming step by buffer size
    out_csv = tmp / "buffer_times.csv"
    text, record = cli("cli_time_buffer_sizes", "torch_time_buffer_sizes",
                       ["--streaming", "--buffers", "1024,4096", "--iterations", "50",
                        "--warmup", "5", "--pipeline-depth", "4", "--output-csv", str(out_csv)],
                       ["stream"])
    with open(tmp / "buffer_times_summary.csv") as f:
        summary = list(csv.DictReader(f))
    if len(summary) != 2 or not all(float(r["device_step_ms"]) > 0 for r in summary):
        raise RuntimeError(f"time_buffer_sizes summary: {summary}")
    emit({**record, "summary": summary})

    # 53. serving capacity at 1, 64 and 256 streams, float32 and int16
    for wire in ("float32", "int16"):
        out_csv = tmp / f"capacity_{wire}.csv"
        text, record = cli("cli_serving_capacity", "torch_serving_capacity",
                           ["--batches", "1,64,256", "--output-csv", str(out_csv)]
                           + (["--fetch-int16"] if wire == "int16" else []), ["stream"], wire=wire)
        with open(out_csv) as f:
            rows = list(csv.DictReader(f))
        if [r["wire_dtype"] for r in rows] != [wire] * 3:
            raise RuntimeError(f"serving_capacity rows: {rows}")
        emit({**record, "capacity": lines_with(text, "capacity:", "link ("), "rows": rows})

    # 54. the training step at 8 x 500 frames, the recipe (kernels 1-2)
    text, record = cli("cli_time_train_step", "torch_time_train_step",
                       ["--steps", "20", "--repeats", "2"], ["cr", "bwd"])
    emit({**record, "lines": lines_with(text, "[time_train_step]")})

    # 55. the component profiles at small lengths
    text, record = cli("cli_profile_train_step", "torch_profile_train_step",
                       ["--batch-size", "2", "--n-frames", "100", "--n-short", "2", "--n-long",
                        "6", "--repeats", "1"], ["cr", "bwd", "fl", "fl_bwd"])
    emit({**record, "lines": lines_with(text, " ms")})
    text, record = cli("cli_profile_streaming_step", "torch_profile_streaming_step",
                       ["--batch-streams", "16", "--n-short", "5", "--n-long", "20",
                        "--repeats", "1"], ["stream"])
    emit({**record, "lines": lines_with(text, " ms")})

    # 56. the CLI trainer under NWS_TPU_HOST_PROFILE
    text, record = cli("train_cli_host_profile", "torch_train",
                       ["--gin-file", "gin/train/train_newt.gin", "--dataset-path", root,
                        "--checkpoint-dir", str(tmp / "host_profile" / "ck"),
                        "--log-dir", str(tmp / "host_profile" / "logs"),
                        "-b", "TrainConfig.max_steps = 10", "-b", "TrainConfig.val_every_n_steps = 5",
                        "-b", "TrainConfig.log_every_n_steps = 5"],
                       ["cr", "bwd"], env={"NWS_TPU_HOST_PROFILE": "1"})
    host = lines_with(text, "[trainer] host profile:", "[trainer] val profile")
    if len(host) != 3 or not all(stage in host[-1] for stage in (  # in memory: JAX's fast path
            "indices:", "gather_dispatch:", "step_dispatch:", "loss_fetch+device_wait:", "log:",
            "val+checkpoint:")):
        raise RuntimeError(f"host profile lines: {host}")
    emit({**record, "lines": host})
    return launches


# ---------------------------------------------------------------------------
# phases 57-62: kernel 9 (the roofline's chains) and the roofline CLI, the
# loss trajectory, the data-path bench, the loss profile and the notebook
# ---------------------------------------------------------------------------
CHAIN_N = 8 * 1024 * 1024  # elements of each chain: the roofline CLI's
CHAIN_K_FMA, CHAIN_K_SIN, CHAIN_A = 256, 32, 0.99
CHAIN_BYTES = 12  # per element: x and x0 read, out written, float32
# kernel 9's instances: name -> (kind, ilp, counts() key)
CHAIN_INSTANCES = {"fma": ("fma", 1, "chain_fma"), "fma_ilp4": ("fma", 4, "chain_fma_ilp4"),
                   "sin": ("sin", 1, "chain_sin"), "sin_ilp4": ("sin", 4, "chain_sin_ilp4")}
QUEUE1_KEYS = ("chain_fma", "chain_fma_ilp4", "chain_sin", "chain_sin_ilp4", "fl", "fl_bwd", "cr",
               "bwd", "lookup")
TRAJ_STEP1_RTOL = 1e-4  # the card's float32 step-1 loss against JAX's float64 one
LOSS_VALUE_RTOL = 1e-5  # the loss profile's float32 value against its float64 oracle


def chain_calls(kind, ilp, x, x0, k=None):
    """(kernel, plain version) of kernel 9's ``kind`` instance on (x, x0),
    ``k`` steps (the CLI's K if None)."""
    if kind == "fma":
        k = CHAIN_K_FMA if k is None else k
        return (lambda: roofline.fma_chain(x, x0, k, CHAIN_A, ilp),
                lambda: roofline.fma_chain_plain(x, x0, k, CHAIN_A, ilp))
    k = CHAIN_K_SIN if k is None else k
    return (lambda: roofline.psin_chain(x, x0, k, ilp),
            lambda: roofline.psin_chain_plain(x, x0, k, ilp))


def chain_agrees(out, ref):
    return bool(torch.all((out - ref).abs() <= ATOL + RTOL * ref.abs()))


def kernel_chain_phase(dev):
    """Phase 57: kernel 9's four instances against their plain versions at
    the roofline CLI's sizes, on an x0 drawn apart from x (the CLI's
    x0 = 0.01 x makes x the fma chain's fixed point, where any step count
    gives x back), with the plain version of K - 1 steps required to
    disagree at the same bars; two calls bit-identical; then each timed on
    the CLI's own inputs -> {instance: {max_abs_err, ms, plain_ms,
    bound_ms, bound_by}}."""
    gen = torch.Generator().manual_seed(9)
    out = {}
    for lanes, names in ((128, tuple(CHAIN_INSTANCES)), (64, ("fma",))):
        x = torch.randn(CHAIN_N // lanes, lanes, generator=gen).to(dev)
        x0 = (0.01 * torch.randn(CHAIN_N // lanes, lanes, generator=gen)).to(dev)
        for name in names:
            kind, ilp, _ = CHAIN_INSTANCES[name]
            k = CHAIN_K_FMA if kind == "fma" else CHAIN_K_SIN
            kern, plain = chain_calls(kind, ilp, x, x0)
            first, second, ref = kern(), kern(), plain()
            short = chain_calls(kind, ilp, x, x0, k - 1)[1]()
            torch.cuda.synchronize()
            bit = bool(torch.equal(first, second))
            err = float((first - ref).abs().max())
            sensitive = not chain_agrees(first, short)
            emit({"phase": "kernel_chain", "instance": name, "lanes": lanes, "elements": CHAIN_N,
                  "max_abs_err": err, "rtol": RTOL, "atol": ATOL, "bit_identical": bit,
                  "k_minus_1_max_abs_diff": float((first - short).abs().max()),
                  "k_minus_1_disagrees": sensitive})
            np.testing.assert_allclose(first.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
            if not bit or not sensitive:
                raise RuntimeError(f"kernel 9 {name}: two calls differ ({not bit}) or K - 1 steps "
                                   f"pass the bars ({not sensitive})")
            entry = out.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            del first, second, ref, short
            if lanes == 128:
                # timed on the CLI's inputs (x0 = 0.01 x, or 1e-6 x for the
                # sine). A launch takes 0.1-0.3 ms: one event pair around
                # each would add the host's ~0.05 ms launch latency, so the
                # kernel is timed as the CLI times it, a queued loop by
                # difference
                kern, plain = chain_calls(kind, ilp, x, x * (0.01 if kind == "fma" else 1e-6))
                bound_ms, bound_by = bound(CHAIN_N * roofline.chain_flop(kind, k, ilp),
                                           CHAIN_N * CHAIN_BYTES)
                entry.update(ms=differential_loop_ms(lambda c: kern(), 5, 25, 3, device=dev),
                             plain_ms=cuda_median_ms(plain, n=5, warmup=1),
                             bound_ms=bound_ms, bound_by=bound_by)
                emit({"phase": "timing_kernel_chain", "instance": name, **entry})
        del x, x0
    return out


def train_trajectory_phase(dev):
    """Phase 58: float32 ``train_step`` at ``"full_lane_cr"`` (kernels 1-2,
    counted) over the recipe of ``utils/trajectory.py`` (the port's seeded
    init, the numpy batch and draws), 60 steps, held against JAX's float64
    curve in ``tests/data/jax_loss_trajectory.json``: the step-1 loss within
    TRAJ_STEP1_RTOL, and JAX's three-tier gate with each bar raised to JAX's
    own spread (``spread_gate``; the fixture's three families). One curve of
    a chaotic recipe is one draw: the card runs the four inits of the
    fixture's float32 family (the seeded init, and three perturbed at
    float32 rounding) and holds the median of their plateau gaps to tier 3;
    tiers 1 and 2 hold for the seeded init's curve, tier 2 for all four ->
    the launches."""
    fixture = json.loads((REPO / "tests" / "data" / "jax_loss_trajectory.json").read_text())
    recipe, ref = fixture["recipe"], fixture["losses"]
    spread = [c["losses"] for family in fixture["spread"].values() for c in family]
    inits = [(c["perturb"], c["seed"]) for c in fixture["spread"]["float32"]]
    assert inits[0] == (0.0, 0)
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
             for k, v in trajectory.trajectory_batch(recipe).items()}
    draws = [(torch.from_numpy(o.astype(np.float32)).to(dev),
              torch.from_numpy(n.astype(np.float32)).to(dev))
             for o, n in trajectory.trajectory_draws(recipe)]
    reset_counts()
    t0 = time.perf_counter()
    curves = []
    for perturb, seed in inits:
        gin.clear_config()
        gin.parse_config("NEWT.fused = 'full_lane_cr'")
        try:
            model = NeuralWaveshaping(generator=torch.Generator().manual_seed(recipe["init_seed"]))
        finally:
            gin.clear_config()
        if perturb:
            model.load_params(trajectory.init_params(recipe, perturb, seed))
        model.to(dev)
        optimizer = Optimizer(model.parameters(), TrainConfig())
        losses = [train_step(model, optimizer, batch, phase_offset=o, noise=n)["loss"]
                  for o, n in draws]
        curves.append([float(v) for v in losses])
    seconds = time.perf_counter() - t0
    got = counts()
    moved = {k: v for k, v in got.items() if v}
    gates = [trajectory.spread_gate(c, ref, spread) for c in curves]
    gate, step1 = gates[0], abs(curves[0][0] - ref[0]) / abs(ref[0])
    plateaus = [g["plateau"] for g in gates]
    plateau_median = float(np.median(plateaus))
    tier3 = plateau_median <= gate["plateau_bar"]
    emit({"phase": "train_trajectory", "curves": len(curves), "steps": len(curves[0]),
          "seconds": seconds, "launches": moved, "step1_rel": step1,
          "step1_rtol": TRAJ_STEP1_RTOL, **{k: gate[k] for k in ("exact", "exact_bars", "row_max",
                                                                "tier1", "tier2")},
          "row_max_all": max(g["row_max"] for g in gates), "plateaus": plateaus,
          "plateau_median": plateau_median, "plateau_bar": gate["plateau_bar"], "tier3": tier3,
          "jax_bars": {"tier1": trajectory.BARS["exact_tol"], "tier2": trajectory.BARS["row_tol"],
                       "tier3": trajectory.BARS["plateau_tol"]},
          "first_loss": curves[0][0], "plateau_loss_median": float(np.median(curves[0][40:60])),
          "ref_plateau_loss_median": float(np.median(ref[40:60]))})
    if moved != {"cr": len(draws) * len(curves), "bwd": len(draws) * len(curves)}:
        raise RuntimeError(f"train_trajectory launches {moved}: expected kernels 1-2 once a step")
    if (not np.all(np.isfinite(curves)) or not step1 <= TRAJ_STEP1_RTOL or not gate["tier1"]
            or not all(g["tier2"] for g in gates) or not tier3):
        raise RuntimeError(f"train_trajectory: step 1 {step1}, gates {gates}")
    return moved


def notebook_phase(tmp):
    """Phase 62: every code cell of ``colab/NEWT_Timbre_Transfer_torch.ipynb``
    on the card (its default device) on a 4-s tone, counted -> the launches."""
    t = np.arange(4 * SR) / SR
    f = 330 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
    wav = (0.4 * np.sin(2 * np.pi * np.cumsum(f) / SR)).astype(np.float32)
    in_path, out_path = tmp / "notebook_in.wav", tmp / "notebook_out.wav"
    wavfile.write(in_path, SR, (wav * 32767).astype(np.int16))
    env = {"NWS_INPUT_WAV": str(in_path), "NWS_OUTPUT_WAV": str(out_path), "MPLBACKEND": "Agg"}
    saved = {k: os.environ.get(k) for k in (*env, "NWS_DEVICE", "NWS_CHECKPOINT")}
    os.environ.update(env)
    for k in ("NWS_DEVICE", "NWS_CHECKPOINT"):
        os.environ.pop(k, None)
    cwd = os.getcwd()
    nb = json.loads((REPO / "colab" / "NEWT_Timbre_Transfer_torch.ipynb").read_text())
    ns = {}
    reset_counts()
    t0 = time.perf_counter()
    try:
        os.chdir(REPO / "colab")
        with contextlib.redirect_stdout(io.StringIO()) as text:
            _, n_plain = plain_calls(lambda: [
                exec(compile("".join(c["source"]), f"<cell {i}>", "exec"), ns)
                for i, c in enumerate(nb["cells"]) if c["cell_type"] == "code"])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        gin.clear_config()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    got = counts()
    moved = {k: v for k, v in got.items() if v}
    out_sr, out = wavfile.read(out_path)
    emit({"phase": "notebook", "seconds": time.perf_counter() - t0, "launches": moved,
          "device": str(ns["synth"].device), "x_realtime": ns["x_realtime"],
          "x_realtime_fast_newt": ns["x_rt_fast"], "out_samples": len(out),
          "lines": text.getvalue().splitlines()[-4:]})
    if (set(moved) != {"cr", "lookup"} or n_plain or ns["synth"].device.type != "cuda"
            or out_sr != SR or len(out) != len(ns["out"]) or ns["out_fast"].shape != ns["out"].shape
            or not np.all(np.isfinite(ns["out"])) or not np.all(np.isfinite(ns["out_fast"]))):
        raise RuntimeError(f"notebook: launches {moved}, plain versions {n_plain}")
    return moved


def queue1_phases(dev, root, tmp):
    """Phases 57-62 -> kernel 9's numbers and the launches of every kernel
    in phases 58-62."""
    chain = kernel_chain_phase(dev)
    launches = dict.fromkeys(QUEUE1_KEYS, 0)

    def add(got):
        for k in QUEUE1_KEYS:
            launches[k] += got.get(k, 0)

    # 58. the loss trajectory against the JAX fixture
    add(train_trajectory_phase(dev))

    # 59. the roofline CLI at its defaults: kernel 9's rows and kernels 5-6
    roofline_keys = ["chain_fma", "chain_fma_ilp4", "chain_sin", "chain_sin_ilp4", "fl", "fl_bwd"]
    text, got, seconds = run_cli("torch_roofline_shaper", [], roofline_keys, plain_ok=True)
    add(got)
    emit({"phase": "cli_roofline", "seconds": seconds,
          "launches": {k: got[k] for k in roofline_keys},
          "lines": lines_with(text, " ms", "ceilings", "[launches]")})

    # 60. the data-path bench on the tone dataset, the recipe (kernels 1-2)
    text, got, seconds = run_cli("torch_bench_data_path",
                                 ["--dataset-path", root, "--steps", "40", "--log-every", "10",
                                  "--warmup-windows", "1"], ["cr", "bwd"])
    add(got)
    result = json.loads(text.strip().splitlines()[-1])
    emit({"phase": "cli_bench_data_path", "seconds": seconds, **result,
          "launches": {k: got[k] for k in ("cr", "bwd")},
          "lines": lines_with(text, "steady-state", "lazy_i16")})
    if not (result["eager_steps_per_s"] > 0 and result["lazy_steps_per_s"] > 0):
        raise RuntimeError(f"bench_data_path: {result}")

    # 61. the loss profile at its defaults (no kernel of the port's own)
    text, got, seconds = run_cli("torch_profile_loss", [], [])
    value = lines_with(text, "rel_err")
    rel = float(value[0].split("rel_err")[1])
    emit({"phase": "cli_profile_loss", "seconds": seconds, "rel_err": rel,
          "rtol": LOSS_VALUE_RTOL, "lines": lines_with(text, " ms", "oracle", "rel_err")})
    if not rel <= LOSS_VALUE_RTOL:
        raise RuntimeError(f"profile_loss: float32 value {rel} from the float64 oracle")

    # 62. the notebook on the card
    add(notebook_phase(tmp))
    return {"chain": chain, "launches": launches}


CHUNK_STEPS, CHUNK_LOG, CHUNK_VAL = 40, 10, 20  # chunks of gcd(10, 20) = 10 steps
CHUNK_TIMED = 3  # chunks timed for each form


def eager_steps(trainer, dm, steps):
    """An eager loop of ``Trainer.train_step`` over ``train_batches``, pass
    after pass, from the trainer's step -> (losses, grad norms)."""
    stream = trainer._stream(dm, "train_batches")
    metrics = [trainer.train_step(next(stream)) for _ in range(steps)]
    return ([float(m["loss"]) for m in metrics], [float(m["grad_norm"]) for m in metrics])


def host_profile(text, steps):
    """``[trainer] host profile:`` of a fit's output -> ms per step by stage."""
    line = next(l for l in text.splitlines() if l.startswith("[trainer] host profile: "))
    stages = (part.split(": ") for part in line[len("[trainer] host profile: "):].split(" | "))
    return {name: 1e3 * float(value.rstrip("s")) / steps for name, value in stages}


def train_chunked_phase(dev, root, tmp):
    """Phase 63 (the chunked fit: the training split on the card, N steps a
    chunk, the step a CUDA graph) -> the launches of kernels 1 and 2."""
    dm = GeneralDataModule(root, batch_size=8)
    lazy_dm = GeneralDataModule(root, batch_size=8, load_to_memory=False)
    val_batches = dm.n_batches("val")
    launches = {"cr": 0, "bwd": 0}

    def cfg(steps, folder):
        return TrainConfig(max_steps=steps, val_every_n_steps=CHUNK_VAL,
                           log_every_n_steps=CHUNK_LOG, checkpoint_dir=str(tmp / folder))

    def fit(trainer, data, steps, restore=False):
        """A counted fit under NWS_TPU_HOST_PROFILE -> (history, its host
        stages in ms a step, seconds)."""
        vals = steps // CHUNK_VAL + (steps % CHUNK_VAL != 0)
        out = io.StringIO()
        os.environ["NWS_TPU_HOST_PROFILE"] = "1"
        try:
            with contextlib.redirect_stdout(out):
                history, got, seconds = counted(lambda: trainer.fit(data, restore=restore),
                                                {"cr": steps + val_batches * vals, "bwd": steps})
        finally:
            del os.environ["NWS_TPU_HOST_PROFILE"]
        launches["cr"] += got["cr"]
        launches["bwd"] += got["bwd"]
        return history, host_profile(out.getvalue(), steps), seconds

    # (a) the graphed fit in memory against two eager twins from the same init
    twins = []
    for _ in range(2):
        eager = Trainer(recipe_model(0), cfg(CHUNK_STEPS, "unused"), device="cuda")
        twins.append(counted(lambda: eager_steps(eager, dm, CHUNK_STEPS),
                             {"cr": CHUNK_STEPS, "bwd": CHUNK_STEPS})[0])
        launches["cr"] += CHUNK_STEPS
        launches["bwd"] += CHUNK_STEPS
    graphed = Trainer(recipe_model(0), cfg(CHUNK_STEPS, "graphed"), device="cuda")
    history, first_stages, fit_s = fit(graphed, dm, CHUNK_STEPS)
    program = graphed._program
    shutil.copytree(tmp / "graphed", tmp / "graphed_copy")
    # the same Trainer on to twice the steps, its graph replayed from the
    # first step: the host's stages without the warm-up and the capture
    graphed.cfg = cfg(2 * CHUNK_STEPS, "graphed_more")
    _, stages, more_s = fit(graphed, dm, CHUNK_STEPS)
    # its steps/s, the validations' host time taken out
    fit_rate = CHUNK_STEPS / (more_s - stages["val+checkpoint"] * CHUNK_STEPS / 1e3)
    twins_bitwise = twins[0] == twins[1]
    twins_rel = max(max_rel(twins[1][0], twins[0][0]), max_rel(twins[1][1], twins[0][1]))
    bar = 0.0 if twins_bitwise else 2 * twins_rel + 1e-6
    graph_rel = max(max_rel(history["loss"], twins[0][0]),
                    max_rel(history["grad_norm"], twins[0][1]))
    # (b) lazy against in memory
    lazy = Trainer(recipe_model(0), cfg(CHUNK_STEPS, "lazy"), device="cuda")
    lazy_history, lazy_stages, lazy_s = fit(lazy, lazy_dm, CHUNK_STEPS)
    lazy_bitwise = lazy_history == history
    lazy_rel = max(max_rel(lazy_history["loss"], history["loss"]),
                   max_rel(lazy_history["grad_norm"], history["grad_norm"]))
    del lazy

    # (c) one more chunk of the graph: the counters against the profiler's
    split = graphed.device_split(dm.dataset("train"))
    rows = graphed._stream(dm, "train_rows")

    def chunk():
        program.set_rows(np.stack([next(rows) for _ in range(CHUNK_LOG)]))
        program.gather(split, CHUNK_LOG)
        return program.run(CHUNK_LOG)

    torch.cuda.synchronize()
    reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    got = counts()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    traced = {"cr": sum("film_shaper_cr_kernel" in n for n in names),
              "bwd": sum("film_shaper_cr_bwd_kernel" in n for n in names)}
    counted_chunk = {k: got[k] for k in traced}
    launches["cr"] += got["cr"]
    launches["bwd"] += got["bwd"]
    del prof, names  # the trace's events, lest collecting them pause the timings below
    gc.collect()

    # (e) the two forms after the warm-up, in turns: steps/s, device busy and
    # idle share. A timed chunk draws its steps' randomness on the host first,
    # as the eager steps do in theirs; fit draws the next chunk's while the
    # card runs this one (fit_steps_per_s above)
    batches = [b for epoch in range(2) for b in dm.train_batches((0, 2, epoch))]
    step_i = iter(range(10**9))

    def eager_chunk():
        for _ in range(CHUNK_LOG):
            graphed.train_step(batches[next(step_i) % len(batches)])

    reset_counts()
    rates = {"graphed": [], "eager": []}
    for _ in range(CHUNK_TIMED):  # in turns
        for name, fn in (("graphed", chunk), ("eager", eager_chunk)):
            rates[name].append(CHUNK_LOG / synced_s(fn)[1])
    busy = {"graphed": device_busy(chunk, runs=2), "eager": device_busy(eager_chunk, runs=2)}
    got = counts()
    launches["cr"] += got["cr"]
    launches["bwd"] += got["bwd"]

    # (d) fit(restore=True) on the same Trainer drops the graph and captures
    # anew; a fresh Trainer's resumed run is the reference
    captures = graphed.graph_captures
    graphed.cfg = cfg(CHUNK_STEPS + 2 * CHUNK_LOG, "graphed")
    again, _, _ = fit(graphed, dm, 2 * CHUNK_LOG, restore=True)
    recaptured = graphed.graph_captures - captures
    fresh = Trainer(recipe_model(7), cfg(CHUNK_STEPS + 2 * CHUNK_LOG, "graphed_copy"), device="cuda")
    fresh_history, _, _ = fit(fresh, dm, 2 * CHUNK_LOG, restore=True)
    resume_rel = max(max_rel(again["loss"], fresh_history["loss"]),
                     max_rel(again["grad_norm"], fresh_history["grad_norm"]))
    emit({"phase": "train_chunked", "B": 8, "clip_s": 4.0, "fused": "full_lane_cr",
          "steps": CHUNK_STEPS, "chunk": program.length, "log_every": CHUNK_LOG,
          "val_every": CHUNK_VAL, "graph_launches": program.graph_launches,
          "capture_s": program.capture_s, "graph_pool_bytes": program.pool_bytes,
          "twins_bit_identical": twins_bitwise, "twins_max_rel": twins_rel, "bar": bar,
          "graphed_vs_eager_bit_identical": (history["loss"], history["grad_norm"]) == twins[0],
          "graphed_vs_eager_max_rel": graph_rel,
          "lazy_vs_in_memory_bit_identical": lazy_bitwise, "lazy_vs_in_memory_max_rel": lazy_rel,
          "chunk_launches_counted": counted_chunk, "chunk_launches_traced": traced,
          "recaptures": recaptured, "resumed_vs_fresh_bit_identical": again == fresh_history,
          "resumed_vs_fresh_max_rel": resume_rel,
          "steps_per_s": rates, "fit_steps_per_s": fit_rate, "device_busy_per_chunk": busy,
          "host_ms_per_step": {"in_memory_first_fit": first_stages, "in_memory": stages,
                               "lazy": lazy_stages},
          "fit_s": {"in_memory": fit_s, "lazy": lazy_s},
          "loss": history["loss"][::CHUNK_LOG], "val": history["val"]})
    if not np.all(np.isfinite(history["loss"])) or graph_rel > bar:
        raise RuntimeError(f"train_chunked: graphed losses {graph_rel} from the eager loop, bar {bar}")
    if lazy_rel > bar or (twins_bitwise and not lazy_bitwise):
        raise RuntimeError(f"train_chunked: lazy {lazy_rel} from in memory, bar {bar}")
    if counted_chunk != traced or traced != {"cr": CHUNK_LOG, "bwd": CHUNK_LOG}:
        raise RuntimeError(f"train_chunked: counted {counted_chunk}, traced {traced}")
    if recaptured != 1 or resume_rel > bar or (twins_bitwise and again != fresh_history):
        raise RuntimeError(f"train_chunked: recaptures {recaptured}, resumed {resume_rel} from fresh")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build the kernels of the paths from the checkout's sources
    t0 = time.perf_counter()
    _build.build(KERNELS)
    emit({"phase": "build", "kernels": KERNELS, "seconds": time.perf_counter() - t0,
          "ptxas": {k: [line.strip() for line in _build.build_log(k).splitlines()
                        if "registers" in line or "spill" in line] for k in KERNELS}})

    # 3. kernel vs plain on the card, on the main path's own inputs
    synth = Synthesizer.from_checkpoint(CKPT, device="cuda")
    newt = synth.model.newt
    weights, packed = newt.shaping_fn.params(), newt._packed_shaper()
    batch = make_requests([2, 4, 4, 7], seed=1)
    single = make_requests([4], seed=2)
    timed = {"batch1_4s": make_requests([4], 5), "batch8_4s": make_requests([4] * 8, 6)}
    cases = [("serve_batch", *main_path_kernel_inputs(synth, batch)),
             ("serve_single", *main_path_kernel_inputs(synth, single)),
             ("timed_batch8", *main_path_kernel_inputs(synth, timed["batch8_4s"])),
             ("odd_tc", *made_up_kernel_inputs(1, 37, HOP, 1, dev)),
             ("hop_64", *made_up_kernel_inputs(2, 500, 64, 2, dev)),
             ("straddle", *made_up_kernel_inputs(3, 1, 3, 3, dev))]
    max_err = 0.0
    for label, exc, film_c in cases:
        b, ta, _ = exc.shape
        tc = film_c.shape[1]
        hop = ta // tc
        with torch.inference_mode():
            out = nf.film_shaper_cr(exc, film_c, weights, hop, packed=packed)
            ref = nf.film_shaper_cr_plain(exc, film_c, weights, hop)
        torch.cuda.synchronize()
        out, ref = out.cpu().numpy(), ref.cpu().numpy()
        err = float(np.max(np.abs(out - ref)))
        emit({"phase": "kernel", "name": "film_shaper_fused_cr", "case": label, "B": b,
              "Tc": tc, "hop": hop, "max_abs_err": err, "rtol": RTOL, "atol": ATOL})
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        max_err = max(max_err, err)
        # with gamma_out = 0 the output is the kernel's in-register beta_out
        # lerp, which must equal linear_upsample on the CPU bit for bit
        with torch.inference_mode():
            film_z = film_c.clone()
            film_z[..., 128:192] = 0.0
            lerp = nf.film_shaper_cr(exc, film_z, weights, hop, packed=packed).cpu()
            expect = linear_upsample(film_z.cpu(), ta)[..., 192:]
        n_diff = int((lerp != expect).sum())
        emit({"phase": "kernel_film_lerp", "case": label, "B": b, "Tc": tc, "hop": hop,
              "elements_not_bit_exact": n_diff})
        if n_diff:
            raise RuntimeError("in-kernel FiLM interpolation is not bit-exact")
    timed_exc, timed_film = cases[2][1], cases[2][2]
    del cases, out, ref, lerp, expect, film_z

    # 4. serve through the entry point a user calls
    nf.film_shaper_cr.launches = nf.film_shaper_cr.bwd_launches = 0
    renders = []
    for requests in (batch, single):
        before = nf.film_shaper_cr.launches
        audio = synth.render(requests, seed=0)
        if nf.film_shaper_cr.launches <= before:
            raise RuntimeError("a render on the card did not launch film_shaper_fused_cr")
        renders.append((requests, audio))
    launches = nf.film_shaper_cr.launches
    if nf.film_shaper_cr.bwd_launches:
        raise RuntimeError("serving launched the backward kernel")
    for requests, audio in renders:
        for (f0, _), a in zip(requests, audio):
            if a.shape != (f0.shape[0] * HOP,) or not np.all(np.isfinite(a)):
                raise RuntimeError(f"bad render: shape {a.shape}, finite {np.all(np.isfinite(a))}")
            if np.sqrt(np.mean(a**2)) < 1e-4:
                raise RuntimeError("silent render")
    emit({"phase": "serve", "requests_s": [2, 4, 4, 7, 4], "renders": len(renders),
          "kernel_launches": launches,
          "rms": [float(np.sqrt(np.mean(a**2))) for _, au in renders for a in au]})

    # card vs CPU, same injected randomness
    f0_b, ctrl_b, _ = synth.prepare(make_requests([2], seed=3))
    rng = np.random.default_rng(4)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, f0_b.shape[1] * HOP - 1).astype(np.float32)
    cpu_synth = Synthesizer.from_checkpoint(CKPT, device="cpu")
    outs = []
    for s in (synth, cpu_synth):
        with torch.inference_mode():
            y = s.model(torch.from_numpy(f0_b).to(s.device), torch.from_numpy(ctrl_b).to(s.device),
                        phase_offset=torch.from_numpy(offset).to(s.device),
                        noise=torch.from_numpy(noise).to(s.device))
        outs.append(y.cpu().numpy())
    card_vs_cpu = nrms(outs[0], outs[1])
    emit({"phase": "card_vs_cpu", "frames": int(f0_b.shape[1]), "nrms": card_vs_cpu, "bar": 1e-3})
    if not card_vs_cpu <= 1e-3:
        raise RuntimeError(f"card and CPU renders differ: nRMS {card_vs_cpu}")

    # 5. timing on the main path's batch-8 inputs, and end to end
    b, ta, _ = timed_exc.shape
    tc = timed_film.shape[1]
    hop = ta // tc
    with torch.inference_mode():
        kernel_ms = cuda_median_ms(
            lambda: nf.film_shaper_cr(timed_exc, timed_film, weights, hop, packed=packed))
        plain_ms = cuda_median_ms(
            lambda: nf.film_shaper_cr_plain(timed_exc, timed_film, weights, hop))
    n_el = b * ta * 64
    flop = n_el * CR_FLOP_PER_ELEMENT
    nbytes = 4 * (2 * n_el + timed_film.numel() + packed.numel())
    bound_ms, bound_by = bound(flop, nbytes)
    emit({"phase": "timing_kernel", "B": b, "Tc": tc, "hop": hop, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "flop": flop, "bytes": nbytes, "bound_ms": bound_ms,
          "bound_by": bound_by, "share_of_bound": bound_ms / kernel_ms})
    del timed_exc, timed_film

    for label, requests in timed.items():
        f0_b, ctrl_b, _ = synth.prepare(requests)
        f0_t, ctrl_t = torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev)
        gen = torch.Generator().manual_seed(0)
        with torch.inference_mode():
            forward_ms = cuda_median_ms(lambda: synth.model(f0_t, ctrl_t, generator=gen))
        render_ms = host_median_ms(lambda: synth.render(requests, seed=0))
        audio_s = len(requests) * 4.0
        emit({"phase": "timing_render", "case": label, "padded_frames": int(f0_b.shape[1]),
              "forward_ms": forward_ms, "render_ms": render_ms,
              "forward_x_realtime": audio_s / (forward_ms / 1e3),
              "render_x_realtime": audio_s / (render_ms / 1e3)})

    stream = stream_phases(dev, synth, cpu_synth)
    timbre = timbre_phases(dev, synth, cpu_synth)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = write_tone_dataset(tmp / "data", splits=TONE_SPLITS)
        check_tone_splits(Path(root), tmp / "data_without_test")
        train = train_phases(dev, root, tmp)
        fl = audio_rate_phases(dev, synth, root, tmp)
        x = exciter_fused_phases(dev, synth, root, tmp, batch, single)
        mp = mixed_precision_phases(dev, root, tmp)
        rt = runtime_phases(dev, root, tmp)
        tc = train_chunked_phase(dev, root, tmp)
        pre = preprocess_phases(dev, tmp)
        fl16 = audio_rate_bf16_phases(dev, root, tmp)
        xb = exciter_fused_bf16_phases(dev, root, tmp)
        par = parallel_phases(dev, synth, cpu_synth, root, tmp)
        mc = measure_cli_phases(dev, root, tmp)
        q1 = queue1_phases(dev, root, tmp)

    emit({"kernels": [{
        "name": "film_shaper_fused_cr", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/newt_fused_cr.cu",
        "replaces": "neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:779",
        "launches": (launches + train["fwd_launches"] + rt["cr"] + tc["cr"] + pre["cr"] + par["cr"]
                     + mc["cr"] + q1["launches"]["cr"]),
        "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }, {
        "name": "_fused_bwd_cr", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/newt_fused_cr_bwd.cu",
        "replaces": "neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:822",
        "launches": (train["bwd_launches"] + rt["bwd"] + tc["bwd"] + pre["bwd"] + par["bwd"]
                     + mc["bwd"] + q1["launches"]["bwd"]),
        "max_abs_err": train["max_abs_err"],
        "ms": train["ms"], "plain_ms": train["plain_ms"], "bound_ms": train["bound_ms"],
        "bound_by": train["bound_by"], "library_ms": None,
    }, {
        "name": "film_shaper_fused_stream", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/newt_fused_stream.cu",
        "replaces": "neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:1509",
        "launches": stream["launches"] + mc["stream"], "max_abs_err": stream["max_abs_err"],
        "ms": stream["ms"], "plain_ms": stream["plain_ms"], "bound_ms": stream["bound_ms"],
        "bound_by": stream["bound_by"], "library_ms": None,
    }, {
        "name": "fast_newt_lookup", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/fast_newt_lookup.cu",
        "replaces": "neural_waveshaping_synthesis_tpu/kernels/fast_newt.py:68",
        "launches": timbre["launches"] + rt["lookup"] + mc["lookup"] + q1["launches"]["lookup"],
        "max_abs_err": timbre["max_abs_err"],
        "ms": timbre["ms"], "plain_ms": timbre["plain_ms"], "bound_ms": timbre["bound_ms"],
        "bound_by": timbre["bound_by"], "library_ms": None,
    }, {
        "name": "film_shaper_fused_fl", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/newt_fused_fl.cu",
        "replaces": "neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:488 and :417",
        "launches": fl["fwd_launches"] + par["fl"] + mc["fl"] + q1["launches"]["fl"],
        "max_abs_err": max(fl["fwd_max_abs_err"], par["fl_err"]),
        "ms": fl["fwd"][0], "plain_ms": fl["fwd"][1], "bound_ms": fl["fwd"][2],
        "bound_by": fl["fwd"][3], "library_ms": None,
    }, {
        "name": "_fused_bwd_fl", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/newt_fused_fl_bwd.cu",
        "replaces": "neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:527 and :450",
        "launches": fl["bwd_launches"] + mc["fl_bwd"] + q1["launches"]["fl_bwd"],
        "max_abs_err": fl["bwd_max_abs_err"],
        "ms": fl["bwd"][0], "plain_ms": fl["bwd"][1], "bound_ms": fl["bwd"][2],
        "bound_by": fl["bwd"][3], "library_ms": None,
    }] + [{
        "name": name, "route": "cuda",
        "source": f"neural_waveshaping_synthesis_tpu_torch/kernels/csrc/{source}",
        "replaces": f"neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:{line}",
        "launches": x["launches"][kind + ("_bwd" if bwd else "")],
        "max_abs_err": (x["bwd_err"] if bwd else x["fwd_err"])[kind],
        "ms": x["numbers"][kind][bwd][0], "plain_ms": x["numbers"][kind][bwd][1],
        "bound_ms": x["numbers"][kind][bwd][2], "bound_by": x["numbers"][kind][bwd][3],
        "library_ms": None,
    } for name, source, line, kind, bwd in (
        ("bank_film_shaper_fused_xcr", "newt_fused_x.cu", 1136, "xcr", 0),
        ("_fused_bwd_xcr", "newt_fused_x_bwd.cu", 1199, "xcr", 1),
        ("bank_newt_fused_xfull", "newt_fused_x.cu", 1383, "xfull", 0),
        ("_fused_bwd_xfull", "newt_fused_x_bwd.cu", 1447, "xfull", 1))] + [{
        "name": name + BF16_INSTANCES[io], "route": "cuda",
        "source": f"neural_waveshaping_synthesis_tpu_torch/kernels/csrc/{source}",
        "replaces": f"neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:{line}",
        "launches": mp["launches"][counter + "_" + io],
        "max_abs_err": (mp["bwd_err"] if bwd else mp["fwd_err"])[io],
        "ms": mp["numbers"][io][bwd][0], "plain_ms": mp["numbers"][io][bwd][1],
        "bound_ms": mp["numbers"][io][bwd][2], "bound_by": mp["numbers"][io][bwd][3],
        "library_ms": None,
    } for name, source, line, counter, bwd in (
        ("film_shaper_fused_cr", "newt_fused_cr.cu", 779, "cr", 0),
        ("_fused_bwd_cr", "newt_fused_cr_bwd.cu", 822, "bwd", 1)) for io in BF16_INSTANCES] + [{
        "name": name + BF16_INSTANCES["bf16"], "route": "cuda",
        "source": f"neural_waveshaping_synthesis_tpu_torch/kernels/csrc/{source}",
        "replaces": f"neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:{lines}",
        "launches": fl16["launches"][counter], "max_abs_err": fl16["bwd_err" if bwd else "fwd_err"],
        "ms": fl16["numbers"][bwd][0], "plain_ms": fl16["numbers"][bwd][1],
        "bound_ms": fl16["numbers"][bwd][2], "bound_by": fl16["numbers"][bwd][3], "library_ms": None,
    } for name, source, lines, counter, bwd in (
        ("film_shaper_fused_fl", "newt_fused_fl.cu", "488 and :417", "fl_bf16", 0),
        ("_fused_bwd_fl", "newt_fused_fl_bwd.cu", "527 and :450", "fl_bwd_bf16", 1))] + [{
        "name": name + BF16_INSTANCES[io],
        "route": "cuda", "source": f"neural_waveshaping_synthesis_tpu_torch/kernels/csrc/{source}",
        "replaces": f"neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:{line}",
        "launches": xb["launches"][f"{kind}{'_bwd' if bwd else ''}_{io}"],
        "max_abs_err": (xb["bwd_err"] if bwd else xb["fwd_err"])[(kind, io)],
        "ms": xb["numbers"][(kind, io)][bwd][0], "plain_ms": xb["numbers"][(kind, io)][bwd][1],
        "bound_ms": xb["numbers"][(kind, io)][bwd][2], "bound_by": xb["numbers"][(kind, io)][bwd][3],
        "library_ms": None,
    } for name, source, line, kind, bwd in (
        ("bank_film_shaper_fused_xcr", "newt_fused_x.cu", 1136, "xcr", 0),
        ("_fused_bwd_xcr", "newt_fused_x_bwd.cu", 1199, "xcr", 1),
        ("bank_newt_fused_xfull", "newt_fused_x.cu", 1383, "xfull", 0),
        ("_fused_bwd_xfull", "newt_fused_x_bwd.cu", 1447, "xfull", 1)) for io in BF16_INSTANCES] + [{
        "name": "fast_newt_lookup[bf16 x]", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/fast_newt_lookup.cu",
        "replaces": "neural_waveshaping_synthesis_tpu/kernels/fast_newt.py:68", **xb["lookup"],
        "library_ms": None}] + [{
        "name": f"roofline_chain[{label}]", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/roofline_chain.cu",
        "replaces": "scripts/roofline_shaper.py:171",
        "launches": q1["launches"][counter], **q1["chain"][instance], "library_ms": None,
    } for instance, (_, _, counter) in CHAIN_INSTANCES.items()
        for label in [instance.replace("_", ", ")]]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-cli"]:
        sys.exit(train_cli_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
