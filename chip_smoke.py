#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (eesen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  build   nvcc builds the kernels from eesen_tpu_torch/csrc (seconds).
  lstm    kernel lstm_fwd vs its plain version on the card, at the
          flagship layer shapes (B=8, T=512, H=320, D in {120, 640}, mixed
          lengths, state_bf16 on and off): rtol 2e-2 / atol 2e-3, the JAX
          package's own tolerance for its bf16 kernel; then kernels 1 and
          4 at the kernel table's shapes (`recurrence_steps`): ms a call,
          the recurrence's microseconds a step and the plan.
  dedup   kernel dedup_prune vs its plain version on the card (B=8, K=512,
          m in {4096, 14336}), then on the adversarial rows of
          tests/dedup_cases.py (-0.0/+0.0, negative scores, ties, all
          dead, one dst, few live, int32-extreme dst, NaN scores) at K=512
          and K=Mp, and at K=5000 with m in {8192, 13192} (phase options'
          budgeted merges): outputs must be equal, bit for bit.
  graph   the 71-phone bigram TLGs built by the port's host code.
  main    the serving path at full width: the WSJ-phn 4 x 320 BiLSTM (120-d
          input, 72 targets, random weights from a seed) serves 8
          utterances through recipes.run.run_search (posteriors + beam
          decode, beam 16, max_active 512) on the 2000-word TLG.  Launch
          counters are zeroed just before and read just after; the card's
          log-posteriors must match the CPU plain run (atol LP_ATOL),
          costs be finite and overflow 0.
  search  converged-CTC posteriors decoded on the card (kernels) and on
          the CPU (plain versions), on the arc-packed 2000-word TLG and
          the dense-rows 1000-word TLG: words identical, costs within
          1e-4 relative.
  skip    blank-skip, every recipe's decode setting (threshold 0.98): (i)
          the search phase's posteriors compacted on the card and on the
          CPU: kept counts, bucket and time_map equal, merged columns
          within SKIP_ATOL; (ii) the full and the compacted search on the
          card (wall ms, median of 3, profiler off; per original frame;
          kernel 2's launches of each), the compacted search's words on
          the card equal to the CPU's (costs within COST_RTOL), and how
          many utterances keep the full search's words; (iii)
          recipes.run.run_search with blank_skip on the main phase's
          batch: kernels 1 and 2 launched, finite costs, overflow 0; (iv)
          greedy_decode_logits of the main phase's lp, card against CPU.
  stream  the streaming path at full width: a unidirectional 4 x 320
          model (120-d input, 72 targets, random weights from a seed) on
          the main phase's 8 utterances in 16-frame chunks (160 ms):
          (i) offline posteriors, 4 lstm_fwd launches; (ii)
          StreamingAcousticModel chunk by chunk (the carried torch-op
          scan): no LSTM kernel launched, lp within LP_ATOL of the offline
          and of the same chunks on the CPU, and in f32 compute within
          STREAM_ATOL of the CPU; (iii) the
          offline lp chunk by chunk into StreamingBeamDecoder on the
          packed TLG: the one-shot decode's words, costs within
          STREAM_COST_RTOL; (iv) StreamingPipeline: the words of the
          card's one-shot decode of its own streamed lp.  Per chunk: the
          AM step's, accept's, partial's and the pipeline's ms (host
          clock, synchronized), the real-time factor (pipeline ms /
          160 ms) and kernel 2's launches.
  options the search options and the batch-major layer: (i) scan_unroll=4
          on main's lp, bit-equal with the same kernel 2 launches; (ii)
          the recipes' beam 17 / max_active 5000 on the packed TLG and
          the converged posteriors: unbudgeted (sort route, no kernel 2),
          approx_top_k (equal bits), OPT_BUDGETS (emit merges on kernel
          2, overflow 0, the unbudgeted words, costs within COST_RTOL;
          ms a frame of each, the peak live degree per table) and
          OPT_SMALL_BUDGET (every merge on kernel 2, overflow counted);
          (iv) light_closure/emit_dedup alone and together at K=512 on 2
          utterances, card against CPU (words, COST_RTOL), kernel 2's
          launches (0 with both) and the words kept from the full
          search; (v) the 1000-word TLG compiled with hubs (the lowest
          degree threshold whose emit merge fits kernel 2) against the
          graph without: words, COST_RTOL, lanes, route and launches;
          (vi) bilstm_layer layer by layer through the 4 x 320 stack:
          bilstm_layer_tm's bits, 2 lstm_fwd launches a layer.
  frontend audio in on the card: 64 utterances of the seeded synthetic
          corpus (recipes/synth_corpus, 40 phones, 4-10 words) padded to
          one power-of-two bucket: (i) fbank at the wsj_phn options (40
          bins, no dither) on all 64 and at the 9 augmentation views
          (frame shift 8/10/11 ms x VTLN warp 0.8/1.0/1.2) on 8, card
          against CPU within FE_TOL where the mel power is above
          FE_MEL_FLOOR; (ii) FeaturePipeline (per-speaker CMVN) at both
          recipe configurations (deltas, 120-d; splice + subsample x3,
          360-d) on each side's fbank: card within PIPE_ATOL of CPU, the
          static dims' per-speaker means within CMVN_MEAN_ATOL of 0;
          (iii) mfcc, plp and resample card against CPU; (iv)
          kaldi_pitch on the card against tests/data/pitch_golden at
          tests/test_pitch.py's per-case tolerances; (v) fbank audio-s
          per second over the batch of 64 on the card (events) and the
          CPU (host clock), and kaldi_pitch ms per audio-second on 10 s
          (a loop over frames).
  recipe  audio in, words out: RecipeRun(RECIPES["wsj_phn"], device=
          "cuda") (4 x 320, 120-d input, 41 targets from the corpus's 40
          phones; the newbob schedule cut to RECIPE_MAX_ITERS epochs) on
          the corpus split 48 / 8 / 8: (i) compute_features with dither
          (finite, 120-d, CMVN means near 0), and without dither card
          against CPU (raw fbank within FE_TOL above the floor, pipeline
          features within PIPE_ATOL); (ii) train with counters zeroed just
          before and read just after: per train step 8 lstm_fwd, 8
          lstm_bwd, 1 ctc_alpha, 1 ctc_beta, per CV step 8 lstm_fwd and 1
          + 1 CTC; finite objectives; (iii) build_graph (a bigram of the
          training texts over the 300-word lexicon) and decode of the
          test set at the recipe's settings (beam 17, max_active 5000,
          blank-skip 0.98): finite costs, overflow 0, 8 lstm_fwd a decoder
          call, kernel 2's launches as kernel2_launches predicts them
          from the merge widths, the WER and ms per frame; (iv) the same
          parameters on the CPU decode the RECIPE_CPU_UTTS shortest test
          utterances: the card's words, costs within COST_RTOL; (v)
          check_blank_skip_parity on the card, its verdict recorded;
          (vi) wall seconds of each stage; (vii) score_sweep over the
          test set at the recipe's acwt_sweep with
          counters zeroed just before and read just after: the guard's
          two searches and the lattice search, 8 lstm_fwd a decoder call
          and kernel 2 as kernel2_launches predicts; the swept WER at the
          decode's acwt equals the decode's, and each utterance's lattice
          best path there is the decode's words; per-acwt WER and the
          seconds of the searches and of the host lattice work apart;
          (viii) write_eesen_nnet of the trained parameters and
          read_eesen_nnet onto the card: equal bits in every tensor and
          bit-equal posteriors of the read-back model on one test chunk;
          (ix) emit_nnet_proto -> parse_nnet_proto of every RECIPES model
          and the trained one.
  cli     the command line (eesen_tpu_torch.tools.cli.main in this
          process, --device cuda, files under tmp/chip_smoke_cli; the
          counters zeroed just before each command and read just after):
          (i) net-output-extract of main's 8 utterances (its model saved
          as the port's model file, its priors as class frame counts), one
          a call at B=1: 8 lstm_fwd launches a call, lp within LP_ATOL of
          main's batched lp; the B=1 forward's ms per utterance beside
          the B=8 forward's; (ii) latgen on main's lp and the packed TLG
          pickled by the port (beam 16, max_active 512, acwt 0.9, batch
          8): main's words, costs within COST_RTOL, kernel 2 launched;
          (iii) on the search phase's converged posteriors, latgen
          --blank-skip 0.98, --streaming --chunk-frames 16 and
          --lattice-ark then lattice-best-path at acwt 0.9: the offline
          latgen's words; (iv) decode-faster (the dense Viterbi) there:
          each cost no higher than the beam search's (within COST_RTOL),
          how many of the 8 give its words, ms per frame beside the beam
          search's; on the 68,364-state TLG the CLI_DENSE_CPU_UTTS
          shortest on the card and with --device cpu: equal words, costs
          within COST_RTOL; (v) align of main's 8 with seeded labels: 8
          lstm_fwd a call, ctc_align of the same f32 lp on the card and
          the CPU equal, the command's segments those of the card; (vi)
          train on the recipe phase's 48 / 8 CMVN'd features and labels
          (the recipe's 4 x 320, 41 targets, its batch, RECIPE_MAX_ITERS
          epochs): per step 8 / 8 / 1 / 1 launches of lstm_fwd /
          lstm_bwd / ctc_alpha / ctc_beta (CV steps 8 / 0 / 1 / 1),
          finite objectives; model-info; net-copy to .nnet gives
          write_eesen_nnet's bytes; net-output-extract -> latgen (the
          recipe's decode settings and graph) -> compute-wer on the 8
          test utterances, the WER recorded; (vii) compute-fbank-feats
          (40 bins) on 8 of the frontend phase's waves, card against
          --device cpu within FE_TOL above FE_MEL_FLOOR.  Each command's
          seconds and launches.
  examples the end-to-end recipe scripts (eesen_tpu_torch/examples/, in
          this process, files under tmp/chip_smoke_examples): (i)
          toy_recipe.main on the card, its default: kernels lstm_fwd,
          lstm_bwd, ctc_alpha, ctc_beta and dedup_prune launched, a finite
          WER; (ii) stress_recipe.main through tools/stress_timing.run at
          EXAMPLES_STRESS_ARGS (1,200 / 32 / 12 utterances, a 20,000-
          sentence trigram LM over the full 20,000-word lexicon, 2 repeats
          an epoch): the parity battery passes (the sweep at the decode
          acwt equals the direct re-decode, the blank-skip guard ran on 6
          utterances, const-arpa rescoring agrees with the G-fst automaton
          on 10 of 10 lattices); training launches 8 lstm_fwd per CTC
          launch and lstm_bwd in eights; each decode stage 8 lstm_fwd a
          chunk and kernel dedup_prune where both merges fit it.  Per
          stage the seconds, launches, peak memory and decode ms per
          frame; the TLG, its merge widths and the peak live arcs.
  lstm_bwd at the training shapes (B=128, T=768, H=320, D in {120, 640},
          mixed lengths with a length-0 row, state_bf16 on and off): first
          kernel lstm_fwd with residuals vs its plain version (m and c at
          the lstm phase's tolerance, the gates at the bf16 one), then
          kernel lstm_bwd vs its plain version on those residuals: rtol
          5e-2 / atol 5e-3 on the weight gradients (atol in units of their
          largest entry, see BWD_W_TOL), rtol 5e-2 / atol 2e-2 on dx, and
          every gradient within BWD_REL_L2 relative L2.
  ctc     kernels ctc_alpha and ctc_beta vs their plain versions on the
          card at B=128 and the CTC_CASES shapes (T=768, L=100 so S=201;
          T=768, L=200 so S=401; T=1300, L=600 so S=1201, two states a
          thread), mixed frame and label lengths, repeated labels, a
          length-0 row: LOG_ZERO positions identical, elsewhere within
          rtol CTC_RTOL / atol CTC_ATOL.
  train   the training path at full width: the same 4 x 320 model trained
          with SGD (momentum 0.9, max_grad 50, lr 4e-5) through
          training.trainer.make_train_step.  (i) one step on 8 rows of
          the batch on the card and on the CPU (plain versions) from the
          same parameters: loss within TRAIN_LOSS_RTOL, and the clipped
          gradient (the momentum buffer after one step) within
          TRAIN_GRAD_RTOL relative L2 per parameter; (ii) TRAIN_STEPS
          chained steps at B=128, T=768, L=100 with counters zeroed just
          before and read just after: finite losses, and per step 8
          lstm_fwd, 8 lstm_bwd, 1 ctc_alpha and 1 ctc_beta launches;
          seconds per step and audio-s/s = B*T*0.010 / (s per step);
          (iii) one step under the profiler, the CTC kernels' device
          time apart.
  mesh    the data-parallel path (parallel/): (i) a world of one over
          NCCL in this process: Trainer(mesh=...) and the plain Trainer
          from the same parameters, MESH_STEPS steps each at B=128, T=768,
          L=100 (plain, mesh, mesh, plain), equal parameter bits and
          reports, the same 8/8/1/1 launches a step (counters zeroed just
          before each run); s a step of each, and the all-reduce of one
          step's gradient bucket alone; make_sharded_beam_decoder over
          phase main's 8 utterances: main's words and costs.  (ii) two
          ranks on the one card over gloo, spawned as `chip_smoke.py
          --mesh-rank R PORT DIR`: MESH_STEPS steps of 2 x 32 rows in f32
          against this process's step over the 64 rows (loss and
          parameters at rtol 1e-4 / atol 1e-5), the ranks' parameters
          equal bits, 8/8/1/1 launches a step on each; the sharded decode
          of main's utterances, 4 a rank (posteriors on the rank's rows,
          gathered): main's words, costs within 1e-4, kernels lstm_fwd
          and dedup_prune launched on each rank; s a step and the
          all-reduce's share (the ranks share the card's SMs: not a
          scaling figure).  The `model` axis, spawned the same way with
          the grid's sizes: (iii) data=1 x model=2, two ranks, each
          holding half of every split leaf and taking all 64 rows:
          loss and every gathered parameter equal bits to this process's
          64-row step, 8/8/1/1 launches a step on each rank, each rank's
          shard shapes, the gather of the parameters alone (ms); (iv)
          data=2 x model=2, four ranks, 32 rows a data index: equal bits
          to (ii)'s parameters and losses and across ranks, a checkpoint
          written on this mesh and restored gives the same state, and
          the sharded decode of main's utterances over "data" and over
          "model": main's words, costs within 1e-4.
  lstm_v1 the v1 route at the LibriSpeech width and its own: (i) kernel
          lstm_scan_fwd vs its plain version (B=128, T=768, H=640 and
          H=1152, training lengths with a length-0 row; m, c, c_raw at
          the lstm tolerance and the gates at the bf16 one, each step
          against the plain step from the kernel's own carries; all four
          within BWD_REL_L2 of the free-running plain version, whose
          elementwise error is recorded); (ii) kernel lstm_scan_bwd vs its
          plain version on those residuals and a random gm (dxw within
          BWD_DX_TOL and BWD_REL_L2); both on their cluster designs at
          these shapes; (iii) the v1 route against the fused route on the
          card (D=1280, the same inputs and f32 weights): m at the lstm
          tolerance, the gradients of x, W_x, W_m, bias and peepholes
          within BWD_REL_L2; (iv) the route choice: `_direction_scan` at
          H=1152 (D=1152, B=8, T=64), counters zeroed just before and read
          just after, must launch lstm_scan_fwd and lstm_scan_bwd once and
          lstm_fwd / lstm_bwd never, and match the CPU plain run (m at
          the lstm tolerance, gradients within BWD_REL_L2); (v) the same
          at H=2688, past both cluster plans' limits: the thread-per-unit
          designs (m within BWD_REL_L2: at that width a 1e-6 change of x
          moves the CPU run itself by 2.5x the lstm tolerance).
  libri   the LibriSpeech char model (4 x 640, 360-d input, 30 targets,
          random weights from a seed): (i) serve B=8, T=512 through
          recipes.run.posteriors (8 lstm_fwd launches), log-posteriors
          within LP_ATOL of the CPU plain run; (ii) train without dropout,
          SGD, B=128, T=768, L=200 (S=401), LIBRI_STEPS chained steps:
          finite losses, per step 8 lstm_fwd, 8 lstm_bwd, 1 ctc_alpha, 1
          ctc_beta; s/step and audio-s/s at 0.030 s a frame, and one step
          under the profiler (the CTC kernels apart); (iii) train
          with the recipe's dropout (recurrent 0.2 no_mem_loss and forward
          0.2, per sequence, twiddle): one step on 8 rows on the card and
          on the CPU from the same parameters and generator seed (the same
          masks; loss and clipped gradients as in train (i)), the model
          cut to its first LIBRI_DROP_CHECK_LAYERS layers (the CPU's
          plain scan costs minutes a step at full depth), then one
          step at B=20 (the recipe's num_sequence) on the card: finite
          loss, seconds, peak memory; no LSTM kernel launches (the
          dropout scan runs in torch ops), 1 ctc_alpha, 1 ctc_beta.
  timing  kernel and plain-version times at the main paths' shapes (CUDA
          events, median) beside each kernel's bound (kernel lstm_fwd also
          per step, with its cluster plan and whether all its clusters
          are co-resident; kernel lstm_bwd also the profiler's device ms
          of its recurrence and of its products apart, the recurrence per
          step, and its cluster plan and residency; kernel dedup_prune
          also its device time per launch under torch.profiler, since the
          wrapper's host time is as long as the kernel; kernels ctc_alpha
          and ctc_beta at the three CTC_CASES shapes, also per step
          and over 10 launches back to back, with the library's plan
          (ctc_depth, ctc_smem_bytes)), and the library
          call where one computes the same function (torch's ctc_loss on
          the same logits); at the training shapes kernel lstm_fwd's
          projection and recurrence apart (profiler device ms), and the
          product kernel alone (gemm_bf16: event ms, TFLOP/s and bound)
          for kernel 1's projection and kernel 3's three products beside
          torch.matmul of the same bf16 operands;
          kernels lstm_scan_fwd/bwd at B=128, T=768, H=640 and H=1152 (ms
          and µs a step, design, plan and residency) beside the
          thread-per-unit design on the same inputs; at H=640
          also kernels
          lstm_fwd/lstm_bwd at D in {360, 1280} (B=128, T=768, and
          serving B=8, T=512), and the two routes' forward + backward per
          direction-layer at D=1280.
  profile the forward (B=8, T=512) and the decode of its posteriors:
          wall ms (host clock to synchronize, profiler off; decode also
          per frame), then under torch.profiler the device-busy ms (sum
          of kernel times), the idle share, and the top kernels (the
          forward's shows kernel lstm_fwd's projection, gemm_bf16_kernel,
          and its recurrence, lstm_rec_kernel, apart).
Then the `kernels` report line, the card's name and power limit, and
last `{"ok": true, "device": {...}}` -- printed only when every phase
passed.  Without CUDA, or without the eesen_tpu_torch package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback as tb

import numpy as np

# the adversarial recombination rows (tests/dedup_cases.py; no jax, no torch)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
B = 8
T_MAX = 512
LENGTHS = (512, 497, 463, 430, 388, 341, 290, 256)
K = 512
DECODE = dict(beam=16.0, max_active=K, funnel_mult=2, acoustic_scale=0.9)
LSTM_RTOL, LSTM_ATOL = 2e-2, 2e-3
# the JAX package's tolerances for its fused gradients
# (tests/test_lstm_pallas.py:137-144): weights, then dx.  Its gradients
# are O(1); here the weight gradients are sums over B*T = 98,304 rows with
# entries up to ~400, and a bf16 recurrence run in another f32 order
# drifts to the bf16 rounding floor (relative L2 error ~1e-3), so for the
# weights the absolute part is taken in units of the reference's largest
# entry where that exceeds 1:
#   |got - ref| <= atol * max(1, max|ref|) + rtol * |ref|
# That is looser than the JAX package's atol on the weights, so every
# gradient is also held to 1e-2 relative L2 (~5x the drift measured).
BWD_W_TOL, BWD_DX_TOL = (5e-2, 5e-3), (5e-2, 2e-2)
BWD_REL_L2 = 1e-2
# the gate residuals are in the compute dtype (bf16): the bf16 tolerance
GATES_RTOL, GATES_ATOL = 2e-2, 2e-3
# alpha/beta reach magnitudes of ~4e3 after 768 frames; the kernel and its
# plain version take the same steps, float32 rounding apart (FMA
# contraction), so 1e-5 relative, 1e-3 absolute
CTC_RTOL, CTC_ATOL = 1e-5, 1e-3
# training shapes (bench.py:50,99-120, the JAX package's headline)
TRAIN_B, TRAIN_T, TRAIN_L = 128, 768, 100
TRAIN_HEAD = (768, 731, 640, 512, 397, 256, 128, 0)   # rows 0-7; rest 768
TRAIN_STEPS = 5
LEARN_RATE = 4e-5
# launches of one training step of the 4 x 320 model, by counter
TRAIN_STEP_LAUNCHES = {"lstm_fwd": 8, "lstm_bwd": 8, "lstm_scan_fwd": 0,
                       "lstm_scan_bwd": 0, "ctc_alpha": 1, "ctc_beta": 1}
# the mesh path: (i) Trainer(mesh=...) over NCCL in a world of one,
# MESH_STEPS steps at the training shapes beside the plain Trainer; (ii)
# to (iv) ranks on the one card over gloo (NCCL refuses two ranks on one
# GPU), (data, model) as MESH_GRIDS gives them, MESH_RANK_ROWS rows a
# data index of 2 (MESH_ROWS in all) in f32, (ii) held as
# tests/test_shard_map_step.py holds the JAX step; each spawned run is
# killed past MESH_TIMEOUT_S
MESH_STEPS, MESH_RANK_ROWS = 3, 32
MESH_ROWS = 2 * MESH_RANK_ROWS
MESH_GRIDS = {"two_ranks": (2, 1), "model_axis": (1, 2),
              "data_model": (2, 2)}
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5
MESH_TIMEOUT_S = 300
MESH_REPS = 5
# the LibriSpeech char recipe (recipes/config.py:149-170): 4 x 640 over
# 360-d input (40 fbank + deltas, spliced +-1), 30 targets (blank + 29
# characters; the recipe takes the count from its lang dir); 3 frames per
# 10 ms subsampled, so 0.030 audio-s per frame (recipes/config.py:60-65)
LIBRI_D, LIBRI_H, LIBRI_V = 360, 640, 30
LIBRI_L, LIBRI_STEPS, LIBRI_DROP_B = 200, 3, 20
LIBRI_DROP_CHECK_LAYERS = 2
LIBRI_FRAME_S = 0.030
# a direction kernels 1 and 3 cannot take: the v1 route, on the cluster
# designs of kernels 4 and 5; and one past both cluster plans' limits
# (kernel 4's H <= 2624, kernel 5's H <= 1664): the thread-per-unit designs
V1_H = 1152
V1_WIDE_H = 2688
# card (kernels, state_bf16) vs CPU (plain versions, f32 state as the JAX
# package's CPU path), bf16 compute: the loss through four layers as the
# serving check's log-posteriors; the gradients differ by the bf16
# rounding of the m cotangent and of the c carry on the card (2^-9
# relative each), so 5e-2 relative L2 per parameter
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-3, 5e-2
# log-posteriors, card vs CPU plain run: sums run in another order, and a
# last-bit difference can flip the bf16 rounding of a layer's output
# (2^-9 relative) that the next layer reads; four layers deep
LP_ATOL = 5e-2
COST_RTOL = 1e-4
# blank-skip (every recipe's decode setting) and its check: kept counts,
# time_map and lengths exact, card vs CPU; the merged columns are
# differences of cumsums that reach ~10^3 at T=512, summed in another
# order on the card, so a few ulp of that
SKIP_THRESHOLD = 0.98
SKIP_ATOL = 1e-3
# streaming: 16-frame chunks (160 ms at WSJ's 10 ms frames).  The carried
# scan runs the same torch ops on the card and the CPU (f32 state); in
# bf16 compute a last-bit difference of a matmul sum can flip the bf16
# rounding of m, as LP_ATOL says (3.9e-4 measured at 4 x 320, T=512), so
# the streamed lp is held to LP_ATOL there and to STREAM_ATOL in f32
# compute, where only the summation order differs
CHUNK = 16
WSJ_FRAME_MS = 10.0
STREAM_ATOL = 1e-4
STREAM_COST_RTOL = 1e-4
# phase options: the recipes' decode setting (recipes/config.py wsj_phn:
# beam 17, max_active 5000) on the packed graph.  Unbudgeted, its merges
# (40,000 and 140,000 lanes) take the sort route.  OPT_BUDGETS puts the
# emit merge on kernel 2 at its cap of 16,384 lanes and narrows the
# closure merge to K + 40,960 lanes (still the sort route: the closure's
# live degree outgrows the 11,384 lanes kernel 2 leaves beside K); the
# phase records both peaks.  OPT_SMALL_BUDGET puts both merges on kernel
# 2 (8192 and 13,192 lanes) and drops arcs, counted in overflow.
OPT_K, OPT_BEAM = 5000, 17.0
OPT_BUDGETS = dict(arc_budget_emit=16384, arc_budget_x=40960)
OPT_SMALL_BUDGET = 8192
LIGHT_UTTS = 2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
F32_OPS = 67e12                # float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _cuda_ms(fn, reps: int) -> float:
    """Median ms of `reps` calls, each timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _cuda_ms_back_to_back(fn, reps: int, per: int = 10) -> float:
    """Median ms per call over `reps` runs of `per` calls back to back,
    each run timed with CUDA events: the device stays busy, so the host's
    time to launch a call is not counted while it is shorter than the
    kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def _device_ms(fn, kernel: str, reps: int) -> float | None:
    """Device ms per launch of the CUDA kernel whose name holds `kernel`,
    over `reps` calls of fn under torch.profiler: the kernel alone, where
    an event pair around one call of a short kernel also takes in the
    wrapper's host time before the launch.  None when the profiler
    recorded no launch of it (`_device_split`)."""
    hit = _device_split(fn, {"kernel": (kernel,)}, reps)["kernel"]
    return hit["ms"] / hit["launches"] if hit["launches"] else None


def _mask(dev):
    import torch

    lens = torch.tensor(LENGTHS, device=dev)
    return (torch.arange(T_MAX, device=dev)[:, None] < lens[None, :]).float()


def lstm_inputs(d: int, h: int, dev, seed: int):
    """One direction-layer's inputs at the flagship shapes (bf16)."""
    import torch

    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dt)

    # layer 1 sees normalized features, later layers LSTM outputs in (-1, 1)
    x = rng.standard_normal((T_MAX, B, d)) if d in (120, LIBRI_D) else \
        rng.uniform(-1, 1, (T_MAX, B, d))
    u = lambda *s: rng.uniform(-0.1, 0.1, s)
    return dict(
        x=t(x, torch.bfloat16), mask=_mask(dev),
        w_x=t(u(d, 4 * h), torch.bfloat16), bias=t(u(4 * h)),
        w_m=t(u(h, 4 * h), torch.bfloat16), ph=t(u(3, h)),
    )


def phase_lstm(dev):
    from eesen_tpu_torch.ops import lstm_cuda

    errs = {}
    for d in (120, 640):
        inp = lstm_inputs(d, 320, dev, SEED + d)
        for sb in (False, True):
            got = lstm_cuda.lstm_direction(**inp, state_bf16=sb).float()
            ref = lstm_cuda.lstm_direction_ref(**inp, state_bf16=sb).float()
            err = float((got - ref).abs().max())
            ok = bool(np.allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                  rtol=LSTM_RTOL, atol=LSTM_ATOL))
            errs[f"D{d}_state_bf16_{int(sb)}"] = err
            if not ok:
                raise AssertionError(f"lstm_fwd D={d} state_bf16={sb}: "
                                     f"max abs err {err}")
    return {"max_abs_err": errs, "rtol": LSTM_RTOL, "atol": LSTM_ATOL,
            "steps": recurrence_steps(dev)}


# kernel 1's shapes in PERF.md's kernel table: (serving B=8, T=512 or
# training B=128, T=768 with residuals, H, D)
K1_TABLE = (("serve", 320, 120), ("serve", 320, 640), ("train", 320, 120),
            ("train", 320, 640), ("serve", LIBRI_H, LIBRI_D),
            ("serve", LIBRI_H, 2 * LIBRI_H), ("train", LIBRI_H, LIBRI_D),
            ("train", LIBRI_H, 2 * LIBRI_H))


def recurrence_steps(dev):
    """Kernels 1 and 4 at the kernel table's shapes: ms a call (CUDA
    events, median) and the recurrence's microseconds a step (kernel 1:
    its recurrence's device ms per launch from the profiler, over T;
    kernel 4, which is the recurrence alone: the call over T), with the
    plan."""
    import torch
    from eesen_tpu_torch.ops import lstm_cuda, lstm_v1_cuda

    out = {}
    for kind, h, d in K1_TABLE:
        if kind == "serve":
            inp, b, t = lstm_inputs(d, h, dev, SEED + d), B, T_MAX
            res = False
        else:
            inp, _ = train_lstm_inputs(d, h, dev, SEED + d + 1, True)
            b, t, res = TRAIN_B, TRAIN_T, True

        def k1():
            return lstm_cuda.lstm_direction(**inp, state_bf16=True,
                                            with_residuals=res)

        plan = lstm_cuda.fwd_plan(b, h)
        rec = _device_split(k1, {"recurrence": ("lstm_rec_kernel",)})
        rec_ms = _per_call(rec["recurrence"], rec["recurrence"]["launches"])
        out[f"lstm_fwd_{kind}_H{h}_D{d}"] = dict(
            ms=_cuda_ms(k1, 5), recurrence_ms=rec_ms,
            us_per_step=rec_ms * 1e3 / t if rec_ms is not None else None,
            plan=plan._asdict(), shape=f"B={b} T={t} D={d} H={h}")
        del inp
    for h, seed in ((LIBRI_H, SEED + 21), (V1_H, SEED + 25)):
        inp = scan_inputs(dev, seed, h)
        ms = _cuda_ms(lambda: lstm_v1_cuda.lstm_scan_fwd(**inp), 3)
        plan = lstm_cuda.fwd_plan(TRAIN_B, h)
        out[f"lstm_scan_fwd_H{h}"] = dict(
            ms=ms, us_per_step=ms * 1e3 / TRAIN_T, plan=plan._asdict(),
            shape=f"B={TRAIN_B} T={TRAIN_T} H={h}")
        del inp
        torch.cuda.empty_cache()
    return out


def dedup_inputs(m: int, dev, seed: int):
    """Random proposals as in tests/test_beam_pallas.py."""
    import torch

    rng = np.random.default_rng(seed)
    dst = rng.integers(0, m // 2, (B, m)).astype(np.int32)
    score = (rng.standard_normal((B, m)) * 4.0).astype(np.float32)
    dead = rng.random((B, m)) < 0.15
    score[dead] = np.inf
    dst[dead] = 0
    return torch.from_numpy(dst).to(dev), torch.from_numpy(score).to(dev)


def _dedup_equal(what, dst, score, k):
    """Kernel dedup_prune vs its plain version: equal outputs (and the
    same sign bits, so -0.0 never stands for +0.0)."""
    import torch
    from eesen_tpu_torch.ops import beam_cuda

    got = beam_cuda.dedup_prune(dst, score, k, DECODE["beam"])
    ref = beam_cuda.dedup_prune_ref(dst, score, k, DECODE["beam"])
    for name, a, r in zip(("states", "scores", "kept"), got, ref):
        if not (torch.equal(a, r) and torch.equal(torch.signbit(a),
                                                  torch.signbit(r))):
            raise AssertionError(f"dedup_prune {what}: {name} differ")


def phase_dedup(dev):
    import torch
    from dedup_cases import CASES, make_case

    errs = {}
    for m, ks in ((4096, (K, 4096)), (14336, (K, 16384)),
                  # the budgeted merges of phase options at K = OPT_K
                  (OPT_SMALL_BUDGET, (OPT_K,)),
                  (OPT_K + OPT_SMALL_BUDGET, (OPT_K,))):
        _dedup_equal(f"m={m} k={ks[0]}", *dedup_inputs(m, dev, SEED + m),
                     ks[0])
        errs[f"m{m}_k{ks[0]}"] = 0.0
        for k in ks:
            for case in CASES:
                dst, score = make_case(case, B, m, seed=SEED + m + k)
                _dedup_equal(f"m={m} k={k} {case}",
                             torch.from_numpy(dst).to(dev),
                             torch.from_numpy(score).to(dev), k)
                errs[f"m{m}_k{k}_{case}"] = 0.0
    return {"max_abs_err": errs, "exact": True, "cases": list(CASES)}


def build_graph(num_words: int, num_sents: int):
    """71-phone bigram TLG (bench.py's inline graph, with the phone count
    of the 72-target model), compiled with degree cap 8 and the eps
    closure.  Returns (graph, lang, lexicon, the TLG Fst)."""
    from eesen_tpu_torch.decoder.arpa import arpa_to_fst
    from eesen_tpu_torch.decoder.ctc_graph import (
        build_lg, build_tlg, compile_lang,
    )
    from eesen_tpu_torch.decoder.graph_compile import compile_graph
    from eesen_tpu_torch.recipes.lm import estimate_bigram_arpa
    from eesen_tpu_torch.recipes.synth_corpus import SynthConfig, make_lexicon

    scfg = SynthConfig(num_phones=71, num_words=num_words)
    rng = np.random.default_rng(7)
    lex = make_lexicon(scfg, rng)
    vocab = [w for w, _ in lex]
    sents = [
        [vocab[int(j)] for j in rng.integers(0, len(vocab),
                                             int(rng.integers(4, 12)))]
        for _ in range(num_sents)
    ]
    arpa = estimate_bigram_arpa(sents, vocab=vocab)
    units = [f"p{i:02d}" for i in range(scfg.num_phones)]
    lang = compile_lang(lex, units, dict_type="phn")
    fst = build_tlg(lang.t_fst, build_lg(lang.l_fst, arpa_to_fst(
        arpa, lang.words)))
    return (compile_graph(fst, max_degree=8, build_closure=True), lang, lex,
            fst)


def phase_graph(graphs, state):
    from eesen_tpu_torch.decoder.beam import use_dense_rows

    out = {}
    for tag, (nw, ns) in (("packed", (2000, 20000)), ("dense", (1000, 5000))):
        t0 = time.perf_counter()
        g, lang, lex, fst = build_graph(nw, ns)
        graphs[tag] = (g, lang, lex)
        if tag == "dense":
            state["dense_fst"] = fst        # phase options recompiles it
        layout = "dense" if use_dense_rows(g) else "packed"
        if layout != tag:
            raise AssertionError(f"{tag} graph took the {layout} layout")
        out[tag] = dict(words=nw, sentences=ns, states=g.num_states,
                        max_emit_degree=g.max_emit_degree,
                        max_closure_degree=g.max_closure_degree,
                        seconds=time.perf_counter() - t0)
    return out


def model_and_inputs(dev):
    import torch
    from eesen_tpu_torch.models.model import AcousticModelConfig, init_model
    from eesen_tpu_torch.models.priors import compute_log_priors

    cfg = AcousticModelConfig(input_dim=120, cell_dim=320, num_layers=4,
                              num_targets=72)
    gen = torch.Generator().manual_seed(SEED)
    params = init_model(gen, cfg, device=dev)
    rng = np.random.default_rng(SEED)
    feats = {f"utt{i}": rng.standard_normal((n, 120)).astype(np.float32)
             for i, n in enumerate(LENGTHS)}
    counts = rng.integers(1, 1000, cfg.num_targets).astype(np.float64)
    return cfg, params, feats, compute_log_priors(counts), counts


def _to_cpu(params):
    if isinstance(params, dict):
        return {k: _to_cpu(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_to_cpu(v) for v in params]
    return params.cpu()


def counters():
    from eesen_tpu_torch.ops import (
        beam_cuda, ctc_cuda, lstm_cuda, lstm_v1_cuda,
    )

    return {"lstm_fwd": lstm_cuda.launches, "dedup_prune": beam_cuda.launches,
            "lstm_bwd": lstm_cuda.bwd_launches,
            "lstm_scan_fwd": lstm_v1_cuda.launches,
            "lstm_scan_bwd": lstm_v1_cuda.bwd_launches,
            "ctc_alpha": ctc_cuda.alpha_launches,
            "ctc_beta": ctc_cuda.beta_launches}


def reset_counters():
    from eesen_tpu_torch.ops import (
        beam_cuda, ctc_cuda, lstm_cuda, lstm_v1_cuda,
    )

    lstm_cuda.launches = 0
    lstm_cuda.bwd_launches = 0
    lstm_v1_cuda.launches = 0
    lstm_v1_cuda.bwd_launches = 0
    beam_cuda.launches = 0
    ctc_cuda.alpha_launches = 0
    ctc_cuda.beta_launches = 0


def phase_main(dev, graphs, state):
    import torch
    from eesen_tpu_torch.decoder.beam import BeamSearchConfig, traceback
    from eesen_tpu_torch.recipes.run import posteriors, run_search

    g = graphs["packed"][0]
    cfg, params, feats, log_priors, counts = model_and_inputs(dev)
    bcfg = BeamSearchConfig(**DECODE)
    reset_counters()
    t0 = time.perf_counter()
    runs = list(run_search(params, cfg, g, feats, log_priors, bcfg,
                           batch_size=B, device=dev))
    hyps = {}
    for chunk, _, lens, out in runs:
        for key, res in zip(chunk, traceback(out, lens, g.final_weight)):
            hyps[key] = res
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in counters().items()
                if k in ("lstm_fwd", "dedup_prune")}
    state["launches"] = launches
    if dev.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    (chunk, lp, lens, out), = runs
    overflow = int(out.overflow.sum())
    costs = [hyps[k][1] for k in feats]
    if overflow or not np.all(np.isfinite(costs)) or len(hyps) != B:
        raise AssertionError(f"overflow {overflow}, costs {costs}")
    # the same utterances through the CPU plain versions
    arr = np.zeros((B, T_MAX, 120), np.float32)
    for j, key in enumerate(chunk):
        arr[j, : len(feats[key])] = feats[key]
    lp_cpu = posteriors(_to_cpu(params), cfg, arr, lens, log_priors,
                        device="cpu")
    valid = torch.from_numpy(np.arange(T_MAX)[None, :] < lens[:, None])
    diff = (lp.cpu() - lp_cpu).abs()[valid]
    lp_err = float(diff.max())
    if not lp_err <= LP_ATOL:
        raise AssertionError(f"log-posteriors differ by {lp_err}")
    state.update(params=params, cfg=cfg, arr=arr, lens=lens,
                 log_priors=log_priors, counts=counts, lp=lp,
                 hyps=[hyps[k] for k in chunk])
    return {"utterances": len(hyps), "frames": int(sum(LENGTHS)),
            "wall_s": wall, "launches": launches, "overflow": overflow,
            "lp_max_abs_err_vs_cpu": lp_err, "lp_atol": LP_ATOL,
            "words_per_utt": [len(hyps[k][0]) for k in feats]}


def synth_posteriors(prons, num_tokens, rng):
    """Converged-CTC log-posteriors as in bench.py: token paths from real
    prons, 1-2 spike frames per phone then 3-8 saturated blank frames."""
    v = 1 + num_tokens
    ll = np.zeros((B, T_MAX, v), np.float32)
    for i in range(B):
        frames = []
        while len(frames) < T_MAX:
            row = prons[int(rng.integers(0, len(prons)))]
            for tok in row[row > 0]:
                col = int(tok) - 1
                for _ in range(int(rng.integers(1, 3))):
                    x = rng.standard_normal(v).astype(np.float32) * 0.4
                    x[col] += 7.0
                    frames.append(x)
                for _ in range(int(rng.integers(3, 9))):
                    x = rng.standard_normal(v).astype(np.float32) * 0.4
                    x[0] += 12.0
                    frames.append(x)
        ll[i] = np.stack(frames)[:T_MAX]
    return ll - np.log(np.exp(ll).sum(-1, keepdims=True))


def search_posteriors(lang, lex):
    """synth_posteriors over 256 of the graph's own prons (seeded)."""
    rng = np.random.default_rng(SEED + 11)
    max_pron = max(len(p) for _, p in lex)
    pick = rng.choice(len(lex), size=256, replace=False)
    prons = np.full((256, max_pron), -1, np.int32)
    for r, i in enumerate(pick):
        for c, u in enumerate(lex[int(i)][1]):
            prons[r, c] = lang.tokens[u]
    return synth_posteriors(prons, 71, rng)


def phase_search(dev, graphs):
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, make_beam_decoder, traceback,
    )

    out = {}
    bcfg = BeamSearchConfig(**DECODE)
    lens = np.asarray(LENGTHS, np.int32)
    for tag, (g, lang, lex) in graphs.items():
        ll = search_posteriors(lang, lex)
        dec = make_beam_decoder(g, bcfg)
        before = counters()
        res_dev = traceback(dec(ll, lens, DeviceGraph.put(g, device=dev)),
                            lens, g.final_weight)
        launched = {k: v - before[k] for k, v in counters().items()}
        t0 = time.perf_counter()
        res_cpu = traceback(dec(ll, lens, DeviceGraph.put(g, device="cpu")),
                            lens, g.final_weight)
        cpu_s = time.perf_counter() - t0
        for i, ((w_d, c_d), (w_c, c_c)) in enumerate(zip(res_dev, res_cpu)):
            if w_d != w_c or not abs(c_d - c_c) <= COST_RTOL * abs(c_c):
                raise AssertionError(
                    f"{tag} utt {i}: card {len(w_d)} words cost {c_d}, "
                    f"cpu {len(w_c)} words cost {c_c}"
                )
        out[tag] = {"words": [len(w) for w, _ in res_dev],
                    "dedup_launches": launched["dedup_prune"],
                    "cpu_decode_s": cpu_s}
    return out


def _results_equal(what, got, want, rtol):
    """Words equal, costs within rtol relative, per utterance."""
    for i, ((w_g, c_g), (w_w, c_w)) in enumerate(zip(got, want)):
        if w_g != w_w or not abs(c_g - c_w) <= rtol * abs(c_w):
            raise AssertionError(
                f"{what} utt {i}: {len(w_g)} words cost {c_g}, want "
                f"{len(w_w)} words cost {c_w}"
            )


def _wall_ms(fn, reps: int):
    """Median wall ms of fn() over reps calls (host clock, synchronized,
    profiler off), and the last call's result."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), res


def phase_skip(dev, graphs, state):
    import dataclasses

    import torch
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, make_beam_decoder, traceback,
    )
    from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames
    from eesen_tpu_torch.decoder.greedy import greedy_decode_logits
    from eesen_tpu_torch.recipes.run import run_search

    out = {}
    bcfg = BeamSearchConfig(**DECODE)
    lens = np.asarray(LENGTHS, np.int32)
    for tag, (g, lang, lex) in graphs.items():
        ll = search_posteriors(lang, lex)
        ll_dev = torch.from_numpy(ll).to(dev)
        # (i) the compaction on the card against the CPU
        cf = compact_blank_frames(ll_dev, lens, SKIP_THRESHOLD)
        cf_cpu = compact_blank_frames(ll, lens, SKIP_THRESHOLD)
        n = cf_cpu.lengths.numpy()
        if not (np.array_equal(cf.lengths.cpu().numpy(), n)
                and cf.loglikes.shape == cf_cpu.loglikes.shape):
            raise AssertionError(f"{tag}: kept counts or bucket differ")
        err = 0.0
        for i, k in enumerate(n):
            if not torch.equal(cf.time_map[i, :k].cpu(),
                               cf_cpu.time_map[i, :k]):
                raise AssertionError(f"{tag} row {i}: time_map differs")
            err = max(err, float((cf.loglikes[i, :k].cpu()
                                  - cf_cpu.loglikes[i, :k]).abs().max()))
        if not err <= SKIP_ATOL:
            raise AssertionError(f"{tag}: compacted loglikes differ by {err}")
        # (ii) full and compacted search on the card, profiler off
        dec = make_beam_decoder(g, bcfg)
        dg = DeviceGraph.put(g, device=dev)
        reps = 3
        before = counters()["dedup_prune"]
        full_ms, res_full = _wall_ms(lambda: traceback(
            dec(ll_dev, lens, dg), lens, g.final_weight), reps)
        full_launches = (counters()["dedup_prune"] - before) // reps

        def skip_decode():
            c = compact_blank_frames(ll_dev, lens, SKIP_THRESHOLD)
            return c, traceback(dec(c.loglikes, c.lengths, dg), c.lengths,
                                g.final_weight)

        before = counters()["dedup_prune"]
        skip_ms, (cf, res_skip) = _wall_ms(skip_decode, reps)
        skip_launches = (counters()["dedup_prune"] - before) // reps
        # the compacted search on the CPU (plain versions)
        res_cpu = traceback(
            dec(cf_cpu.loglikes, cf_cpu.lengths,
                DeviceGraph.put(g, device="cpu")),
            cf_cpu.lengths, g.final_weight)
        _results_equal(f"{tag} skip card vs cpu", res_skip, res_cpu,
                       COST_RTOL)
        kept = int(n.sum())
        out[tag] = {
            "kept_frames": kept, "frames": int(lens.sum()),
            "kept_share": kept / int(lens.sum()),
            "compacted_T": int(cf.loglikes.shape[1]),
            "loglikes_max_abs_err_vs_cpu": err, "atol": SKIP_ATOL,
            "dedup_launches": {"full": full_launches, "skip": skip_launches},
            "decode_ms": {"full": full_ms, "skip": skip_ms},
            "decode_ms_per_frame": {"full": full_ms / T_MAX,
                                    "skip": skip_ms / T_MAX},
            "utts_with_full_words": sum(
                w_s == w_f for (w_s, _), (w_f, _) in zip(res_skip, res_full)),
        }
    # (iii) the serving entry with the recipes' blank-skip
    g = graphs["packed"][0]
    feats = {f"utt{i}": state["arr"][i, :n]
             for i, n in enumerate(state["lens"])}
    reset_counters()
    runs = list(run_search(
        state["params"], state["cfg"], g, feats, state["log_priors"],
        dataclasses.replace(bcfg, blank_skip=SKIP_THRESHOLD), batch_size=B,
        device=dev))
    torch.cuda.synchronize()
    launches = {k: v for k, v in counters().items()
                if k in ("lstm_fwd", "dedup_prune")}
    if dev.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    (chunk, lp, kept, res), = runs
    costs = [c for _, c in traceback(res, kept, g.final_weight)]
    if int(res.overflow.sum()) or not np.all(np.isfinite(costs)):
        raise AssertionError(f"run_search with blank-skip: costs {costs}")
    out["run_search"] = {"launches": launches,
                         "kept_frames": [int(k) for k in kept],
                         "compacted_T": int(lp.shape[1])}
    # (iv) greedy decoding of the serving lp on the card and on the CPU
    greedy = greedy_decode_logits(state["lp"], state["lens"])
    if greedy != greedy_decode_logits(state["lp"].cpu(), state["lens"]):
        raise AssertionError("greedy labels differ, card vs cpu")
    out["greedy_labels_per_utt"] = [len(x) for x in greedy]
    state["skip_launches"] = {
        "dedup_prune": out["packed"]["dedup_launches"]["skip"],
        "run_search": launches}
    return out


def stream_model(dev):
    import torch
    from eesen_tpu_torch.models.model import AcousticModelConfig, init_model

    cfg = AcousticModelConfig(input_dim=120, cell_dim=320, num_layers=4,
                              num_targets=72, bidirectional=False)
    return cfg, init_model(torch.Generator().manual_seed(SEED + 5), cfg,
                           device=dev)


def stream_am(sam, feats, lens, timed=False):
    """The features through sam in CHUNK-frame chunks -> (log-posteriors
    [B, T, V], ms per chunk or None)."""
    import torch

    st = sam.start(feats.shape[0])
    outs, times = [], []
    for t0 in range(0, feats.shape[1], CHUNK):
        t1 = min(t0 + CHUNK, feats.shape[1])
        cl = (lens - t0).clamp(0, t1 - t0)
        if timed:
            torch.cuda.synchronize()
            a = time.perf_counter()
        logits, st = sam.step(st, feats[:, t0:t1], cl)
        if timed:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - a) * 1e3)
        outs.append(logits)
    lp = torch.log_softmax(torch.cat(outs, dim=1), dim=-1)
    return lp, (statistics.median(times) if timed else None)


def phase_stream(dev, graphs, state):
    import dataclasses

    import torch
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, StreamingBeamDecoder,
        make_beam_decoder, traceback,
    )
    from eesen_tpu_torch.models.streaming import (
        StreamingAcousticModel, StreamingPipeline,
    )
    from eesen_tpu_torch.recipes.run import posteriors

    g = graphs["packed"][0]
    bcfg = BeamSearchConfig(**DECODE)
    cfg, params = stream_model(dev)
    arr, lens = state["arr"], state["lens"]
    feats = torch.from_numpy(arr).to(dev)
    lens_dev = torch.from_numpy(lens).long().to(dev)
    valid = torch.from_numpy(np.arange(T_MAX)[None, :] < lens[:, None])
    out = {"chunk_frames": CHUNK, "chunk_ms_audio": CHUNK * WSJ_FRAME_MS}
    # (i) offline: 4 launches of kernel 1, one a layer
    reset_counters()
    lp_off = posteriors(params, cfg, arr, lens, None, device=dev)
    torch.cuda.synchronize()
    out["offline_launches"] = counters()
    if dev.type == "cuda" and counters()["lstm_fwd"] != cfg.num_layers:
        raise AssertionError(f"offline forward: {counters()}")
    # (ii) the carried scan: no LSTM kernel; against offline and the CPU
    sam = StreamingAcousticModel(params, cfg, device=dev)
    reset_counters()
    lp_str, am_ms = stream_am(sam, feats, lens_dev, timed=True)
    torch.cuda.synchronize()
    lstm = {k: v for k, v in counters().items() if k.startswith("lstm")}
    if any(lstm.values()):
        raise AssertionError(f"the carried scan launched {lstm}")
    params_cpu = _to_cpu(params)
    feats_cpu = torch.from_numpy(arr)
    lens_cpu = torch.from_numpy(lens).long()
    lp_cpu, _ = stream_am(StreamingAcousticModel(params_cpu, cfg,
                                                 device="cpu"),
                          feats_cpu, lens_cpu)
    # the same chunks in f32 compute, card and CPU: no bf16 rounding to
    # flip, so the sums' order alone
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    lp32, _ = stream_am(StreamingAcousticModel(params, cfg32, device=dev),
                        feats, lens_dev)
    lp32_cpu, _ = stream_am(StreamingAcousticModel(params_cpu, cfg32,
                                                   device="cpu"),
                            feats_cpu, lens_cpu)
    err_off = float((lp_str - lp_off).abs().cpu()[valid].max())
    err_cpu = float((lp_str.cpu() - lp_cpu).abs()[valid].max())
    err32 = float((lp32.cpu() - lp32_cpu).abs()[valid].max())
    out["am"] = {"lstm_launches": lstm, "ms_per_chunk": am_ms,
                 "lp_max_abs_err_vs_offline": err_off,
                 "lp_max_abs_err_vs_cpu": err_cpu, "atol": LP_ATOL,
                 "f32_lp_max_abs_err_vs_cpu": err32, "f32_atol": STREAM_ATOL}
    if not (err_off <= LP_ATOL and err_cpu <= LP_ATOL
            and err32 <= STREAM_ATOL):
        raise AssertionError(f"streamed lp: {out['am']}")
    # (iii) the offline lp chunk by chunk into StreamingBeamDecoder
    dg = DeviceGraph.put(g, device=dev)
    one_shot = make_beam_decoder(g, bcfg)
    ref = traceback(one_shot(lp_off, lens, dg), lens, g.final_weight)
    dec = StreamingBeamDecoder(g, bcfg, device=dev)
    st = dec.start(B)
    act = torch.arange(T_MAX, device=dev)[None, :] < lens_dev[:, None]
    acc_ms, part_ms = [], []
    before = counters()["dedup_prune"]
    for t0 in range(0, T_MAX, CHUNK):
        torch.cuda.synchronize()
        a = time.perf_counter()
        st = dec.accept(st, lp_off[:, t0:t0 + CHUNK], act[:, t0:t0 + CHUNK])
        torch.cuda.synchronize()
        b = time.perf_counter()
        dec.partial(st)
        acc_ms.append((b - a) * 1e3)
        part_ms.append((time.perf_counter() - b) * 1e3)
    res = dec.finish(st)
    stream_launches = counters()["dedup_prune"] - before
    _results_equal("streaming decoder vs one-shot", res, ref, STREAM_COST_RTOL)
    out["decoder"] = {"accept_ms_per_chunk": statistics.median(acc_ms),
                      "partial_ms_per_chunk": statistics.median(part_ms),
                      "dedup_launches": stream_launches,
                      "words_per_utt": [len(w) for w, _ in res]}
    # (iv) the pipeline against the one-shot decode of its own streamed lp
    pipe = StreamingPipeline(params, cfg, g, bcfg, device=dev)
    ref_str = traceback(one_shot(lp_str, lens, dg), lens, g.final_weight)
    reset_counters()
    st = pipe.start(B)
    step_ms = []
    for t0 in range(0, T_MAX, CHUNK):
        t1 = min(t0 + CHUNK, T_MAX)
        torch.cuda.synchronize()
        a = time.perf_counter()
        st = pipe.step(st, feats[:, t0:t1], (lens_dev - t0).clamp(0, t1 - t0))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - a) * 1e3)
    res = pipe.finish(st)
    pipe_launches = counters()
    _results_equal("pipeline vs one-shot", res, ref_str, STREAM_COST_RTOL)
    if pipe_launches["lstm_fwd"] or (dev.type == "cuda"
                                     and pipe_launches["dedup_prune"] == 0):
        raise AssertionError(f"pipeline launches: {pipe_launches}")
    ms = statistics.median(step_ms)
    out["pipeline"] = {"ms_per_chunk": ms,
                       "real_time_factor": ms / (CHUNK * WSJ_FRAME_MS),
                       "launches": pipe_launches,
                       "chunks": len(step_ms)}
    state["stream_launches"] = {"dedup_prune": stream_launches,
                                "pipeline": pipe_launches,
                                "offline": out["offline_launches"]}
    return out


def _same_outputs(what, got, want):
    """Every BeamOutputs field bit for bit."""
    import torch

    for name, a, b in zip(got._fields, got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs")


def emit_merge_width(graph, k: int, m_e: int = 0) -> int:
    """Lanes of a frame's emit merge by make_beam_decoder's rule: the
    budget (packed layout) or K x the emit row width, plus the hub arcs."""
    from eesen_tpu_torch.decoder.beam import use_dense_rows

    hubs = int(graph.hub_offsets[-1]) if graph.has_hubs else 0
    if m_e and not use_dense_rows(graph):
        return max(m_e, k) + hubs
    return merge_widths(graph, k)[0] + hubs


def hub_threshold(fst, k: int) -> int:
    """The smallest raw emit out-degree whose states, taken as hubs, keep
    the emit merge (K x the degree cap of 8, plus the hub arcs) within
    kernel 2's cap."""
    from eesen_tpu_torch.ops import beam_cuda

    deg = np.array([sum(a.ilabel != 0 for a in fst.arcs[s])
                    for s in range(fst.num_states)])
    room = beam_cuda.MAX_LANES - k * 8
    for t in sorted(set(deg[deg > 8].tolist())):
        if int(deg[deg >= t].sum()) <= room:
            return t
    raise AssertionError("no hub threshold fits kernel 2")


def phase_options(dev, graphs, state):
    """The search options and the batch-major layer: (i) scan_unroll, (ii)
    arc budgets at the recipes' max_active 5000 and approx_top_k, (iv)
    the light dedup modes, (v) a hub graph, (vi) bilstm_layer.  (iii),
    kernel 2 at K = 5000, is in phases dedup and timing."""
    import dataclasses

    import torch
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, make_beam_decoder, traceback,
    )
    from eesen_tpu_torch.decoder.graph_compile import compile_graph
    from eesen_tpu_torch.models.bilstm import bilstm_layer, bilstm_layer_tm
    from eesen_tpu_torch.ops import beam_cuda
    from eesen_tpu_torch.tools.stress_timing import degree_peaks

    def k2():
        return counters()["dedup_prune"]

    def timed(fn):
        torch.cuda.synchronize()
        n0, t0 = k2(), time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, k2() - n0

    out, launches = {}, {}
    g, lang, lex = graphs["packed"]
    dg = DeviceGraph.put(g, device=dev)
    bcfg = BeamSearchConfig(**DECODE)
    lens = np.asarray(LENGTHS, np.int32)
    # (i) scan_unroll: the frame loop is Python, so the same bits
    one, _, n_one = timed(lambda: make_beam_decoder(g, bcfg)(
        state["lp"], state["lens"], dg))
    four, _, n_four = timed(lambda: make_beam_decoder(
        g, dataclasses.replace(bcfg, scan_unroll=4))(
        state["lp"], state["lens"], dg))
    _same_outputs("scan_unroll=4", four, one)
    if n_four != n_one or n_one == 0:
        raise AssertionError(f"scan_unroll launches {n_four} vs {n_one}")
    out["scan_unroll"] = {"bit_equal": True, "dedup_launches": n_four}
    launches["scan_unroll"] = n_four
    # (ii) max_active 5000, beam 17 on the converged posteriors
    ll = torch.from_numpy(search_posteriors(lang, lex)).to(dev)
    kcfg = BeamSearchConfig(beam=OPT_BEAM, max_active=OPT_K,
                            acoustic_scale=DECODE["acoustic_scale"])
    full, full_ms, n_full = timed(lambda: make_beam_decoder(g, kcfg)(
        ll, lens, dg))
    approx, _, _ = timed(lambda: make_beam_decoder(
        g, dataclasses.replace(kcfg, approx_top_k=True))(ll, lens, dg))
    _same_outputs("approx_top_k", approx, full)
    res_full = traceback(full, lens, g.final_weight)
    bud_cfg = dataclasses.replace(kcfg, **OPT_BUDGETS)
    peaks, restore = degree_peaks()
    try:
        bud = make_beam_decoder(g, bud_cfg)(ll, lens, dg)
    finally:
        restore()
    bud, bud_ms, n_bud = timed(lambda: make_beam_decoder(g, bud_cfg)(
        ll, lens, dg))
    widths = {"emit": emit_merge_width(g, OPT_K, OPT_BUDGETS[
        "arc_budget_emit"]), "closure": OPT_K + OPT_BUDGETS["arc_budget_x"]}
    fits = {k: beam_cuda.padded_width(m) <= beam_cuda.MAX_LANES
            for k, m in widths.items()}
    want = fits["closure"] + T_MAX * (fits["emit"] + fits["closure"])
    overflow = int(bud.overflow.sum())
    if n_full != 0 or n_bud != want or overflow:
        raise AssertionError(f"budgeted decode: {n_bud} launches (want "
                             f"{want}), overflow {overflow}; unbudgeted "
                             f"{n_full} launches")
    _results_equal("budgeted vs unbudgeted", traceback(
        bud, lens, g.final_weight), res_full, COST_RTOL)
    small_cfg = dataclasses.replace(kcfg, arc_budget_emit=OPT_SMALL_BUDGET,
                                    arc_budget_x=OPT_SMALL_BUDGET)
    small, small_ms, n_small = timed(lambda: make_beam_decoder(
        g, small_cfg)(ll, lens, dg))
    small_ovf = int(small.overflow.sum())
    if small_ovf == 0 or n_small != 1 + 2 * T_MAX:
        raise AssertionError(f"small budget: overflow {small_ovf}, "
                             f"{n_small} launches")
    res_small = traceback(small, lens, g.final_weight)
    out["budgets"] = {
        "max_active": OPT_K, "beam": OPT_BEAM, "frames": T_MAX,
        "unbudgeted": {"ms_per_frame": full_ms / T_MAX,
                       "dedup_launches": n_full,
                       "merge_lanes": list(merge_widths(g, OPT_K))},
        "approx_top_k_bit_equal": True,
        "budgeted": {**OPT_BUDGETS, "ms_per_frame": bud_ms / T_MAX,
                     "dedup_launches": n_bud, "merge_lanes": widths,
                     "kernel_2": fits, "overflow": overflow,
                     "peak_live_degree": {
                         ("emit", "closure")[w]: int(v)
                         for w, v in peaks.items()}},
        "small": {"arc_budget": OPT_SMALL_BUDGET,
                  "ms_per_frame": small_ms / T_MAX,
                  "dedup_launches": n_small, "overflow": small_ovf,
                  "utts_with_full_words": sum(
                      a[0] == b[0] for a, b in zip(res_small, res_full))},
    }
    launches["budgeted"], launches["small_budget"] = n_bud, n_small
    # (iv) light dedup at K=512, 2 utterances, card against the CPU
    ll2, lens2 = ll[:LIGHT_UTTS], lens[:LIGHT_UTTS]
    dg_cpu = DeviceGraph.put(g, device="cpu")
    ref2 = traceback(make_beam_decoder(g, bcfg)(ll2, lens2, dg),
                     lens2, g.final_weight)
    out["light"] = {}
    for name, opts in (("closure", dict(light_closure_dedup=True)),
                       ("emit", dict(light_emit_dedup=True)),
                       ("both", dict(light_closure_dedup=True,
                                     light_emit_dedup=True))):
        dec = make_beam_decoder(g, dataclasses.replace(bcfg, **opts))
        res, ms, n = timed(lambda: dec(ll2, lens2, dg))
        res = traceback(res, lens2, g.final_weight)
        res_cpu = traceback(dec(ll2.cpu(), lens2, dg_cpu), lens2,
                            g.final_weight)
        _results_equal(f"light {name} card vs cpu", res, res_cpu, COST_RTOL)
        out["light"][name] = {
            "dedup_launches": n, "ms_per_frame": ms / T_MAX,
            "utts_with_full_words": sum(
                a[0] == b[0] for a, b in zip(res, ref2))}
        launches[f"light_{name}"] = n
    if out["light"]["both"]["dedup_launches"] != 0:
        raise AssertionError(f"light modes launched kernel 2: {out['light']}")
    # (v) the 1000-word TLG again with hubs, against the graph without
    gd, lang_d, lex_d = graphs["dense"]
    t0 = time.perf_counter()
    thr = hub_threshold(state["dense_fst"], K)
    gh = compile_graph(state["dense_fst"], max_degree=8, hub_threshold=thr,
                       build_closure=True)
    compile_s = time.perf_counter() - t0
    lld = torch.from_numpy(search_posteriors(lang_d, lex_d)).to(dev)
    dg_d = DeviceGraph.put(gd, device=dev)
    dg_h = DeviceGraph.put(gh, device=dev)
    plain, plain_ms, _ = timed(lambda: make_beam_decoder(gd, bcfg)(
        lld, lens, dg_d))
    hub, hub_ms, n_hub = timed(lambda: make_beam_decoder(gh, bcfg)(
        lld, lens, dg_h))
    _results_equal("hub vs plain graph", traceback(hub, lens, gh.final_weight),
                   traceback(plain, lens, gd.final_weight), COST_RTOL)
    width = emit_merge_width(gh, K)
    on_k2 = beam_cuda.padded_width(width) <= beam_cuda.MAX_LANES
    if not on_k2 or n_hub != kernel2_launches(gh, K, [T_MAX]):
        raise AssertionError(f"hub emit merge {width} lanes, {n_hub} "
                             f"launches")
    out["hubs"] = {"hub_threshold": thr, "hubs": len(gh.hub_src),
                   "hub_arcs": int(gh.hub_offsets[-1]),
                   "states": gh.num_states, "plain_states": gd.num_states,
                   "compile_s": compile_s, "emit_merge_lanes": width,
                   "route": "kernel 2" if on_k2 else "sort",
                   "dedup_launches": n_hub, "ms_per_frame": hub_ms / T_MAX,
                   "plain_ms_per_frame": plain_ms / T_MAX}
    launches["hubs"] = n_hub
    # (vi) bilstm_layer through the serving stack, layer by layer
    cfg, params = state["cfg"], state["params"]
    x = torch.from_numpy(state["arr"]).to(dev)
    lens_t = torch.from_numpy(state["lens"])
    n_layer = []
    for i in range(cfg.num_layers):
        lcfg = cfg.layer_cfg(i)
        n0 = counters()["lstm_fwd"]
        y = bilstm_layer(params["layers"][i], x, lens_t, lcfg)
        torch.cuda.synchronize()
        n_layer.append(counters()["lstm_fwd"] - n0)
        y_tm = bilstm_layer_tm(params["layers"][i],
                               x.transpose(0, 1).contiguous(), lens_t, lcfg)
        if not torch.equal(y, y_tm.transpose(0, 1)):
            raise AssertionError(f"bilstm_layer {i} differs from the "
                                 "time-major layer")
        x = y
    if n_layer != [2] * cfg.num_layers:
        raise AssertionError(f"bilstm_layer launches {n_layer}")
    out["bilstm_layer"] = {"bit_equal": True, "lstm_fwd_launches": n_layer}
    state["options_launches"] = launches
    return out


def train_lengths():
    lens = np.full(TRAIN_B, TRAIN_T, np.int64)
    lens[:len(TRAIN_HEAD)] = TRAIN_HEAD
    return lens


def train_lstm_inputs(d: int, h: int, dev, seed: int, state_bf16: bool):
    """One direction-layer at the training shapes: the forward kernel's
    residuals and a random cotangent of the m carry (bf16 compute)."""
    import torch
    from eesen_tpu_torch.ops import lstm_cuda

    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dt)

    lens = torch.from_numpy(train_lengths()).to(dev)
    mask = (torch.arange(TRAIN_T, device=dev)[:, None]
            < lens[None, :]).float()
    x = rng.standard_normal((TRAIN_T, TRAIN_B, d)) \
        if d in (120, LIBRI_D) else rng.uniform(-1, 1, (TRAIN_T, TRAIN_B, d))
    u = lambda *s: rng.uniform(-0.1, 0.1, s)
    fwd = dict(x=t(x, torch.bfloat16), mask=mask,
               w_x=t(u(d, 4 * h), torch.bfloat16), bias=t(u(4 * h)),
               w_m=t(u(h, 4 * h), torch.bfloat16), ph=t(u(3, h)))
    m, c, gates = lstm_cuda.lstm_direction(**fwd, state_bf16=state_bf16,
                                           with_residuals=True)
    sdt = m.dtype
    gm = t(rng.standard_normal((TRAIN_T, TRAIN_B, h)), sdt)
    bwd = dict(x=fwd["x"], mask=mask, gates=gates, c=c, m=m, gm=gm,
               w_x=fwd["w_x"], w_m=fwd["w_m"], ph=fwd["ph"])
    return fwd, bwd


def phase_lstm_bwd(dev):
    from eesen_tpu_torch.ops import lstm_cuda

    errs, rel_l2, worst, fwd_errs = {}, {}, {}, {}
    names = ("dx", "dw_x", "dw_m", "db", "dph")
    for d in (120, 640):
        for sb in (False, True):
            fwd, inp = train_lstm_inputs(d, 320, dev, SEED + d + 1, sb)
            # kernel 1 as the training path runs it, before its residuals
            # feed both sides of the backward check
            fwd_ref = lstm_cuda.lstm_direction_ref(
                **fwd, state_bf16=sb, with_residuals=True)
            for name, r, (rtol, atol) in zip(
                    ("m", "c", "gates"), fwd_ref,
                    ((LSTM_RTOL, LSTM_ATOL), (LSTM_RTOL, LSTM_ATOL),
                     (GATES_RTOL, GATES_ATOL))):
                g = inp[name]
                key = f"D{d}_state_bf16_{int(sb)}_{name}"
                if g.dtype != r.dtype or g.shape != r.shape:
                    raise AssertionError(f"lstm_fwd {key}: {g.dtype} "
                                         f"{tuple(g.shape)} vs {r.dtype}")
                g, r = g.float().cpu().numpy(), r.float().cpu().numpy()
                fwd_errs[key] = float(np.abs(g - r).max())
                if not np.allclose(g, r, rtol=rtol, atol=atol):
                    raise AssertionError(f"lstm_fwd {key}: max abs err "
                                         f"{fwd_errs[key]}")
            del fwd_ref
            got = lstm_cuda.lstm_direction_bwd(**inp)
            ref = lstm_cuda.lstm_direction_bwd_ref(**inp)
            for name, g, r in zip(names, got, ref):
                if g.dtype != r.dtype or g.shape != r.shape:
                    raise AssertionError(f"lstm_bwd {name}: {g.dtype} "
                                         f"{tuple(g.shape)} vs {r.dtype}")
                rtol, atol = BWD_DX_TOL if name == "dx" else BWD_W_TOL
                g, r = g.float().cpu().numpy(), r.float().cpu().numpy()
                key = f"D{d}_state_bf16_{int(sb)}_{name}"
                err = np.abs(g - r)
                scale = 1.0 if name == "dx" else max(1.0, float(np.abs(r).max()))
                errs[key] = float(err.max())
                rel_l2[key] = float(np.linalg.norm(g - r)
                                    / max(np.linalg.norm(r), 1e-30))
                worst[key] = float(np.max(err / (atol * scale
                                                  + rtol * np.abs(r))))
                if (not np.all(np.isfinite(g)) or worst[key] > 1.0
                        or rel_l2[key] > BWD_REL_L2):
                    raise AssertionError(f"lstm_bwd {key}: max abs err "
                                         f"{errs[key]}, {worst[key]} of "
                                         f"the tolerance, relative L2 "
                                         f"{rel_l2[key]}")
    return {"max_abs_err": errs, "rel_l2_err": rel_l2,
            "worst_share_of_tol": worst, "weights_tol": BWD_W_TOL,
            "dx_tol": BWD_DX_TOL, "rel_l2_tol": BWD_REL_L2,
            "fwd_max_abs_err": fwd_errs,
            "fwd_tol": {"m_c": (LSTM_RTOL, LSTM_ATOL),
                        "gates": (GATES_RTOL, GATES_ATOL)}}


# the CTC shapes: WSJ training (S=201), LibriSpeech training (S=401), and
# a 600-character transcript (S=1201, past one thread a state) over 1300
# frames; (frames, labels, classes, frames per label at most)
CTC_CASES = {"S201": (TRAIN_T, TRAIN_L, 72, 3),
             "S401": (TRAIN_T, LIBRI_L, LIBRI_V, 3),
             "S1201": (1300, 600, LIBRI_V, 2)}
# kernels 6 and 7 by name, for their device time in a profiled step
CTC_KERNELS = ("ctc_alpha_kernel", "ctc_beta_kernel")


def ctc_train_inputs(dev, seed: int, case: str = "S201"):
    """The kernels' inputs at a CTC_CASES shape, B=128: random logits
    through the port's CTC prep, labels with repeats, the training row
    lengths scaled to the case's frames (a length-0 row, frames and
    labels), min(L, frames / frames-per-label) labels a row.  Returns
    the kernels' inputs and the same logits, labels and lengths for
    torch's ctc_loss."""
    import torch
    from eesen_tpu_torch.ops.ctc import _ctc_prep, _final_states
    from eesen_tpu_torch.utils.math import LOG_ZERO

    t, l, v, fpl = CTC_CASES[case]
    rng = np.random.default_rng(seed)
    lens = np.round(train_lengths() * t / TRAIN_T).astype(np.int64)
    lab_l = np.minimum(l, lens // fpl)
    labels = rng.integers(1, v, (TRAIN_B, l))
    labels[:, 1::7] = labels[:, 0::7][:, :labels[:, 1::7].shape[1]]
    for i, n in enumerate(lab_l):
        labels[i, n:] = 0
    logits = torch.from_numpy(rng.standard_normal(
        (TRAIN_B, t, v)).astype(np.float32)).to(dev)
    lab_l_t = torch.from_numpy(lab_l).to(dev)
    labels_t = torch.from_numpy(labels).to(dev)
    _, _, can_skip, _, lp_e = _ctc_prep(logits, labels_t, lab_l_t, 0)
    _, _, init = _final_states(lab_l_t, lp_e.shape[2])
    lens_t = torch.from_numpy(lens).to(dev)
    inp = dict(lp_e=lp_e.contiguous(),
               can_skip_f=torch.where(can_skip, 0.0, LOG_ZERO).contiguous(),
               beta_init_row=init.contiguous(), logit_lengths=lens_t)
    lib = dict(log_probs=torch.log_softmax(logits, -1).transpose(0, 1),
               targets=labels_t, input_lengths=lens_t, target_lengths=lab_l_t)
    return inp, lib


def phase_ctc(dev):
    from eesen_tpu_torch.ops import ctc_cuda
    from eesen_tpu_torch.utils.math import LOG_ZERO, LOG_ZERO_THRESHOLD

    errs, states = {}, {}
    for case in CTC_CASES:
        inp, _ = ctc_train_inputs(dev, SEED + 3, case)
        got = ctc_cuda.ctc_alpha_beta(**inp)
        ref = ctc_cuda.ctc_alpha_beta_ref(**inp)
        states[case] = int(inp["lp_e"].shape[2])
        for name, g, r in zip(("alpha", "beta"), got, ref):
            g, r = g.cpu().numpy(), r.cpu().numpy()
            fin = r > LOG_ZERO_THRESHOLD
            if not np.array_equal(g > LOG_ZERO_THRESHOLD, fin):
                raise AssertionError(f"ctc {case} {name}: LOG_ZERO positions "
                                     f"differ")
            errs[f"{case}_{name}"] = float(np.abs(g[fin] - r[fin]).max())
            if not np.all(np.isfinite(g)) or not np.allclose(
                    g[fin], r[fin], rtol=CTC_RTOL, atol=CTC_ATOL):
                raise AssertionError(f"ctc {case} {name}: max abs err "
                                     f"{errs[f'{case}_{name}']}")
        pad = int(np.flatnonzero(train_lengths() == 0)[0])
        a, b = got[0][pad], got[1][pad]
        if not (bool((a == a[:1]).all()) and bool((b == LOG_ZERO).all())):
            raise AssertionError(f"ctc {case}: the length-0 row is not "
                                 f"init / LOG_ZERO")
        del got, ref, inp
    return {"max_abs_err": {w: max(v for k, v in errs.items()
                                   if k.endswith(w))
                            for w in ("alpha", "beta")},
            "max_abs_err_by_case": errs, "rtol": CTC_RTOL,
            "atol": CTC_ATOL, "states": states}


def train_setup(dev, **model):
    """The flagship model (with `model`'s fields replaced), its SGD state
    and one fixed batch on `dev` (train_batch)."""
    import torch
    from eesen_tpu_torch.models.model import AcousticModelConfig
    from eesen_tpu_torch.training.trainer import create_train_state

    cfg = AcousticModelConfig(input_dim=120, cell_dim=320, num_layers=4,
                              num_targets=72, **model)
    st, tx = create_train_state(torch.Generator().manual_seed(SEED), cfg,
                                train_opt(), device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch().items()}
    return cfg, st, tx, batch


def train_opt():
    from eesen_tpu_torch.training.optim import OptimizerConfig

    return OptimizerConfig(algorithm="sgd", momentum=0.9, max_grad=50.0)


def train_batch():
    """bench.py's batch as host arrays: normal features, random labels;
    rows 0-7 of mixed length, row 7 a padded row of 0 frames and 0
    labels."""
    rng = np.random.default_rng(SEED + 7)
    lens = train_lengths()
    lab_l = np.minimum(TRAIN_L, lens // 3)
    feats = rng.standard_normal((TRAIN_B, TRAIN_T, 120)).astype(np.float32)
    labels = rng.integers(1, 72, (TRAIN_B, TRAIN_L))
    for i in range(TRAIN_B):
        feats[i, lens[i]:] = 0.0
        labels[i, lab_l[i]:] = 0
    return {"feats": feats, "feat_lengths": lens, "labels": labels,
            "label_lengths": lab_l}


def card_vs_cpu_step(step, st, b8, gen_seed=None):
    """One train step on the card and on the CPU (plain versions) from
    the same parameters, a zero momentum state and, with gen_seed, the
    same dropout masks (both drawn from torch.Generator().manual_seed(
    gen_seed) on the CPU): the loss within TRAIN_LOSS_RTOL and each
    parameter's clipped gradient (the momentum buffer after one step)
    within TRAIN_GRAD_RTOL relative L2."""
    import torch
    from eesen_tpu_torch.training.optim import OptState, unravel
    from eesen_tpu_torch.training.trainer import TrainState

    gen = lambda: (None if gen_seed is None
                   else torch.Generator().manual_seed(gen_seed))
    t0 = time.perf_counter()
    st_card, m_card = step(st, b8, gen(), LEARN_RATE)
    cpu_st = TrainState(_to_cpu(st.params), OptState(
        dict(st.opt_state.hyperparams),
        {k: v.cpu() for k, v in st.opt_state.inner.items()}), st.step)
    st_cpu, m_cpu = step(cpu_st, {k: v.cpu() for k, v in b8.items()}, gen(),
                         LEARN_RATE)
    seconds = time.perf_counter() - t0
    loss_c, loss_h = float(m_card["loss"]), float(m_cpu["loss"])
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    # one step from a zero momentum buffer leaves the clipped gradient in it
    g_card = unravel(_to_cpu(st.params),
                     st_card.opt_state.inner["trace"].cpu())
    g_cpu = unravel(cpu_st.params, st_cpu.opt_state.inner["trace"])
    grad_err = {}

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}.{k}" if path else k)
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}{i}")
        else:
            grad_err[path] = float((a - b).norm() / b.norm().clamp_min(1e-30))

    walk(g_card, g_cpu, "")
    worst = max(grad_err, key=grad_err.get)
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err[worst] <= TRAIN_GRAD_RTOL
            and np.isfinite(loss_c)):
        raise AssertionError(f"8-row step: loss {loss_c} vs {loss_h}, "
                             f"grad {worst} rel err {grad_err[worst]}")
    return {"rows": len(b8["feats"]), "loss_card": loss_c, "loss_cpu": loss_h,
            "loss_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL,
            "grad_rel_err_max": grad_err[worst], "grad_rel_err_worst": worst,
            "grad_rtol": TRAIN_GRAD_RTOL, "seconds": seconds}


def _rel_l2(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _close(name, got, ref, rtol, atol):
    """Max abs error of got vs ref; raises past rtol/atol (elementwise)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{ref.dtype} {tuple(ref.shape)}")
    g, r = (a.detach().float().cpu().numpy() for a in (got, ref))
    err = float(np.abs(g - r).max()) if g.size else 0.0
    if not np.all(np.isfinite(g)) or not np.allclose(g, r, rtol=rtol,
                                                      atol=atol):
        raise AssertionError(f"{name}: max abs err {err}")
    return err


def scan_inputs(dev, seed: int, h: int = LIBRI_H):
    """Kernel 4's inputs at B=128, T=768 and cell width h (640, the
    LibriSpeech width, or V1_H) with the training lengths: xw ~ N(0, 1) as
    an input projection of LSTM outputs gives, W_m and ph uniform +-0.1
    (param_range)."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    lens = torch.from_numpy(train_lengths()).to(dev)
    mask = (torch.arange(TRAIN_T, device=dev)[:, None]
            < lens[None, :]).float()
    return dict(xw=t(rng.standard_normal((TRAIN_T, TRAIN_B, 4 * h))),
                mask=mask,
                w_m=t(rng.uniform(-0.1, 0.1, (h, 4 * h))).to(torch.bfloat16),
                ph=t(rng.uniform(-0.1, 0.1, (3, h))))


def direction_params(d: int, h: int, seed: int, dev):
    """One direction's float32 parameters, uniform +-0.1, as the model
    holds them ([D, 4, H], [4, H], [H, 4, H], three [H])."""
    import torch

    rng = np.random.default_rng(seed)
    u = lambda *s: torch.from_numpy(
        rng.uniform(-0.1, 0.1, s).astype(np.float32)).to(dev)
    return {"w_gifo_x": u(d, 4, h), "bias": u(4, h), "w_gifo_m": u(h, 4, h),
            "phole_i_c": u(h), "phole_f_c": u(h), "phole_o_c": u(h)}


PH_KEYS = ("phole_i_c", "phole_f_c", "phole_o_c")


def fused_route(x, mask, p, state_bf16=False):
    """One direction through kernels 1 and 3 (the autograd Function)."""
    import torch
    from eesen_tpu_torch.ops import lstm_cuda

    d, _, h = p["w_gifo_x"].shape
    return lstm_cuda.lstm_direction(
        x, mask, p["w_gifo_x"].reshape(d, 4 * h), p["bias"].reshape(4 * h),
        p["w_gifo_m"].reshape(h, 4 * h),
        torch.stack([p[k] for k in PH_KEYS]), state_bf16=state_bf16)


def v1_route(x, mask, p):
    """One direction through kernels 4 and 5 (`_v1_direction_tm`)."""
    from eesen_tpu_torch.ops import lstm_v1_cuda

    return lstm_v1_cuda._v1_direction_tm(
        x, mask, p["w_gifo_x"], p["bias"], p["w_gifo_m"],
        *(p[k] for k in PH_KEYS))


def route_inputs(dev, seed: int):
    """A stacked layer's direction at the LibriSpeech width (D=1280,
    H=640, B=128, T=768, training lengths): x bf16 uniform(-1, 1), f32
    parameters, and a loss weight for the m carry at valid steps."""
    import torch

    rng = np.random.default_rng(seed)
    d, h = 2 * LIBRI_H, LIBRI_H
    lens = torch.from_numpy(train_lengths()).to(dev)
    mask = (torch.arange(TRAIN_T, device=dev)[:, None]
            < lens[None, :]).float()
    x = torch.from_numpy(rng.uniform(-1, 1, (TRAIN_T, TRAIN_B, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((TRAIN_T, TRAIN_B, h)).astype(
        np.float32)).to(dev) * mask[:, :, None]
    return x, mask, direction_params(d, h, seed, dev), w


def route_grads(route, x, mask, p, w):
    """m and the autograd gradients of x and every parameter (the three
    peepholes stacked) for the loss sum(m * w)."""
    import torch

    x = x.detach().requires_grad_()
    pp = {k: v.detach().requires_grad_() for k, v in p.items()}
    m = route(x, mask, pp)
    names = ["x", "w_gifo_x", "bias", "w_gifo_m", *PH_KEYS]
    grads = torch.autograd.grad((m.float() * w).sum(),
                                [x] + [pp[k] for k in names[1:]])
    g = dict(zip(names, grads))
    g["peepholes"] = torch.stack([g.pop(k) for k in PH_KEYS])
    return m.detach(), g


def scan_step(inp, m, c):
    """Kernel 4's plain step (lstm_scan_fwd_ref's) at every step at once,
    from the given m and c carries one step back (zero at t=0) instead of
    the plain version's own trajectory: (m, c, c_raw, gates)."""
    import torch
    from eesen_tpu_torch.ops.lstm_v1_cuda import _shift

    bf, f32 = torch.bfloat16, torch.float32
    h = inp["w_m"].shape[0]
    ph = inp["ph"]
    m_prev, c_prev = _shift(m), _shift(c)
    gifo = inp["xw"] + torch.matmul(m_prev.to(bf).to(f32),
                                    inp["w_m"].to(f32))
    g = torch.tanh(gifo[..., :h])
    i = torch.sigmoid(gifo[..., h:2 * h] + c_prev * ph[0])
    f = torch.sigmoid(gifo[..., 2 * h:3 * h] + c_prev * ph[1])
    c_raw = f * c_prev + i * g
    o = torch.sigmoid(gifo[..., 3 * h:] + c_raw * ph[2])
    mt = inp["mask"][:, :, None]
    return (o * torch.tanh(c_raw) * mt + m_prev * (1.0 - mt),
            c_raw * mt + c_prev * (1.0 - mt), c_raw,
            torch.cat([g, i, f, o], dim=-1).to(bf))


def scan_designs(b: int, h: int):
    """Kernels 4 and 5's designs and plans at (b, h) (host arithmetic)."""
    from eesen_tpu_torch.ops import lstm_v1_cuda

    return {k: {"design": la.design, "plan": list(la.plan)}
            for k, la in (("fwd", lstm_v1_cuda.fwd_launch(b, h)),
                          ("bwd", lstm_v1_cuda.bwd_launch(b, h)))}


def scan_checks(dev, h: int, seed: int):
    """(i) kernel 4 vs its plain version and (ii) kernel 5 vs its plain
    version on kernel 4's residuals, at B=128, T=768, cell width h."""
    import torch
    from eesen_tpu_torch.ops import lstm_v1_cuda

    # (i) kernel 4 vs its plain version.  Over 768 steps two f32
    # trajectories of this recurrence drift apart by bf16 flips of the
    # recurrent operand: the plain version against itself on xw * (1 +
    # 1e-6) reaches 0.69x the lstm tolerance in m at H=640 and 1.54x in c
    # at H=1152 (the gates 0.88x and 1.66x of theirs).  So each step's m,
    # c, c_raw and gates are held elementwise against the plain step from
    # the kernel's own carries, and the free-running plain version in
    # relative L2 (its elementwise error recorded)
    inp = scan_inputs(dev, seed, h)
    got = lstm_v1_cuda.lstm_scan_fwd(**inp)
    ref = lstm_v1_cuda.lstm_scan_fwd_ref(**inp)
    step = scan_step(inp, got[0], got[1])
    fwd_err, free_err, free_l2 = {}, {}, {}
    for name, g, r, st, tol in zip(
            ("m", "c", "c_raw", "gates"), got, ref, step,
            [(LSTM_RTOL, LSTM_ATOL)] * 3 + [(GATES_RTOL, GATES_ATOL)]):
        fwd_err[name] = _close(f"H={h} lstm_scan_fwd {name}", g, st, *tol)
        free_err[name] = float((g.float() - r.float()).abs().max())
        free_l2[name] = _rel_l2(g, r)
    if max(free_l2.values()) > BWD_REL_L2:
        raise AssertionError(f"H={h} lstm_scan_fwd: relative L2 {free_l2}")
    del ref, step
    # (ii) kernel 5 vs its plain version on kernel 4's residuals
    m, c, c_raw, gates = got
    gm = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        m.shape).astype(np.float32)).to(dev)
    res = dict(mask=inp["mask"], gates=gates, c_raw=c_raw, c=c, gm=gm,
               w_m=inp["w_m"], ph=inp["ph"])
    dxw = lstm_v1_cuda.lstm_scan_bwd(**res)
    dxw_ref = lstm_v1_cuda.lstm_scan_bwd_ref(**res)
    bwd_err = _close(f"H={h} lstm_scan_bwd dxw", dxw, dxw_ref, *BWD_DX_TOL)
    bwd_l2 = _rel_l2(dxw, dxw_ref)
    if bwd_l2 > BWD_REL_L2:
        raise AssertionError(f"H={h} lstm_scan_bwd dxw: relative L2 {bwd_l2}")
    return {"shape": f"B={TRAIN_B} T={TRAIN_T} H={h}",
            "designs": scan_designs(TRAIN_B, h), "fwd_max_abs_err": fwd_err,
            "fwd_free_running_max_abs_err": free_err,
            "fwd_free_running_rel_l2": free_l2,
            "bwd_max_abs_err": bwd_err, "bwd_rel_l2": bwd_l2,
            "fwd_tol": {"m_c_craw": (LSTM_RTOL, LSTM_ATOL),
                        "gates": (GATES_RTOL, GATES_ATOL)},
            "bwd_tol": BWD_DX_TOL, "rel_l2_tol": BWD_REL_L2}


def route_vs_cpu(dev, h: int, seed: int, m_elementwise: bool = True):
    """One direction at width h (D=h, B=8, T=64, a length-0 row) through
    `_direction_scan` on the card, counters zeroed just before and read
    just after, and on the CPU (plain versions): the launches, m at the
    lstm tolerance (or, without m_elementwise, within BWD_REL_L2, its
    elementwise error recorded) and the gradients within BWD_REL_L2."""
    import torch
    from eesen_tpu_torch.models import bilstm

    cfg = bilstm.BiLstmConfig(input_dim=h, cell_dim=h)
    p = direction_params(h, h, seed, "cpu")
    lens = torch.tensor((64, 61, 50, 43, 33, 20, 9, 0))
    mask = (torch.arange(64)[:, None] < lens[None, :]).float()
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (64, 8, h)).astype(np.float32))
    runs = []                           # the card's run, then the CPU's
    for where in (dev, torch.device("cpu")):
        pp = {k: v.to(where).requires_grad_() for k, v in p.items()}
        reset_counters()
        m = bilstm._direction_scan(pp, x.to(where), mask.to(where), cfg)
        grads = torch.autograd.grad(m.float().sum(), list(pp.values()))
        if where.type == "cuda":
            torch.cuda.synchronize()
            launched = counters()
        runs.append((m.detach().float().cpu(), [g.cpu() for g in grads]))
    want = {"lstm_fwd": 0, "lstm_bwd": 0, "lstm_scan_fwd": 1,
            "lstm_scan_bwd": 1}
    if any(launched[k] != v for k, v in want.items()):
        raise AssertionError(f"H={h} direction launched {launched}")
    (m_card, g_card), (m_cpu, g_cpu) = runs
    if m_elementwise:
        m_err = _close(f"H={h} card vs cpu m", m_card, m_cpu, LSTM_RTOL,
                       LSTM_ATOL)
    else:
        m_err = float((m_card - m_cpu).abs().max())
    m_l2 = _rel_l2(m_card, m_cpu)
    g_l2 = {k: _rel_l2(g, c) for k, g, c in zip(p, g_card, g_cpu)}
    if max(m_l2, *g_l2.values()) > BWD_REL_L2:
        raise AssertionError(f"H={h} card vs cpu: m {m_l2}, gradients "
                             f"{g_l2} (relative L2)")
    return launched, {"shape": f"B=8 T=64 D={h} H={h}",
                      "designs": scan_designs(8, h), "launches": launched,
                      "m_max_abs_err_vs_cpu": m_err,
                      "m_elementwise": m_elementwise, "m_rel_l2_vs_cpu": m_l2,
                      "grad_rel_l2_vs_cpu": g_l2}


def phase_lstm_v1(dev, state):
    """Kernels 4 and 5 against their plain versions at H=640 and H=1152,
    the v1 route against the fused route, the route choice at H=1152, and
    a direction past the cluster plans' limits."""
    import torch

    out = {}
    # (i), (ii) at the LibriSpeech width and at the route's own
    errs = {}
    for h, seed in ((LIBRI_H, SEED + 21), (V1_H, SEED + 25)):
        out[f"kernels_h{h}"] = chk = scan_checks(dev, h, seed)
        errs[h] = {"fwd": max(chk["fwd_max_abs_err"].values()),
                   "bwd": chk["bwd_max_abs_err"]}
        torch.cuda.empty_cache()
    state["v1_err"] = errs
    # (iii) the two routes on the card, the same inputs and weights
    x, mask, p, w = route_inputs(dev, SEED + 23)
    m_f, g_f = route_grads(fused_route, x, mask, p, w)
    m_v, g_v = route_grads(v1_route, x, mask, p, w)
    route = {"m_max_abs_err": _close("v1 vs fused m", m_v, m_f, LSTM_RTOL,
                                     LSTM_ATOL),
             "grad_rel_l2": {k: _rel_l2(g_v[k], g_f[k]) for k in g_f}}
    bad = {k: v for k, v in route["grad_rel_l2"].items() if v > BWD_REL_L2}
    if bad:
        raise AssertionError(f"v1 vs fused gradients: {bad}")
    out["route_vs_fused"] = {"shape": "B=128 T=768 D=1280 H=640", **route}
    del x, mask, p, w, m_f, g_f, m_v, g_v
    torch.cuda.empty_cache()
    # (iv) the route choice: a direction kernels 1 and 3 cannot take, on
    # the cluster designs of kernels 4 and 5
    state["v1_launches"], out["route_choice"] = route_vs_cpu(
        dev, V1_H, SEED + 24)
    # (v) a direction past both cluster plans' limits: the thread-per-unit
    # designs.  At this width the recurrence amplifies rounding: the CPU
    # plain run against itself on x * (1 + 1e-6) moves m by 2.5x the lstm
    # tolerance (relative L2 1.5e-3, the gradients 5.5e-3), so m is held
    # in relative L2 like the gradients
    _, out["route_wide"] = route_vs_cpu(dev, V1_WIDE_H, SEED + 26,
                                        m_elementwise=False)
    return out


def libri_config(dropout: bool, num_layers: int = 4):
    """The LibriSpeech char recipe's model (recipes/config.py:152-170):
    4 x 640 over 360-d input, 30 targets (blank + 29 characters), with the
    recipe's dropout when `dropout` (num_layers cuts its depth)."""
    from eesen_tpu_torch.models.model import AcousticModelConfig

    drop = dict(forward_dropout=0.2, recurrent_dropout=0.2,
                forward_step_dropout=False, recurrent_step_dropout=False,
                recurrent_dropout_mode="no_mem_loss", twiddle=True)
    return AcousticModelConfig(input_dim=LIBRI_D, cell_dim=LIBRI_H,
                               num_layers=num_layers, num_targets=LIBRI_V,
                               **(drop if dropout else {}))


def libri_batch(dev, b: int):
    """b rows at T=768 with the training lengths (row 7 a padded row),
    normal 360-d features, characters 1..29, min(200, frames/3) labels."""
    import torch

    rng = np.random.default_rng(SEED + 31)
    lens = train_lengths()
    lab_l = np.minimum(LIBRI_L, lens // 3)
    feats = rng.standard_normal((TRAIN_B, TRAIN_T, LIBRI_D)).astype(
        np.float32)
    labels = rng.integers(1, LIBRI_V, (TRAIN_B, LIBRI_L))
    for i in range(TRAIN_B):
        feats[i, lens[i]:] = 0.0
        labels[i, lab_l[i]:] = 0
    batch = {"feats": feats, "feat_lengths": lens, "labels": labels,
             "label_lengths": lab_l}
    return {k: torch.from_numpy(np.ascontiguousarray(v[:b])).to(dev)
            for k, v in batch.items()}


def phase_libri(dev, state):
    """The LibriSpeech char 4 x 640 model on the card: (i) serve, (ii)
    train without dropout, (iii) train with the recipe's dropout."""
    import dataclasses

    import torch
    from eesen_tpu_torch.models.model import init_model
    from eesen_tpu_torch.models.priors import compute_log_priors
    from eesen_tpu_torch.recipes.run import posteriors
    from eesen_tpu_torch.training.optim import OptimizerConfig
    from eesen_tpu_torch.training.trainer import (
        create_train_state, make_train_step,
    )

    out = {}
    # (i) serve B=8, T=512 through kernel 1 at H=640
    cfg = libri_config(dropout=True)
    params = init_model(torch.Generator().manual_seed(SEED), cfg, device=dev)
    rng = np.random.default_rng(SEED + 32)
    arr = np.zeros((B, T_MAX, LIBRI_D), np.float32)
    for i, n in enumerate(LENGTHS):
        arr[i, :n] = rng.standard_normal((n, LIBRI_D))
    lens = np.asarray(LENGTHS)
    log_priors = compute_log_priors(
        rng.integers(1, 1000, LIBRI_V).astype(np.float64))
    reset_counters()
    t0 = time.perf_counter()
    lp = posteriors(params, cfg, arr, lens, log_priors, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counters()
    state["libri_serve_launches"] = launched
    if launched["lstm_fwd"] != 8 or launched["lstm_scan_fwd"] != 0:
        raise AssertionError(f"libri serve launched {launched}")
    lp_cpu = posteriors(_to_cpu(params), cfg, arr, lens, log_priors,
                        device="cpu")
    valid = torch.from_numpy(np.arange(T_MAX)[None, :] < lens[:, None])
    lp_err = float((lp.cpu() - lp_cpu).abs()[valid].max())
    if not lp_err <= LP_ATOL:
        raise AssertionError(f"libri log-posteriors differ by {lp_err}")
    out["serve"] = {"batch": B, "frames": T_MAX, "wall_s": wall,
                    "launches": launched, "lp_max_abs_err_vs_cpu": lp_err,
                    "lp_atol": LP_ATOL}
    del params, lp, lp_cpu
    # (ii) train without dropout, B=128, T=768, L=200 (S=401)
    opt = OptimizerConfig(algorithm="sgd", momentum=0.9, max_grad=50.0)
    cfg_nd = libri_config(dropout=False)
    st, tx = create_train_state(torch.Generator().manual_seed(SEED), cfg_nd,
                                opt, device=dev)
    step = make_train_step(cfg_nd, tx)
    batch = libri_batch(dev, TRAIN_B)
    st, _ = step(st, batch, None, LEARN_RATE)          # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    losses = []
    for _ in range(LIBRI_STEPS):
        st, m = step(st, batch, None, LEARN_RATE)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in counters().items() if k != "dedup_prune"}
    state["libri_train_launches"] = launched
    per_step = {k: v / LIBRI_STEPS for k, v in launched.items()}
    losses = [float(v) for v in losses]
    if per_step != TRAIN_STEP_LAUNCHES or not np.all(np.isfinite(losses)):
        raise AssertionError(f"libri launches per step {per_step}, "
                             f"losses {losses}")
    s_step = wall / LIBRI_STEPS
    holder = {"st": st}

    def one_step():
        holder["st"], _ = step(holder["st"], batch, None, LEARN_RATE)

    out["train"] = {"batch": TRAIN_B, "frames": TRAIN_T, "labels": LIBRI_L,
                    "ctc_states": 2 * LIBRI_L + 1, "steps": LIBRI_STEPS,
                    "losses": losses, "launches_per_step": per_step,
                    "s_per_step": s_step,
                    "audio_s_per_s": TRAIN_B * TRAIN_T * LIBRI_FRAME_S / s_step,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "profile": _profile(one_step, CTC_KERNELS)}
    del st, tx, step, holder
    # (iii) the recipe's dropout: 8 rows card vs CPU with the same masks
    # (the model's first LIBRI_DROP_CHECK_LAYERS layers), then the
    # recipe's num_sequence rows on the card at full depth
    cfg_c = libri_config(dropout=True, num_layers=LIBRI_DROP_CHECK_LAYERS)
    st_c, tx_c = create_train_state(torch.Generator().manual_seed(SEED),
                                    cfg_c, opt, device=dev)
    reset_counters()
    check = card_vs_cpu_step(make_train_step(cfg_c, tx_c), st_c,
                             {k: v[:8] for k, v in batch.items()},
                             gen_seed=SEED + 33)
    check["launches"] = counters()
    check["layers"] = LIBRI_DROP_CHECK_LAYERS
    del st_c
    cfg_d = libri_config(dropout=True)
    st, tx = create_train_state(torch.Generator().manual_seed(SEED), cfg_d,
                                opt, device=dev)
    step = make_train_step(cfg_d, tx)
    b20 = {k: v[:LIBRI_DROP_B] for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    _, m = step(st, b20, torch.Generator().manual_seed(SEED + 34),
                LEARN_RATE)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counters()
    state["libri_dropout_launches"] = launched
    want = {"lstm_fwd": 0, "lstm_bwd": 0, "lstm_scan_fwd": 0,
            "lstm_scan_bwd": 0, "ctc_alpha": 1, "ctc_beta": 1}
    for name, got in (("8-row", check["launches"]), ("B=20", launched)):
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"libri dropout {name} step launched {got}")
    if not np.isfinite(loss):
        raise AssertionError(f"libri dropout step loss {loss}")
    out["dropout"] = {"cpu_check": check, "batch": LIBRI_DROP_B,
                      "frames": TRAIN_T, "loss": loss, "seconds": seconds,
                      "launches": launched,
                      "audio_s_per_s":
                          LIBRI_DROP_B * TRAIN_T * LIBRI_FRAME_S / seconds,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


def phase_train(dev, state):
    import torch
    from eesen_tpu_torch.training.trainer import make_train_step

    cfg, st, tx, batch = train_setup(dev)
    step = make_train_step(cfg, tx)
    # (i) 8 rows, card vs CPU, from the same parameters and a zero state
    cpu_check = card_vs_cpu_step(step, st, {k: v[:8] for k, v in
                                            batch.items()})
    # (ii) chained full-width steps, counters zeroed just before
    st, m = step(st, batch, None, LEARN_RATE)          # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        st, m = step(st, batch, None, LEARN_RATE)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in counters().items() if k != "dedup_prune"}
    state["train_launches"] = launches
    losses = [float(x) for x in losses]
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    if per_step != TRAIN_STEP_LAUNCHES or not np.all(np.isfinite(losses)):
        raise AssertionError(f"launches per step {per_step}, losses {losses}")
    s_step = wall / TRAIN_STEPS
    # (iii) one step under the profiler
    holder = {"st": st}

    def one_step():
        holder["st"], _ = step(holder["st"], batch, None, LEARN_RATE)

    return {"cpu_check": cpu_check, "batch": TRAIN_B, "frames": TRAIN_T,
            "labels": TRAIN_L, "steps": TRAIN_STEPS, "losses": losses, "launches": launches,
            "launches_per_step": per_step, "s_per_step": s_step,
            "audio_s_per_s": TRAIN_B * TRAIN_T * 0.010 / s_step,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile": _profile(one_step, CTC_KERNELS)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_epoch(trainer, batch):
    """MESH_STEPS steps of trainer.run_epoch on `batch`, the counters
    zeroed just before and read just after -> (s a step, report,
    launches)."""
    import torch

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    report = trainer.run_epoch(iter([dict(batch)] * MESH_STEPS), True,
                               LEARN_RATE)
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / MESH_STEPS
    return s, report, {k: v for k, v in counters().items()
                       if k != "dedup_prune"}


def _params_equal(a, b) -> bool:
    import torch
    from eesen_tpu_torch.training.optim import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def mesh_world_of_one(dev, graphs, state):
    """(i) Trainer(mesh=...) over NCCL in a world of one, in this process,
    against the plain Trainer from the same parameters: an epoch of
    MESH_STEPS steps each, equal reports and launches; then each trainer's
    step function chained on the card's batch (plain, mesh, mesh, plain),
    s a step, and equal parameter bits; the all-reduce of one step's
    bucket alone; the sharded decoder over phase main's 8 utterances."""
    import torch
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, make_sharded_beam_decoder, traceback,
    )
    from eesen_tpu_torch.models.model import AcousticModelConfig
    from eesen_tpu_torch.parallel.distributed import (
        init_distributed, psum_,
    )
    from eesen_tpu_torch.parallel.mesh import make_mesh
    from eesen_tpu_torch.recipes.run import posteriors
    from eesen_tpu_torch.training.optim import ravel
    from eesen_tpu_torch.training.trainer import Trainer, TrainerConfig

    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                     timeout=MESH_TIMEOUT_S)
    try:
        mesh = make_mesh(device=dev)
        tcfg = TrainerConfig(
            model=AcousticModelConfig(input_dim=120, cell_dim=320,
                                      num_layers=4, num_targets=72),
            optimizer=train_opt(), seed=SEED, report_step=10 ** 6,
            ter_step=MESH_STEPS)
        trainers = {"plain": Trainer(tcfg, device=dev),
                    "mesh": Trainer(tcfg, mesh=mesh)}
        epochs = {k: mesh_epoch(t, train_batch())
                  for k, t in trainers.items()}
        if vars(epochs["plain"][1]) != vars(epochs["mesh"][1]) or \
                not _params_equal(trainers["plain"].state.params,
                                  trainers["mesh"].state.params):
            raise AssertionError(f"reports {vars(epochs['plain'][1])} vs "
                                 f"{vars(epochs['mesh'][1])}, or the "
                                 f"parameters differ")
        launches = epochs["mesh"][2]
        per_step = {k: v / MESH_STEPS for k, v in launches.items()}
        if per_step != TRAIN_STEP_LAUNCHES or epochs["plain"][2] != launches:
            raise AssertionError(f"launches: plain {epochs['plain'][2]}, "
                                 f"mesh {launches}")
        state["mesh_launches"] = launches
        # the two step functions alone, chained on the card's batch
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in train_batch().items()}
        step_s = {"plain": [], "mesh": []}
        for name in ("plain", "mesh", "mesh", "plain"):
            t = trainers[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                t.state, _ = t.train_step(t.state, batch, None, LEARN_RATE)
            torch.cuda.synchronize()
            step_s[name].append((time.perf_counter() - t0) / TRAIN_STEPS)
        if not _params_equal(trainers["plain"].state.params,
                             trainers["mesh"].state.params):
            raise AssertionError("mesh trainer's parameters differ")
        meshed = trainers["mesh"]
        bucket = torch.zeros(ravel(meshed.state.params).numel() + 2,
                             device=dev)
        allreduce_ms, _ = _wall_ms(lambda: psum_(bucket, mesh), MESH_REPS)
        # the job-sharded decode of phase main's utterances
        g = graphs["packed"][0]
        dec = make_sharded_beam_decoder(g, BeamSearchConfig(**DECODE), mesh)
        dg = DeviceGraph.put(g, device=dev)
        reset_counters()
        t0 = time.perf_counter()
        lp = posteriors(state["params"], state["cfg"], state["arr"],
                        state["lens"], state["log_priors"], dev)
        res = traceback(dec(lp, state["lens"], dg), state["lens"],
                        g.final_weight)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launched = counters()
        state["mesh_decode_launches"] = {
            k: launched[k] for k in ("lstm_fwd", "dedup_prune")}
        _results_equal("sharded decode (world 1)", res, state["hyps"],
                       COST_RTOL)
        if min(state["mesh_decode_launches"].values()) == 0:
            raise AssertionError(f"decode launches {launched}")
    finally:
        torch.distributed.destroy_process_group()
    s_mesh = statistics.mean(step_s["mesh"])
    return {"backend": "nccl", "world": 1, "batch": TRAIN_B,
            "frames": TRAIN_T, "labels": TRAIN_L, "steps": MESH_STEPS,
            "equal_bits": True, "launches": launches,
            "launches_per_step": per_step,
            "epoch_s_per_step": {k: e[0] for k, e in epochs.items()},
            "chained_steps": TRAIN_STEPS,
            "s_per_step_plain": step_s["plain"],
            "s_per_step_mesh": step_s["mesh"],
            "mesh_over_plain": s_mesh / statistics.mean(step_s["plain"]),
            "allreduce_ms": allreduce_ms, "allreduce_floats": bucket.numel(),
            "allreduce_share": allreduce_ms / 1e3 / s_mesh,
            "decode_s": decode_s,
            "decode_launches": state["mesh_decode_launches"],
            "decode_words": [len(w) for w, _ in res]}


def mesh_spawn(work, dev, data: int, model: int):
    """Ranks 0..data*model-1 of a data x model mesh on `dev` over gloo,
    spawned as `chip_smoke.py --mesh-rank R PORT DIR DEVICE DATA MODEL`
    with their inputs in `work`; every one killed past MESH_TIMEOUT_S.
    -> (seconds from the first start to the last exit, what each rank
    saved)."""
    import torch

    port = str(free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
                 [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                  str(r), port, work, str(dev), str(data), str(model)],
                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                 text=True, cwd=ROOT)
             for r in range(data * model)]
    try:
        logs = [p.communicate(timeout=MESH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    spawn_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{data}x{model} rank {r} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    return spawn_s, [torch.load(os.path.join(work, f"rank{r}.pt"),
                                weights_only=False)
                     for r in range(data * model)]


def _rank_report(o, name, r):
    """One rank's training numbers; its launches a step must be 8/8/1/1
    and its sharded decodes must have run kernels 1 and 2."""
    per_step = {k: v / MESH_STEPS for k, v in o["train_launches"].items()
                if k != "dedup_prune"}
    if per_step != TRAIN_STEP_LAUNCHES:
        raise AssertionError(f"{name} rank {r} launches per step {per_step}")
    decode_launches = {
        axis: {k: n[k] for k in ("lstm_fwd", "dedup_prune")}
        for axis, n in o["decode_launches"].items()}
    for axis, dl in decode_launches.items():
        if min(dl.values()) == 0:
            raise AssertionError(f"{name} rank {r} decode over {axis}: "
                                 f"launches {dl}")
    s_step = statistics.median(o["step_s"])
    return {"losses": o["losses"], "step_s": o["step_s"],
            "s_per_step": s_step, "allreduce_ms": o["allreduce_ms"],
            "allreduce_share": o["allreduce_ms"] / 1e3 / s_step,
            "gather_ms": o["gather_ms"],
            "gather_share": (None if o["gather_ms"] is None
                             else o["gather_ms"] / 1e3 / s_step),
            "shard_shapes": o["shard_shapes"],
            "train_launches": o["train_launches"],
            "decode_s": o["decode_s"], "decode_launches": decode_launches}


def mesh_ranks(dev, graphs, state):
    """(ii)-(iv) ranks on the one card over gloo (`mesh_spawn`), each run
    MESH_STEPS steps of its rows of MESH_ROWS f32 rows, beside this
    process's step over the MESH_ROWS rows:

    (ii) data=2 x model=1: loss and parameters at MESH_RTOL / MESH_ATOL,
         the ranks' parameters equal bits; the sharded decode of phase
         main's utterances, 4 a rank: main's words, costs within
         COST_RTOL;
    (iii) data=1 x model=2: loss and gathered parameters equal bits to
         this process's step (same kernels, same inputs, a data group of
         one);
    (iv) data=2 x model=2: gathered parameters and losses equal bits to
         (ii)'s (the same two-addend sums) and across ranks; a
         checkpoint round trip; the sharded decode over "data" and over
         "model": main's words."""
    import pickle
    import shutil

    import torch
    from eesen_tpu_torch.training.optim import ravel
    from eesen_tpu_torch.training.trainer import make_train_step

    work = os.path.join(ROOT, "tmp", "chip_smoke_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    runs = {}
    try:
        cfg, st, tx, batch = train_setup(dev, compute_dtype=torch.float32,
                                         state_bf16=False)
        rows = {k: v[:MESH_ROWS] for k, v in batch.items()}
        step = make_train_step(cfg, tx)
        losses, plain_s = [], []
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, rows, None, LEARN_RATE)
            losses.append(float(m["loss"]))
            plain_s.append(time.perf_counter() - t0)
        want = ravel(st.params).cpu()
        with open(os.path.join(work, "graph.pkl"), "wb") as f:
            pickle.dump(graphs["packed"][0], f)
        np.savez(os.path.join(work, "main.npz"), arr=state["arr"],
                 lens=state["lens"])
        for name, (data, model) in MESH_GRIDS.items():
            t0 = time.perf_counter()
            spawn_s, ranks = mesh_spawn(work, dev, data, model)
            runs[name] = {"grid": [data, model], "spawn_s": spawn_s,
                          "ranks": ranks}
            for r in range(data * model):
                os.remove(os.path.join(work, f"rank{r}.pt"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"backend": "gloo", "rows": MESH_ROWS, "frames": TRAIN_T,
           "labels": TRAIN_L, "compute_dtype": "float32",
           "steps": MESH_STEPS, "losses_single": losses,
           "s_per_step_single": plain_s}
    base = runs["two_ranks"]["ranks"][0]
    for name, run_ in runs.items():
        ranks = run_.pop("ranks")
        for o in ranks[1:]:
            if not torch.equal(o["params"], ranks[0]["params"]):
                raise AssertionError(f"{name}: the ranks' parameters differ")
        reports = []
        for r, o in enumerate(ranks):
            rep = _rank_report(o, name, r)
            param_err = float((o["params"] - want).abs().max())
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(o["losses"], losses))
            rep.update(param_max_abs_err=param_err, loss_rel_err=loss_err)
            if name == "two_ranks":
                if not (torch.allclose(o["params"], want, rtol=MESH_RTOL,
                                       atol=MESH_ATOL)
                        and loss_err <= MESH_RTOL):
                    raise AssertionError(
                        f"{name} rank {r}: losses {o['losses']} vs "
                        f"{losses}, parameters off by {param_err}")
            elif name == "model_axis":
                if not (torch.equal(o["params"], want)
                        and o["losses"] == losses):
                    raise AssertionError(
                        f"{name} rank {r}: not the single step's bits "
                        f"(losses {o['losses']} vs {losses}, parameters "
                        f"off by {param_err})")
            else:
                if not (torch.equal(o["params"], base["params"])
                        and o["losses"] == base["losses"]):
                    raise AssertionError(
                        f"{name} rank {r}: not the data-only mesh's bits")
                if not o["checkpoint_equal"]:
                    raise AssertionError(
                        f"{name} rank {r}: the restored state differs")
                rep["checkpoint_equal"] = True
            for axis, res in o["decode"].items():
                _results_equal(f"{name} rank {r}, decode over {axis}", res,
                               state["hyps"], COST_RTOL)
            reports.append(rep)
        run_["ranks"] = reports
        run_["s_per_step"] = max(rep["s_per_step"] for rep in reports)
        out[name] = run_
    state["mesh_rank_launches"] = {
        name: [r["train_launches"] for r in out[name]["ranks"]]
        for name in MESH_GRIDS}
    state["mesh_rank_decode_launches"] = {
        name: [r["decode_launches"] for r in out[name]["ranks"]]
        for name in MESH_GRIDS}
    out.update(rtol=MESH_RTOL, atol=MESH_ATOL, equal_bits_across_ranks=True,
               model_axis_equal_bits_to_single=True,
               data_model_equal_bits_to_two_ranks=True)
    return out


def mesh_rank(rank: int, port: str, work: str, device: str, data: str,
              model: str) -> int:
    """One rank of a `mesh_spawn` run on `device`: its rows of the f32
    training batch on a data x model mesh; the gather and the all-reduce
    alone; on a 2 x 2 mesh a checkpoint round trip; then, where the grid
    has a data axis, its share of main's utterances (posteriors on its
    data rows, gathered) searched over each axis of the grid that is not
    of one rank; writes rank<r>.pt."""
    import pickle

    import torch
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, make_sharded_beam_decoder, traceback,
    )
    from eesen_tpu_torch.ops import build
    from eesen_tpu_torch.parallel.distributed import (
        all_gather, init_distributed, psum_,
    )
    from eesen_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from eesen_tpu_torch.parallel.sharding import (
        gather_params, local_rows, shard_batch, shard_state,
    )
    from eesen_tpu_torch.recipes.run import posteriors
    from eesen_tpu_torch.training.optim import ravel, tree_leaves
    from eesen_tpu_torch.training.trainer import (
        Trainer, TrainerConfig, make_shard_map_train_step,
    )

    dev = torch.device(device)
    data, model = int(data), int(model)
    if dev.type == "cuda":
        build.load()
    # NCCL refuses two ranks on one GPU: gloo, on the card's tensors
    init_distributed(f"127.0.0.1:{port}", data * model, rank,
                     backend="gloo", timeout=MESH_TIMEOUT_S)
    try:
        mesh = make_mesh(MeshConfig(data=data, model=model), device=dev)
        cfg, st, tx, batch = train_setup(dev, compute_dtype=torch.float32,
                                         state_bf16=False)
        st = shard_state(st, mesh)
        rows = shard_batch({k: v[:MESH_ROWS] for k, v in batch.items()},
                           mesh)
        step = make_shard_map_train_step(cfg, tx, mesh)
        losses, step_s = [], []
        reset_counters()
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, rows, None, LEARN_RATE)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        train_launches = counters()
        shapes = {}
        for x in tree_leaves(st.params):
            key = "x".join(map(str, x.shape))
            shapes[key] = shapes.get(key, 0) + 1
        params = ravel(gather_params(st.params, mesh))
        gather_ms = None
        if model > 1:
            gather_ms, _ = _wall_ms(lambda: gather_params(st.params, mesh),
                                    MESH_REPS)
        bucket = torch.zeros(params.numel() + 2, device=dev)
        allreduce_ms, _ = _wall_ms(lambda: psum_(bucket, mesh), MESH_REPS)
        res = {"losses": losses, "step_s": step_s, "params": params.cpu(),
               "shard_shapes": shapes, "gather_ms": gather_ms,
               "allreduce_ms": allreduce_ms,
               "train_launches": train_launches, "decode": {},
               "decode_s": {}, "decode_launches": {}}
        if data > 1 and model > 1:
            tcfg = TrainerConfig(model=cfg, optimizer=train_opt(), seed=SEED,
                                 checkpoint_dir=os.path.join(work, "ckpt"))
            saver = Trainer(tcfg, mesh=mesh)
            saver.state = st
            saver.save_checkpoint(1)
            loaded = Trainer(tcfg, mesh=mesh)
            loaded.restore_checkpoint(1)
            res["checkpoint_equal"] = loaded.state.step == st.step and all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves((loaded.state.params,
                                 loaded.state.opt_state.inner)),
                    tree_leaves((st.params, st.opt_state.inner))))
        if data > 1:
            with open(os.path.join(work, "graph.pkl"), "rb") as f:
                g = pickle.load(f)
            main = np.load(os.path.join(work, "main.npz"))
            arr, lens = main["arr"], main["lens"]
            mcfg, mparams, _, log_priors, _ = model_and_inputs(dev)
            dg = DeviceGraph.put(g, device=dev)
            lo, hi = local_rows(len(lens), mesh)
            for axis in ("data", "model")[:1 + (model > 1)]:
                dec = make_sharded_beam_decoder(g, BeamSearchConfig(**DECODE),
                                                mesh, axis=axis)
                reset_counters()
                t0 = time.perf_counter()
                lp = all_gather(posteriors(mparams, mcfg, arr[lo:hi],
                                           lens[lo:hi], log_priors, dev),
                                mesh)
                res["decode"][axis] = traceback(dec(lp, lens, dg), lens,
                                                g.final_weight)
                torch.cuda.synchronize()
                res["decode_s"][axis] = time.perf_counter() - t0
                res["decode_launches"][axis] = counters()
        torch.save(res, os.path.join(work, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_mesh(dev, graphs, state):
    return {"world_of_one": mesh_world_of_one(dev, graphs, state),
            **mesh_ranks(dev, graphs, state)}


def _nbytes(tensors) -> int:
    return sum(v.numel() * v.element_size() for v in tensors)


def lstm_bound(inp, outs, valid_steps: int, passes: int = 1):
    """Kernel 1 (passes=1: 2*sum(len)*(D+H)*4H FLOP) or kernel 3 (passes=2:
    dx, dW_x, dW_m and dm's product, 4*sum(len)*(D+H)*4H FLOP) over the
    valid steps at the bf16 rate, or its inputs and outputs moved once at
    the memory rate, whichever is longer.  Returns (ms, "operations" or
    "bytes")."""
    d = inp["x"].shape[2]
    h = inp["w_m"].shape[0]
    flops = 2.0 * passes * valid_steps * (d + h) * 4 * h
    t_ops = flops / BF16_FLOPS
    t_bytes = (_nbytes(inp.values()) + _nbytes(outs)) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ctc_bound_ms(inp, which: str) -> float:
    """Kernel 6 or 7: reads lp_e (and the masks and lengths) once, writes
    its [B,T,S] float32 output once; the log-space arithmetic, ~10
    float32 operations a state and frame, is far below the bytes."""
    ins = [inp["lp_e"], inp["can_skip_f"], inp["logit_lengths"]]
    if which == "beta":
        ins.append(inp["beta_init_row"])
    nbytes = _nbytes(ins) + inp["lp_e"].numel() * 4
    ops = 10.0 * inp["lp_e"].numel()
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS) * 1e3


def dedup_bound_ms(m: int, k: int = K) -> float:
    """Kernel 2: reads dst and score once, writes k slots of three 4-byte
    outputs; ~8 operations a lane (threshold, hash, compare), far below
    the bytes."""
    nbytes = B * m * 8 + B * k * 12
    ops = 8.0 * B * m
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS) * 1e3


def fwd_residency(b: int, h: int):
    """Kernel 1's cluster plan at (b, h), bf16, and whether all its
    clusters are resident at once (cudaOccupancyMaxActiveClusters)."""
    from eesen_tpu_torch.ops import build, lstm_cuda

    p = lstm_cuda.fused_launch(b, 0, h).fwd
    active = build.load().lstm_fwd_max_clusters(b, h, p.cluster, p.rows,
                                                p.units, p.kres, 1)
    return {**p._asdict(), "clusters": -(-b // p.rows),
            "max_active_clusters": active}


def bwd_residency(b: int, h: int):
    """Kernel 3's recurrence plan at (b, h), bf16, and whether all its
    clusters are resident at once (one wave)."""
    from eesen_tpu_torch.ops import build, lstm_cuda

    p = lstm_cuda.fused_launch(b, 0, h).bwd
    active = build.load().lstm_bwd_max_clusters(b, h, *p, 1)
    clusters = -(-b // p.rows)
    return {**p._asdict(), "clusters": clusters,
            "max_active_clusters": active, "one_wave": active >= clusters}


def _device_split(fn, groups, reps: int = 4):
    """Device time of `reps` calls of fn() under torch.profiler, summed by
    groups of kernel names ({group: substrings}; the rest under "other"):
    {group: {"ms": total ms, "launches": kernels recorded,
    "gemm_launches": of them, product kernels}, "windows": profiled
    windows}.  The launch counts show what the window recorded: this
    machine's profiler can drop kernel records (PERF.md), and has
    recorded no kernel at all in some windows; a window that recorded no
    kernel of some group is profiled again, at most three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {g: {"ms": 0.0, "launches": 0, "gemm_launches": 0}
               for g in (*groups, "other")}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and \
                    e.self_device_time_total > 0:
                g = next((g for g, names in groups.items()
                          if any(n in e.key for n in names)), "other")
                out[g]["ms"] += e.self_device_time_total / 1e3
                out[g]["launches"] += e.count
                if any(n in e.key for n in PRODUCT_KERNELS[:2]):
                    out[g]["gemm_launches"] += e.count
        if all(out[g]["launches"] for g in groups):
            break
    out["windows"] = window
    return out


# the product kernel and the device kernels around it: its operand copies
# (pad_kernel) and kernel 3's ordered sums of partials (sum_rows_kernel)
PRODUCT_KERNELS = ("gemm_bf16_kernel", "gemm_kernel", "pad_kernel",
                   "sum_rows_kernel")
# kernel 3's device kernels: the recurrence, and the products with their
# partial sums; "other" is the wrapper's torch ops (the W_m slice layout)
BWD_GROUPS = {"recurrence": ("lstm_bwd_rec_kernel",),
              "products": PRODUCT_KERNELS}
# kernel 1's: the input projection and the recurrence
FWD_GROUPS = {"projection": PRODUCT_KERNELS,
              "recurrence": ("lstm_rec_kernel",)}


def _per_call(group, calls_seen) -> float | None:
    """A group's device ms per call of its wrapper, over the calls whose
    launches the profiler recorded (calls_seen)."""
    return group["ms"] / calls_seen if calls_seen else None


def bwd_timing(bwd, valid: int, b: int, h: int, reps: int):
    """Kernel 3 per direction-layer: event ms, the plain version's, its
    bound, the device ms of its recurrence (per launch, and per step) and
    of its products (per call: the three products and the sums of their
    partials), both from the profiler's recorded launches (a call's
    products counted by its recorded product-kernel launches, three a
    call), its cluster plan and residency, and the three products alone
    (`products_timing`)."""
    from eesen_tpu_torch.ops import lstm_cuda

    grads = lstm_cuda.lstm_direction_bwd(**bwd)
    bound, by = lstm_bound(bwd, grads, valid, passes=2)
    split = _device_split(lambda: lstm_cuda.lstm_direction_bwd(**bwd),
                          BWD_GROUPS)
    rec, prod = split["recurrence"], split["products"]
    rec_ms = _per_call(rec, rec["launches"])
    t_max = bwd["x"].shape[0]
    return dict(
        ms=_cuda_ms(lambda: lstm_cuda.lstm_direction_bwd(**bwd), reps),
        plain_ms=_cuda_ms(lambda: lstm_cuda.lstm_direction_bwd_ref(**bwd), 1),
        bound_ms=bound, bound_by=by,
        rec_ms=rec_ms,
        rec_us_per_step=rec_ms * 1e3 / t_max if rec_ms is not None else None,
        products_ms=_per_call(prod, prod["gemm_launches"] / 3),
        device_split=split, clusters=bwd_residency(b, h),
        products=products_timing(bwd, reps))


def fwd_split(fwd):
    """Kernel 1 with residuals at a training shape: the device ms of its
    projection and of its recurrence per call (profiler), and the
    projection alone (`projection_timing`)."""
    from eesen_tpu_torch.ops import lstm_cuda

    split = _device_split(lambda: lstm_cuda.lstm_direction(
        **fwd, state_bf16=True, with_residuals=True), FWD_GROUPS)
    rec = split["recurrence"]
    proj = split["projection"]
    return dict(projection_ms=_per_call(proj, proj["gemm_launches"]),
                recurrence_ms=_per_call(rec, rec["launches"]),
                device_split=split, projection=projection_timing(fwd))


def _product(name, a, b, reps, **kw):
    """The product kernel alone (lstm_cuda.gemm_bf16) on these operands:
    event ms, TFLOP/s (2*M*N*K), its bound (the larger of the FLOPs at the
    bf16 rate and the operands read once and C written once at the memory
    rate) and torch.matmul of the same bf16 operands as library_ms."""
    import torch
    from eesen_tpu_torch.ops import lstm_cuda

    av, bv, k = lstm_cuda.gemm_operands(
        a, b, **{n: kw[n] for n in ("a_mn", "b_mn", "k", "b_k0") if n in kw})
    m, n = av.shape[0], bv.shape[1]
    flops = 2.0 * m * n * k
    out_bytes = 2 if kw.get("out_dtype") == torch.bfloat16 else 4
    nbytes = 2 * (m * k + k * n) + out_bytes * m * n
    ms = _cuda_ms(lambda: lstm_cuda.gemm_bf16(a, b, **kw), reps)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"product": name, "shape": f"M={m} N={n} K={k}",
            "splits": kw.get("splits", 1), "ms": ms,
            "tflops": flops / ms / 1e9,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": _cuda_ms(lambda: torch.matmul(av, bv), reps),
            "library_call": "torch.matmul (bf16)"}


def products_timing(bwd, reps: int):
    """Kernel 3's three products alone at its shapes and splits (dW_x,
    dW_m, dx; the gate residuals stand in for dgifo, of its shape and
    type): per product and summed."""
    import torch
    from eesen_tpu_torch.ops import lstm_cuda

    t_max, b, d = bwd["x"].shape
    h = bwd["w_m"].shape[0]
    tb = t_max * b
    x2 = bwd["x"].reshape(tb, d)
    dg = bwd["gates"].reshape(tb, 4 * h)
    m2 = bwd["m"].reshape(tb, h).to(torch.bfloat16)
    zx = lstm_cuda.gemm_plan(d, 4 * h, tb).splits
    zm = lstm_cuda.gemm_plan(h, 4 * h, tb - b).splits
    rows = [_product("dW_x", x2, dg, reps, a_mn=True, splits=zx),
            _product("dW_m", m2, dg, reps, a_mn=True, b_k0=b, k=tb - b,
                     splits=zm),
            _product("dx", dg, bwd["w_x"], reps, b_mn=False,
                     out_dtype=torch.bfloat16)]
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "bound_ms", "library_ms")}
    flops = sum(r["tflops"] * r["ms"] for r in rows)
    return {"each": rows, **tot, "tflops": flops / tot["ms"]}


def projection_timing(fwd):
    """Kernel 1's projection x.W_x + b alone at its shape."""
    t_max, b, d = fwd["x"].shape
    return _product("x.W_x + b", fwd["x"].reshape(t_max * b, d),
                    fwd["w_x"], 5, bias=fwd["bias"])


def phase_timing(dev):
    from eesen_tpu_torch.ops import beam_cuda, lstm_cuda

    out = {"lstm_fwd": {}, "dedup_prune": {}}
    for d in (120, 640):
        inp = lstm_inputs(d, 320, dev, SEED + d)
        bound, by = lstm_bound(inp, [lstm_cuda.lstm_direction(
            **inp, state_bf16=True)], sum(LENGTHS))
        ms = _cuda_ms(lambda: lstm_cuda.lstm_direction(
            **inp, state_bf16=True), 5)
        out["lstm_fwd"][f"D{d}"] = dict(
            ms=ms, ms_per_step=ms / T_MAX,
            plain_ms=_cuda_ms(lambda: lstm_cuda.lstm_direction_ref(
                **inp, state_bf16=True), 2),
            bound_ms=bound, bound_by=by,
            clusters=fwd_residency(B, 320),
        )
    for m, k, tag in ((4096, K, "m4096"), (14336, K, "m14336"),
                      (OPT_SMALL_BUDGET, OPT_K, f"m{OPT_SMALL_BUDGET}_k{OPT_K}"),
                      (OPT_K + OPT_SMALL_BUDGET, OPT_K,
                       f"m{OPT_K + OPT_SMALL_BUDGET}_k{OPT_K}")):
        dst, score = dedup_inputs(m, dev, SEED + m)
        beam = DECODE["beam"]
        out["dedup_prune"][tag] = dict(
            ms=_cuda_ms(lambda: beam_cuda.dedup_prune(dst, score, k, beam),
                        50),
            device_ms=_device_ms(
                lambda: beam_cuda.dedup_prune(dst, score, k, beam),
                "dedup_prune_kernel", 50),
            plain_ms=_cuda_ms(lambda: beam_cuda.dedup_prune_ref(
                dst, score, k, beam), 20),
            bound_ms=dedup_bound_ms(m, k),
        )
    out.update(timing_train_shapes(dev))
    out.update(timing_libri(dev))
    return out


def scan_bound(inp, outs, valid_steps: int):
    """Kernel 4 or 5: its inputs and outputs moved once at the memory
    rate (36*H bytes a row-step), or 2*sum(len)*H*4H FLOP (the recurrent
    product over the valid steps) at the bf16 rate, whichever is longer.
    Returns (ms, "operations" or "bytes")."""
    h = inp["w_m"].shape[0]
    t_ops = 2.0 * valid_steps * h * 4 * h / BF16_FLOPS
    t_bytes = (_nbytes(inp.values()) + _nbytes(outs)) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _thread_per_unit(which: str, args, outs) -> None:
    """Kernel 4 or 5 in its thread-per-unit design (csrc/lstm_scan_*.cu,
    which the route runs at the widths its cluster plans refuse) through
    the library entry itself, at any width it takes, so that timing it
    beside the cluster design does not move the wrapper's launch
    counters.  Kernel 5 transposes W_m per call, as its wrapper does for
    that design."""
    import torch
    from eesen_tpu_torch.ops import build, lstm_v1_cuda

    lib = build.load()
    h = args["w_m"].shape[0]
    t_max, b = args["mask"].shape
    stream = torch.cuda.current_stream().cuda_stream
    if which == "fwd":
        shape = lstm_v1_cuda._launch_shape(which, h,
                                           lstm_v1_cuda.fwd_smem_bytes)
        ptrs = [args[k].data_ptr() for k in ("xw", "mask", "w_m", "ph")]
        err = lib.lstm_scan_fwd(*ptrs, *(o.data_ptr() for o in outs),
                                t_max, b, h, *shape, stream)
    else:
        shape = lstm_v1_cuda._launch_shape(which, h,
                                           lstm_v1_cuda.bwd_smem_bytes)
        wm_t = args["w_m"].t().contiguous()
        ptrs = [args[k].data_ptr() for k in ("mask", "gates", "c_raw", "c",
                                             "gm")]
        err = lib.lstm_scan_bwd(*ptrs, wm_t.data_ptr(),
                                args["ph"].data_ptr(), outs[0].data_ptr(),
                                t_max, b, h, *shape, stream)
    build.check(err, f"thread-per-unit lstm_scan_{which}")


def scan_residency(b: int, h: int):
    """Kernels 4 and 5's designs at (b, h) and, for a cluster design, how
    many of its clusters the card holds at once
    (cudaOccupancyMaxActiveClusters) and whether all are resident."""
    from eesen_tpu_torch.ops import build

    lib = build.load()
    out = scan_designs(b, h)
    for k, entry in (("fwd", lambda *p: lib.lstm_fwd_max_clusters(*p, 1)),
                     ("bwd", lib.lstm_scan_bwd_max_clusters)):
        if out[k]["design"] == "cluster":
            plan = out[k]["plan"]
            active = entry(b, h, *plan)
            out[k].update(clusters=-(-b // plan[1]),
                          max_active_clusters=active,
                          one_wave=active >= -(-b // plan[1]))
    return out


def scan_timing(dev, h: int, seed: int, valid: int):
    """Kernels 4 and 5 at B=128, T=768 and width h, on (i)'s inputs: event
    ms of one launch (median) and per step, the bound, the plain version's
    ms, and the thread-per-unit design's ms on the same inputs in the same
    run; with the designs, plans and residency."""
    import torch
    from eesen_tpu_torch.ops import lstm_v1_cuda

    inp = scan_inputs(dev, seed, h)
    res = lstm_v1_cuda.lstm_scan_fwd(**inp)
    bwd = dict(mask=inp["mask"], gates=res[3], c_raw=res[2], c=res[1],
               gm=torch.randn_like(res[0]), w_m=inp["w_m"], ph=inp["ph"])
    dxw = lstm_v1_cuda.lstm_scan_bwd(**bwd)
    plan = scan_residency(TRAIN_B, h)
    out = {}
    for k, fn, ref, args, outs in (
            ("fwd", lstm_v1_cuda.lstm_scan_fwd, lstm_v1_cuda.lstm_scan_fwd_ref,
             inp, res),
            ("bwd", lstm_v1_cuda.lstm_scan_bwd, lstm_v1_cuda.lstm_scan_bwd_ref,
             bwd, [dxw])):
        bound, by = scan_bound(args, outs, valid)
        ms = _cuda_ms(lambda: fn(**args), 3)
        scratch = [torch.empty_like(o) for o in outs]
        per_unit_ms = _cuda_ms(lambda: _thread_per_unit(k, args, scratch), 3)
        out[k] = dict(ms=ms, us_per_step=ms * 1e3 / TRAIN_T,
                      thread_per_unit_ms=per_unit_ms,
                      thread_per_unit_us_per_step=per_unit_ms * 1e3 / TRAIN_T,
                      plain_ms=_cuda_ms(lambda: ref(**args), 1),
                      bound_ms=bound, bound_by=by, **plan[k],
                      shape=f"B={TRAIN_B} T={TRAIN_T} H={h}")
        del scratch
    return out["fwd"], out["bwd"]


def timing_libri(dev):
    """Kernels 4 and 5 at B=128, T=768, H=640 (the LibriSpeech width) and
    H=1152 (the v1 route's), beside their thread-per-unit design
    (`scan_timing`); at H=640 kernels 1 and 3 per direction-layer at D in
    {360, 1280}, B=128, T=768 (kernel 1 with residuals), and kernel 1
    serving B=8, T=512; then the two routes, forward + backward through
    autograd, per direction-layer at D=1280 (recorded only: they do not
    decide the route)."""
    import torch
    from eesen_tpu_torch.ops import lstm_cuda

    valid = int(train_lengths().sum())
    out = {"lstm_scan_fwd": {}, "lstm_scan_bwd": {}, "lstm_fwd_h640": {},
           "lstm_bwd_h640": {}, "routes_h640": {}}
    for h, seed in ((LIBRI_H, SEED + 21), (V1_H, SEED + 25)):
        out["lstm_scan_fwd"][f"H{h}"], out["lstm_scan_bwd"][f"H{h}"] = \
            scan_timing(dev, h, seed, valid)
        torch.cuda.empty_cache()
    for d in (LIBRI_D, 2 * LIBRI_H):
        fwd, bwd = train_lstm_inputs(d, LIBRI_H, dev, SEED + d + 1, True)
        res = lstm_cuda.lstm_direction(**fwd, state_bf16=True,
                                       with_residuals=True)
        bound, by = lstm_bound(fwd, res, valid)
        ms = _cuda_ms(lambda: lstm_cuda.lstm_direction(
            **fwd, state_bf16=True, with_residuals=True), 2)
        out["lstm_fwd_h640"][f"train_D{d}"] = dict(
            ms=ms, ms_per_step=ms / TRAIN_T,
            plain_ms=_cuda_ms(lambda: lstm_cuda.lstm_direction_ref(
                **fwd, state_bf16=True, with_residuals=True), 1),
            bound_ms=bound, bound_by=by,
            clusters=fwd_residency(TRAIN_B, LIBRI_H), **fwd_split(fwd))
        out["lstm_bwd_h640"][f"D{d}"] = bwd_timing(bwd, valid, TRAIN_B,
                                                   LIBRI_H, 2)
        del fwd, bwd, res
        inp = lstm_inputs(d, LIBRI_H, dev, SEED + d)
        bound, by = lstm_bound(inp, [lstm_cuda.lstm_direction(
            **inp, state_bf16=True)], sum(LENGTHS))
        ms = _cuda_ms(lambda: lstm_cuda.lstm_direction(
            **inp, state_bf16=True), 3)
        out["lstm_fwd_h640"][f"serve_D{d}"] = dict(
            ms=ms, ms_per_step=ms / T_MAX, clusters=fwd_residency(B, LIBRI_H),
            plain_ms=_cuda_ms(lambda: lstm_cuda.lstm_direction_ref(
                **inp, state_bf16=True), 1),
            bound_ms=bound, bound_by=by)
    torch.cuda.empty_cache()
    x, mask, p, w = route_inputs(dev, SEED + 23)
    routes = (("fused", lambda a, b, c: fused_route(a, b, c, True)),
              ("v1", v1_route))
    for name, route in routes:
        out["routes_h640"][name] = {"fwd_bwd_ms": _cuda_ms(
            lambda: route_grads(route, x, mask, p, w), 2),
            "shape": "B=128 T=768 D=1280 H=640"}
    return out


def _ctc_kernel(which: str, inp, lens, out):
    """One CTC kernel through the library entry itself, so that timing
    it does not move the wrapper's launch counters (lens: the frame
    counts as int32)."""
    import torch
    from eesen_tpu_torch.ops import build

    lib = build.load()
    b, t, s = inp["lp_e"].shape
    stream = torch.cuda.current_stream().cuda_stream
    if which == "alpha":
        err = lib.ctc_alpha(inp["lp_e"].data_ptr(),
                            inp["can_skip_f"].data_ptr(), lens.data_ptr(),
                            out.data_ptr(), b, t, s, stream)
    else:
        err = lib.ctc_beta(inp["lp_e"].data_ptr(),
                           inp["can_skip_f"].data_ptr(),
                           inp["beta_init_row"].data_ptr(), lens.data_ptr(),
                           out.data_ptr(), b, t, s, stream)
    build.check(err, f"ctc_{which}")


def timing_train_shapes(dev):
    """Kernels 1 and 3 per direction-layer at the training shapes (B=128,
    T=768, H=320), and kernels 6 and 7 at the CTC_CASES shapes beside
    torch's ctc_loss (forward; forward + backward) on the same logits,
    labels and lengths as the CTC yardstick."""
    import torch
    from eesen_tpu_torch.ops import build, ctc_cuda, lstm_cuda

    out = {"lstm_fwd_train": {}, "lstm_bwd": {}, "ctc_alpha": {},
           "ctc_beta": {}}
    valid = int(train_lengths().sum())
    for d in (120, 640):
        fwd, bwd = train_lstm_inputs(d, 320, dev, SEED + d + 1, True)
        res = lstm_cuda.lstm_direction(**fwd, state_bf16=True,
                                       with_residuals=True)
        bound, by = lstm_bound(fwd, res, valid)
        ms = _cuda_ms(lambda: lstm_cuda.lstm_direction(
            **fwd, state_bf16=True, with_residuals=True), 3)
        out["lstm_fwd_train"][f"D{d}"] = dict(
            ms=ms, ms_per_step=ms / TRAIN_T,
            plain_ms=_cuda_ms(lambda: lstm_cuda.lstm_direction_ref(
                **fwd, state_bf16=True, with_residuals=True), 1),
            bound_ms=bound, bound_by=by,
            clusters=fwd_residency(TRAIN_B, 320), **fwd_split(fwd),
        )
        out["lstm_bwd"][f"D{d}"] = bwd_timing(bwd, valid, TRAIN_B, 320, 3)
        del fwd, bwd, res
    for case in CTC_CASES:
        inp, lib = ctc_train_inputs(dev, SEED + 3, case)
        buf = torch.empty_like(inp["lp_e"])
        refs = {
            "alpha": lambda: ctc_cuda.ctc_alpha_ref(
                inp["lp_e"], inp["can_skip_f"], inp["logit_lengths"]),
            "beta": lambda: ctc_cuda.ctc_beta_ref(**inp),
        }
        # the library yardstick: torch's CTC loss on the same logits
        # (forward computes alpha, backward beta)
        lp_g = lib["log_probs"].detach().clone().requires_grad_()

        def lib_fwd():
            return torch.nn.functional.ctc_loss(**lib, reduction="sum")

        def lib_fwd_bwd():
            torch.nn.functional.ctc_loss(
                lp_g, lib["targets"], lib["input_lengths"],
                lib["target_lengths"], reduction="sum").backward()

        library = {"alpha": (_cuda_ms(lib_fwd, 10), "F.ctc_loss forward"),
                   "beta": (_cuda_ms(lib_fwd_bwd, 10),
                            "F.ctc_loss forward + backward")}
        b, t, s = inp["lp_e"].shape
        lens = inp["logit_lengths"].to(torch.int32)
        depth = build.load().ctc_depth(s)
        plan = dict(ctc_cuda.ctc_plan(s)._asdict(), depth=depth,
                    smem_bytes=build.load().ctc_smem_bytes(s, depth))
        for which in ("alpha", "beta"):
            ms = _cuda_ms(lambda: _ctc_kernel(which, inp, lens, buf), 20)
            out[f"ctc_{which}"][case] = dict(
                ms=ms, us_per_step=ms * 1e3 / t,
                ms_back_to_back=_cuda_ms_back_to_back(
                    lambda: _ctc_kernel(which, inp, lens, buf), 5),
                plan=plan,
                plain_ms=_cuda_ms(refs[which], 2),
                bound_ms=ctc_bound_ms(inp, which), bound_by="bytes",
                library_ms=library[which][0], library_call=library[which][1],
                shape=f"B={b} T={t} S={s}",
            )
        del inp, lib, buf, lp_g, lens
    return out


def _profile(fn, apart=()):
    """fn() unprofiled (wall ms), then under torch.profiler: the device
    time of every CUDA kernel it ran (one stream, so kernels do not
    overlap), the idle share of the unprofiled wall time, the kernels
    with the most device time, and the device ms of the kernels whose
    names hold each string of `apart`.  Device fields are None when the
    profiler records no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    if not rows:
        return {"wall_ms": wall, "device_busy_ms": None, "idle_share": None,
                "top": None, "apart_ms": None}
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:8]],
            "apart_ms": {name: sum(ms for k, ms, _ in rows if name in k)
                         for name in apart}}


def phase_profile(dev, graphs, state):
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, make_beam_decoder,
    )
    from eesen_tpu_torch.recipes.run import posteriors

    g = graphs["packed"][0]
    dec = make_beam_decoder(g, BeamSearchConfig(**DECODE))
    dg = DeviceGraph.put(g, device=dev)
    decode = _profile(lambda: dec(state["lp"], state["lens"], dg))
    return {
        "forward": _profile(lambda: posteriors(
            state["params"], state["cfg"], state["arr"], state["lens"],
            state["log_priors"], device=dev)),
        "decode": decode,
        "decode_ms_per_frame": decode["wall_ms"] / T_MAX,
    }


# ---------------------------------------------------------------------------
# the front end and the recipe driver: audio in, words out
# ---------------------------------------------------------------------------

# card vs CPU at the JAX package's numpy-oracle tolerance
# (tests/test_features.py:79), where the mel power is above FE_MEL_FLOOR:
# below it the log holds FFT rounding, cuFFT's against pocketfft's
FE_TOL, FE_MEL_FLOOR = 1e-3, 1.0
# pipeline features card vs CPU: per-speaker CMVN (var = E[x^2] - mean^2
# in float32 on log-mel near 20) multiplies raw differences by up to ~75
# (the CPU tests' corpus: 1e-5 -> 7.5e-4)
PIPE_ATOL = 1e-2
CMVN_MEAN_ATOL = 1e-3
# tests/test_pitch.py:37-47 (speechish: near-tie lags one grid step off)
PITCH_CASES = {"tone220": (1e-4, 1e-4), "vibrato": (1e-4, 1e-4),
               "noise": (1e-4, 1e-4), "speechish": (6e-3, 2e-3),
               "tone_8k": (1e-4, 1e-4)}
# the recipe corpus (recipes/synth_corpus.py: 40 phones, 4-10 words an
# utterance, 20 speakers), cut to 48 train / 8 CV / 8 test utterances of
# a 300-word lexicon, and the recipe's newbob cut to RECIPE_MAX_ITERS
RECIPE_WORDS, RECIPE_SPLIT, RECIPE_MAX_ITERS = 300, (48, 8, 8), 2
RECIPE_CPU_UTTS = 4
PITCH_TIMING_S = 10.0


def recipe_corpus():
    """Waves (float32, int16 range, 16 kHz), texts, speakers, lexicon and
    units of the seeded synthetic corpus, and its train/cv/test keys."""
    from eesen_tpu_torch.recipes.synth_corpus import (
        SynthConfig, generate_corpus, make_lexicon, make_phones,
    )

    scfg = SynthConfig(num_words=RECIPE_WORDS, seed=SEED)
    rng = np.random.default_rng(SEED)
    phones = make_phones(scfg, rng)
    lex = make_lexicon(scfg, rng)
    waves, text, utt2spk = generate_corpus(scfg, sum(RECIPE_SPLIT), 1, lex,
                                           phones)
    keys = [sorted(waves)[i] for i in rng.permutation(len(waves))]
    a, b, _ = RECIPE_SPLIT
    return {"waves": waves, "text": text, "utt2spk": utt2spk, "lex": lex,
            "units": [f"p{i:02d}" for i in range(scfg.num_phones)],
            "split": {"train": sorted(keys[:a]), "cv": sorted(keys[a:a + b]),
                      "test": sorted(keys[a + b:])}}


def padded_waves(waves):
    """The waves zero-padded to one power-of-two length (the rule of
    RecipeRun._raw_fbank), sorted by key: [N, bucket] float32."""
    keys = sorted(waves)
    max_n = max(len(w) for w in waves.values())
    bucket = 1 << max(int(np.ceil(np.log2(max(max_n, 1024)))), 10)
    wp = np.zeros((len(keys), bucket), np.float32)
    for j, k in enumerate(keys):
        wp[j, : len(waves[k])] = waves[k]
    return wp


def phase_frontend(dev, state):
    import dataclasses

    import torch
    from eesen_tpu_torch.frontend import features as tf
    from eesen_tpu_torch.frontend import mfcc as tm
    from eesen_tpu_torch.frontend import pitch as tp
    from eesen_tpu_torch.frontend import plp as tplp
    from eesen_tpu_torch.frontend import resample as trs
    from eesen_tpu_torch.frontend.pipeline import (
        FeaturePipeline, speaker_cmvn_stats,
    )
    from eesen_tpu_torch.recipes.augment import librispeech_tags
    from eesen_tpu_torch.recipes.config import RECIPES

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the front end's products need f32")
    corpus = state["corpus"] = recipe_corpus()
    waves = corpus["waves"]
    keys = sorted(waves)
    w_cpu = torch.from_numpy(padded_waves(waves))          # [64, bucket]
    w_dev = w_cpu.to(dev)
    lens = [len(waves[k]) for k in keys]
    base = RECIPES["wsj_phn"].fbank
    out = {"utterances": len(keys), "bucket_samples": w_cpu.shape[1],
           "audio_s": sum(lens) / 16000.0}

    def view(shift):
        return dataclasses.replace(base, frame_opts=dataclasses.replace(
            base.frame_opts, dither=0.0, frame_shift_ms=shift))

    # (i) fbank, card vs CPU: the whole batch at the recipe's options, 8
    # utterances at each augmentation view
    views = {}
    for tag in librispeech_tags():
        opts = view(tag.frame_shift_ms)
        sub = slice(None) if tag.name == "10_1" else slice(0, 8)
        got = tf.fbank(w_dev[sub], opts, vtln_warp=tag.vtln_warp)
        want = tf.fbank(w_cpu[sub], opts, vtln_warp=tag.vtln_warp)
        mask = want > np.log(FE_MEL_FLOOR)
        views[tag.name] = {
            "max_abs_err": _close(f"fbank {tag.name}", got.cpu()[mask],
                                  want[mask], FE_TOL, FE_TOL),
            "compared_share": float(mask.float().mean())}
        if tag.name == "10_1":
            fb_dev, fb_cpu = got.cpu().numpy(), want.numpy()
    out["fbank"] = views
    # (ii) the pipeline at both recipe configurations on each side's raw
    nf = [tf.num_frames(n, base.frame_opts) for n in lens]
    pipes = {}
    for recipe, dim in (("wsj_phn", 120), ("tedlium_phn_30ms", 360)):
        feats = {}
        for side, fb in (("card", fb_dev), ("cpu", fb_cpu)):
            raw = {k: fb[j, :nf[j]] for j, k in enumerate(keys)}
            cmvn = speaker_cmvn_stats(raw, corpus["utt2spk"])
            pipe = FeaturePipeline(RECIPES[recipe].pipeline, cmvn,
                                   corpus["utt2spk"])
            feats[side] = {k: pipe(k, v) for k, v in raw.items()}
        err = 0.0
        for k in keys:
            a, b = feats["card"][k], feats["cpu"][k]
            if a.shape[1] != dim or not np.all(np.isfinite(a)):
                raise AssertionError(f"{recipe} {k}: {a.shape}")
            err = max(err, float(np.abs(a - b).max()))
        if not err <= PIPE_ATOL:
            raise AssertionError(f"{recipe} pipeline card vs CPU {err}")
        mean = 0.0
        if recipe == "wsj_phn":       # CMVN: static dims of each speaker
            for spk in set(corpus["utt2spk"].values()):
                x = np.concatenate([feats["card"][k][:, :40] for k in keys
                                    if corpus["utt2spk"][k] == spk])
                mean = max(mean, float(np.abs(x.mean(0)).max()))
            if not mean <= CMVN_MEAN_ATOL:
                raise AssertionError(f"CMVN means {mean}")
        pipes[recipe] = {"dim": dim, "max_abs_err": err,
                         "cmvn_mean_max": mean}
    out["pipeline"] = pipes
    # (iii) mfcc, plp, resample on 8 utterances, card vs CPU (frames whose
    # every mel bin is above the floor)
    w8, d8 = w_cpu[:8], w_dev[:8]
    mopts = tm.MfccOptions(frame_opts=tf.FrameOptions(dither=0.0))
    popts = tplp.PlpOptions(frame_opts=tf.FrameOptions(dither=0.0))
    power = tf.mel_energies(tf.frame_signal(w8, mopts.frame_opts),
                            mopts.mel_opts, mopts.frame_opts)
    fmask = (power > FE_MEL_FLOOR).all(-1)
    want = tm.mfcc(w8, mopts)
    out["mfcc"] = {"max_abs_err": _close(
        "mfcc", tm.mfcc(d8, mopts).cpu()[fmask], want[fmask], FE_TOL,
        FE_TOL * 23), "compared_share": float(fmask.float().mean())}
    out["plp"] = {"max_abs_err": _close(
        "plp", tplp.plp(d8, popts).cpu()[fmask],
        tplp.plp(w8, popts)[fmask], FE_TOL, FE_TOL)}
    rs = {}
    for fi, fo in ((16000, 8000), (16000, 22050)):
        want = trs.resample(w8, fi, fo)
        rs[f"{fi}_{fo}"] = _close(f"resample {fi}->{fo}",
                                  trs.resample(d8, fi, fo).cpu(), want,
                                  FE_TOL, FE_TOL * float(want.abs().max()))
    out["resample_max_abs_err"] = rs
    # (iv) kaldi_pitch on the card against the reference's goldens
    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "data", "pitch_golden",
                                "golden.npz"))
    golden = {}
    for name, (tol_pitch, tol_nccf) in PITCH_CASES.items():
        got = tp.kaldi_pitch(torch.from_numpy(data[f"{name}_wave"]).to(dev),
                             tp.PitchOptions(samp_freq=float(
                                 data[f"{name}_sr"]))).cpu().numpy()
        gold = data[f"{name}_raw"]
        if got.shape != gold.shape:
            raise AssertionError(f"pitch {name}: {got.shape} {gold.shape}")
        rel = float((np.abs(got[:, 1] - gold[:, 1]) / gold[:, 1]).max())
        dn = float(np.abs(got[:, 0] - gold[:, 0]).max())
        if not (rel <= tol_pitch and dn <= tol_nccf):
            raise AssertionError(f"pitch {name}: pitch {rel}, nccf {dn}")
        golden[name] = {"pitch_rel_err": rel, "nccf_abs_err": dn,
                        "tol": [tol_pitch, tol_nccf]}
    out["pitch_golden"] = golden
    # (v) times: fbank over the batch of 64 (card: events; CPU: host
    # clock), pitch over PITCH_TIMING_S of joined utterances (host clock,
    # synchronized: a loop over frames)
    opts = view(10.0)
    card_ms = _cuda_ms(lambda: tf.fbank(w_dev, opts), 5)
    cpu_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        tf.fbank(w_cpu, opts)
        cpu_ms.append((time.perf_counter() - t0) * 1e3)
    cpu_ms = statistics.median(cpu_ms)
    padded_s = w_cpu.numel() / 16000.0
    long = np.concatenate([waves[k] for k in keys])[
        : int(PITCH_TIMING_S * 16000)]
    long_dev = torch.from_numpy(long).to(dev)
    p_card_ms, p_card = _wall_ms(lambda: tp.kaldi_pitch(long_dev), 3)
    t0 = time.perf_counter()
    p_cpu = tp.kaldi_pitch(torch.from_numpy(long))
    p_cpu_ms = (time.perf_counter() - t0) * 1e3
    out["timing"] = {
        "fbank_batch": list(w_cpu.shape), "fbank_card_ms": card_ms,
        "fbank_cpu_ms": cpu_ms,
        "fbank_card_audio_s_per_s": out["audio_s"] / card_ms * 1e3,
        "fbank_cpu_audio_s_per_s": out["audio_s"] / cpu_ms * 1e3,
        "fbank_card_padded_audio_s_per_s": padded_s / card_ms * 1e3,
        "pitch_audio_s": len(long) / 16000.0, "pitch_frames": len(p_cpu),
        "pitch_card_ms": p_card_ms, "pitch_cpu_ms": p_cpu_ms,
        "pitch_card_ms_per_audio_s": p_card_ms / (len(long) / 16000.0),
        "pitch_cpu_ms_per_audio_s": p_cpu_ms / (len(long) / 16000.0),
        "pitch_card_vs_cpu_same_lags": float(
            (p_card.cpu()[:, 1] == p_cpu[:, 1]).float().mean()),
    }
    return out


def merge_widths(graph, k: int):
    """(emit, closure) merge widths of one search frame on the card, by
    decoder/beam.make_beam_decoder's rule: K x the emit row width, and
    K + K x the closure (or eps) row width."""
    from eesen_tpu_torch.decoder.beam import use_dense_rows

    if use_dense_rows(graph):
        emit, x = graph.dense_rows()
        d_e, d_x = emit.shape[1], x.shape[1]
    else:
        d_e = max(graph.max_emit_degree, 1)
        d_x = max(graph.max_closure_degree if graph.has_closure
                  else graph.max_eps_degree, 1)
    return k * d_e, k + k * d_x


def kernel2_launches(graph, k: int, frames_per_call) -> int:
    """Kernel 2's launches over decoder calls of the given frame counts:
    one per merge whose padded width fits beam_cuda.MAX_LANES (one
    closure merge to start, then an emit and a closure merge a frame)."""
    from eesen_tpu_torch.ops import beam_cuda

    fits = [beam_cuda.padded_width(m) <= beam_cuda.MAX_LANES
            for m in merge_widths(graph, k)]
    return sum(fits[1] + t * (fits[0] + fits[1]) for t in frames_per_call)


def _recording(run):
    """Wrap run._run_search so that the chunks it yields are kept."""
    seen, search = [], run._run_search

    def wrapped(*args, **kwargs):
        for item in search(*args, **kwargs):
            seen.append(item)
            yield item

    run._run_search = wrapped
    return seen


def _best_paths(run, seen):
    from eesen_tpu_torch.decoder.beam import traceback

    res, overflow = {}, 0
    for chunk, _, lens, out in seen:
        overflow += int(out.overflow.sum())
        for key, r in zip(chunk, traceback(out, lens,
                                           run.graph.final_weight)):
            res[key] = r
    return res, overflow


def phase_recipe(dev, state):
    import dataclasses
    import shutil

    from eesen_tpu_torch.recipes.config import RECIPES

    corpus = state.get("corpus") or recipe_corpus()
    base = RECIPES["wsj_phn"]
    cfg = dataclasses.replace(base, newbob=dataclasses.replace(
        base.newbob, max_iters=RECIPE_MAX_ITERS))
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tmp",
                        "chip_smoke_recipe")
    shutil.rmtree(work, ignore_errors=True)
    try:
        return _recipe(dev, state, corpus, cfg, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _recipe(dev, state, corpus, cfg, work):
    """The recipe phase in `work` (removed by phase_recipe)."""
    import torch
    from eesen_tpu_torch.io.datadir import DataDir
    from eesen_tpu_torch.recipes.lm import estimate_bigram_arpa
    from eesen_tpu_torch.recipes.run import RecipeRun
    from eesen_tpu_torch.training.batching import Utterance, make_batches
    from eesen_tpu_torch.training.optim import tree_leaves, tree_unflatten

    split, text = corpus["split"], corpus["text"]
    stages = {}

    def sync():
        torch.cuda.synchronize()

    run = RecipeRun(cfg, os.path.join(work, "card"), corpus["lex"],
                    corpus["units"], device=dev)
    cpu = RecipeRun(cfg, os.path.join(work, "cpu"), corpus["lex"],
                    corpus["units"], device="cpu")
    t0 = time.perf_counter()
    run.build_lang()
    data = DataDir.write(os.path.join(work, "data"), text=text,
                         utt2spk=corpus["utt2spk"])
    data.wav_scp = dict(corpus["waves"])
    labels = run.prep_labels(data)
    stages["lang_labels"] = time.perf_counter() - t0
    # (i) features with dither on the card; without, card vs CPU
    t0 = time.perf_counter()
    feats = run.compute_features(data, dither_seed=0)
    sync()
    stages["features"] = time.perf_counter() - t0
    dims = {v.shape[1] for v in feats.values()}
    if dims != {120} or not all(np.all(np.isfinite(v))
                                for v in feats.values()):
        raise AssertionError(f"features: dims {dims} or not finite")
    mean = 0.0
    for spk in set(corpus["utt2spk"].values()):
        x = np.concatenate([v[:, :40] for k, v in feats.items()
                            if corpus["utt2spk"][k] == spk])
        mean = max(mean, float(np.abs(x.mean(0)).max()))
    if not mean <= CMVN_MEAN_ATOL:
        raise AssertionError(f"CMVN means {mean}")
    raw_err = 0.0
    raw_card, raw_cpu = run._raw_fbank(data, None), cpu._raw_fbank(data, None)
    for k, want in raw_cpu.items():
        mask = want > np.log(FE_MEL_FLOOR)
        raw_err = max(raw_err, _close(
            f"raw fbank {k}", torch.from_numpy(raw_card[k][mask]),
            torch.from_numpy(want[mask]), FE_TOL, FE_TOL))
    f_card = run.compute_features(data, dither_seed=None)
    f_cpu = cpu.compute_features(data, dither_seed=None)
    pipe_err = max(float(np.abs(f_card[k] - f_cpu[k]).max()) for k in f_cpu)
    if not pipe_err <= PIPE_ATOL:
        raise AssertionError(f"features card vs CPU {pipe_err}")

    def part(d, name):
        return {k: d[k] for k in split[name]}

    # (ii) train: launch counters zeroed just before, read just after
    reset_counters()
    t0 = time.perf_counter()
    hist = run.train(part(feats, "train"), part(labels, "train"),
                     part(feats, "cv"), part(labels, "cv"))
    sync()
    stages["train"] = time.perf_counter() - t0
    train_launches = counters()
    steps = int(run.trainer.state.step)
    cv_utts = [Utterance(k, feats[k], labels[k]) for k in split["cv"]]
    cv_steps = len(hist) * len(list(make_batches(cv_utts, cfg.batch)))
    calls = steps + cv_steps
    want = {"lstm_fwd": 8 * calls, "lstm_bwd": 8 * steps,
            "lstm_scan_fwd": 0, "lstm_scan_bwd": 0, "ctc_alpha": calls,
            "ctc_beta": calls, "dedup_prune": 0}
    objs = [v for h in hist.values() for v in (h["train_obj"], h["cv_obj"])]
    if train_launches != want or not np.all(np.isfinite(objs)) or not steps:
        raise AssertionError(f"train launches {train_launches}, want {want}"
                             f", objectives {objs}")
    train_audio_s = sum(len(corpus["waves"][k]) for k in split["train"]) / (
        16000.0) * len(hist)
    # (iii) graph, then the test set's decode at the recipe's settings
    t0 = time.perf_counter()
    arpa = estimate_bigram_arpa([text[k] for k in split["train"]],
                                vocab=[w for w, _ in corpus["lex"]])
    run.build_graph(arpa)
    stages["graph"] = time.perf_counter() - t0
    test = part(feats, "test")
    refs = {k: text[k] for k in split["test"]}
    seen = _recording(run)
    reset_counters()
    t0 = time.perf_counter()
    stats, hyps = run.decode(test, refs)
    sync()
    stages["decode"] = time.perf_counter() - t0
    del run._run_search                  # the class's method again
    decode_launches = {k: v for k, v in counters().items()
                       if k in ("lstm_fwd", "dedup_prune")}
    best, overflow = _best_paths(run, seen)
    costs = [c for _, c in best.values()]
    k = cfg.decode.max_active
    predicted = kernel2_launches(run.graph, k, [lp.shape[1]
                                                for _, lp, _, _ in seen])
    widths = merge_widths(run.graph, k)
    frames = sum(len(v) for v in test.values())
    if overflow or not np.all(np.isfinite(costs)) or len(best) != len(test):
        raise AssertionError(f"decode: overflow {overflow}, costs {costs}")
    if decode_launches != {"lstm_fwd": 8 * len(seen),
                           "dedup_prune": predicted}:
        raise AssertionError(f"decode launches {decode_launches}, "
                             f"predicted {predicted} kernel 2")
    # (iv) the same parameters on the CPU decode the shortest utterances
    cpu.lang, cpu.graph = run.lang, run.graph
    cpu.params = tree_unflatten(run.params, [
        p.cpu() for p in tree_leaves(run.params)])
    cpu.model_cfg, cpu.log_priors = run.model_cfg, run.log_priors
    few = sorted(test, key=lambda u: (len(test[u]), u))[:RECIPE_CPU_UTTS]
    cpu_seen = _recording(cpu)
    t0 = time.perf_counter()
    cpu.decode({u: test[u] for u in few}, {u: refs[u] for u in few})
    stages["cpu_decode"] = time.perf_counter() - t0
    del cpu._run_search
    cpu_best, _ = _best_paths(cpu, cpu_seen)
    _results_equal("recipe decode card vs CPU", [best[u] for u in few],
                   [cpu_best[u] for u in few], COST_RTOL)
    # (v) the blank-skip guard on the card
    t0 = time.perf_counter()
    ok, info = run.check_blank_skip_parity(test)
    sync()
    stages["blank_skip_guard"] = time.perf_counter() - t0
    # (vii) score_sweep: the guard, one search and the host lattice work
    sweep_res = _recipe_sweep(run, test, refs, stats, hyps)
    stages["score_sweep"] = sweep_res["seconds"]["total"]
    # (viii) the trained model through a Kaldi <Nnet> file and back
    t0 = time.perf_counter()
    nnet_res = _recipe_nnet(run, test, work, dev)
    stages["nnet_roundtrip"] = time.perf_counter() - t0
    # (ix) nnet.proto text of every recipe's model and back
    proto_res = _recipe_protos(run)
    state["recipe_data"] = {"feats": feats, "labels": labels,
                            "split": split, "text": text,
                            "graph": run.graph, "words": run.lang.words}
    state["recipe_launches"] = {"train": train_launches,
                                "decode": decode_launches,
                                "lattices": sweep_res.pop("launches")}
    return {
        "utterances": {s: len(v) for s, v in split.items()},
        "audio_s": {s: sum(len(corpus["waves"][k]) for k in v) / 16000.0
                    for s, v in split.items()},
        "lexicon_words": len(corpus["lex"]), "units": len(corpus["units"]),
        "features": {"dim": 120, "cmvn_mean_max": mean,
                     "raw_card_vs_cpu_max_abs_err": raw_err,
                     "card_vs_cpu_max_abs_err": pipe_err},
        "train": {"epochs": len(hist), "steps": steps, "cv_steps": cv_steps,
                  "history": hist, "launches": train_launches,
                  "s_per_step_incl_cv": stages["train"] / calls,
                  "audio_s_per_s": train_audio_s / stages["train"]},
        "graph_states": run.graph.num_states,
        "decode": {"frames": frames, "calls": len(seen),
                   "searched_frames": [lp.shape[1] for _, lp, _, _ in seen],
                   "ms_per_frame": stages["decode"] * 1e3 / frames,
                   "merge_widths": list(widths),
                   "kernel2_predicted": predicted,
                   "launches": decode_launches, "overflow": overflow,
                   "wer": stats.wer, "report": stats.report(),
                   "words_per_utt": [len(hyps[u]) for u in sorted(hyps)]},
        "cpu_check": {"utterances": few, "same_words": True,
                      "cost_rtol": COST_RTOL},
        "blank_skip_guard": {"ok": ok, **info},
        "score_sweep": {**sweep_res,
                        "launches": state["recipe_launches"]["lattices"]},
        "nnet": nnet_res, "proto": proto_res,
        "stage_seconds": stages,
    }


def _recipe_sweep(run, test, refs, stats, hyps):
    """(vii) RecipeRun.score_sweep over the test set at the recipe's
    acwt_sweep, counters zeroed just before and read just after: the
    guard's two searches, one search for the lattices, and the lattice
    work on the host, timed apart.  The swept WER at the decode's acwt
    must be the decode's, and each utterance's lattice best path there
    the decode's words."""
    import torch

    acwt = run.cfg.decode.acoustic_scale
    keys = sorted(test)
    stage, search_s, seconds, frames, kept = ["other"], {}, {}, [], {}
    search, guard, lattices = (run._run_search, run.check_blank_skip_parity,
                               run.decode_lattices)

    def timed_search(*args, **kwargs):
        it = search(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            torch.cuda.synchronize()
            search_s[stage[0]] = (search_s.get(stage[0], 0.0)
                                  + time.perf_counter() - t0)
            if item is None:
                return
            frames.append(item[1].shape[1])
            yield item

    def staged(name, fn):
        def call(*args, **kwargs):
            stage[0] = name
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = time.perf_counter() - t0
                stage[0] = "other"
        return call

    def keep(feats, **kwargs):
        kept["blank_skip"] = kwargs["decode_cfg"].blank_skip
        kept["lats"] = lattices(feats, **kwargs)
        return kept["lats"]

    run._run_search = timed_search
    run.check_blank_skip_parity = staged("guard", guard)
    run.decode_lattices = staged("lattices", keep)
    run._guard_cache.clear()
    reset_counters()
    t0 = time.perf_counter()
    try:
        sweep = run.score_sweep(test, refs)
    finally:
        del run._run_search, run.check_blank_skip_parity, run.decode_lattices
    seconds["total"] = time.perf_counter() - t0
    launches = {k: v for k, v in counters().items()
                if k in ("lstm_fwd", "dedup_prune")}
    predicted = kernel2_launches(run.graph, run.cfg.decode.max_active, frames)
    want = {"lstm_fwd": 8 * len(frames), "dedup_prune": predicted}
    if launches != want:
        raise AssertionError(f"score_sweep launches {launches}, want {want}")
    if sorted(sweep) != sorted(run.cfg.acwt_sweep):
        raise AssertionError(f"swept acwts {sorted(sweep)}")
    if sweep[acwt].wer != stats.wer:
        raise AssertionError(f"swept WER at {acwt}: {sweep[acwt].wer}, "
                             f"decode {stats.wer}")
    words = run.lang.words
    differ = [u for u in keys if [words.sym(w) for w in kept["lats"][u]
                                  .scaled(acwt).best_path()[1]] != hyps[u]]
    if differ or kept["blank_skip"] != run.cfg.decode.blank_skip:
        raise AssertionError(f"lattice best paths differ on {differ}, "
                             f"blank_skip {kept['blank_skip']}")
    lattice_search = search_s.get("lattices", 0.0)
    return {
        "utterances": keys, "acwt": acwt,
        "wer": {str(a): sweep[a].wer for a in sorted(sweep)},
        "report": {str(a): sweep[a].report() for a in sorted(sweep)},
        "decode_wer": stats.wer, "best_paths_equal_decode": True,
        "lattice_blank_skip": kept["blank_skip"],
        "searched_frames": frames, "kernel2_predicted": predicted,
        "lattice_states": {u: kept["lats"][u].num_states for u in keys},
        "lattice_arcs": {u: kept["lats"][u].num_arcs for u in keys},
        "seconds": {"total": seconds["total"], "guard": seconds["guard"],
                    "guard_search": search_s.get("guard", 0.0),
                    "lattice_search": lattice_search,
                    "lattice_host": seconds["lattices"] - lattice_search},
        "launches": launches,
    }


def _recipe_nnet(run, test, work, dev):
    """(viii) write_eesen_nnet of the trained parameters, read back onto
    the card: equal bits in every tensor, and the read-back model's
    posteriors on one test chunk equal the trained model's bit for bit."""
    import torch
    from eesen_tpu_torch.models.serialize import (
        read_eesen_nnet, write_eesen_nnet,
    )
    from eesen_tpu_torch.recipes.run import _pad_chunk, posteriors
    from eesen_tpu_torch.training.optim import tree_leaves

    path = os.path.join(work, "final.nnet")
    t0 = time.perf_counter()
    write_eesen_nnet(path, run.params, run.model_cfg, parallel=True)
    t1 = time.perf_counter()
    back, cfg = read_eesen_nnet(path, device=dev)
    t2 = time.perf_counter()
    mcfg = run.model_cfg
    shape = ("input_dim", "cell_dim", "num_layers", "num_targets",
             "bidirectional")
    if any(getattr(cfg, f) != getattr(mcfg, f) for f in shape):
        raise AssertionError(f"read config {cfg} vs {mcfg}")
    pairs = list(zip(tree_leaves(run.params), tree_leaves(back)))
    if len(tree_leaves(run.params)) != len(pairs) or not all(
            b.device == a.device and b.dtype == torch.float32
            and torch.equal(a, b) for a, b in pairs):
        raise AssertionError("read-back parameters differ")
    chunk = sorted(test)[:8]
    arr, lens = _pad_chunk(test, chunk, 128, 8)
    lp = [posteriors(p, mcfg, arr, lens, run.log_priors, dev)
          for p in (run.params, back)]
    if not torch.equal(lp[0], lp[1]):
        raise AssertionError("read-back posteriors differ: max "
                             f"{float((lp[0] - lp[1]).abs().max())}")
    return {"bytes": os.path.getsize(path), "tensors": len(pairs),
            "write_s": t1 - t0, "read_s": t2 - t1,
            "posteriors_shape": list(lp[0].shape), "bit_equal": True}


def _recipe_protos(run):
    """(ix) emit_nnet_proto -> parse_nnet_proto for every RECIPES model
    (targets as this corpus's lang gives them) and the trained one: the
    proto's fields come back."""
    import dataclasses

    from eesen_tpu_torch.models.proto import emit_nnet_proto, parse_nnet_proto
    from eesen_tpu_torch.recipes.config import RECIPES

    fields = ("input_dim", "cell_dim", "num_layers", "num_targets",
              "param_range", "fgate_bias", "forward_dropout",
              "recurrent_dropout", "forward_step_dropout",
              "recurrent_step_dropout", "recurrent_dropout_mode", "twiddle",
              "bidirectional")
    cfgs = {name: dataclasses.replace(
        r.model, num_targets=run.model_cfg.num_targets)
        for name, r in sorted(RECIPES.items())}
    cfgs["trained"] = run.model_cfg
    lines = {}
    for name, cfg in cfgs.items():
        text = emit_nnet_proto(cfg)
        back = parse_nnet_proto(text)
        bad = [f for f in fields if getattr(back, f) != getattr(cfg, f)]
        if bad:
            raise AssertionError(f"proto {name}: {bad}")
        lines[name] = len(text.splitlines())
    return {"models": sorted(cfgs), "lines": lines}


# --------------------------------------------------------------------------
# phase cli: the command line (eesen_tpu_torch/tools/cli.py) in-process
# --------------------------------------------------------------------------

# (v) seeded label sequences for `align`: one label per CLI_FRAMES_PER_LABEL
# frames of each utterance
CLI_FRAMES_PER_LABEL = 6
# (vi) the recipe's batch (recipes/config.py wsj_phn) and newbob cut
CLI_TRAIN = ["--num-targets", "41", "--cell-dim", "320", "--num-layers", "4",
             "--num-sequence", "10", "--frame-limit", "25000",
             "--learn-rate", "4e-5", "--max-iters", str(RECIPE_MAX_ITERS),
             "--report-step", "1"]
# (iv) the 68,364-state check runs the dense decoder's plain torch ops on
# the CPU too: the two shortest utterances
CLI_DENSE_CPU_UTTS = 2


class CliRunner:
    """cli.main in this process, under `work`: the launch counters zeroed
    just before each command and read just after (synchronized); each
    command's seconds and launches kept under its label."""

    def __init__(self, work: str):
        self.work = work
        self.seconds, self.launches = {}, {}

    def path(self, name: str) -> str:
        return os.path.join(self.work, name)

    def __call__(self, label: str, *argv, device: str = "cuda") -> str:
        import contextlib
        import io

        import torch
        from eesen_tpu_torch.tools import cli

        buf = io.StringIO()
        reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--device", device, *map(str, argv)])
        torch.cuda.synchronize()
        self.seconds[label] = time.perf_counter() - t0
        self.launches[label] = {k: v for k, v in counters().items() if v}
        if rc != 0:
            raise AssertionError(f"{label}: exit code {rc}")
        return buf.getvalue()


class _Recorded:
    """module.name wrapped while in use: each call's arguments, results
    and seconds (synchronized) are kept."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls, self.results, self.seconds = [], [], []

    def __enter__(self):
        import torch

        orig = self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.calls.append(args)
            self.results.extend(res)
            return res

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _hyp_words(path: str):
    """{key: [word ids]} of a latgen / decode-faster text output."""
    with open(path) as f:
        return {p[0]: [int(w) for w in p[1:]]
                for p in (line.split() for line in f) if p}


def _write_wav16(path: str, samples) -> None:
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(np.round(samples), -32768, 32767).astype(
            "<i2").tobytes())


def phase_cli(dev, graphs, state):
    import shutil

    work = os.path.join(ROOT, "tmp", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        return _cli(dev, graphs, state, CliRunner(work))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _cli(dev, graphs, state, run):
    """The phase in run.work (removed by phase_cli)."""
    import pickle

    from eesen_tpu_torch.decoder import beam as tbeam
    from eesen_tpu_torch.decoder import dense as tdense
    from eesen_tpu_torch.io.kaldi_io import write_ark
    from eesen_tpu_torch.tools import cli

    out = {}
    lens = state["lens"]
    keys = [f"utt{j}" for j in range(B)]
    write_ark(run.path("feats.ark"), (
        (k, state["arr"][j, : lens[j]]) for j, k in enumerate(keys)))
    model = run.path("main.pt")
    cli.save_model_blob(model, {"params": state["params"],
                                "config": state["cfg"]})
    np.savetxt(run.path("counts"), state["counts"])
    out["posteriors"] = _cli_posteriors(dev, state, run, keys, model)

    # (ii) latgen on main's lp and the port's pickle of the packed TLG
    g, lang, lex = graphs["packed"]
    with open(run.path("tlg.pkl"), "wb") as f:
        pickle.dump(g, f)
    lp = state["lp"].float().cpu().numpy()
    write_ark(run.path("main_lp.ark"), (
        (k, lp[j, : lens[j]]) for j, k in enumerate(keys)))
    dec = ["--beam", "16", "--max-active", K, "--acoustic-scale", "0.9",
           "--batch-size", B]
    with _Recorded(tbeam, "traceback") as rec:
        run("latgen", "latgen", *dec, run.path("tlg.pkl"),
            f"ark:{run.path('main_lp.ark')}", run.path("main_hyp.txt"))
    _results_equal("latgen vs main", rec.results, state["hyps"], COST_RTOL)
    words = _hyp_words(run.path("main_hyp.txt"))
    if [words[k] for k in keys] != [w for w, _ in state["hyps"]]:
        raise AssertionError("latgen text differs from its best paths")
    if not run.launches["latgen"].get("dedup_prune"):
        raise AssertionError(f"latgen launches {run.launches['latgen']}")
    out["latgen"] = {"same_words_as_main": B, "cost_rtol": COST_RTOL,
                     "launches": run.launches["latgen"]}

    # (iii) blank-skip, streaming and lattices on converged posteriors
    ll = search_posteriors(lang, lex)
    write_ark(run.path("conv.ark"), (
        (k, ll[j, : lens[j]]) for j, k in enumerate(keys)))
    conv = f"ark:{run.path('conv.ark')}"
    with _Recorded(tbeam, "traceback") as beam_rec:
        run("latgen_converged", "latgen", *dec, run.path("tlg.pkl"), conv,
            run.path("conv_hyp.txt"))
    offline = _hyp_words(run.path("conv_hyp.txt"))
    modes = {"latgen_blank_skip": ["--blank-skip", SKIP_THRESHOLD],
             "latgen_streaming": ["--streaming", "--chunk-frames", CHUNK],
             "latgen_lattices": ["--lattice-ark", run.path("lat.ark")]}
    for label, extra in modes.items():
        run(label, "latgen", *dec, *extra, run.path("tlg.pkl"), conv,
            run.path(f"{label}.txt"))
        if _hyp_words(run.path(f"{label}.txt")) != offline:
            raise AssertionError(f"{label}: words differ from offline")
    run("lattice_best_path", "lattice-best-path", run.path("lat.ark"),
        "--out", run.path("bp.txt"), "--acoustic-scale", "0.9")
    if _hyp_words(run.path("bp.txt")) != offline:
        raise AssertionError("lattice-best-path words differ from latgen")
    frames = int(sum(lens))
    out["converged"] = {
        "frames": frames, "same_words": ["blank_skip", "streaming",
                                         "lattice_best_path"],
        "ms_per_frame": {k: run.seconds[k] * 1e3 / frames for k in (
            "latgen_converged", *modes)},
        "launches": {k: run.launches[k] for k in ("latgen_converged",
                                                  *modes)}}

    # (iv) decode-faster: exact Viterbi against the beam search
    out["decode_faster"] = _cli_dense(dev, graphs, run, keys, lens, conv,
                                      beam_rec, tdense)
    out["align"] = _cli_align(dev, state, run, keys, model)
    out["train"] = _cli_train(state, run)
    out["fbank"] = _cli_fbank(state, run)
    out["command_seconds"] = run.seconds
    out["launches"] = run.launches
    state["cli_launches"] = run.launches
    return out


def _cli_posteriors(dev, state, run, keys, model):
    """(i) net-output-extract of main's 8 utterances, one a call: 8
    lstm_fwd launches each, lp within LP_ATOL of main's batched lp; the
    B=1 forward's ms per utterance beside the B=8 forward's."""
    import torch
    from eesen_tpu_torch.io.kaldi_io import read_rspecifier
    from eesen_tpu_torch.models.priors import subtract_priors
    from eesen_tpu_torch.recipes.run import posteriors
    from eesen_tpu_torch.tools import cli

    lens = state["lens"]
    run("net_output_extract", "net-output-extract",
        f"--class-frame-counts={run.path('counts')}", model,
        f"ark:{run.path('feats.ark')}", f"ark:{run.path('post.ark')}")
    want = {"lstm_fwd": 8 * B}
    if run.launches["net_output_extract"] != want:
        raise AssertionError(
            f"net-output-extract launches {run.launches['net_output_extract']}"
            f", want {want}")
    post = dict(read_rspecifier(f"ark:{run.path('post.ark')}"))
    lp = state["lp"].float().cpu().numpy()
    err = max(float(np.abs(post[k] - lp[j, : lens[j]]).max())
              for j, k in enumerate(keys))
    if not err <= LP_ATOL:
        raise AssertionError(f"net-output-extract lp differs by {err}")
    params, cfg, pri = state["params"], state["cfg"], state["log_priors"]
    x = {k: torch.from_numpy(state["arr"][j, : lens[j]]).to(dev)
         for j, k in enumerate(keys)}
    b1 = [_wall_ms(lambda: subtract_priors(cli._log_posteriors(
        params, cfg, x[k], dev), pri), 3)[0] for k in keys]
    b8, _ = _wall_ms(lambda: posteriors(params, cfg, state["arr"], lens, pri,
                                        dev), 3)
    return {"max_abs_err_vs_main": err, "atol": LP_ATOL,
            "launches": run.launches["net_output_extract"],
            "b1_ms_per_utt": b1, "b1_ms_total": sum(b1),
            "b8_forward_ms": b8, "frames": [int(n) for n in lens]}


def _cli_dense(dev, graphs, run, keys, lens, conv, beam_rec, tdense):
    """(iv) decode-faster on the packed TLG: each cost no higher than the
    beam search's (exact Viterbi), how many of the 8 give its words, ms
    per frame; on the 68,364-state TLG the two shortest utterances on the
    card and on the CPU: equal words, costs within COST_RTOL.

    Both tracebacks fall back to the best partial path (no final weight)
    where no final state is reached at the last frame
    (decoder-wrappers.cc:60).  The converged posteriors are cut mid-word
    at each utterance's length, so the beam can hold no final state at
    its end while the exact search reaches one on a path the beam
    pruned, at a higher cost than the beam's partial path.  So a row
    whose beam reached a final state is held on the final costs, and a
    row whose beam did not on the best last-frame score without final
    weights (the dense one no higher than the beam's)."""
    import pickle

    from eesen_tpu_torch.io.kaldi_io import write_ark

    frames = int(sum(lens))
    with _Recorded(tdense, "decode_dense") as rec, _Recorded(
            tdense, "traceback_dense") as trec:
        run("decode_faster", "decode-faster", "--acoustic-scale", "0.9",
            "--batch-size", B, run.path("tlg.pkl"), conv,
            run.path("dense_hyp.txt"))
    beam = beam_rec.results
    (b_out, b_lens, fw), = beam_rec.calls
    b_out = b_out.numpy()
    (_, d_fin, _, _), = trec.calls
    d_fin = d_fin.cpu().numpy()
    beam_final = []
    for i, ((_, c_d), (_, c_b)) in enumerate(zip(rec.results, beam)):
        t = int(b_lens[i]) - 1
        st, sc = b_out.states[t, i], b_out.scores[t, i]
        final = bool(np.isfinite(np.where(
            st >= 0, sc + fw[np.maximum(st, 0)], np.inf)).any())
        beam_final.append(final)
        got = c_d if final else float(d_fin[i].min())
        if not got <= c_b + COST_RTOL * abs(c_b):
            raise AssertionError(
                f"decode-faster utt {i}: {'final' if final else 'partial'}"
                f" cost {got} above the beam search's {c_b}")
    same = sum(w_d == w_b for (w_d, _), (w_b, _) in zip(rec.results, beam))
    g, lang, lex = graphs["dense"]
    with open(run.path("tlg68k.pkl"), "wb") as f:
        pickle.dump(g, f)
    ll = search_posteriors(lang, lex)
    few = list(range(B - CLI_DENSE_CPU_UTTS, B))
    write_ark(run.path("conv68k.ark"), (
        (keys[j], ll[j, : lens[j]]) for j in few))
    res = {}
    for device in ("cuda", "cpu"):
        with _Recorded(tdense, "decode_dense") as r68:
            run(f"decode_faster_68k_{device}", "decode-faster",
                "--acoustic-scale", "0.9", run.path("tlg68k.pkl"),
                f"ark:{run.path('conv68k.ark')}",
                run.path(f"dense68k_{device}.txt"), device=device)
        res[device] = r68.results
    _results_equal("decode-faster 68k card vs CPU", res["cuda"], res["cpu"],
                   COST_RTOL)
    f68 = int(sum(lens[j] for j in few))
    return {
        "states": {tag: graphs[tag][0].num_states
                   for tag in ("packed", "dense")},
        "cost_le_beam": True, "same_words_as_beam": same,
        "beam_reached_final": beam_final,
        "costs": [c for _, c in rec.results],
        "beam_costs": [c for _, c in beam],
        "ms_per_frame": run.seconds["decode_faster"] * 1e3 / frames,
        "device_ms_per_frame": sum(rec.seconds) * 1e3 / frames,
        "beam_ms_per_frame": run.seconds["latgen_converged"] * 1e3 / frames,
        "launches": run.launches["decode_faster"],
        "68k": {"utterances": len(few), "frames": f68,
                "card_ms_per_frame":
                    run.seconds["decode_faster_68k_cuda"] * 1e3 / f68,
                "cpu_ms_per_frame":
                    run.seconds["decode_faster_68k_cpu"] * 1e3 / f68,
                "same_words": True, "cost_rtol": COST_RTOL}}


def _cli_align(dev, state, run, keys, model):
    """(v) align of main's 8 utterances with seeded label sequences: 8
    lstm_fwd a call; ctc_align of the same f32 lp on the card and on the
    CPU equal, and the command's segments those of the card."""
    import torch
    from eesen_tpu_torch.io.kaldi_io import write_ark
    from eesen_tpu_torch.ops.align import align_to_segments, ctc_align
    from eesen_tpu_torch.tools import cli

    lens, cfg = state["lens"], state["cfg"]
    rng = np.random.default_rng(SEED + 15)
    labels = {k: rng.integers(1, cfg.num_targets, int(lens[j]) //
                              CLI_FRAMES_PER_LABEL).astype(np.int32)
              for j, k in enumerate(keys)}
    write_ark(run.path("labels.ark"), labels.items())
    run("align", "align", model, f"ark:{run.path('feats.ark')}",
        f"ark:{run.path('labels.ark')}", run.path("ali.txt"))
    if run.launches["align"] != {"lstm_fwd": 8 * B}:
        raise AssertionError(f"align launches {run.launches['align']}")
    with open(run.path("ali.txt")) as f:
        lines = {p[0]: p[1:] for p in (line.split() for line in f) if p}
    segs = 0
    for j, k in enumerate(keys):
        x = torch.from_numpy(state["arr"][j, : lens[j]]).to(dev)
        lp = cli._log_posteriors(state["params"], cfg, x, dev)[None]
        args = ([int(lens[j])], labels[k][None], [len(labels[k])])
        card = ctc_align(lp, *args)[0]
        host = ctc_align(lp.cpu(), *args)[0]
        if not np.array_equal(card, host):
            raise AssertionError(f"align {k}: card and CPU differ")
        want = [f"{l}:{s}:{e}" for l, s, e in align_to_segments(card)]
        if lines[k] != want:
            raise AssertionError(f"align {k}: command segments differ")
        segs += len(want)
    return {"utterances": B, "labels": sum(len(v) for v in labels.values()),
            "segments": segs, "card_equals_cpu": True,
            "launches": run.launches["align"],
            "ms_per_utt": run.seconds["align"] * 1e3 / B}


def _cli_train(state, run):
    """(vi) train on phase recipe's 48 / 8 CMVN'd features and labels (the
    recipe's 4 x 320, 41 targets): 8/8/1/1 launches a step, finite
    objectives; model-info; net-copy to .nnet gives write_eesen_nnet's
    bytes; then net-output-extract -> latgen -> compute-wer on the 8 test
    utterances."""
    import logging
    import pickle

    from eesen_tpu_torch.io.kaldi_io import write_ark
    from eesen_tpu_torch.models.serialize import write_eesen_nnet
    from eesen_tpu_torch.recipes.config import RECIPES
    from eesen_tpu_torch.tools import cli
    from eesen_tpu_torch.training.batching import (
        BatchConfig, Utterance, make_batches,
    )

    rd = state["recipe_data"]
    split, feats, labels = rd["split"], rd["feats"], rd["labels"]
    for part in ("train", "cv", "test"):
        write_ark(run.path(f"{part}_f.ark"),
                  ((k, feats[k]) for k in split[part]))
        write_ark(run.path(f"{part}_l.ark"),
                  ((k, labels[k]) for k in split[part]))

    objs = []

    class Objectives(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "Obj(log[Pzx]) = " in msg:
                objs.append(float(msg.split("Obj(log[Pzx]) = ")[1].split()[0]))

    handler = Objectives()
    logging.getLogger("eesen_tpu.training.trainer").addHandler(handler)
    try:
        text = run("train", "train",
                   *(f"ark:{run.path(n)}" for n in (
                       "train_f.ark", "train_l.ark", "cv_f.ark",
                       "cv_l.ark")),
                   run.path("model.pt"), *CLI_TRAIN,
                   "--label-counts", run.path("train_counts"))
    finally:
        logging.getLogger("eesen_tpu.training.trainer").removeHandler(handler)
    epochs = int(text.split()[1])
    bcfg = BatchConfig(num_sequence=10, frame_limit=25000)
    if RECIPES["wsj_phn"].batch != bcfg:
        raise AssertionError("CLI_TRAIN is not the recipe's batch")

    def n_batches(part):
        return len(list(make_batches([
            Utterance(k, feats[k], labels[k]) for k in split[part]], bcfg)))

    steps, cv_steps = epochs * n_batches("train"), epochs * n_batches("cv")
    calls = steps + cv_steps
    want = {"lstm_fwd": 8 * calls, "lstm_bwd": 8 * steps,
            "ctc_alpha": calls, "ctc_beta": calls}
    if run.launches["train"] != want:
        raise AssertionError(f"train launches {run.launches['train']}, "
                             f"want {want}")
    if len(objs) != calls or not np.all(np.isfinite(objs)):
        raise AssertionError(f"train objectives {objs}")
    info = run("model_info", "model-info", run.path("model.pt"))
    if "num-targets 41" not in info or "cell-dim 320" not in info:
        raise AssertionError(f"model-info: {info}")
    run("net_copy", "net-copy", run.path("model.pt"), run.path("model.nnet"))
    params, cfg = cli.load_model(run.path("model.pt"))
    write_eesen_nnet(run.path("direct.nnet"), params, cfg)
    with open(run.path("model.nnet"), "rb") as a, open(
            run.path("direct.nnet"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("net-copy .nnet differs from "
                                 "write_eesen_nnet's")
    # the recipe's decode settings on its graph and words
    with open(run.path("recipe_tlg.pkl"), "wb") as f:
        pickle.dump(rd["graph"], f)
    rd["words"].write(run.path("words.txt"))
    run("net_output_extract_test", "net-output-extract",
        f"--class-frame-counts={run.path('train_counts')}",
        run.path("model.pt"), f"ark:{run.path('test_f.ark')}",
        f"ark:{run.path('test_post.ark')}")
    dcfg = RECIPES["wsj_phn"].decode
    run("latgen_test", "latgen", "--beam", dcfg.beam, "--max-active",
        dcfg.max_active, "--acoustic-scale", dcfg.acoustic_scale,
        "--blank-skip", dcfg.blank_skip, "--words", run.path("words.txt"),
        run.path("recipe_tlg.pkl"), f"ark:{run.path('test_post.ark')}",
        run.path("test_hyp.txt"))
    with open(run.path("ref.txt"), "w") as f:
        for k in split["test"]:
            f.write(f"{k} {' '.join(rd['text'][k])}\n")
    report = run("compute_wer", "compute-wer", run.path("ref.txt"),
                 run.path("test_hyp.txt"))
    wer = float(report.split("%WER")[1].split()[0])
    if not np.isfinite(wer):
        raise AssertionError(f"compute-wer: {report}")
    return {"epochs": epochs, "steps": steps, "cv_steps": cv_steps,
            "launches": run.launches["train"], "objectives": objs,
            "s_per_step_incl_cv": run.seconds["train"] / calls,
            "nnet_bytes_equal": True, "wer": wer, "report": report.strip(),
            "test_launches": {k: run.launches[k] for k in (
                "net_output_extract_test", "latgen_test")}}


def _cli_fbank(state, run):
    """(vii) compute-fbank-feats at the wsj_phn options on 8 of phase
    frontend's waves, on the card and with --device cpu: within FE_TOL
    where the mel power is above FE_MEL_FLOOR."""
    import torch
    from eesen_tpu_torch.io.kaldi_io import read_rspecifier

    waves = state["corpus"]["waves"]
    keys = sorted(waves)[:8]
    with open(run.path("wav.scp"), "w") as f:
        for k in keys:
            _write_wav16(run.path(f"{k}.wav"), waves[k])
            f.write(f"{k} {run.path(k + '.wav')}\n")
    got = {}
    for device in ("cuda", "cpu"):
        run(f"fbank_{device}", "compute-fbank-feats", "--num-mel-bins", "40",
            f"scp:{run.path('wav.scp')}",
            f"ark:{run.path(f'fbank_{device}.ark')}", device=device)
        got[device] = dict(read_rspecifier(
            f"ark:{run.path(f'fbank_{device}.ark')}"))
    err = 0.0
    for k in keys:
        want = got["cpu"][k]
        mask = want > np.log(FE_MEL_FLOOR)
        err = max(err, _close(f"compute-fbank-feats {k}", torch.from_numpy(
            got["cuda"][k][mask]), torch.from_numpy(want[mask]), FE_TOL,
            FE_TOL))
    audio_s = sum(len(waves[k]) for k in keys) / 16000.0
    return {"utterances": len(keys), "max_abs_err_vs_cpu": err,
            "tol": FE_TOL, "audio_s": audio_s,
            "card_audio_s_per_s": audio_s / run.seconds["fbank_cuda"],
            "cpu_audio_s_per_s": audio_s / run.seconds["fbank_cpu"]}


# phase examples: the stress recipe cut to 1,244 utterances and a 20,000-
# sentence LM, at the full 20,000-word lexicon
EXAMPLES_STRESS_ARGS = ["--utts", "1200", "--cv", "32", "--eval", "12",
                        "--lm-sents", "20000", "--epoch-repeat", "2"]
EXAMPLE_KERNELS = ("lstm_fwd", "lstm_bwd", "ctc_alpha", "ctc_beta",
                   "dedup_prune")
STRESS_DECODES = ("sweep", "direct", "direct_best", "full_decode",
                  "skip_decode", "lattices")


def phase_examples(dev, state):
    import shutil

    work = os.path.join(ROOT, "tmp", "chip_smoke_examples")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        return _examples(work, state)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _examples(work, state):
    """(i) examples/toy_recipe.main on the card (its default device):
    kernels 1, 3, 6, 7 in training and 1, 2 in the decode launched, a
    finite WER; (ii) examples/stress_recipe.main through
    tools/stress_timing.run at EXAMPLES_STRESS_ARGS (the bench graph
    cache under the work dir): its parity battery passes (the sweep at
    the decode acwt equals the direct re-decode, the blank-skip guard ran
    on its 6 utterances, const-arpa rescoring agrees with the G-fst
    automaton on all 10 sampled lattices), training launches 8 lstm_fwd
    per CTC launch and lstm_bwd in eights, each decode stage 8 lstm_fwd a
    chunk and kernel 2 wherever a merge fits it; per stage the seconds
    and launches."""
    from eesen_tpu_torch.examples import stress_recipe, toy_recipe
    from eesen_tpu_torch.tools import stress_timing

    reset_counters()
    t0 = time.perf_counter()
    toy = toy_recipe.main([os.path.join(work, "toy")])
    toy_s = time.perf_counter() - t0
    toy_launches = counters()
    missing = [k for k in EXAMPLE_KERNELS if not toy_launches[k]]
    if missing or not np.isfinite(toy["stats"].wer):
        raise AssertionError(f"toy recipe: launches {toy_launches}, "
                             f"{toy['stats'].report()}")

    cache = stress_recipe.BENCH_GRAPH_CACHE
    stress_recipe.BENCH_GRAPH_CACHE = os.path.join(work, "bench",
                                                   "tlg_stress.npz")
    try:
        reset_counters()
        res = stress_timing.run([os.path.join(work, "stress"),
                                 *EXAMPLES_STRESS_ARGS])
        stress_launches = counters()
    finally:
        stress_recipe.BENCH_GRAPH_CACHE = cache
    stages = res["stages"]
    guard = res["blank_skip_guard"]
    if not (res["sweep_equals_direct"] and guard["ok"] is not None
            and guard["checked"] == 6
            and res["const_arpa"]["rescore_parity"] == "10/10"):
        raise AssertionError(
            f"stress parity battery: sweep == direct "
            f"{res['sweep_equals_direct']}, guard {guard}, const-arpa "
            f"{res['const_arpa']['rescore_parity']}")
    tr = stages["train"]["launches"]
    if not (tr.get("ctc_alpha") and tr["ctc_alpha"] == tr.get("ctc_beta")
            and tr.get("lstm_fwd") == 8 * tr["ctc_alpha"]
            and tr.get("lstm_bwd", 0) % 8 == 0 and tr.get("lstm_bwd")):
        raise AssertionError(f"stress train launches {tr}")
    fits = all(m["kernel"] for m in res["graph"]["merges"].values())
    for name in STRESS_DECODES:
        n = stages[name]["launches"]
        if not n.get("lstm_fwd") or n["lstm_fwd"] % 8 or (
                fits and not n.get("dedup_prune")):
            raise AssertionError(f"stress {name} launches {n}")
    missing = [k for k in EXAMPLE_KERNELS if not stress_launches[k]]
    if missing:
        raise AssertionError(f"stress recipe launched none of {missing}")
    state["examples_launches"] = {
        k: {"toy": toy_launches[k], "stress": stress_launches[k]}
        for k in toy_launches}
    return {"toy": {"seconds": toy_s, "wer": toy["stats"].wer,
                    "epochs": len(toy["history"]),
                    "final_cv_acc": toy["history"][max(toy["history"])][
                        "cv_acc"],
                    "launches": toy_launches},
            "stress": {"args": EXAMPLES_STRESS_ARGS,
                       "stages": {k: {f: v[f] for f in (
                           "seconds", "launches", "peak_gb", "ms_per_frame")
                           if f in v} for k, v in stages.items()},
                       "graph": res["graph"],
                       "live_arcs_peak": res["live_arcs_peak"],
                       "final_cv_acc": res["final_cv_acc"],
                       "sweep": res["sweep"], "guard": guard,
                       "direct_wer": res["direct_wer"],
                       "full_wer": res["full_wer"],
                       "blank_skip_wer": res["blank_skip_wer"],
                       "blank_skip_diff_utts": res["blank_skip_diff_utts"],
                       "const_arpa": res["const_arpa"],
                       "launches": stress_launches}}


def kernels_report(state, timing):
    def mesh_launches(name):
        """A kernel's launches on the mesh path (phase mesh): training in
        a world of one (3 steps) and on each rank of each spawned grid
        (ii)-(iv); the sharded decodes likewise, by axis."""
        out = {}
        if name != "dedup_prune":
            out["mesh_train_launches"] = state["mesh_launches"][name]
            out["mesh_rank_train_launches"] = {
                grid: [r[name] for r in ranks]
                for grid, ranks in state["mesh_rank_launches"].items()}
        if name in ("lstm_fwd", "dedup_prune"):
            out["mesh_decode_launches"] = state["mesh_decode_launches"][name]
            out["mesh_rank_decode_launches"] = {
                grid: [{axis: n[name] for axis, n in r.items()}
                       for r in ranks]
                for grid, ranks in state["mesh_rank_decode_launches"].items()
                if any(ranks)}
        return out

    def cli_launches(name):
        """A kernel's launches in phase cli, by command (nonzero only)."""
        return {"cli_launches": {
            label: n[name] for label, n in state["cli_launches"].items()
            if n.get(name)}}

    def examples_launches(name):
        """A kernel's launches in phase examples: the toy recipe, the
        cut-scale stress recipe."""
        return {"examples_launches": state["examples_launches"][name]}

    lt = timing["lstm_fwd"]["D640"]
    ltt = timing["lstm_fwd_train"]["D640"]
    dt = timing["dedup_prune"]["m14336"]
    k5000 = {m: timing["dedup_prune"][f"m{m}_k{OPT_K}"]
             for m in (OPT_SMALL_BUDGET, OPT_K + OPT_SMALL_BUDGET)}
    bt = timing["lstm_bwd"]["D640"]
    tl = state["train_launches"]
    rl = state["recipe_launches"]
    train_path = f"train ({TRAIN_STEPS} steps)"
    h640 = {k: timing[f"{k}_h640"] for k in ("lstm_fwd", "lstm_bwd")}
    scan = {k: timing[f"lstm_scan_{k}"] for k in ("fwd", "bwd")}
    v1_path = f"v1 route: one H={V1_H} direction, forward + backward"
    err = state["v1_err"]
    scan_rows = [
        {"name": f"lstm_scan_{k}", "route": "cuda",
         "source": src,
         "wide_source": f"eesen_tpu_torch/csrc/lstm_scan_{k}.cu",
         "replaces": f"eesen_tpu/ops/lstm_pallas.py:{line}",
         "launches": state["v1_launches"][f"lstm_scan_{k}"],
         "recipe_train_launches": rl["train"][f"lstm_scan_{k}"],
         **cli_launches(f"lstm_scan_{k}"),
         **examples_launches(f"lstm_scan_{k}"),
         "path": v1_path, "max_abs_err": err[LIBRI_H][k],
         **{f: scan[k]["H640"][f]
            for f in ("ms", "us_per_step", "thread_per_unit_ms", "plain_ms",
                      "bound_ms", "bound_by", "design", "plan", "shape")},
         "library_ms": None,
         "h1152": {**scan[k][f"H{V1_H}"], "max_abs_err": err[V1_H][k]}}
        for k, line, src in (
            ("fwd", 50, "eesen_tpu_torch/csrc/lstm_fwd.cu"),
            ("bwd", 94, "eesen_tpu_torch/csrc/lstm_bwd.cu"))
    ]
    ctc = [
        {"name": f"ctc_{w}", "route": "cuda",
         "source": "eesen_tpu_torch/csrc/ctc_alpha_beta.cu",
         "replaces": f"eesen_tpu/ops/ctc_pallas.py:{line}",
         "launches": tl[f"ctc_{w}"], "path": train_path,
         **mesh_launches(f"ctc_{w}"),
         "libri_train_launches": state["libri_train_launches"][f"ctc_{w}"],
         "recipe_train_launches": rl["train"][f"ctc_{w}"],
         **cli_launches(f"ctc_{w}"),
         **examples_launches(f"ctc_{w}"),
         "max_abs_err": state["ctc"]["max_abs_err"][w],
         **{k: timing[f"ctc_{w}"]["S201"][k]
            for k in ("ms", "us_per_step", "ms_back_to_back", "plan",
                      "plain_ms", "bound_ms", "bound_by", "library_ms",
                      "library_call", "shape")},
         "S401": timing[f"ctc_{w}"]["S401"],
         "S1201": timing[f"ctc_{w}"]["S1201"]}
        for w, line in (("alpha", 62), ("beta", 88))
    ]
    return {"kernels": [
        {"name": "lstm_fwd", "route": "cuda",
         "source": "eesen_tpu_torch/csrc/lstm_fwd.cu",
         "replaces": "eesen_tpu/ops/lstm_pallas.py:323",
         "launches": state["launches"]["lstm_fwd"], "path": "serve",
         "train_launches": tl["lstm_fwd"], **mesh_launches("lstm_fwd"),
         "max_abs_err": max(state["lstm"]["max_abs_err"].values()),
         "ms": lt["ms"], "plain_ms": lt["plain_ms"],
         "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
         "library_ms": None, "ms_per_step": lt["ms_per_step"],
         "shape": "B=8 T=512 D=640 H=320 bf16, state_bf16",
         "train_shape_max_abs_err": max(
             state["lstm_bwd"]["fwd_max_abs_err"].values()),
         "train_shape_ms": ltt["ms"], "train_shape_plain_ms": ltt["plain_ms"],
         "train_shape_ms_per_step": ltt["ms_per_step"],
         "train_shape_bound_ms": ltt["bound_ms"],
         "train_shape_projection_ms": ltt["projection_ms"],
         "train_shape_recurrence_ms": ltt["recurrence_ms"],
         "train_shape_projection": ltt["projection"],
         "skip_run_search_launches":
             state["skip_launches"]["run_search"]["lstm_fwd"],
         "stream_offline_launches":
             state["stream_launches"]["offline"]["lstm_fwd"],
         "libri_serve_launches": state["libri_serve_launches"]["lstm_fwd"],
         "libri_train_launches": state["libri_train_launches"]["lstm_fwd"],
         "recipe_train_launches": rl["train"]["lstm_fwd"],
         "recipe_decode_launches": rl["decode"]["lstm_fwd"],
         "recipe_lattice_launches": rl["lattices"]["lstm_fwd"],
         **cli_launches("lstm_fwd"),
         **examples_launches("lstm_fwd"),
         "h640": h640["lstm_fwd"]},
        {"name": "lstm_bwd", "route": "cuda",
         "source": "eesen_tpu_torch/csrc/lstm_bwd.cu",
         "replaces": "eesen_tpu/ops/lstm_pallas.py:379",
         "launches": tl["lstm_bwd"], "path": train_path,
         **mesh_launches("lstm_bwd"),
         "max_abs_err": max(state["lstm_bwd"]["max_abs_err"].values()),
         "ms": bt["ms"], "plain_ms": bt["plain_ms"],
         "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"],
         "library_ms": None,
         "shape": "B=128 T=768 D=640 H=320 bf16, state_bf16",
         "rec_ms": bt["rec_ms"], "rec_us_per_step": bt["rec_us_per_step"],
         "products_ms": bt["products_ms"], "clusters": bt["clusters"],
         "products": bt["products"],
         "libri_train_launches": state["libri_train_launches"]["lstm_bwd"],
         "recipe_train_launches": rl["train"]["lstm_bwd"],
         **cli_launches("lstm_bwd"),
         **examples_launches("lstm_bwd"),
         "h640": h640["lstm_bwd"]},
        *scan_rows,
        *ctc,
        {"name": "dedup_prune", "route": "cuda",
         "source": "eesen_tpu_torch/csrc/dedup_prune.cu",
         "replaces": "eesen_tpu/ops/beam_pallas.py:110",
         "launches": state["launches"]["dedup_prune"],
         **mesh_launches("dedup_prune"),
         "skip_launches": state["skip_launches"]["dedup_prune"],
         "skip_run_search_launches":
             state["skip_launches"]["run_search"]["dedup_prune"],
         "stream_launches": state["stream_launches"]["dedup_prune"],
         "pipeline_launches":
             state["stream_launches"]["pipeline"]["dedup_prune"],
         "recipe_decode_launches": rl["decode"]["dedup_prune"],
         "recipe_lattice_launches": rl["lattices"]["dedup_prune"],
         **cli_launches("dedup_prune"),
         **examples_launches("dedup_prune"),
         "options_launches": state["options_launches"],
         "max_abs_err": max(state["dedup"]["max_abs_err"].values()),
         "ms": dt["ms"], "device_ms": dt["device_ms"],
         "plain_ms": dt["plain_ms"],
         "bound_ms": dt["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "shape": "B=8 M=14336 (16384 lanes) K=512",
         **{f"k{OPT_K}_{f}": {f"m{m}": t[f] for m, t in k5000.items()}
            for f in ("ms", "device_ms", "plain_ms", "bound_ms")}},
    ]}


def card_label() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def run(dev) -> bool:
    """All phases on `dev`; True when every one passed."""
    from eesen_tpu_torch.ops import build

    state, graphs = {}, {}
    card = card_label() if dev.type == "cuda" else "cpu (no card)"
    ok = True

    def phase(name, fn, *args):
        nonlocal ok
        t0 = time.perf_counter()
        try:
            res = fn(*args)
        except Exception as e:  # report every phase; fail at the end
            tb.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e)})
            ok = False
            return None
        emit({"phase": name, "ok": True,
              "seconds": time.perf_counter() - t0, "card": card, **res})
        return res

    if dev.type == "cuda":
        if phase("build", lambda: {"library": os.path.relpath(
                build.build(verbose=True))}) is None:
            return False
    state["lstm"] = phase("lstm", phase_lstm, dev)
    state["dedup"] = phase("dedup", phase_dedup, dev)
    if phase("graph", phase_graph, graphs, state) is None:
        return False
    if phase("main", phase_main, dev, graphs, state) is None:
        return False
    phase("search", phase_search, dev, graphs)
    phase("skip", phase_skip, dev, graphs, state)
    phase("stream", phase_stream, dev, graphs, state)
    phase("options", phase_options, dev, graphs, state)
    if dev.type == "cuda":
        phase("frontend", phase_frontend, dev, state)
        phase("recipe", phase_recipe, dev, state)
        phase("cli", phase_cli, dev, graphs, state)
        phase("examples", phase_examples, dev, state)
        state["lstm_bwd"] = phase("lstm_bwd", phase_lstm_bwd, dev)
        state["ctc"] = phase("ctc", phase_ctc, dev)
        phase("train", phase_train, dev, state)
        phase("mesh", phase_mesh, dev, graphs, state)
        phase("lstm_v1", phase_lstm_v1, dev, state)
        phase("libri", phase_libri, dev, state)
        timing = phase("timing", phase_timing, dev)
        phase("profile", phase_profile, dev, graphs, state)
        if ok and timing is not None:
            emit(kernels_report(state, timing))
    return ok


def main() -> int:
    if sys.argv[1:2] == ["--mesh-rank"]:          # spawned by phase mesh
        return mesh_rank(int(sys.argv[2]), *sys.argv[3:8])
    try:
        import torch
        import eesen_tpu_torch  # noqa: F401  (also turns TF32 off)
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if not run(dev):
        return 1
    print(card_label(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
