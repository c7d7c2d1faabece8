#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each prints one line or a few and ``phase N took X s``; any
failed check exits non-zero). The whole run, the build included, is cut
to fit ``RUN_BUDGET_S`` (750 s): earlier paths are cut in depth, steps or
batch, never in width, and every gate stays; the last line before the
results gives the run's seconds.

1. the device, and ``nvidia-smi``'s name and power limit;
2. builds the hand-written kernels of ``src/repro_torch/csrc/`` (one
   ``nvcc`` per source, all at once) and prints each instance's ptxas
   registers and spills, and each library's count of tensor-core
   instructions in its SASS (the float-digit kernel must hold DMMA;
   ``cuobjdump -sass`` runs beside phases 3-9 and is read after phase 9);
   the build starts before torch is imported, phase 19's dry runs after
   phase 1 in a process of their own, and the work that runs no kernel
   goes on the card beside it: phase 16(d) and the one-device references
   of phases 17(e) and 18;
3. holds the CIM matmul/conv kernel (int8 tensor cores on integer planes)
   against its plain PyTorch version on random inputs (dense, occupancy
   skip with dead columns and dead blocks, nibble planes, psum_bits
   1/4/8, psum_quant off, int8 and uint8 activations, ragged M and N,
   conv 3x3/1x1 at stride 1/2, SAME/VALID); then at decode's row counts
   (M 1, 8, 16, 33: one-warp row blocks, narrow column tiles, the split
   tile loop) with N from 1 to 11264, rows 126 and 128, psum_bits
   1/4/6/8 and psum_quant off, sparse against dense bit for bit; then
   K3 as an implicit GEMM (``IMPLICIT_ADC_CONV_CASES``: psum_bits 1/4/6,
   psum_quant off, int8 and uint8 codes, stride 1/2, 1x1 and 3x3, ragged
   M, batch 1, and the zoo's front ends: 1x3 on H = 1 at C_in 80 and 768,
   14x14 stride 14 on 3 channels with 196-row tiles), each case on int8
   and int4 planes with and without the occupancy map, all four equal;
   3b. the same case grid through the ADC-free matmul/conv kernels, and
   float32 digit planes carrying cell variation (sigma 0.3) through both
   kernel families; then the tensor-core ADC-free matmul and the
   implicit-GEMM conv on the shapes their loaders find hard (C_in 3 to 64
   at 14 channels per array, odd and even sizes at stride 2 under SAME
   and VALID, 1x1 projections, blocks across images, ragged M, rows not
   a multiple of 32, N from 1 to 200); then the float-plane implicit
   convs (FP64 tensor cores), ADC and ADC-free, on K3's grid at sigma
   0.1, 0.2, 0.3 and 0.4, sparse against dense;
4. the main path: ResNet-20 at full width (16, 32, 64; 32x32; 10
   classes) with the paper's CIFAR-10 settings, initialised from a seed,
   calibrated on one batch, packed at int8 and int4, answering batches of
   256 images in deploy mode. Deploy logits are held against emulate
   logits, the launch counters against 20 K3 launches per forward, no
   matmul launch and no patch gather in torch, and the kernel is timed
   at the main path's shapes beside its plain version and its bound
   (and K1 on the convs' materialized patches, a shape no path gives it
   now);
5. ResNet-18 (widths 64..512, 32x32) one deploy forward per pack dtype
   against emulate at batch 64, with the same counters, and the convs
   that K3 runs on its staged path (a 128-row input window over 32 KB);
6. the ``adc_free`` backend on the same packed ResNet-20, int8 and int4:
   logits against emulate with ``psum_quant=False``, the implicit-GEMM
   ADC-free conv's counter against 20 per forward, the ADC-free matmul's,
   the ADC kernel's and the plain-torch patch gathers' at 0, and
   per-layer times beside the plain version, the bound and one PyTorch
   call of the same function (``library_ms``: on clean integer planes
   the ADC-free conv is one float32 ``F.conv2d`` with the split-folded
   weight, the matmul one ``torch.matmul``; timed as a yardstick only);
   the ADC-free matmul is timed too, on the convs' materialized patches
   (its own entry, ``cim_matmul_adc_free_resnet``, with 0 launches: no
   path gives it these shapes now);
7. the ``binary`` backend: ResNet-20 packed with ``mode="binary"``, its
   kernel forward against its plain version, counters at 20 per forward;
8. cell variation: one deploy forward with a ``Sampler`` at sigma 0.3
   against emulate under the same fields, with the float-digit counters
   (20 float-plane K3 launches, no patch gather);
   the Monte-Carlo sweep over sigma in {0, .1, .2, .3, .4} x 4 samples on
   deploy and one sigma = 0.2 point on adc_free and on binary; the
   per-layer attribution at sigma 0.3; the float-digit conv timed at the
   path's shapes;
9. the CIM experts kernel (every expert of an MoE bank in one launch)
   against its plain version: E in {1, 8, 64}, an expert whose capacity
   buffer is all zero rows, ragged C and N, nibble banks, occupancy maps,
   psum_bits 1/4/6/8, psum_quant off, int8 and uint8 codes; and against
   a per-expert loop of the CIM matmul kernel; then with ``counts`` (each
   expert's filled capacity slots: an expert with none, one full, ragged
   and decode-like counts, the sign ADC), against the plain version with
   counts and a per-expert loop on codes zeroed past them;
10. the MoE serving path: moonshot-v1-16b-a3b at its published widths
   (d_model 2048, 16 heads of 128, 64 experts top-6 of d_ff 1408, 2
   shared, vocab 163840), depth cut from 48 to 2 layers (1 dense + 1
   MoE), random weights from seed 0, packed with the serving launcher's
   CIM config (4-bit weights on 2-bit cells, 8-bit activations, 6-bit
   partial sums, 128x128 arrays, column-wise scales) at int8 and int4,
   served in bfloat16: one prefill forward (batch 8 x 64 tokens) on
   deploy against emulate, ``generate_batch`` of 16 new tokens and the
   slot engine on 3 requests at batch 2, deploy tokens against emulate
   tokens; the launch counters (6 experts-kernel and 21 matmul-kernel
   launches per forward at 3 layers; 3 and 14 at 2), every experts
   launch given the counts its MoE
   block computed on the device; the same packs on the ``adc_free`` backend,
   one prefill forward each against emulate with ``psum_quant=False``,
   the ADC-free matmul on every CIM linear (K4's path: 21 + 6 x 64
   launches per forward), then timed at the operands of one prefill
   forward and one decode step against its plain version, its bound and
   one float32 ``torch.matmul`` with the split-folded weight, with the
   planes relaid on every call and relaid once; prefill and
   decode times; one decode step captured in a CUDA graph and replayed
   (the counts need no host sync): its tokens against the eager decode
   loop's, and its time per step; a decode step captured in a cache with
   room for 2 positions and replayed 5 times, past ``max_len``: no device
   error, and its caches and tokens equal the same steps run eagerly
   through the layer path (the reference's clamped write); both ADC
   kernels timed at the operands
   of one prefill forward and one decode step, the experts kernel with
   the counts of those calls;
11. the training path, train -> checkpoint -> pack -> save -> load ->
   serve: one-stage column-wise QAT of ResNet-20 at full width with the
   paper's CIFAR-10 settings (``repro_torch.train.qat.train_qat``: LSQ
   and straight-through gradients on the emulate backend) on
   ``make_image_dataset(n=4096, hw=32, seed=0)``, the first quarter held
   out, 60 steps at batch 128, lr 0.05 cosine; a ``CheckpointManager``
   save at step 30 whose restored params, BN state and momentum equal
   the saved ones bit for bit; the trained model packed int8 and int4,
   each ``DeployArtifact`` saved and loaded back (leaves equal in dtype
   and bits), and the loaded artifacts deployed at batch 256: 20 K3, 0
   K1 and 0 plain patch gathers per forward, logits against emulate of
   the trained params. Gates: the mean loss of the last 20 steps at most
   0.7 x that of the first 20, held-out accuracy at least 0.20 (chance
   0.10). Prints ms per QAT step (CUDA events, median over steps
   10-60) and the save and load seconds. The QAT run takes cuDNN's
   deterministic algorithms, so every run gives the same losses;
12. drift, recalibration, the health monitor and the telemetry plane,
   on phase 10's packs (``tests/test_drift.py``'s schedule, a
   ``Sampler`` source): (a) a zero schedule serves phase 10's tokens; (b)
   from t = 300, one prefill and 16 decode steps, each step's drifted
   deploy logits against drifted emulate's under the same fields, the
   drifting engine's tokens on int8, int4 and a second run equal to that
   step-by-step run's, 21 float-plane K1 launches, 6 K6 and no integer
   K1 per forward (the MoE banks do not drift, as in the reference), the
   drifted decode step timed (CUDA events, the host clock, the share in
   ``drift_tree``), and the float-plane K1 held against its plain
   version and timed at the operands of one drifted prefill and one
   drifted decode step; (f) the engine's ``metrics()``: JSON, the token
   counter, the decode histogram's count, Prometheus names only of
   ``obs.names``; (c) column-only drift at t = 400 recalibrated with 64
   probes: each drifting linear's output error at one prefill's
   activations under 0.34 x the drifted one, on scales calibrated on
   those activations (the same delta on the random init's uncalibrated
   scales printed beside it); (d) hard drift with the monitor's
   thresholds at 0: the fallback's steps launch no CIM kernel and give a
   ``ref``-backend engine's tokens, and ``recalibrate()`` clears it; (e)
   the ADC collector armed on a clean prefill: logits bit-equal, 0 K6 and
   405 K1 launches (per expert), deploy's counts equal emulate's exact
   counters, ``every_n`` 4 folds a quarter of the calls; (g) the
   ResNet-20 drift sweep (cell and column drift, t 0-512, 4 samples,
   batch 256, int8): the logit error does not fall with t, 20 float-plane
   K3 launches per drifted forward;
13. the dense and MLA transformers of the zoo at their published widths,
   on phase 10's traffic and CIM config, random weights from seed 0,
   int8 and int4 packs (``ZOO_CASES``): deepseek-v3-671b's leading
   dense layer (MLA: q_lora 1536, kv_lora 512, 128 heads; d_ff 18432;
   ``moe=None``), llama3-8b cut to 2 layers with the bf16 and the int8 KV
   cache, and qwen3-0.6b cut to 2 of its 28 layers (qk-norm, tied
   embeddings).
   Each: deploy prefill logits against emulate, the engine's and the slot
   engine's tokens against emulate's per KV cache, 8, 14 and 14 K1
   launches per forward and no other kernel, prefill and decode times
   (eager, and a decode step replayed from a CUDA graph against the eager
   loop's tokens), every K1 call of one prefill forward and one decode
   step after the prompt held against its plain version and timed beside
   its bound, the int8 cache's bytes and its tokens' agreement with the
   bf16 cache's (not a gate), pack seconds and peak memory;
14. the recurrent and multimodal zoo at published widths
   (``RECURRENT_ZOO``), on phase 13's traffic and CIM config, random
   weights from seed 0: zamba2-2.7b cut to 12 Mamba2 layers (the shared
   attention block applied twice, its two cache slots), xlstm-1.3b
   cut to 8 blocks (7 mLSTM, 1 sLSTM: one period), whisper-small cut to 1
   encoder and 1 decoder layer of 12 with its conv
   stem on raw log-mel frames (8 x 3000 x 80: both stem convs on K3, the
   encoder at M 12,000) and llava-next-mistral-7b cut to 1 layer with
   its 14x14 patch-embed conv
   on 336 x 336 images (K3 on 196-row tiles, 576 image tokens before the
   text); int8 packs, and int4 on whisper. Each: the deploy forward with
   its front-end input against emulate, served tokens against emulate's
   (``generate_batch``, or whisper's lockstep run with the encoder states
   in the cache, and the slot engine), the K1 and K3 counters against the
   spec tree's CIM nodes (zamba2 38 K1, xlstm 38, whisper 2 K3 and 16 K1
   a forward and 10 K1 a decode step, llava 1 K3 and 7 K1) with no
   other kernel and no patch gather in torch, a decode step replayed from
   a CUDA graph with logits, tokens and caches bit-equal to the eager
   steps, every K1 and K3 call of one forward and one decode step against
   its plain version, summed and timed beside its bound, peak memory and
   the phase's seconds;
15. the recurrent and multimodal zoo on a drifting chip (``DRIFT_ZOO``):
   phase 14's four configurations at their cuts and published widths
   (zamba2 at 12 layers, xlstm at 8 blocks, whisper at 1 + 1 layers on 8
   x 3000 x 80 log-mel frames, llava at 1 layer, its forward with images
   at batch 2), int8 packs, phase 12's schedule (``DRIFT_SCHED``, a
   ``Sampler(DRIFT_SEED)`` source) from t = 300. Each: the forward with
   the front-end input and one prefill + 15 decode steps drifted, deploy
   against emulate under the same fields (the conv front ends too); the
   drifting engine's ``generate_batch`` (whisper's encoder states in its
   cache) against that step-by-step run, the health monitor armed;
   whisper's drifting slot engine against its schedule replayed on
   drifted emulate, and ``generate_batch`` without encoder states
   refused; the counted run (the forward and the engine) all on float
   planes: zamba2 38 K1, xlstm 38, whisper 2 K3 + 16 K1 a forward and
   10 K1 an invocation, llava 1 K3 + 7 K1, no integer K1/K3 and no
   patch gather in torch; the drifted decode step eager (with its
   ``drift_tree``) and one realization's step replayed from a CUDA graph
   (bit-equal to eager); every float K1 and K3 call of one drifted
   forward and one drifted decode step against its plain version, timed
   by graph replay beside its FP64 bound (whisper's 126-row stems,
   llava's 196-row patch embed: the launch checks the tile sums exact
   first). Then whisper packed with baked cell variation (``model_artifact``
   with a ``Sampler`` at sigma 0.3): deploy against emulate under the
   same sources; and the serving launcher, ``repro_torch.launch.serve``'s
   ``main`` on zamba2 at its cut with ``--cim deploy``, the drift flags,
   ``--health`` and ``--metrics-out``: exit 0, its tok/s, a metrics JSON
   naming only ``obs.names`` metrics; the phase's seconds and peak memory;
16. the LM training path (``phase16_lm_training``: (a)-(c) and (e) after
   phase 15, nothing beside them; (d) beside phase 2's build): (a)
   qwen3-0.6b uncut (28 layers, d 1024, GQA kv 8, qk-norm, tied embeddings of
   151,936) trained by the port's launcher,
   ``repro_torch.launch.train.main``, under its CIM config (``--cim
   emulate``: 4-bit weights on 2-bit cells, 6-bit partial sums, 128x128
   arrays, column-wise LSQ and straight-through gradients) at batch 8 x
   256, AdamW, lr 3e-4, 20 steps, checkpoints at steps 18 and 20, on
   deterministic
   algorithms (``_Deterministic``: the scatter-add backwards summed in a
   fixed order); gates: exit 0, every loss and grad norm finite, the
   mean loss of the last 10 steps at most 0.7 x that of the first 5;
   prints ms per step (CUDA events, median over steps 6-20), tokens/s
   and peak memory; its step ``PROBE_STEP`` (3) runs under
   ``FlopCounterMode`` for phase 19(a); (b) the same command with
   ``--crash-at 19 --ckpt-every 19`` in a directory holding (a)'s
   step-18 checkpoint resumes there, writes its step-19 checkpoint (async,
   waited for) and raises ``InjectedFailure``; the relaunch resumes from
   that step 19 and ends at 20 with (a)'s params (rtol 1e-5, atol 1e-6;
   bit-equal expected); (c) the
   trained params packed int8 and served (8 stream prompts of 64 tokens,
   16 new, ``generate_batch``): deploy prefill logits against emulate at
   1e-4 of their largest magnitude, tokens identical, 196 K1 launches per
   forward and no other kernel; the share of the served tokens that
   follow the stream's transition table is printed; (e)
   ``compressed_psum_tree`` on the trained model's gradient (the
   embedding and the first 4 of its 28 layers) in a one-rank NCCL group
   equal to the same function on the CPU bit for bit; (d)
   moonshot-v1-16b-a3b at published width cut to 2 layers (one dense,
   one MoE of 64 experts top-6 + 2 shared), emulate, 2 AdamW steps at
   batch 8 x 128: losses and grad norms finite, and on
   the last batch and on a 4-token probe every expert the router gave
   tokens has nonzero gradients on its weights and column scales and
   every other expert zero ones; the phase's seconds;
17. column-parallel serving over a ``("model",)`` mesh of 4 ranks
   (``phase17_column_parallel``): ``torch.multiprocessing`` spawns them on
   a free port after the parent has freed its CUDA memory; each joins a
   gloo group on the one card (``launch.mesh.init_rank``, ``make_mesh``),
   loads the libraries phase 2 built, and the join has a time limit (a
   rank that raises or hangs fails the phase). Each rank runs the kernels
   on its own columns and all-gathers the outputs through gloo. (a)
   phase 11's ResNet-20 artifacts (int8, int4) loaded with
   ``DeployArtifact.load(path, mesh=)`` at batch 256: deploy int8 and
   int4, adc_free, cell variation at sigma 0.3 (the field drawn over the
   full planes before the shard) and one drifted realization at t = 256
   on phase 12(g)'s schedule, each bit-equal on every rank to the
   parent's single-device logits, with 20 K3 (K5 for adc_free; on float
   planes for the last two) launches per rank per forward, each on C_out
   / 4 columns, no K1 and no patch gather in torch; (b) phase 13's int8
   llama3-8b pack at phase 13's 2 layers (published widths, bf16 KV
   cache, 8 prompts of 64 tokens, 16 new), saved by phase 13 and served
   by each rank through ``engine_from_artifact(path, cfg, mesh=)``:
   prefill logits bit-equal to the single device's, ``generate_batch``
   tokens equal to phase 13's on every rank, 14 K1 launches per rank per
   forward (every
   linear sharded) and no other kernel, the ADC collector's totals over
   one armed prefill summed over the mesh equal to the single device's;
   rank 0 prints the eager decode step (CUDA events), the share of it in
   the all-gathers (host clock), its K1 calls of a decode step timed by
   graph replay beside their bound at the shard's shapes, and each rank's
   peak memory; (c) ``repro_torch.launch.serve`` on qwen3-0.6b uncut
   (``--cim deploy --batch 2 --prompt-len 8 --new-tokens 2``) with
   ``--mesh 4 --dist-backend gloo`` (in a process of its own) and with
   ``--mesh 1`` (in this one): both exit 0 with the same tokens, and
   rank 0's tok/s; (d) the same llama3 pack on the same ranks decoded
   greedily with flash decode (``flash_decode=True``: the KV cache
   time-sharded over the ranks, a quarter of it on each, the partial
   softmaxes merged by all-reduces) against the same ranks' plain
   decode, with the bf16 and the int8 KV caches: tokens equal on every
   rank (any that differs printed with its two top logits), logits within
   ``MESH_FD_TOL`` a layer of their largest magnitude, the cache bytes a
   rank a quarter of the whole, 14 K1 and 6 all-reduces a step;
   ``ServingEngine.generate_batch`` with flash decode gives phase 13's
   tokens; rank 0's flash step (CUDA events) and the all-reduces' share
   of it (host clock); (e) moonshot-v1-16b-a3b at published widths cut to
   phase 16d's 2 layers, the training launcher's CIM config (emulate),
   ``moe_impl="auto"``: each rank holds its 16 experts
   (``nn.module.shard_params``) and runs one forward and backward of the
   LM loss at batch 4 x 64 expert-parallel; the loss equals the single
   device's (computed by the parent first) to 1e-5 relative, every expert
   bank's gradient block and the router's within ``MESH_MOE_GRAD_TOL`` of
   their largest magnitude, the global gradient norm within 1e-3; each
   rank's peak memory; (f) data parallel serving: the same four ranks as
   a ``("data", "model")`` mesh of (2, 2), (b)'s llama3 pack placed again
   column-sharded over its ``"model"`` ranks (``DeployArtifact.shard``),
   the 8 prompts (4 rows a data rank) prefilled and decoded 8
   steps greedily through the serve cell's step (``launch.cells.
   build_cell(...).step_fn``: each rank on its rows and its cache rows,
   flash decode over ``"model"``, 64 of the 128 positions a rank): each
   rank's prefill logits bit-equal to its rows of phase 13's one-device
   prefill, its tokens equal to the one-device decode's and its logits
   within ``MESH_FD_TOL`` a layer, no all-gather over ``"data"`` in the
   steps (``core.colshard.collective.axes``), 14 K1 launches a call per
   rank at M = 4 rows and no other kernel; rank 0's decode step (CUDA
   events) beside (d)'s ``("model",)`` x 4 step and its K1 calls of a
   step timed beside their bound; the phase's seconds;
18. FSDP and tensor parallelism over a ``("data", "model")`` mesh of (2,
   2) gloo ranks sharing the card (``phase18_fsdp``): (a) llama3-8b at
   published widths cut to 2 layers, emulate under the training
   launcher's CIM config, AdamW in float32, ``build_cell``'s placements
   (FSDP: embed over data; heads, mlp, vocab over model), batch 4 x 64,
   2 steps (3 until the run was cut to its time budget): each step's loss
   against one device's on the same params to 1e-5 (step 2's twice: on
   the gathered step-1 state and on the checkpoint's restore),
   step-1 gradients within ``FSDP_GRAD_TOL`` of each leaf's scale,
   a quarter of every embed x (heads | mlp) weight and its moments a
   rank, the step-1 checkpoint written once by rank 0; rank 0 counts its
   step 1's argument bytes and collectives by kind for phase 19(b); (b)
   that checkpoint resumed on the same mesh (step 2 bit-equal), on a
   ("model",) mesh of 2 and on one device; (c) the trained tree packed
   int8 and served (4 prompts of 64 tokens, 4 new) on a ("model",) mesh
   of 4 under the full ``sharding_rules``: prefill logits and tokens
   equal to one device's, 14 K1 a forward a rank on N/4 columns and no
   other kernel; the phase's seconds;
19. the dry run against the card (``phase19_dry_run``): the port's
   ``launch.dryrun.run_cell`` counts two cells on ``meta`` tensors in a
   process of its own (no card; started before the build): (a) phase
   16a's run, qwen3-0.6b uncut on one device at batch 8 x 256 under the
   training launcher's CIM config: its argument bytes equal the params,
   AdamW state and batch of 16a's step 3 on the card, and its FLOPs
   ``FlopCounterMode``'s count of that step on the card, exactly; its
   meta peak beside the card's ``max_memory_allocated`` over the step and
   its roofline bound beside 16a's median step, printed; (b) phase 18's
   cell as rank 0 of the fake process group: its argument bytes a rank
   (and apart, its batch's: the rows rank 0's step read, counted as it
   took them) and its collective bytes by kind equal what rank 0 of phase
   18's gloo run held and counted over its step 1, exactly; the phase's
   seconds;
then the whole run's seconds, a JSON line per kernel, the card's name
and power limit, and the final JSON line.

Times: each kernel and each library call is timed as the device time of
a CUDA-graph replay of repeated calls (no host launch gaps: ``ms``,
``library_ms``), and eagerly by CUDA events, host launch gaps included
(printed in brackets); the plain versions run eagerly, timed by CUDA
events.

Tolerances: each kernel and its plain version add the same float32 terms
in the same order with the same roundings (float-digit partial sums are
exact in float64 on both sides: each float launch checks the bound
first, ``tests/test_torch_float_digits.py`` proves it), so they are
expected to agree bit
for bit; the gate is rtol 1e-5 / atol 1e-4, the reference's own
kernel-vs-oracle tolerance. Deploy against emulate is gated at 1e-4 as in
``tests/test_cim_conv_deploy.py`` (the transformer's logits at 1e-4 of
their largest magnitude); 0.0 is expected, and served tokens must be
identical. The weights are random, so the
accuracies printed in phase 8 mean nothing; the logit error is what the
sweep checks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate, dense int8 tensor-core rate, and
# the FP64 tensor-core rate (the float-digit kernels' MACs run in float64)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP64_OPS_PER_S = 67e12
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 256
REQUESTS = 3                      # deploy forwards per pack dtype
SIGMA = 0.3                       # cell variation of the float-plane checks
SWEEP_SIGMAS = (0.0, 0.1, 0.2, 0.3, 0.4)
SWEEP_SAMPLES = 4
QAT_IMAGES = 4096                 # the first quarter held out
QAT_STEPS = 60
QAT_BATCH = 128
QAT_LR = 0.05
QAT_CKPT_STEP = 30
QAT_LOSS_RATIO = 0.7              # last-20 mean over first-20 mean, at most
QAT_MIN_ACC = 0.20                # held-out accuracy (chance 0.10)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


class _Build:
    """``_build.build()`` in a thread of its own, holding the build module's
    lock (a ``load`` elsewhere meanwhile waits for it rather than start a
    second nvcc); ``error`` and ``seconds`` once joined."""

    def __init__(self, build_module):
        import threading
        self._mod, self.error, self.seconds = build_module, None, 0.0
        self._thread = threading.Thread(target=self._run)

    def _run(self):
        t0 = time.perf_counter()
        try:
            with self._mod._lock:
                self._mod.build()
        except Exception as e:           # re-raised by ``check`` in main
            self.error = e
        self.seconds = time.perf_counter() - t0

    def start(self):
        self._thread.start()

    def join(self):
        self._thread.join()


def _took(n, t0: float) -> float:
    """Print ``phase n took X s`` since ``t0``; the time now."""
    now = time.perf_counter()
    print(f"phase {n} took {now - t0:.1f} s", flush=True)
    return now


def _start_build():
    """Phase 2's build, started before torch is imported (nvcc needs none
    of it): ``kernels/_build.py`` loaded from its file under its package
    name, so that the kernels' wrappers import this module and wait on its
    lock; None where the checkout holds no kernels or the machine no nvcc."""
    import importlib.util
    path = ROOT / "src" / "repro_torch" / "kernels" / "_build.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(
        "repro_torch.kernels._build", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    try:
        mod._nvcc()
    except RuntimeError:
        return None
    build = _Build(mod)
    build.start()
    return build


def main() -> int:
    t_run = time.perf_counter()
    build = _start_build()
    import torch
    if not torch.cuda.is_available():
        if build is not None:
            build.join()
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}; "
          f"count {torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = _took(1, t_run)

    # 19's dry runs count on the host, in a process of their own, while
    # the kernels build
    dry = _start_dry_runs()

    # 2. build, in a thread of its own since the start: the work that runs
    # no kernel goes on the card meanwhile (16(d), phase 18's one-device
    # reference run and 17(e)'s; their times are printed as taken beside
    # the build); the SASS dumps run in the background until phase 9's end
    check(build is not None and _build is build._mod, "phase 2: the "
          "build did not start before torch was imported")
    t_beside = time.perf_counter()
    _moe_training(torch, dev, smi, False)
    gc.collect()
    torch.cuda.empty_cache()
    single18 = _phase18_references(torch, FSDP_WORK)
    gc.collect()
    torch.cuda.empty_cache()
    _phase17e_references(torch, MESH_WORK)
    gc.collect()
    torch.cuda.empty_cache()
    t_beside = time.perf_counter() - t_beside
    build.join()
    check(build.error is None, f"phase 2 build: {build.error}")
    print(f"phase 2 build: {', '.join(n + '.cu' for n in _build.SOURCES)} in "
          f"{build.seconds:.1f} s from the script's start (16d and the "
          f"references of 17e and 18 beside it, {t_beside:.1f} s)",
          flush=True)
    for name in _build.SOURCES:
        print(f"phase 2 ptxas {name}.cu: "
              + ("; ".join(_ptxas_summary(_build.build_log.get(name, "")))
                 or "already built"), flush=True)
    sass = {name: _start_sass(_build.library_path(name))
            for name in _build.SOURCES}
    t0 = _took(2, t0)

    # "cim_matmul": K1's cases of phases 3 and 3b, at shapes of their own
    errs = {name: 0.0 for name in (*KERNELS, "cim_matmul")}

    # 3. kernel against its plain version
    n_cases = phase3_kernel_cases(torch, dev, errs)
    n_cases += phase3_implicit_adc_cases(torch, dev, errs)
    print(f"phase 3 kernel vs plain: {n_cases} cases pass (K3 an implicit "
          f"GEMM: {len(IMPLICIT_ADC_CONV_CASES)} of them on int8 and int4 "
          f"planes with and without occ, all four equal); max |kernel - "
          f"plain| cim_matmul {errs['cim_matmul']!r}, cim_conv "
          f"{errs['cim_conv']!r}", flush=True)
    n_cases = phase3b_new_kernel_cases(torch, dev, errs)
    n_cases += phase3b_float_implicit_cases(torch, dev, errs)
    print(f"phase 3b ADC-free and float-digit kernels vs plain: {n_cases} "
          f"cases pass; max |kernel - plain| "
          + ", ".join(f"{k} {errs[k]!r}" for k in (
              "cim_matmul", "cim_conv", "cim_matmul_adc_free",
              "cim_conv_adc_free", "cim_conv_variation")),
          flush=True)
    t0 = _took(3, t0)

    # 4. the main path: packed ResNet-20 inference
    timings, model = phase4_resnet20(torch, dev, errs)
    t0 = _took(4, t0)

    # 5. ResNet-18
    phase5_resnet18(torch, dev)
    t0 = _took(5, t0)

    # 6.-8. the adc_free and binary backends and cell variation
    timings.update(phase6_adc_free(torch, model, errs))
    t0 = _took(6, t0)
    phase7_binary(torch, model)
    t0 = _took(7, t0)
    timings.update(phase8_variation(torch, model, errs))
    resnet20 = {k: model[k] for k in ("cfg", "cim", "state")}
    resnet20["packed"] = model["packed"]["int8"]      # phase 12's sweep
    del model                          # free the ResNet phases' tensors
    gc.collect()
    torch.cuda.empty_cache()
    t0 = _took(8, t0)

    # 9. the CIM experts kernel against its plain version
    n_cases = phase9_experts_cases(torch, dev, errs)
    print(f"phase 9 experts kernel vs plain: {n_cases} cases pass; max "
          f"|kernel - plain| {errs['cim_matmul_experts']!r}", flush=True)
    t0 = _took(9, t0)

    # 2's SASS dumps, collected
    sass = {name: _sass_counts(*job) for name, job in sass.items()}
    print("phase 2 SASS tensor-core instructions (cuobjdump -sass, run "
          "beside phases 3-9): "
          + "; ".join(f"{n}.cu {c}" for n, c in sass.items()), flush=True)
    check(sass["cim_matmul"]["DMMA"] > 0,
          "the float-digit kernel's SASS holds no DMMA (FP64 tensor core)")

    # 10. the MoE serving path at full width
    mc = moe_config()
    timings.update(phase10_moe_serving(torch, errs, mc))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = _took(10, t0)

    # 11. the training path: QAT, checkpoint, artifacts on disk, deploy
    qat = phase11_qat(torch, dev, smi)
    t0 = _took(11, t0)

    # 12. drift, recalibration, the health monitor and the telemetry plane
    timings.update(phase12_drift(torch, errs, mc, resnet20))
    del mc, resnet20
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()

    # 13. the dense and MLA transformers of the zoo at published widths
    timings.update(phase13_zoo(torch, errs))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = _took(13, t0)

    # 14. the recurrent and multimodal zoo at published widths
    timings.update(phase14_recurrent_zoo(torch, errs))
    gc.collect()
    torch.cuda.empty_cache()

    # 15. the recurrent and multimodal zoo on a drifting chip
    timings.update(phase15_zoo_drift(torch, errs))
    gc.collect()
    torch.cuda.empty_cache()

    # 16. the LM training path ((d) ran beside the build); one of its
    # steps is counted for 19(a)
    step16 = phase16_lm_training(torch, smi)

    # 17. column-parallel serving over a mesh of ranks sharing the card
    phase17_column_parallel(torch, smi, qat)
    gc.collect()
    torch.cuda.empty_cache()

    # 18. FSDP and tensor parallelism over a (data, model) mesh of ranks;
    # rank 0 counts its first step for 19(b)
    step18 = phase18_fsdp(torch, smi, single18)
    gc.collect()
    torch.cuda.empty_cache()

    # 19. the dry run against the card
    phase19_dry_run(dry, step16, step18, smi)

    # results
    print(f"chip_smoke took {time.perf_counter() - t_run:.1f} s in all, the "
          f"build included (budget {RUN_BUDGET_S} s); nvidia-smi: {smi}",
          flush=True)
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": t["launches"], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CUDA_SOURCE = "src/repro_torch/csrc/cim_matmul.cu"
MMA_SOURCE = "src/repro_torch/csrc/cim_adc_free_mma.cu"
MMA_ADC_SOURCE = "src/repro_torch/csrc/cim_matmul_mma.cu"
#: kernel entries of the results line: (source, TPU kernel it replaces).
#: Integer planes run on the int8 tensor cores (``cim_mma.cuh``, included
#: by both MMA sources); float32 (cell-variation) planes on the FP64
#: tensor-core kernel of CUDA_SOURCE. Every conv is an implicit GEMM.
KERNELS = {
    # K3: the implicit GEMM with the ADC epilogue
    "cim_conv": (MMA_ADC_SOURCE, "src/repro/kernels/cim_conv.py:60"),
    # integer planes on the int8 tensor cores; the conv an implicit GEMM.
    # The matmul at its path's shapes (every CIM linear of the MoE
    # transformer on adc_free), and at the 20 ResNet-20 convs'
    # materialized patches, a shape no path gives it now (launches 0)
    "cim_matmul_adc_free": (MMA_SOURCE,
                            "src/repro/kernels/cim_adc_free.py:98"),
    "cim_matmul_adc_free_resnet": (MMA_SOURCE,
                                   "src/repro/kernels/cim_adc_free.py:98"),
    "cim_conv_adc_free": (MMA_SOURCE, "src/repro/kernels/cim_adc_free.py:180"),
    # K3 on float32 planes that carry cell variation: the implicit GEMM on
    # the FP64 tensor cores
    "cim_conv_variation": (CUDA_SOURCE, "src/repro/kernels/cim_conv.py:60"),
    # K1 at its path's shapes: the MoE transformer's attention, dense MLP
    # and shared-expert linears
    "cim_matmul_transformer": (MMA_ADC_SOURCE,
                               "src/repro/kernels/cim_matmul.py:160"),
    "cim_matmul_experts": (MMA_ADC_SOURCE,
                           "src/repro/kernels/cim_matmul.py:269"),
    # K1 on float32 planes that carry drift: every drifted linear of the
    # MoE transformer, on the FP64 tensor cores
    "cim_matmul_drift": (CUDA_SOURCE, "src/repro/kernels/cim_matmul.py:160"),
    # K1 at one decode step's operands on the zoo's dense paths: deepseek-v3's
    # MLA layers (kt up to 144) and llama3-8b (phase 13)
    "cim_matmul_mla": (MMA_ADC_SOURCE, "src/repro/kernels/cim_matmul.py:160"),
    "cim_matmul_llama3": (MMA_ADC_SOURCE,
                          "src/repro/kernels/cim_matmul.py:160"),
    # K3 over the zoo's front ends (whisper's 1x3 stem convs on raw
    # log-mel frames, llava's 14x14 patch embed), and K1 at one decode
    # step's operands on zamba2 and xlstm (phase 14)
    "cim_conv_frontend": (MMA_ADC_SOURCE, "src/repro/kernels/cim_conv.py:60"),
    "cim_matmul_ssm": (MMA_ADC_SOURCE, "src/repro/kernels/cim_matmul.py:160"),
    # K1 and K3 on float32 planes on the drifted recurrent and multimodal
    # zoo (phase 15): K1 at one drifted decode step's operands on zamba2,
    # xlstm, whisper and llava; K3 over whisper's two stem convs and
    # llava's patch embed in one drifted forward each (126- and 196-row
    # tiles), on the FP64 tensor cores
    "cim_matmul_zoo_drift": (CUDA_SOURCE,
                             "src/repro/kernels/cim_matmul.py:160"),
    "cim_conv_frontend_float": (CUDA_SOURCE,
                                "src/repro/kernels/cim_conv.py:60"),
}


def _counted():
    """The kernel wrappers whose launch counters the main paths read."""
    from repro_torch.kernels.cim_adc_free import (cim_conv_adc_free_cuda,
                                                  cim_matmul_adc_free_cuda)
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.kernels.cim_matmul import (cim_matmul_cuda,
                                                cim_matmul_experts_cuda)
    return {"cim_matmul": cim_matmul_cuda, "cim_conv": cim_conv_cuda,
            "cim_matmul_adc_free": cim_matmul_adc_free_cuda,
            "cim_conv_adc_free": cim_conv_adc_free_cuda,
            "cim_matmul_experts": cim_matmul_experts_cuda}


def _reset_counters() -> None:
    from repro_torch.kernels import ref
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "float_launches"):
            fn.float_launches = 0
    ref.extract_conv_patches.cuda_gathers = 0


def _read_counters():
    """({wrapper: launches, "plain_gathers": patch gathers in plain torch
    on the card}, {wrapper: launches on float32 planes})."""
    from repro_torch.kernels import ref
    fns = _counted()
    launches = {k: fn.launches for k, fn in fns.items()}
    launches["plain_gathers"] = ref.extract_conv_patches.cuda_gathers
    return (launches,
            {k: getattr(fn, "float_launches", 0) for k, fn in fns.items()})


def _start_sass(path):
    """Start ``cuobjdump -sass`` on a built library, its listing written to
    a file beside it: (the process, the listing's path). Fails where the
    toolkit has no cuobjdump."""
    import os
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(exe), "cuobjdump not found: the SASS of the "
          "float-digit kernel cannot be checked for DMMA")
    out = Path(path).with_suffix(".sass")
    with open(out, "w") as f:
        return subprocess.Popen([exe, "-sass", str(path)], stdout=f,
                                stderr=subprocess.STDOUT), out


def _sass_counts(proc, out):
    """{"DMMA", "IMMA", "HMMA": count} of a library's SASS listing (FP64,
    integer and half-precision tensor-core instructions) once
    ``_start_sass``'s process has ended."""
    import re
    check(proc.wait(timeout=300) == 0, f"cuobjdump -sass exited "
          f"{proc.returncode}: {out.read_text()[-2000:]}")
    sass = out.read_text()
    out.unlink()
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("DMMA", "IMMA", "HMMA")}


def _ptxas_summary(log: str):
    """One entry per compiled kernel of an nvcc -Xptxas -v log: its name
    (template arguments kept), registers, spill stores and loads, bytes."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            for junk in ("_ZN", "_GLOBAL__N_"):
                name = name.replace(junk, "")
        elif "spill stores" in ln:
            parts = ln.replace(",", "").split()
            spill = f"spill {parts[parts.index('spill') - 2]}/" \
                    f"{parts[parts.index('loads') - 3]} B"
        elif "Used" in ln and "registers" in ln and name is not None:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{_short_kernel_name(name)} {regs} regs {spill}")
            name, spill = None, ""
    return out


def _short_kernel_name(mangled: str) -> str:
    """``..._ZN..14cim_mma_kernelILi16ELb1ELb0ELb1ELb0EEEv..`` -> the
    kernel's name with its template arguments, ``...<16,1,0,1,0>``. A
    length may follow other digits (an anonymous namespace's hash), so
    every digit run's suffixes are tried."""
    import re
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            ident = mangled[m.end(): m.end() + n]
            if n and ident.endswith("_kernel") and ident.isidentifier():
                rest = mangled[m.end() + n:]
                args = (re.findall(r"L[ib](\d+)E", rest.split("EEv")[0])
                        if rest.startswith("I") else [])
                return ident + (f"<{','.join(args)}>" if args else "")
    return mangled[:48]


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _compare(torch, got, want, name, what, errs):
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name} {what}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
          "or non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    errs[name] = max(errs[name], err)
    check(bool(torch.allclose(got, want, **KERNEL_TOL)),
          f"{name} {what}: max |kernel - plain| = {err!r}")


# (M, kt, rows, N, unsigned codes, nibble planes (1) or int8 (0), occ,
# psum_bits, quant)
MATMUL_CASES = (
    (4096, 2, 126, 16, False, 0, False, 4, True),
    (4097, 2, 126, 20, False, 0, True, 1, True),
    (1000, 3, 126, 32, True, 1, True, 4, True),
    (777, 1, 128, 64, False, 1, False, 8, True),
    (513, 5, 126, 130, True, 0, True, 4, False),
    (300, 2, 126, 32, False, 0, False, 1, True),
    (257, 37, 126, 512, False, 1, True, 4, True),
    (64, 4, 128, 17, True, 1, True, 8, True))
# The case table below also parametrises tests/test_torch_cuda.py.
# the tensor-core ADC matmul at decode's row counts: (M, kt, rows, N,
# uint8 codes, nibble planes (1) or int8 (0), occ, psum_bits,
# psum_quant). M 1-16: one-warp row blocks and 16-column tiles; under two
# blocks per SM the
# tile loop splits (kt 16, 22 and 88 at N 2048: the MoE transformer's
# attention, shared-expert and dense down projections); N 11264 (the
# dense layer's up projections) does not; M 33 takes a 48-row block
SMALL_M_CASES = (
    (1, 16, 128, 2048, False, 0, True, 6, True),
    (8, 16, 128, 2048, False, 1, True, 6, True),
    (8, 88, 128, 2048, False, 0, True, 6, True),
    (8, 16, 128, 11264, True, 0, True, 8, True),
    (16, 22, 128, 2048, True, 1, True, 1, True),
    (16, 5, 126, 17, False, 1, True, 1, True),
    (33, 3, 126, 100, False, 1, True, 4, True),
    (1, 2, 126, 1, True, 0, False, 4, False),
    (8, 4, 128, 2048, False, 0, True, 4, False),
    (8, 7, 128, 40, True, 0, True, 1, True))
# (kh, stride, padding, nibble, occ, psum_bits)
CONV_CASES = (
    (3, 1, "SAME", False, True, 4), (3, 2, "SAME", True, True, 4),
    (1, 2, "SAME", True, False, 8), (3, 1, "VALID", False, False, 1),
    (1, 1, "VALID", True, True, 1), (3, 2, "VALID", True, True, 4))


def _matmul_operands(torch, g, m, kt, rows, n, uns, nibble):
    """Random codes, and S = 3 digit planes with dead columns and a fully
    dead (split, tile): (a, logical d, stored digits, occ, s_p, deq)."""
    from repro_torch.core.nibble import occupancy_map, pack_nibbles
    if uns:
        a = torch.randint(0, 256, (m, kt, rows), generator=g,
                          dtype=torch.uint8)
    else:
        a = torch.randint(-8, 8, (m, kt, rows), generator=g, dtype=torch.int8)
    d = torch.randint(-3, 4, (3, kt, rows, n), generator=g, dtype=torch.int8)
    d[:, :, :, 3:9] = 0                    # dead columns
    d[1, 0] = 0                            # a fully dead (split, tile)
    digits = pack_nibbles(d) if nibble else d
    amax = 255 if uns else 8
    s_p = 0.5 + torch.rand((3, kt, n), generator=g) * amax * rows ** 0.5
    deq = torch.randn((3, kt, n), generator=g) * 0.1
    return a, d, digits, occupancy_map(d), s_p, deq


def _conv_operands(torch, g, kh, nibble):
    """Random codes (8, 17, 15, C_in) and 6-D conv planes with padded
    channel slots and dead output channels: (a, d6, logical (S, kt, rows,
    C_out), stored digits, occ, s_p, deq, c_per_array)."""
    from repro_torch.core.nibble import occupancy_map, pack_nibbles
    cpa = 128 // (kh * kh)
    c_in, c_out, kt = 2 * cpa + 3, 48, 3
    a = torch.randint(0, 8, (8, 17, 15, c_in), generator=g, dtype=torch.int8)
    d6 = torch.randint(-1, 2, (3, kt, kh, kh, cpa, c_out), generator=g,
                       dtype=torch.int8)
    d6[:, -1, :, :, 3:] = 0                # padded channel slots
    d6[..., 5:9] = 0                       # dead output channels
    rows = kh * kh * cpa
    logical = d6.reshape(3, kt, rows, c_out)
    digits = (pack_nibbles(d6).reshape(3, kt, rows // 2, c_out) if nibble
              else logical)
    s_p = 0.5 + torch.rand((3, kt, c_out), generator=g) * 20
    deq = torch.randn((3, kt, c_out), generator=g) * 0.1
    return (a, d6, logical, digits, occupancy_map(d6, conv=True), s_p, deq,
            cpa)


def phase3_kernel_cases(torch, dev, errs) -> int:
    from repro_torch.core.nibble import unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.kernels.cim_matmul import cim_matmul_cuda

    g = torch.Generator().manual_seed(0)
    n_cases = 0
    for m, kt, rows, n, uns, nibble, sparse, pb, quant in MATMUL_CASES:
        ops = _matmul_operands(torch, g, m, kt, rows, n, uns, nibble)
        if nibble:
            check(torch.equal(unpack_nibbles(ops[2]), ops[1]),
                  "nibble round trip")
        a, d, digits, occ, s_p, deq = (x.to(dev) for x in ops)
        got = cim_matmul_cuda(a, digits, s_p, deq, occ if sparse else None,
                              psum_bits=pb, psum_quant=quant)
        want = ref.cim_matmul_ref(a, d, s_p, deq, psum_bits=pb,
                                  psum_quant=quant)
        torch.cuda.synchronize()
        _compare(torch, got, want, "cim_matmul",
                 f"M={m} kt={kt} rows={rows} N={n} uint8={uns} "
                 f"nibble={nibble} occ={sparse} psum_bits={pb} quant={quant}",
                 errs)
        n_cases += 1

    # decode's row counts; sparse equals dense bit for bit (the sign ADC
    # included: a dead plane still passes p = 0 through the ADC)
    for m, kt, rows, n, uns, nibble, sparse, pb, quant in SMALL_M_CASES:
        a, d, digits, occ, s_p, deq = (
            x.to(dev) for x in _matmul_operands(torch, g, m, kt, rows, n,
                                                uns, nibble))
        kw = dict(psum_bits=pb, psum_quant=quant)
        got = cim_matmul_cuda(a, digits, s_p, deq, occ if sparse else None,
                              **kw)
        dense = cim_matmul_cuda(a, digits, s_p, deq, None, **kw)
        want = ref.cim_matmul_ref(a, d, s_p, deq, psum_bits=pb,
                                  psum_quant=quant)
        torch.cuda.synchronize()
        what = (f"small M={m} kt={kt} rows={rows} N={n} uint8={uns} "
                f"nibble={nibble} occ={sparse} psum_bits={pb} quant={quant}")
        _compare(torch, got, want, "cim_matmul", what, errs)
        check(torch.equal(got, dense), f"cim_matmul {what}: sparse differs "
              "from dense")
        n_cases += 1

    for kh, stride, padding, nibble, sparse, pb in CONV_CASES:
        a, _, logical, digits, occ, s_p, deq, cpa = (
            x.to(dev) if torch.is_tensor(x) else x
            for x in _conv_operands(torch, g, kh, nibble))
        geo = dict(kh=kh, kw=kh, stride=stride, padding=padding,
                   c_per_array=cpa, psum_bits=pb)
        got = cim_conv_cuda(a, digits, s_p, deq, occ if sparse else None,
                            **geo)
        want = ref.cim_conv_ref(a, logical, s_p, deq, **geo)
        torch.cuda.synchronize()
        _compare(torch, got, want, "cim_conv",
                 f"{kh}x{kh} stride {stride} {padding} nibble={nibble} "
                 f"occ={sparse} psum_bits={pb}", errs)
        n_cases += 1
    return n_cases


# The case tables and the operand builder below also parametrise the card
# tests of tests/test_torch_cuda.py.
# the tensor-core ADC-free matmul on shapes its loaders find hard:
# (M, kt, rows, N, uint8 codes, nibble planes (1) or int8 (0), occ); rows
# not a multiple of 32 (16/96: 16-byte aligned loads; 40, 100, 127: staged),
# N from 1 to 200 (column tiles 16/32/64, several of them), ragged M, and
# enough row blocks that each persistent block takes several
ADC_FREE_MATMUL_CASES = (
    (1, 1, 16, 1, False, 0, False), (333, 2, 40, 3, True, 0, True),
    (1000, 3, 100, 20, False, 1, True), (2049, 1, 127, 33, True, 0, True),
    (515, 4, 96, 64, False, 1, True), (70001, 2, 126, 16, True, 1, True),
    (4097, 2, 128, 200, False, 1, True), (129, 5, 126, 64, True, 0, False))
# the implicit-GEMM conv: (batch, H, W, C_in, k, stride, padding, cpa,
# C_out, nibble, uint8 codes, occ). C_in 3/14/15/16/29/64 at cpa 14 (16-byte
# aligned pixels at 16 and 64: direct loads; 3 on packed segments, as C_in
# 29 at cpa 128; the rest staged), odd and even
# H and W at stride 2 under SAME (pads 0 before, 1 after on even sizes) and
# VALID, 1x1 projections at cpa 128, blocks that straddle images (H'W' well
# under a 64-row block), M not a multiple of the block
IMPLICIT_CONV_CASES = (
    (5, 9, 9, 3, 3, 1, "SAME", 14, 16, False, True, True),
    (4, 10, 12, 14, 3, 2, "SAME", 14, 20, True, False, True),
    (3, 11, 7, 15, 3, 2, "SAME", 14, 32, False, True, False),
    (7, 8, 8, 16, 3, 2, "SAME", 14, 32, True, True, True),
    (2, 13, 10, 29, 3, 2, "VALID", 14, 64, False, False, True),
    (6, 6, 6, 64, 3, 1, "SAME", 14, 64, True, True, True),
    (9, 8, 8, 64, 3, 2, "VALID", 14, 70, False, True, True),
    (11, 16, 16, 16, 1, 2, "SAME", 128, 32, True, True, True),
    (5, 15, 15, 32, 1, 2, "SAME", 128, 64, False, False, False),
    (3, 5, 5, 29, 1, 1, "VALID", 128, 9, False, True, True),
    (13, 4, 4, 16, 3, 1, "SAME", 14, 16, False, False, True))


def implicit_conv_operands(torch, g, b, h, w, c_in, kh, kw, cpa, n, uns):
    """Codes (b, h, w, c_in) over their whole range, kh x kw conv planes
    (S = 3, digits -8..7) with dead output channels and a dead (split,
    tile), on the CPU: (a, logical (S, kt, rows, n), int4 planes, occ,
    deq). The int4 planes are nibble pairs on the channel-slice axis, or,
    at an odd c_per_array (the pack keeps those dense), the logical
    planes."""
    from repro_torch.core.nibble import occupancy_map, pack_nibbles
    kt = -(-c_in // cpa)
    if uns:
        a = torch.randint(0, 256, (b, h, w, c_in), generator=g,
                          dtype=torch.uint8)
    else:
        a = torch.randint(-128, 128, (b, h, w, c_in), generator=g,
                          dtype=torch.int8)
    d6 = torch.randint(-8, 8, (3, kt, kh, kw, cpa, n), generator=g,
                       dtype=torch.int8)
    d6[..., 1:4] = 0                       # dead output channels
    d6[1, 0] = 0                           # a dead (split, tile)
    rows = kh * kw * cpa
    logical = d6.reshape(3, kt, rows, n)
    packed = (pack_nibbles(d6).reshape(3, kt, rows // 2, n) if cpa % 2 == 0
              else logical)
    deq = torch.randn((3, kt, n), generator=g) * 0.1
    return a, logical, packed, occupancy_map(d6, conv=True), deq


# K3, the ADC conv as an implicit GEMM, on the implicit conv's grid and at
# batch 1 (ResNet-20's first and last stages): (batch, H, W, C_in, kh, kw,
# stride, padding, cpa, C_out, uint8 codes, psum_bits, psum_quant). Each
# case runs on int8 and int4 (nibble) planes, with and without the
# occupancy map: the four results must be equal, and equal to the plain
# version. The last five are the zoo's front ends at their shapes:
# whisper's 1x3 stem convs on H = 1 (C_in 80 and 768 at cpa 42: tiles of
# 126 rows, kt 2 and 19; stride 1 and 2, SAME on an even width of 3000,
# so the stride-2 conv pads (0, 1); staged loads, no window fits), and
# llava's 14x14 stride-14 VALID patch embed on 3 channels (cpa 1: tiles of
# 196 rows, over the exact small-sum conversion's 128; packed segments;
# its int4 pack stays dense, cpa being odd). The float-plane cases
# (FLOAT_CONV_CASES, the whole grid: drifted and varied whisper and llava
# run their stems on float planes) carry cell variation at each sigma of
# VARIATION_SIGMAS, ADC and ADC-free; the 126- and 196-row tiles are exact
# by the bound the wrappers check before each float launch
# (kernels/cim_matmul.py::float_sums_exact, csrc/cim_matmul.cu).
IMPLICIT_ADC_CONV_CASES = (
    (5, 9, 9, 3, 3, 3, 1, "SAME", 14, 16, True, 4, True),
    (4, 10, 12, 14, 3, 3, 2, "SAME", 14, 20, False, 1, True),
    (3, 11, 7, 15, 3, 3, 2, "SAME", 14, 32, True, 6, True),
    (7, 8, 8, 16, 3, 3, 2, "SAME", 14, 32, True, 4, False),
    (2, 13, 10, 29, 3, 3, 2, "VALID", 14, 64, False, 4, True),
    (6, 6, 6, 64, 3, 3, 1, "SAME", 14, 64, True, 1, True),
    (9, 8, 8, 64, 3, 3, 2, "VALID", 14, 70, True, 6, True),
    (11, 16, 16, 16, 1, 1, 2, "SAME", 128, 32, True, 1, True),
    (5, 15, 15, 32, 1, 1, 2, "SAME", 128, 64, False, 4, True),
    (3, 5, 5, 29, 1, 1, 1, "VALID", 128, 9, True, 6, False),
    (13, 4, 4, 16, 3, 3, 1, "SAME", 14, 16, False, 4, True),
    (1, 32, 32, 16, 3, 3, 1, "SAME", 14, 16, True, 1, True),
    (1, 8, 8, 64, 3, 3, 1, "SAME", 14, 64, False, 6, True),
    # the front ends
    (2, 1, 3000, 80, 1, 3, 1, "SAME", 42, 96, False, 6, True),
    (2, 1, 3000, 768, 1, 3, 2, "SAME", 42, 96, False, 6, True),
    (3, 1, 64, 80, 1, 3, 2, "SAME", 42, 40, True, 4, True),
    (2, 336, 336, 3, 14, 14, 14, "VALID", 1, 1024, False, 6, True),
    (3, 28, 42, 3, 14, 14, 14, "VALID", 1, 40, True, 1, True))
FLOAT_CONV_CASES = IMPLICIT_ADC_CONV_CASES
VARIATION_SIGMAS = (0.1, 0.2, 0.3, 0.4)


def implicit_adc_conv_operands(torch, g, b, h, w, c_in, kh, kw, cpa, n,
                               uns):
    """``implicit_conv_operands`` and ADC scales over the partial sums'
    range: (a, logical, int4 planes, occ, s_p, deq), on the CPU."""
    a, logical, packed, occ, deq = implicit_conv_operands(
        torch, g, b, h, w, c_in, kh, kw, cpa, n, uns)
    rows = kh * kw * cpa
    s_p = 0.5 + torch.rand(deq.shape, generator=g) * (255 if uns else 128) * (
        rows ** 0.5)
    return a, logical, packed, occ, s_p, deq


def varied_planes(torch, g, logical, sigma):
    """float32 planes carrying one cell-variation realization at
    ``sigma``, theta drawn from ``g`` (the planes' logical layout)."""
    from repro_torch.core.variation import perturb_digits
    return perturb_digits(logical, torch.randn(logical.shape, generator=g),
                          sigma)


def phase3_implicit_adc_cases(torch, dev, errs) -> int:
    """K3 as an implicit GEMM against the plain conv: int8 and int4 planes,
    with and without the occupancy map, all four equal bit for bit (sparse
    == dense under the sign ADC too)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_conv import cim_conv_cuda

    g = torch.Generator().manual_seed(2)
    for case in IMPLICIT_ADC_CONV_CASES:
        b, h, w, c_in, kh, kw, stride, padding, cpa, n, uns, pb, quant = case
        a, logical, packed, occ, s_p, deq = (
            x.to(dev) for x in implicit_adc_conv_operands(
                torch, g, b, h, w, c_in, kh, kw, cpa, n, uns))
        geo = dict(kh=kh, kw=kw, stride=stride, padding=padding,
                   c_per_array=cpa, psum_bits=pb, psum_quant=quant)
        outs = [cim_conv_cuda(a, planes, s_p, deq, o, **geo)
                for planes in (logical, packed) for o in (None, occ)]
        want = ref.cim_conv_ref(a, logical, s_p, deq, **geo)
        torch.cuda.synchronize()
        what = (f"implicit B={b} {h}x{w}x{c_in} {kh}x{kw} stride {stride} "
                f"{padding} cpa={cpa} N={n} uint8={uns} psum_bits={pb} "
                f"quant={quant}")
        for got in outs:
            _compare(torch, got, want, "cim_conv", what, errs)
        check(all(torch.equal(o, outs[0]) for o in outs[1:]),
              f"cim_conv {what}: int4 or sparse differs from int8 dense")
    return len(IMPLICIT_ADC_CONV_CASES)


def phase3b_float_implicit_cases(torch, dev, errs) -> int:
    """The float-plane implicit convs (FP64 tensor cores), ADC and
    ADC-free, at each sigma of VARIATION_SIGMAS, against their plain
    versions; sparse equals dense."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_adc_free import cim_conv_adc_free_cuda
    from repro_torch.kernels.cim_conv import cim_conv_cuda

    g = torch.Generator().manual_seed(3)
    n_cases = 0
    for case in FLOAT_CONV_CASES:
        b, h, w, c_in, kh, kw, stride, padding, cpa, n, uns, pb, quant = case
        a, logical, _, occ, s_p, deq = implicit_adc_conv_operands(
            torch, g, b, h, w, c_in, kh, kw, cpa, n, uns)
        geo = dict(kh=kh, kw=kw, stride=stride, padding=padding,
                   c_per_array=cpa)
        mq = dict(psum_bits=pb, psum_quant=quant)
        for sigma in VARIATION_SIGMAS:
            a_d, noisy, occ_d, s_d, deq_d = (x.to(dev) for x in (
                a, varied_planes(torch, g, logical, sigma), occ, s_p, deq))
            what = (f"implicit float sigma {sigma} B={b} {h}x{w}x{c_in} "
                    f"{kh}x{kw} stride {stride} {padding} N={n} uint8={uns}")
            for name, sparse, dense, want in (
                    ("cim_conv_variation",
                     cim_conv_cuda(a_d, noisy, s_d, deq_d, occ_d, **geo, **mq),
                     cim_conv_cuda(a_d, noisy, s_d, deq_d, None, **geo, **mq),
                     ref.cim_conv_ref(a_d, noisy, s_d, deq_d, **geo, **mq)),
                    ("cim_conv_adc_free",
                     cim_conv_adc_free_cuda(a_d, noisy, deq_d, occ_d, **geo),
                     cim_conv_adc_free_cuda(a_d, noisy, deq_d, None, **geo),
                     ref.cim_conv_adc_free_ref(a_d, noisy, deq_d, **geo))):
                torch.cuda.synchronize()
                _compare(torch, sparse, want, name, what, errs)
                check(torch.equal(sparse, dense),
                      f"{name} {what}: sparse differs from dense")
                n_cases += 1
    return n_cases


def phase3b_new_kernel_cases(torch, dev, errs) -> int:
    """Phase 3's case grid through the ADC-free kernels, and float32 digit
    planes carrying one cell-variation realization (sigma 0.3) through
    both kernel families; then the tensor-core ADC-free matmul and the
    implicit-GEMM conv on the shapes their loaders find hard."""
    from repro_torch.core.variation import perturb_digits
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_adc_free import (cim_conv_adc_free_cuda,
                                                  cim_matmul_adc_free_cuda)
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.kernels.cim_matmul import cim_matmul_cuda

    g = torch.Generator().manual_seed(1)
    n_cases = 0
    for m, kt, rows, n, uns, nibble, sparse, pb, quant in MATMUL_CASES:
        ops = _matmul_operands(torch, g, m, kt, rows, n, uns, nibble)
        noisy = perturb_digits(ops[1], torch.randn(ops[1].shape, generator=g),
                               SIGMA)
        a, d, digits, occ, s_p, deq, noisy = (x.to(dev)
                                              for x in ops + (noisy,))
        o = occ if sparse else None
        what = (f"M={m} kt={kt} rows={rows} N={n} uint8={uns} "
                f"nibble={nibble} occ={sparse}")
        mq = dict(psum_bits=pb, psum_quant=quant)
        for name, planes, got, want in (
                ("cim_matmul_adc_free", "integer",
                 cim_matmul_adc_free_cuda(a, digits, deq, o),
                 ref.cim_matmul_adc_free_ref(a, d, deq)),
                ("cim_matmul_adc_free", "float",
                 cim_matmul_adc_free_cuda(a, noisy, deq, o),
                 ref.cim_matmul_adc_free_ref(a, noisy, deq)),
                ("cim_matmul", "float",
                 cim_matmul_cuda(a, noisy, s_p, deq, o, **mq),
                 ref.cim_matmul_ref(a, noisy, s_p, deq, **mq))):
            torch.cuda.synchronize()
            _compare(torch, got, want, name, f"{what} {planes} planes", errs)
            n_cases += 1

    for kh, stride, padding, nibble, sparse, pb in CONV_CASES:
        a, d6, logical, digits, occ, s_p, deq, cpa = _conv_operands(
            torch, g, kh, nibble)
        noisy = perturb_digits(logical, torch.randn(d6.shape, generator=g),
                               SIGMA, shape=d6.shape)
        a, logical, digits, occ, s_p, deq, noisy = (x.to(dev) for x in (
            a, logical, digits, occ, s_p, deq, noisy))
        o = occ if sparse else None
        geo = dict(kh=kh, kw=kh, stride=stride, padding=padding,
                   c_per_array=cpa)
        what = (f"{kh}x{kh} stride {stride} {padding} nibble={nibble} "
                f"occ={sparse}")
        for name, planes, got, want in (
                ("cim_conv_adc_free", "integer",
                 cim_conv_adc_free_cuda(a, digits, deq, o, **geo),
                 ref.cim_conv_adc_free_ref(a, logical, deq, **geo)),
                ("cim_conv_adc_free", "float",
                 cim_conv_adc_free_cuda(a, noisy, deq, o, **geo),
                 ref.cim_conv_adc_free_ref(a, noisy, deq, **geo)),
                ("cim_conv_variation", "float",
                 cim_conv_cuda(a, noisy, s_p, deq, o, psum_bits=pb, **geo),
                 ref.cim_conv_ref(a, noisy, s_p, deq, psum_bits=pb, **geo))):
            torch.cuda.synchronize()
            _compare(torch, got, want, name, f"{what} {planes} planes", errs)
            n_cases += 1

    for m, kt, rows, n, uns, nibble, sparse in ADC_FREE_MATMUL_CASES:
        ops = _matmul_operands(torch, g, m, kt, rows, n, uns, nibble)
        a, d, digits, occ, _, deq = (x.to(dev) for x in ops)
        got = cim_matmul_adc_free_cuda(a, digits, deq,
                                       occ if sparse else None)
        want = ref.cim_matmul_adc_free_ref(a, d, deq)
        torch.cuda.synchronize()
        _compare(torch, got, want, "cim_matmul_adc_free",
                 f"M={m} kt={kt} rows={rows} N={n} uint8={uns} "
                 f"nibble={nibble} occ={sparse}", errs)
        n_cases += 1

    for (b, h, w, c_in, kh, stride, padding, cpa, n, nibble, uns,
         sparse) in IMPLICIT_CONV_CASES:
        a, logical, packed, occ, deq = (x.to(dev) for x in
                                        implicit_conv_operands(
                                            torch, g, b, h, w, c_in, kh, kh,
                                            cpa, n, uns))
        geo = dict(kh=kh, kw=kh, stride=stride, padding=padding,
                   c_per_array=cpa)
        got = cim_conv_adc_free_cuda(a, packed if nibble else logical, deq,
                                     occ if sparse else None, **geo)
        want = ref.cim_conv_adc_free_ref(a, logical, deq, **geo)
        torch.cuda.synchronize()
        _compare(torch, got, want, "cim_conv_adc_free",
                 f"implicit B={b} {h}x{w}x{c_in} {kh}x{kh} stride {stride} "
                 f"{padding} cpa={cpa} N={n} nibble={nibble} uint8={uns} "
                 f"occ={sparse}", errs)
        n_cases += 1
    return n_cases


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def paper_cim(**kw):
    """Paper Table II CIFAR-10 settings (as benchmarks/common.py): 3-bit
    weights on 1-bit cells, 3-bit unsigned activations, 4-bit partial
    sums, 128x128 arrays, column-wise weight and psum scales."""
    from repro_torch.core.cim_linear import CIMConfig
    return CIMConfig(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                     act_bits=3, psum_bits=4, array_rows=128, array_cols=128,
                     weight_granularity="column", psum_granularity="column",
                     act_signed=False, **kw)


def _events_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    the replay timed with CUDA events, so host launch gaps are left out
    (a kernel faster than its wrapper's host work would otherwise be timed
    at the host's pace)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def _bytes_ops_ms(nbytes: int, macs: int, ops_per_s: float):
    """(bytes time, ops time) in ms: bytes over the HBM rate, 2 ops per MAC
    over ``ops_per_s``."""
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * 2 * macs / ops_per_s


def _needed_macs(op, m: int) -> int:
    """MACs a CIM conv needs at ``m`` output pixels: for each (split, tile,
    column) the occupancy map marks live, the tile's real input rows,
    kh * kw * min(c_per_array, C_in - t * c_per_array). Padded channel
    slots hold zero codes and zero digits, so they are not counted."""
    occ, cpa = op["occ"], op["c_per_array"]
    s, kt, n = op["deq"].shape
    c_in = op["a_int"].shape[-1]
    live = ([int(v) for v in occ.sum(dim=(0, 2)).tolist()]
            if occ is not None else [s * n] * kt)
    return m * sum(op["kh"] * op["kw"] * min(cpa, c_in - t * cpa) * live[t]
                   for t in range(kt))


def _folded_weight(torch, logical, deq):
    """(kt*rows, N) float32 W = sum_s digits[s] * deq[s]: on clean integer
    planes round() is the identity, so the ADC-free matmul is one float
    product with W (the split-folded weight)."""
    w = (logical.to(torch.float32) * deq[:, :, None, :]).sum(dim=0)
    return w.reshape(-1, w.shape[-1])


def _time_calls(torch, calls, name, errs, reps):
    """calls: {kernel: (kernel fn, plain fn, library fn or None, bound_ms
    pair)}; checks kernel against plain and times all three: the kernel
    and the library call by CUDA-graph replay (device time, ``ms`` and
    ``library_ms``) and eagerly by CUDA events (``events_ms`` and
    ``library_events_ms``, host launch gaps included), the plain version
    eagerly by CUDA events."""
    out = {}
    for kname, (kern, plain, lib, (bytes_ms, ops_ms)) in calls.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        _compare(torch, got, want, kname, f"{name} at the path's shapes",
                 errs)
        t = {"ms": _graph_ms(torch, kern, reps),
             "events_ms": _events_ms(torch, kern, reps),
             "plain_ms": _events_ms(torch, plain, max(2, reps // 4), warmup=1),
             "library_ms": None if lib is None else _graph_ms(torch, lib,
                                                              reps),
             "library_events_ms": None if lib is None else _events_ms(
                 torch, lib, reps),
             "bytes_ms": bytes_ms, "ops_ms": ops_ms,
             "bound_ms": max(bytes_ms, ops_ms)}
        out[kname] = t
    return out


def _sum_layers(per_layer):
    """Per-kernel sums over the layers of one forward."""
    tot = {}
    for layer in per_layer:
        for k, t in layer.items():
            acc = tot.setdefault(k, {"ms": 0.0, "events_ms": 0.0,
                                     "plain_ms": 0.0, "library_ms": 0.0,
                                     "library_events_ms": 0.0,
                                     "bound_ms": 0.0, "bytes_ms": 0.0,
                                     "ops_ms": 0.0})
            for f in acc:
                acc[f] = None if (acc[f] is None or t[f] is None) else \
                    acc[f] + t[f]
    for t in tot.values():
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else \
            "operations"
    return tot


def _fmt(k, t):
    """One kernel's times: graph replay, then eager events in brackets."""
    lib = ("n/a" if t["library_ms"] is None else
           f"{t['library_ms']:.4f} [{t['library_events_ms']:.4f}]")
    return (f"{k} {t['ms']:.4f} [{t['events_ms']:.4f}] ms (plain "
            f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.5f}, library {lib})")


def _fmt_total(t, launches: str, ops: str = "ops") -> str:
    """A kernel's per-forward sums: graph replay, eager events, plain,
    bound and, where there is one, the library call both ways."""
    lib = ("" if t["library_ms"] is None else
           f", library {t['library_ms']:.4f} ms [events "
           f"{t['library_events_ms']:.4f}]")
    return (f"{t['ms']:.4f} ms per forward [events {t['events_ms']:.4f}] "
            f"({launches}), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms by {t['bound_by']} (bytes "
            f"{t['bytes_ms']:.5f}, {ops} {t['ops_ms']:.5f}){lib}")


def _time_layers(torch, model_cfg, packed, taps, errs, reps: int):
    """Times K3 and its plain version on the operands the deploy forward
    gave each CIM conv; returns per-kernel sums over one forward and
    prints one line per layer."""
    from repro_torch.core.cim_conv import conv_deploy_operands
    from repro_torch.core.nibble import unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.models.resnet import conv_layer_names

    cim = model_cfg.cim
    per_layer = []
    for name, stride in conv_layer_names(model_cfg):
        blk, layer = name.split(".")
        op = conv_deploy_operands(taps[name], packed[blk][layer], cim)
        kh, kw, cpa = op["kh"], op["kw"], op["c_per_array"]
        nibble = op["digits"].dtype == torch.uint8
        logical = (unpack_nibbles(op["digits"], groups=kh * kw) if nibble
                   else op["digits"])
        geo = dict(kh=kh, kw=kw, stride=stride, padding="SAME",
                   c_per_array=cpa, psum_bits=cim.psum_bits,
                   psum_quant=cim.psum_quant)
        kt, n = op["digits"].shape[1], op["digits"].shape[-1]
        b, h, w = op["a_int"].shape[:3]
        m = b * (-(-h // stride)) * (-(-w // stride))     # SAME: ceil(H / s)
        # bytes: each input read once, the output written once; ops: the
        # int8 MACs of the occupied planes over the real input rows
        rest = (op["digits"].numel()
                + (op["occ"].numel() if op["occ"] is not None else 0)
                + 4 * (op["s_p"].numel() + op["deq"].numel()) + 4 * m * n)
        macs = _needed_macs(op, m)
        calls = {
            "cim_conv": (
                lambda: cim_conv_cuda(op["a_int"], op["digits"], op["s_p"],
                                      op["deq"], op["occ"], **geo),
                lambda: ref.cim_conv_ref(op["a_int"], logical, op["s_p"],
                                         op["deq"], **geo),
                None, _bytes_ops_ms(op["a_int"].numel() + rest, macs,
                                    INT8_OPS_PER_S)),
        }
        t = _time_calls(torch, calls, name, errs, reps)
        per_layer.append(t)
        print(f"  {name}: M={m} kt={kt} rows={kh * kw * cpa} N={n} "
              f"nibble={nibble}: " + "; ".join(_fmt(k, v)
                                                for k, v in t.items()),
              flush=True)
    return _sum_layers(per_layer)


def phase4_resnet20(torch, dev, errs):
    from repro_torch.api import pack_model
    from repro_torch.data.pipeline import make_image_dataset
    from repro_torch.models import resnet

    cim = paper_cim()
    cfg = resnet.ResNetConfig(name="resnet20-cifar10", depth=20, n_classes=10,
                              widths=(16, 32, 64), in_hw=32, cim=cim)
    n_convs = len(resnet.conv_layer_names(cfg))
    check(n_convs == 20, f"ResNet-20 has {n_convs} CIM convs, expected 20")
    x_all, _ = make_image_dataset(n_classes=10, hw=32,
                                  n=BATCH * (REQUESTS + 1), seed=0)
    batches = [torch.as_tensor(x_all[i * BATCH:(i + 1) * BATCH], device=dev)
               for i in range(REQUESTS + 1)]
    t0 = time.perf_counter()
    params, state = resnet.init(0, cfg)
    params = resnet.calibrate(params, state, batches[0], cfg)
    packed = {dt: pack_model(params, cim.replace(pack_dtype=dt))
              for dt in ("int8", "int4")}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    requests = batches[1:]
    want = [resnet.forward(params, state, xb, cfg, train=False)[0]
            for xb in requests]

    # the main path: only these deploy forwards may move the counters
    _reset_counters()
    got, ms = {}, {}
    for dt in ("int8", "int4"):
        got[dt], ms[dt] = [], []
        for xb in requests:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y, _ = resnet.forward(packed[dt], state, xb, dcfg, train=False)
            end.record()
            got[dt].append(y)
            ms[dt].append((start, end))
    torch.cuda.synchronize()
    counted, _ = _read_counters()
    forwards = 2 * len(requests)
    # K3 gathers its own patch rows: 20 implicit-GEMM launches a forward,
    # no matmul launch, no patch tensor
    launches = {"cim_conv": n_convs * forwards, "cim_matmul": 0,
                "plain_gathers": 0}
    for k, v in launches.items():
        check(counted[k] == v, f"{k}: {counted[k]} in {forwards} deploy "
              f"forwards, expected {v}")
    worst = 0.0
    for dt in ("int8", "int4"):
        for y, w in zip(got[dt], want):
            check(y.shape == (BATCH, 10) and bool(torch.isfinite(y).all()),
                  f"{dt} deploy logits: shape {tuple(y.shape)} or non-finite")
            worst = max(worst, float((y - w).abs().max()))
            check(bool(torch.allclose(y, w, **LOGIT_TOL)),
                  f"{dt} deploy logits vs emulate: max diff "
                  f"{float((y - w).abs().max())!r}")
        ms[dt] = [s.elapsed_time(e) for s, e in ms[dt]]
    print(f"phase 4 ResNet-20 (widths 16/32/64, 32x32, batch {BATCH}): set-up "
          f"(init, calibrate, 2 packs) {setup_s:.2f} s; {forwards} deploy "
          f"forwards; ms per batch int8 {[round(v, 3) for v in ms['int8']]}, "
          f"int4 {[round(v, 3) for v in ms['int4']]}; max |deploy - emulate| "
          f"{worst!r}; launches {counted} (cim_conv 20 x {forwards})",
          flush=True)

    # per-kernel times at the main path's shapes, outside the counted run
    timings = {}
    for dt in ("int8", "int4"):
        _, _, taps = resnet.forward(packed[dt], state, requests[0], dcfg,
                                    train=False, return_taps=True)
        print(f"phase 4 per-layer times, {dt} planes (graph replay "
              "[eager events]):", flush=True)
        tot = _time_layers(torch, cfg, packed[dt], taps, errs, reps=20)
        for k, t in tot.items():
            print(f"phase 4 {k} {dt}: {_fmt_total(t, '20 launches')}",
                  flush=True)
        if dt == "int8":
            timings.update(tot)
    for k, t in timings.items():
        t.update(launches=launches[k], library_ms=None)
    model = dict(cfg=cfg, cim=cim, params=params, state=state, packed=packed,
                 requests=requests)
    return timings, model


def phase5_resnet18(torch, dev) -> None:
    from repro_torch.api import pack_model
    from repro_torch.core.cim_conv import conv_deploy_operands
    from repro_torch.data.pipeline import make_image_dataset
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_conv import window_mode
    from repro_torch.models import resnet

    cim = paper_cim()
    cfg = resnet.ResNetConfig(name="resnet18", depth=18, n_classes=10,
                              in_hw=32, cim=cim)
    x, _ = make_image_dataset(n_classes=10, hw=32, n=128, seed=1)
    xc, xb = (torch.as_tensor(v, device=dev) for v in (x[:64], x[64:]))
    params, state = resnet.init(1, cfg)
    params = resnet.calibrate(params, state, xc, cfg)
    want, _ = resnet.forward(params, state, xb, cfg, train=False)
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    diffs, packed = {}, {}
    n_convs = len(resnet.conv_layer_names(cfg))
    for dt in ("int8", "int4"):
        packed[dt] = pack_model(params, cim.replace(pack_dtype=dt))
        _reset_counters()
        y, _ = resnet.forward(packed[dt], state, xb, dcfg, train=False)
        torch.cuda.synchronize()
        counted, _ = _read_counters()
        check(counted["cim_conv"] == n_convs and counted["cim_matmul"] == 0
              and counted["plain_gathers"] == 0,
              f"ResNet-18 {dt}: launches {counted}, expected {n_convs} "
              "cim_conv, no matmul launch and no patch gather")
        check(y.shape == (64, 10) and bool(torch.isfinite(y).all()),
              f"ResNet-18 {dt} logits: shape or non-finite")
        diffs[dt] = float((y - want).abs().max())
        check(bool(torch.allclose(y, want, **LOGIT_TOL)),
              f"ResNet-18 {dt} deploy vs emulate: max diff {diffs[dt]!r}")
    # which convs run K3 in window mode, which on its staged path (a
    # 128-row block's input window over 32 KB)
    _, _, taps = resnet.forward(packed["int8"], state, xb, dcfg, train=False,
                                return_taps=True)
    staged = []
    for name, stride in resnet.conv_layer_names(cfg):
        blk, layer = name.split(".")
        op = conv_deploy_operands(taps[name], packed["int8"][blk][layer], cim)
        s, kt, _, n = op["digits"].shape
        geo = ref.conv_geometry(op["a_int"].shape, op["kh"], op["kw"], stride,
                                "SAME", kt, op["c_per_array"])
        if not window_mode(geo, s, n):
            staged.append(f"{name} ({geo.h}x{geo.w}x{geo.c_in}, "
                          f"{geo.kh}x{geo.kw}/{stride})")
    print(f"phase 5 ResNet-18 (widths 64..512, 32x32, batch 64, k_tiles up "
          f"to 37): {n_convs} K3 launches a forward, no patch gather; max "
          f"|deploy - emulate| {diffs}; K3 on its staged path (no window "
          f"mode) for {len(staged)} of {n_convs} convs: "
          f"{', '.join(staged) or 'none'}", flush=True)


# ---------------------------------------------------------------------------
# phases 6-8
# ---------------------------------------------------------------------------

def _time_adc_free_layers(torch, model_cfg, packed, taps, errs, reps: int):
    """The ADC-free matmul and conv kernels at the operands the adc_free
    forward gave each CIM conv, beside their plain versions, their bounds
    and the one PyTorch call that computes the same function."""
    import torch.nn.functional as F

    from repro_torch.core.cim_conv import conv_deploy_operands
    from repro_torch.core.nibble import pack_nibbles, unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_adc_free import (cim_conv_adc_free_cuda,
                                                  cim_matmul_adc_free_cuda)
    from repro_torch.models.resnet import conv_layer_names

    per_layer = []
    for name, stride in conv_layer_names(model_cfg):
        blk, layer = name.split(".")
        op = conv_deploy_operands(taps[name], packed[blk][layer],
                                  model_cfg.cim)
        kh, kw, cpa = op["kh"], op["kw"], op["c_per_array"]
        nibble = op["digits"].dtype == torch.uint8
        logical = (unpack_nibbles(op["digits"], groups=kh * kw) if nibble
                   else op["digits"])
        s, kt, rows, n = logical.shape
        geo = dict(kh=kh, kw=kw, stride=stride, padding="SAME",
                   c_per_array=cpa)
        a_int = op["a_int"]
        patches = ref.extract_conv_patches(a_int, kh, kw, stride, "SAME", kt,
                                           cpa)
        b, ho, wo = patches.shape[:3]
        m = b * ho * wo
        a_t = patches.reshape(m, kt, rows)
        # the yardsticks: one float32 matmul / conv with the folded weight
        w = _folded_weight(torch, logical, op["deq"])
        a_f = a_t.reshape(m, kt * rows).to(torch.float32)
        c_in = a_int.shape[-1]
        w_conv = (w.reshape(kt, kh, kw, cpa, n).permute(4, 0, 3, 1, 2)
                  .reshape(n, kt * cpa, kh, kw)[:, :c_in].contiguous())
        (ph_lo, ph_hi), (pw_lo, pw_hi) = ref.conv_pads(
            a_int.shape[1], a_int.shape[2], kh, kw, stride, "SAME")
        x_nchw = F.pad(a_int.to(torch.float32).permute(0, 3, 1, 2),
                       (pw_lo, pw_hi, ph_lo, ph_hi)).contiguous()
        lib_mm = lambda: torch.matmul(a_f, w)                      # noqa: E731
        lib_conv = lambda: F.conv2d(x_nchw, w_conv, stride=stride)  # noqa: E731
        kern_conv = lambda: cim_conv_adc_free_cuda(               # noqa: E731
            a_int, op["digits"], op["deq"], op["occ"], **geo)
        got = kern_conv()
        yard = lib_conv().permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        scale = float(got.abs().max()) + 1.0
        check(float((yard - got).abs().max()) <= 1e-4 * scale,
              f"{name}: the folded-weight conv yardstick does not compute the "
              "ADC-free conv")
        rest = (op["digits"].numel()
                + (op["occ"].numel() if op["occ"] is not None else 0)
                + 4 * op["deq"].numel() + 4 * m * n)
        macs = _needed_macs(op, m)
        # the matmul takes nibble planes in one half-split block
        mm_digits = pack_nibbles(logical) if nibble else logical
        calls = {
            "cim_matmul_adc_free_resnet": (
                lambda: cim_matmul_adc_free_cuda(a_t, mm_digits, op["deq"],
                                                 op["occ"]),
                lambda: ref.cim_matmul_adc_free_ref(a_t, logical, op["deq"]),
                lib_mm, _bytes_ops_ms(a_t.numel() + rest, macs,
                                      INT8_OPS_PER_S)),
            "cim_conv_adc_free": (
                kern_conv,
                lambda: ref.cim_conv_adc_free_ref(a_int, logical, op["deq"],
                                                  **geo),
                lib_conv, _bytes_ops_ms(a_int.numel() + rest, macs,
                                        INT8_OPS_PER_S)),
        }
        t = _time_calls(torch, calls, name, errs, reps)
        per_layer.append(t)
        print(f"  {name}: M={m} kt={kt} rows={rows} N={n} nibble={nibble}: "
              + "; ".join(_fmt(k, v) for k, v in t.items()), flush=True)
    return _sum_layers(per_layer)


def phase6_adc_free(torch, model, errs):
    """The adc_free backend on the main path's packed ResNet-20."""
    from repro_torch.models import resnet

    cfg, cim, requests = model["cfg"], model["cim"], model["requests"]
    params, state, packed = model["params"], model["state"], model["packed"]
    acfg = dataclasses.replace(cfg, cim=cim.replace(mode="adc_free"))
    ecfg = dataclasses.replace(cfg, cim=cim.replace(psum_quant=False))
    want = [resnet.forward(params, state, xb, ecfg, train=False)[0]
            for xb in requests]
    torch.cuda.synchronize()

    _reset_counters()
    got, ms = {}, {}
    for dt in ("int8", "int4"):
        got[dt], ms[dt] = [], []
        for xb in requests:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got[dt].append(resnet.forward(packed[dt], state, xb, acfg,
                                          train=False)[0])
            end.record()
            ms[dt].append((start, end))
    torch.cuda.synchronize()
    launches, _ = _read_counters()
    forwards = 2 * len(requests)
    check(launches["cim_conv_adc_free"] == 20 * forwards,
          f"cim_conv_adc_free launched {launches['cim_conv_adc_free']} times "
          f"in {forwards} adc_free forwards, expected {20 * forwards}")
    # the implicit-GEMM conv gathers its own patch rows: no matmul launch,
    # no patch tensor
    for k in ("cim_matmul_adc_free", "plain_gathers", "cim_matmul",
              "cim_conv"):
        check(launches[k] == 0, f"{k}: {launches[k]} in the adc_free "
              "forwards, expected 0")
    worst = 0.0
    for dt in ("int8", "int4"):
        for y, w in zip(got[dt], want):
            check(y.shape == (BATCH, 10) and bool(torch.isfinite(y).all()),
                  f"adc_free {dt} logits: shape {tuple(y.shape)} or "
                  "non-finite")
            worst = max(worst, float((y - w).abs().max()))
            check(bool(torch.allclose(y, w, **LOGIT_TOL)),
                  f"adc_free {dt} logits vs emulate(psum_quant=False): max "
                  f"diff {float((y - w).abs().max())!r}")
        ms[dt] = [s.elapsed_time(e) for s, e in ms[dt]]
    print(f"phase 6 adc_free ResNet-20 (batch {BATCH}): {forwards} forwards; "
          f"ms per batch int8 {[round(v, 3) for v in ms['int8']]}, int4 "
          f"{[round(v, 3) for v in ms['int4']]}; max |adc_free - "
          f"emulate(psum_quant=False)| {worst!r}; launches {launches}",
          flush=True)

    timings = {}
    for dt in ("int8", "int4"):
        _, _, taps = resnet.forward(packed[dt], state, requests[0], acfg,
                                    train=False, return_taps=True)
        print(f"phase 6 per-layer times, {dt} planes (graph replay "
              "[eager events]):", flush=True)
        tot = _time_adc_free_layers(torch, acfg, packed[dt], taps, errs,
                                    reps=20)
        for k, t in tot.items():
            print(f"phase 6 {k} {dt}: {_fmt_total(t, '20 calls')}",
                  flush=True)
        if dt == "int8":
            timings.update(tot)
    # K4 on the materialized patches of the 20 convs, as first ported:
    # its own entry, launched by no path (the adc_free forward runs the
    # implicit conv); K4's path is the adc_free transformer (phase 10)
    timings["cim_conv_adc_free"]["launches"] = launches["cim_conv_adc_free"]
    timings["cim_matmul_adc_free_resnet"]["launches"] = 0
    return timings


def phase7_binary(torch, model) -> None:
    """The binary backend: ResNet-20 packed into S = 1 sign planes, its
    kernel forward against the same backend on the plain version."""
    from repro_torch.api import pack_model
    from repro_torch.models import resnet

    cfg, cim, requests = model["cfg"], model["cim"], model["requests"]
    state = model["state"]
    bcim = cim.replace(mode="binary")
    t0 = time.perf_counter()
    bpacked = pack_model(model["params"], bcim)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    check(all(bpacked[n.split(".")[0]][n.split(".")[1]]["w_digits"].shape[0]
              == 1 for n, _ in resnet.conv_layer_names(cfg)),
          "binary planes are not S = 1")
    bcfg = dataclasses.replace(cfg, cim=bcim)
    pcfg = dataclasses.replace(cfg, cim=bcim.replace(use_kernel=False))
    want = [resnet.forward(bpacked, state, xb, pcfg, train=False)[0]
            for xb in requests]
    torch.cuda.synchronize()

    _reset_counters()
    got = [resnet.forward(bpacked, state, xb, bcfg, train=False)[0]
           for xb in requests]
    torch.cuda.synchronize()
    launches, _ = _read_counters()
    for k, v in (("cim_conv", 20 * len(requests)), ("cim_matmul", 0),
                 ("plain_gathers", 0)):
        check(launches[k] == v, f"binary: {k} {launches[k]} in "
              f"{len(requests)} forwards, expected {v}")
    worst = 0.0
    for y, w in zip(got, want):
        check(y.shape == (BATCH, 10) and bool(torch.isfinite(y).all()),
              "binary logits: shape or non-finite")
        worst = max(worst, float((y - w).abs().max()))
        check(bool(torch.allclose(y, w, **LOGIT_TOL)),
              f"binary kernel logits vs plain: max diff {worst!r}")
    model["binary"] = (bpacked, bcfg)
    print(f"phase 7 binary ResNet-20 (batch {BATCH}): pack {pack_s:.2f} s; "
          f"{len(requests)} forwards; max |kernel - plain| {worst!r}; "
          f"launches {launches}", flush=True)


def phase8_variation(torch, model, errs):
    """Cell variation on the card: one realization against emulate, the
    Monte-Carlo sweep and the per-layer attribution, and the float-digit
    conv timed at the path's shapes."""
    from repro_torch.core.cim_conv import conv_deploy_operands
    from repro_torch.core.nibble import unpack_nibbles
    from repro_torch.core.variation import Sampler, perturb_digits
    from repro_torch.data.pipeline import make_image_dataset
    from repro_torch.eval.robustness import (monte_carlo_resnet,
                                             per_layer_attribution)
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.models import resnet

    cfg, cim, requests = model["cfg"], model["cim"], model["requests"]
    params, state = model["params"], model["state"]
    packed = model["packed"]["int8"]
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    acfg = dataclasses.replace(cfg, cim=cim.replace(mode="adc_free"))
    bpacked, bcfg = model["binary"]
    xb = requests[0]
    sampler = Sampler(0)

    # one realization: deploy on float planes against emulate, same fields
    want, _ = resnet.forward(params, state, xb, cfg, train=False,
                             variation=sampler, variation_std=SIGMA)
    clean, _ = resnet.forward(packed, state, xb, dcfg, train=False)
    torch.cuda.synchronize()
    _reset_counters()
    got, _ = resnet.forward(packed, state, xb, dcfg, train=False,
                            variation=sampler, variation_std=SIGMA)
    torch.cuda.synchronize()
    launches, floats = _read_counters()
    check(launches["cim_conv"] == 20 and floats["cim_conv"] == 20
          and launches["cim_matmul"] == 0 and launches["plain_gathers"] == 0,
          f"varied deploy forward: launches {launches}, on float planes "
          f"{floats}; expected 20 float-plane conv launches, no matmul "
          "launch and no patch gather")
    diff = float((got - want).abs().max())
    check(got.shape == (BATCH, 10) and bool(torch.isfinite(got).all()),
          "varied deploy logits: shape or non-finite")
    check(bool(torch.allclose(got, want, **LOGIT_TOL)),
          f"varied deploy vs emulate under the same fields: max diff {diff!r}")
    check(not torch.equal(got, clean), "sigma 0.3 left the logits clean")
    print(f"phase 8 variation, one realization at sigma {SIGMA} (batch "
          f"{BATCH}): max |deploy - emulate| {diff!r}; max |varied - clean| "
          f"{float((got - clean).abs().max())!r}; launches {launches}, on "
          f"float planes {floats}", flush=True)

    # the Monte-Carlo sweep and one point on each other packed backend
    x, y = make_image_dataset(n_classes=10, hw=32, n=BATCH, seed=3)
    t0 = time.perf_counter()
    sweep = monte_carlo_resnet(packed, state, dcfg, x, y, seed=0,
                               sigmas=SWEEP_SIGMAS, n_samples=SWEEP_SAMPLES,
                               batch=BATCH)
    sweep_s = time.perf_counter() - t0
    err = sweep.logit_err_mean
    check(bool(np.all(np.isfinite(sweep.logit_err))),
          "sweep: non-finite logit error")
    check(bool(np.all(np.diff(err) > 0)),
          f"sweep: mean logit error does not rise with sigma: {err.tolist()}")
    print(f"phase 8 Monte-Carlo sweep on deploy ({SWEEP_SAMPLES} samples x "
          f"{BATCH} images, {sweep_s:.2f} s): "
          + "; ".join(f"sigma {sg}: logit err {e:.6f}, acc {a:.4f}"
                      for sg, e, a in zip(sweep.sigmas, err, sweep.acc_mean))
          + " (random weights: the accuracy means nothing)", flush=True)
    for label, pk, c in (("adc_free", packed, acfg),
                         ("binary", bpacked, bcfg)):
        pt = monte_carlo_resnet(pk, state, c, x, y, seed=0, sigmas=(0.2,),
                                n_samples=1, batch=BATCH)
        e = float(pt.logit_err[0, 0])
        check(np.isfinite(e) and e > 0, f"{label} sweep point: error {e!r}")
        print(f"phase 8 sweep point on {label}: sigma 0.2 logit err {e:.6f}, "
              f"acc {pt.acc[0, 0]:.4f} (clean {pt.acc_clean:.4f}; random "
              "weights)", flush=True)

    attr = per_layer_attribution(packed, state, dcfg, xb, seed=0,
                                 sigma=SIGMA)
    check(len(attr) == 20 and all(np.isfinite(a.rel_err) and a.rel_err > 0
                                  for a in attr),
          f"attribution: {len(attr)} rows or a bad error")
    print(f"phase 8 per-layer attribution at sigma {SIGMA} (sample 0):",
          flush=True)
    for a in attr:
        print(f"  {a.name}: rel err {a.rel_err:.6f}, worst column "
              f"{a.worst_col} at {a.worst_col_err:.6f}, median "
              f"{a.median_col_err:.6f}", flush=True)

    # the float-digit conv at the path's shapes
    _, _, taps = resnet.forward(packed, state, xb, dcfg, train=False,
                                return_taps=True)
    per_layer = []
    for name, stride in resnet.conv_layer_names(cfg):
        blk, layer = name.split(".")
        op = conv_deploy_operands(taps[name], packed[blk][layer], cim)
        kh, kw, cpa = op["kh"], op["kw"], op["c_per_array"]
        digits = op["digits"]
        if digits.dtype == torch.uint8:
            digits = unpack_nibbles(digits, groups=kh * kw)
        s, kt, rows, n = digits.shape
        noisy = perturb_digits(digits, sampler.for_layer(name), SIGMA,
                               shape=(s, kt, kh, kw, cpa, n))
        geo = dict(kh=kh, kw=kw, stride=stride, padding="SAME",
                   c_per_array=cpa, psum_bits=cim.psum_bits)
        a_int = op["a_int"]
        m = a_int.shape[0] * (-(-a_int.shape[1] // stride)) * (
            -(-a_int.shape[2] // stride))
        nbytes = (a_int.numel() + 4 * noisy.numel()
                  + (op["occ"].numel() if op["occ"] is not None else 0)
                  + 4 * (op["s_p"].numel() + op["deq"].numel()) + 4 * m * n)
        calls = {"cim_conv_variation": (
            lambda: cim_conv_cuda(a_int, noisy, op["s_p"], op["deq"],
                                  op["occ"], **geo),
            lambda: ref.cim_conv_ref(a_int, noisy, op["s_p"], op["deq"],
                                     **geo),
            None, _bytes_ops_ms(nbytes, _needed_macs(op, m),
                                FP64_OPS_PER_S))}
        t = _time_calls(torch, calls, name, errs, reps=10)
        per_layer.append(t)
        print(f"  {name}: M={m} kt={kt} rows={rows} N={n}: "
              + _fmt("cim_conv_variation", t["cim_conv_variation"]),
              flush=True)
    tot = _sum_layers(per_layer)["cim_conv_variation"]
    tot["launches"] = floats["cim_conv"]
    print(f"phase 8 cim_conv_variation: "
          f"{_fmt_total(tot, '20 launches on float planes', 'FP64 ops')}",
          flush=True)
    return {"cim_conv_variation": tot}


# ---------------------------------------------------------------------------
# phases 9 and 10: the MoE experts kernel and the MoE serving path
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"
# (E, C, kt, rows, N, uint8 codes, nibble, occ, psum_bits, psum_quant)
EXPERTS_CASES = (
    (1, 64, 16, 128, 1408, False, False, False, 4, True),
    (8, 61, 16, 128, 1408, False, True, True, 6, True),
    (64, 48, 16, 128, 1408, True, True, True, 6, True),
    (64, 61, 11, 128, 2048, False, False, True, 1, True),
    (8, 5, 2, 126, 17, True, False, True, 8, True),
    (8, 33, 3, 128, 100, False, True, False, 4, False),
    (64, 7, 2, 64, 130, False, True, True, 8, True))


# (E, C, kt, rows, N, uint8 codes, nibble, occ, psum_bits, counts): an
# expert with no filled slot, one full (C), ragged ones; "decode": 48
# token-expert pairs over 64 experts, as a moonshot decode step
EXPERTS_COUNTS_CASES = (
    (64, 48, 16, 128, 1408, False, False, True, 6, "decode"),
    (8, 61, 11, 128, 2048, False, True, True, 1,
     (0, 61, 1, 17, 33, 48, 60, 5)),
    (8, 61, 16, 128, 1408, True, False, False, 4, (61,) * 8),
    (4, 5, 2, 126, 17, True, True, True, 8, (5, 0, 2, 3)))


def _experts_operands(torch, g, e, c, kt, rows, n, uns):
    """An MoE bank: codes (E, C, kt, rows) with expert 0's capacity buffer
    all zero rows, S = 2 planes with dead columns and a dead (split, tile)
    on expert 1: (a, logical d, nibble d, occ, s_p, deq)."""
    from repro_torch.core.nibble import occupancy_map, pack_nibbles
    if uns:
        a = torch.randint(0, 256, (e, c, kt, rows), generator=g,
                          dtype=torch.uint8)
    else:
        a = torch.randint(-128, 128, (e, c, kt, rows), generator=g,
                          dtype=torch.int8)
    a[0] = 0
    d = torch.randint(-3, 4, (e, 2, kt, rows, n), generator=g,
                      dtype=torch.int8)
    d[..., 3:9] = 0
    if e > 1:
        d[1, 1, 0] = 0
    amax = 255 if uns else 128
    s_p = 0.5 + torch.rand((e, 2, kt, n), generator=g) * amax * rows ** 0.5 / 8
    deq = torch.randn((e, 2, kt, n), generator=g) * 0.1
    return a, d, pack_nibbles(d), occupancy_map(d), s_p, deq


def phase9_experts_cases(torch, dev, errs) -> int:
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_matmul import (cim_matmul_cuda,
                                                cim_matmul_experts_cuda)

    g = torch.Generator().manual_seed(9)
    n_cases = 0
    for e, c, kt, rows, n, uns, nibble, sparse, pb, quant in EXPERTS_CASES:
        a, d, nib, occ, s_p, deq = (x.to(dev) for x in _experts_operands(
            torch, g, e, c, kt, rows, n, uns))
        digits = nib if nibble else d
        o = occ if sparse else None
        mq = dict(psum_bits=pb, psum_quant=quant)
        got = cim_matmul_experts_cuda(a, digits, s_p, deq, o, **mq)
        want = ref.cim_matmul_experts_ref(a, d, s_p, deq, **mq)
        loop = torch.stack([cim_matmul_cuda(a[i], digits[i], s_p[i], deq[i],
                                            None if o is None else o[i], **mq)
                            for i in range(e)])
        torch.cuda.synchronize()
        what = (f"E={e} C={c} kt={kt} rows={rows} N={n} uint8={uns} "
                f"nibble={nibble} occ={sparse} psum_bits={pb} quant={quant}")
        _compare(torch, got, want, "cim_matmul_experts", what, errs)
        check(torch.equal(got, loop), f"cim_matmul_experts {what}: differs "
              "from a per-expert loop of the matmul kernel")
        n_cases += 1

    # counts: each expert's filled capacity slots, a prefix of its buffer
    for (e, c, kt, rows, n, uns, nibble, sparse, pb,
         counts) in EXPERTS_COUNTS_CASES:
        a, d, nib, occ, s_p, deq = (x.to(dev) for x in _experts_operands(
            torch, g, e, c, kt, rows, n, uns))
        if counts == "decode":             # 48 pairs over the experts
            counts = torch.bincount(torch.randint(0, e, (48,), generator=g),
                                    minlength=e).clamp(max=c).tolist()
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        digits = nib if nibble else d
        o = occ if sparse else None
        got = cim_matmul_experts_cuda(a, digits, s_p, deq, o, psum_bits=pb,
                                      counts=cnt)
        full = cim_matmul_experts_cuda(a, digits, s_p, deq, o, psum_bits=pb)
        want = ref.cim_matmul_experts_ref(a, d, s_p, deq, psum_bits=pb,
                                          counts=cnt)
        a0 = a.clone()
        for j, cj in enumerate(counts):
            a0[j, cj:] = 0
        loop = torch.stack([cim_matmul_cuda(a0[i], digits[i], s_p[i],
                                            deq[i], None if o is None
                                            else o[i], psum_bits=pb)
                            for i in range(e)])
        torch.cuda.synchronize()
        what = (f"E={e} C={c} kt={kt} rows={rows} N={n} uint8={uns} "
                f"nibble={nibble} occ={sparse} psum_bits={pb} counts "
                f"{counts}")
        _compare(torch, got, want, "cim_matmul_experts", what, errs)
        check(torch.equal(got, loop), f"cim_matmul_experts {what}: differs "
              "from a per-expert loop of the matmul kernel on codes zeroed "
              "past the counts")
        check(all(torch.equal(got[j, :cj], full[j, :cj])
                  for j, cj in enumerate(counts)),
              f"cim_matmul_experts {what}: filled rows differ from the "
              "launch without counts")
        n_cases += 1
    return n_cases


def launcher_cim(**kw):
    """The serving launcher's CIM config (``repro_torch.launch.serve``, as
    ``src/repro/launch/serve.py``): 4-bit weights on 2-bit cells (S = 2),
    8-bit signed activations, 6-bit partial sums, 128x128 arrays,
    column-wise scales; ``kw`` replaces fields."""
    from repro_torch.launch.serve import launcher_cim as serving_cim
    return serving_cim().replace(**kw)


def moe_config(reduced: bool = False):
    """The MoE phase's model and traffic: the published config with its
    depth cut to 2 layers (1 dense + 1 MoE), batch 8 x 64-token prompts,
    16 new tokens; the slot engine at batch 2."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(MOE_ARCH, reduced=reduced, cim=launcher_cim())
    if not reduced:
        cfg = cfg.replace(n_layers=2)
    return dict(cfg=cfg, batch=8, prompt_len=64, new_tokens=16, max_len=128,
                requests=((5, 4), (3, 2), (4, 3)), reps=10)


def _slot_run(engine, prompts, requests):
    rids = [engine.submit(p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, requests)]
    done = {}
    for _ in range(64):
        for fin in engine.step():
            done[fin["rid"]] = list(fin["tokens"])
        if len(done) == len(rids):
            break
    return [done.get(r) for r in rids]


#: the kernel wrappers ``kernels.ops`` calls, by their names in the
#: results line
_OPS_WRAPPERS = {"cim_matmul_transformer": "cim_matmul_cuda",
                 "cim_conv_frontend": "cim_conv_cuda",
                 "cim_matmul_experts": "cim_matmul_experts_cuda",
                 "cim_matmul_adc_free": "cim_matmul_adc_free_cuda"}


def _capture_kernel_calls(fn):
    """Run ``fn`` and return the operands of every CIM matmul, CIM conv,
    experts and ADC-free matmul kernel call it made through
    ``kernels.ops``."""
    import repro_torch.kernels.ops as kops
    calls = {name: [] for name in _OPS_WRAPPERS}
    orig = {name: getattr(kops, w) for name, w in _OPS_WRAPPERS.items()}

    def rec(name, f):
        def wrapped(*a, **kw):
            calls[name].append((a, kw))
            return f(*a, **kw)
        return wrapped
    for name, w in _OPS_WRAPPERS.items():
        setattr(kops, w, rec(name, orig[name]))
    try:
        fn()
    finally:
        for name, w in _OPS_WRAPPERS.items():
            setattr(kops, w, orig[name])
    return calls


def _moe_bound(torch, a_t, digits, occ, s_p, deq, m_axis: int,
               counts=None, ops_per_s: float = INT8_OPS_PER_S):
    """(bytes ms, ops ms at ``ops_per_s``) of one call, from this run's
    data (``s_p`` None for the ADC-free matmul). The filled rows of an expert's buffer
    are its ``counts``, or without them its rows that are not all zero;
    the others (empty capacity slots) need no MACs and no code bytes; an
    expert with no filled row needs none of its planes.
    MACs: filled rows x rows per tile x live (split, tile, column) cells
    of the occupancy map. The output is written whole."""
    if m_axis == 0:                       # one matrix: add an expert axis
        a_t, digits, deq = (x[None] for x in (a_t, digits, deq))
        s_p, occ = (None if x is None else x[None] for x in (s_p, occ))
    e, c, kt, rows = a_t.shape
    n = digits.shape[-1]
    filled = ((a_t.reshape(e, c, -1) != 0).any(dim=-1).sum(dim=1)
              if counts is None else
              counts.to(torch.int64).clamp(0, c))                  # (E,)
    live = (occ.reshape(e, -1).sum(dim=1).to(torch.int64) if occ is not None
            else torch.full((e,), digits[0].shape[0] * kt * n,
                            device=a_t.device))
    used = filled > 0
    per_expert = (digits[0].numel() * digits.element_size()
                  + (occ[0].numel() if occ is not None else 0)
                  + 4 * (s_p[0].numel() if s_p is not None else 0)
                  + 4 * deq[0].numel())
    nbytes = (int(used.sum()) * per_expert + int(filled.sum()) * kt * rows
              + 4 * e * c * n)
    macs = int((filled * live).sum()) * rows
    return _bytes_ops_ms(nbytes, macs, ops_per_s)


def _time_captured_calls(torch, calls, errs, reps: int,
                         ops_per_s: float = INT8_OPS_PER_S):
    """Each captured call (``_capture_kernel_calls``: K1, K3, K6 or the
    ADC-free matmul) timed beside its plain version and its bound (the
    MACs at ``ops_per_s``: the FP64 rate for float32 planes), summed per
    kernel over the captured run."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_adc_free import cim_matmul_adc_free_cuda
    from repro_torch.kernels.cim_conv import cim_conv_cuda
    from repro_torch.kernels.cim_matmul import (cim_matmul_cuda,
                                                cim_matmul_experts_cuda,
                                                logical_digits)
    per_call = []
    for name, lst in calls.items():
        for a, kw in lst:
            if "kh" in kw:                       # K3
                a_t, digits, s_p, deq = a[:4]
                occ = a[4] if len(a) > 4 else kw.get("occ")
                ckw = {k: v for k, v in kw.items() if k != "occ"}
                logical = logical_digits(digits, kw["kh"] * kw["kw"])
                kern = (lambda a_t=a_t, d=digits, sp=s_p, dq=deq, o=occ,
                        ckw=ckw: cim_conv_cuda(a_t, d, sp, dq, o, **ckw))
                plain = (lambda a_t=a_t, d=logical, sp=s_p, dq=deq, ckw=ckw:
                         ref.cim_conv_ref(a_t, d, sp, dq, **ckw))
                per_call.append(_time_calls(
                    torch, {name: (kern, plain, None, _conv_bound(
                        torch, a_t, digits, occ, s_p, deq, ckw, ops_per_s))},
                    f"{name} {tuple(a_t.shape)}", errs, reps))
                continue
            if name == "cim_matmul_adc_free":
                a_t, digits, deq = a[:3]
                occ = a[3] if len(a) > 3 else kw.get("occ")
                logical = logical_digits(digits)
                kern = (lambda a_t=a_t, d=digits, dq=deq, o=occ:
                        cim_matmul_adc_free_cuda(a_t, d, dq, o))
                plain = (lambda a_t=a_t, d=logical, dq=deq:
                         ref.cim_matmul_adc_free_ref(a_t, d, dq))
                # the yardstick, as on ResNet-20 (phase 6): one float32
                # matmul with the split-folded weight
                lib = (lambda a_f=a_t.reshape(a_t.shape[0], -1).float(),
                       w=_folded_weight(torch, logical, deq):
                       torch.matmul(a_f, w))
                per_call.append(_time_calls(
                    torch, {name: (kern, plain, lib, _moe_bound(
                        torch, a_t, digits, occ, None, deq, 0))},
                    f"{name} {tuple(a_t.shape)}", errs, reps))
                continue
            a_t, digits, s_p, deq = a[:4]
            occ = a[4] if len(a) > 4 else kw.get("occ")
            mq = dict(psum_bits=kw["psum_bits"],
                      psum_quant=kw.get("psum_quant", True))
            logical = logical_digits(digits)
            if name == "cim_matmul_experts":
                cnt = kw.get("counts")
                kern = (lambda a_t=a_t, d=digits, sp=s_p, dq=deq, o=occ,
                        cnt=cnt: cim_matmul_experts_cuda(a_t, d, sp, dq, o,
                                                         counts=cnt, **mq))
                plain = (lambda a_t=a_t, d=logical, sp=s_p, dq=deq, cnt=cnt:
                         ref.cim_matmul_experts_ref(a_t, d, sp, dq,
                                                    counts=cnt, **mq))
                bound = _moe_bound(torch, a_t, digits, occ, s_p, deq, 1,
                                   cnt)
            else:
                kern = (lambda a_t=a_t, d=digits, sp=s_p, dq=deq, o=occ:
                        cim_matmul_cuda(a_t, d, sp, dq, o, **mq))
                # in blocks of 1024 rows, each output row being its own
                # codes' (the float64 partial sums of a whole llava d_ff
                # linear at 2560 rows would take 19 GB)
                plain = (lambda a_t=a_t, d=logical, sp=s_p, dq=deq: torch.cat(
                    [ref.cim_matmul_ref(a_t[i:i + 1024], d, sp, dq, **mq)
                     for i in range(0, a_t.shape[0], 1024)]))
                bound = _moe_bound(torch, a_t, digits, occ, s_p, deq, 0,
                                   ops_per_s=ops_per_s)
            per_call.append(_time_calls(
                torch, {name: (kern, plain, None, bound)},
                f"{name} {tuple(a_t.shape)}", errs, reps))
    return _sum_layers(per_call)


def phase10_moe_serving(torch, errs, mc):
    """The MoE serving path: moonshot-v1-16b-a3b, 4 layers, int8 and int4
    packs, deploy against emulate, through the serving entry points."""
    from repro_torch.api import model_artifact
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import ServingEngine, engine_from_artifact

    cfg = mc["cfg"]
    cim = cfg.cim
    model = get_model(cfg)
    b, tp, new, max_len = (mc["batch"], mc["prompt_len"], mc["new_tokens"],
                           mc["max_len"])
    n_dense = cfg.moe.n_dense_layers
    n_moe = cfg.n_layers - n_dense
    k6_fwd = 3 * n_moe
    k1_fwd = 7 * n_dense + (4 + 3 * bool(cfg.moe.n_shared)) * n_moe
    dev = torch.device("cuda")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model.specs(cfg), 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    arts, pack_s = {}, {}
    for dt in ("int8", "int4"):
        t0 = time.perf_counter()
        arts[dt] = model_artifact(params, cim.replace(pack_dtype=dt),
                                  meta={"arch": MOE_ARCH})
        torch.cuda.synchronize()
        pack_s[dt] = time.perf_counter() - t0
    n_banks = sum(k.endswith("_digits") and v.ndim == 6 for k, v in
                  arts["int8"].params["moe_layers"]["moe"].items())
    check(n_banks == 3 and arts["int8"].params["moe_layers"]["moe"][
        "wg_digits"].shape[:2] == (n_moe, cfg.moe.n_experts),
          f"MoE banks not packed per (layer, expert): {n_banks} banks")
    bank_bytes = {dt: sum(v.numel() for k, v in
                          arts[dt].params["moe_layers"]["moe"].items()
                          if k.endswith("_digits"))
                  for dt in arts}
    print(f"phase 10 {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"of {cfg.resolved_head_dim} (kv {cfg.n_kv_heads}), "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
          f"{cfg.moe.d_ff} + {cfg.moe.n_shared} shared, dense d_ff "
          f"{cfg.moe.dense_d_ff}, vocab {cfg.vocab}, {cfg.compute_dtype}; "
          f"reduced: n_layers 48 -> {cfg.n_layers} ({n_dense} dense + "
          f"{n_moe} MoE); init {init_s:.2f} s, pack int8 "
          f"{pack_s['int8']:.2f} s, int4 {pack_s['int4']:.2f} s; expert "
          f"planes int8 {bank_bytes['int8'] / 1e9:.3f} GB, int4 "
          f"{bank_bytes['int4'] / 1e9:.3f} GB; max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)

    g = torch.Generator().manual_seed(10)
    tokens = torch.randint(0, cfg.vocab, (b, tp), generator=g).to(dev)
    prompts = tokens.cpu().numpy().astype(np.int32)
    rng = np.random.default_rng(10)
    slot_prompts = [rng.integers(0, cfg.vocab, ln).astype(np.int32)
                    for ln, _ in mc["requests"]]

    # emulate: the reference the deploy path is held against
    t0 = time.perf_counter()
    em = model.forward(params, tokens, cfg)
    em_tokens = ServingEngine(model, cfg, params, batch_size=b,
                              max_len=max_len).generate_batch(prompts, new)
    em_slots = _slot_run(ServingEngine(model, cfg, params, batch_size=2,
                                       max_len=max_len), slot_prompts,
                         mc["requests"])
    torch.cuda.synchronize()
    em_s = time.perf_counter() - t0

    # the main path: only these deploy runs may move the counters; every
    # experts launch must be given its MoE block's counts
    _reset_counters()
    out, invocations = {}, 0
    with _CountsSeen() as seen:
        for dt in ("int8", "int4"):
            dcfg = cfg.replace(cim=arts[dt].config)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dp = model.forward(arts[dt].params, tokens, dcfg)
            end.record()
            eng = engine_from_artifact(arts[dt], cfg, batch_size=b,
                                       max_len=max_len)
            t0 = time.perf_counter()
            gen = eng.generate_batch(prompts, new)
            gen_s = time.perf_counter() - t0
            slot_eng = engine_from_artifact(arts[dt], cfg, batch_size=2,
                                            max_len=max_len)
            slots = _slot_run(slot_eng, slot_prompts, mc["requests"])
            torch.cuda.synchronize()
            invocations += 1 + eng.t + slot_eng.t
            out[dt] = dict(logits=dp, fwd_ms=start.elapsed_time(end), gen=gen,
                           gen_s=gen_s, slots=slots, slot_steps=slot_eng.t)
    launches, _ = _read_counters()
    check(launches["cim_matmul_experts"] == k6_fwd * invocations,
          f"experts kernel launched {launches['cim_matmul_experts']} times in "
          f"{invocations} forwards, expected {k6_fwd} per forward")
    check(launches["cim_matmul"] == k1_fwd * invocations,
          f"matmul kernel launched {launches['cim_matmul']} times in "
          f"{invocations} forwards, expected {k1_fwd} per forward")
    check(seen["calls"] == launches["cim_matmul_experts"]
          and seen["with_counts"] == seen["calls"],
          f"experts kernel: {seen['with_counts']} of {seen['calls']} calls "
          "given counts")
    scale = float(em.float().abs().max())
    for dt, r in out.items():
        y = r["logits"]
        check(y.shape == (b, tp, cfg.vocab) and bool(torch.isfinite(y).all()),
              f"{dt} deploy logits: shape {tuple(y.shape)} or non-finite")
        r["diff"] = float((y.float() - em.float()).abs().max())
        check(r["diff"] <= 1e-4 * scale, f"{dt} deploy vs emulate logits: "
              f"max diff {r['diff']!r} at max |logit| {scale!r}")
        check(r["gen"].shape == (b, new) and np.array_equal(r["gen"],
                                                            em_tokens),
              f"{dt} generate_batch tokens differ from emulate's")
        check([len(t or ()) for t in r["slots"]] == [n for _, n in
                                                     mc["requests"]]
              and r["slots"] == em_slots,
              f"{dt} slot engine: {r['slots']} against emulate {em_slots}")
    print(f"phase 10 main path: {invocations} deploy forwards (int8 and int4: "
          f"one prefill forward, generate_batch {b} x {tp} -> {new}, slot "
          f"engine 3 requests at batch 2 in {out['int8']['slot_steps']} "
          f"steps); launches {launches} = experts {k6_fwd}, matmul {k1_fwd} "
          f"per forward; max |deploy - emulate| int8 {out['int8']['diff']!r}, "
          f"int4 {out['int4']['diff']!r} (max |logit| {scale!r}); served "
          f"tokens equal emulate's; every experts launch given its block's "
          f"counts ({seen['filled']} filled slots in all); emulate "
          f"reference runs {em_s:.2f} s", flush=True)

    # the adc_free backend on the same packs: the ADC-free matmul on every
    # CIM linear (expert banks one linear per expert), its own counted run
    k4 = phase10_adc_free(torch, errs, mc, model, params, arts, tokens,
                          k1_fwd + k6_fwd * cfg.moe.n_experts)

    # prefill and decode times, outside the counted run (after a warm-up
    # forward: the adc_free phase freed the kept relaid planes)
    timing = {}
    for dt in ("int8", "int4"):
        p, dcfg = arts[dt].params, cfg.replace(cim=arts[dt].config)
        model.forward(p, tokens, dcfg)
        cache = model.init_cache(cfg, b, max_len)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * new)]
        ev[0].record()
        logits, cache = model.decode_step(p, cache, tokens, dcfg)
        ev[1].record()
        tok = torch.argmax(logits[:, -1:].float(), dim=-1).to(torch.int32)
        for i in range(1, new):
            ev[2 * i].record()
            logits, cache = model.decode_step(p, cache, tok, dcfg)
            ev[2 * i + 1].record()
            tok = torch.argmax(logits[:, -1:].float(), dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        steps = [ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(new)]
        timing[dt] = dict(prefill=steps[0], decode=float(np.median(steps[1:])))
        print(f"phase 10 {dt}: prefill forward (forward) "
              f"{out[dt]['fwd_ms']:.2f} ms, prefill through the cache "
              f"{steps[0]:.2f} ms, decode {timing[dt]['decode']:.2f} ms per "
              f"step (median of {new - 1}; min {min(steps[1:]):.2f}, max "
              f"{max(steps[1:]):.2f}); generate_batch {out[dt]['gen_s']:.3f} "
              f"s = {b * new / out[dt]['gen_s']:.1f} tokens/s", flush=True)
        same, replay_ms, eager_ms = _graph_decode(
            torch, model, dcfg, p, lambda: model.init_cache(cfg, b, max_len),
            tokens, new - 1)
        check(same, f"{dt}: the decode step replayed from a CUDA graph "
              "differs from the eager steps (logits, tokens or caches)")
        print(f"phase 10 {dt}: one decode step captured in a CUDA graph, "
              f"replayed {new - 1} times: the first step's logits, the "
              f"tokens and the caches bit-equal to the eager steps'; "
              f"{replay_ms:.2f} ms per step by replay (median; eager "
              f"{eager_ms:.2f} ms in the same loop)", flush=True)
    past = _graph_decode_overrun(torch, model, cfg, arts["int8"], tokens, b,
                                 room=2, steps=5)
    print(f"phase 10 int8: a decode step captured in a CUDA graph in a cache "
          f"with room for 2 new positions, replayed 5 times ({past} past "
          f"max_len): no device error; the caches (K, V, lengths) equal the "
          f"same steps run eagerly through the layer path (the write clamped "
          f"as the reference's), and so do the tokens", flush=True)

    # both kernels at the operands of one prefill forward and one decode step
    results = {}
    for dt in ("int8", "int4"):
        p, dcfg = arts[dt].params, cfg.replace(cim=arts[dt].config)
        for what, fn in (
                ("prefill", lambda: model.forward(p, tokens, dcfg)),
                ("decode", lambda: model.decode_step(
                    p, model.init_cache(cfg, b, max_len), tokens[:, :1],
                    dcfg))):
            calls = _capture_kernel_calls(fn)
            check(len(calls["cim_matmul_experts"]) == k6_fwd
                  and len(calls["cim_matmul_transformer"]) == k1_fwd
                  and not calls["cim_matmul_adc_free"]
                  and all(kw.get("counts") is not None
                          for _, kw in calls["cim_matmul_experts"]),
                  f"{dt} {what}: captured "
                  f"{({k: len(v) for k, v in calls.items()})}, or an experts "
                  "call without counts")
            tot = _time_captured_calls(torch, calls, errs, mc["reps"])
            for k, t in tot.items():
                print(f"phase 10 {k} {dt} {what}: "
                      f"{_fmt_total(t, f'{len(calls[k])} launches')}",
                      flush=True)
            if dt == "int8" and what == "prefill":
                results = tot
    for k, t in results.items():
        t.update(launches=launches["cim_matmul" if k == "cim_matmul_transformer"
                                   else k])
    results["cim_matmul_adc_free"] = k4
    mc["served"] = dict(model=model, params=params, arts=arts, tokens=tokens,
                        prompts=prompts, slot_prompts=slot_prompts,
                        gen=out["int8"]["gen"])
    print(f"phase 10 max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    return results


class _CountsSeen:
    """Within: counts the experts-kernel calls made through ``kernels.ops``
    and those given ``counts``, and sums the filled slots (read after the
    run; the calls themselves sync nothing)."""

    def __enter__(self):
        import repro_torch.kernels.ops as kops
        self.kops, self.orig = kops, kops.cim_matmul_experts_cuda
        self.counts = []
        self.seen = {"calls": 0, "with_counts": 0, "filled": 0}

        def spy(*a, **kw):
            self.seen["calls"] += 1
            if kw.get("counts") is not None:
                self.seen["with_counts"] += 1
                self.counts.append(kw["counts"].sum())
            return self.orig(*a, **kw)
        kops.cim_matmul_experts_cuda = spy
        return self.seen

    def __exit__(self, *exc):
        self.kops.cim_matmul_experts_cuda = self.orig
        self.seen["filled"] = int(sum(int(c) for c in self.counts))
        return False


def _graph_decode(torch, model, dcfg, params, new_cache, tokens, steps):
    """A deploy decode step of any family captured in a CUDA graph after
    the prompt and replayed ``steps`` times (each replay's token fed to
    the next; lengths the step returns copied back into the cache), against
    the same steps run eagerly from the same prompt: (the first step's
    logits, every step's tokens and the final caches all bit-equal, median
    ms per replayed step, median ms per eager step). ``new_cache()`` makes
    a fresh cache (whisper's with its encoder states). The warm-up's
    writes to the recurrent states are undone before the capture."""
    from repro_torch import tree_leaves, tree_map

    def copy_back(dst, src):
        """src's leaves into dst's where they are other tensors (a step
        returns its caches as they are, and new lengths)."""
        tree_map(lambda d, s: d is s or d.copy_(s), dst, src)

    def argmax(logits):
        return torch.argmax(logits[:, -1:].float(), dim=-1).to(torch.int32)

    def prompt():
        cache = new_cache()
        logits, cache = model.decode_step(params, cache, tokens, dcfg)
        return argmax(logits), cache

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        return out, (start, end)

    tok, cache = prompt()
    eager, ev_e, first = [], [], None
    for _ in range(steps):
        (logits, cache), ev = timed(
            lambda tok=tok, cache=cache: model.decode_step(params, cache, tok,
                                                           dcfg))
        if first is None:
            first = logits.clone()
        tok = argmax(logits)
        eager.append(tok)
        ev_e.append(ev)
    eager_cache = cache

    tok, cache = prompt()
    static = tok.clone()
    snap = tree_map(lambda t: t.clone(), cache)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        model.decode_step(params, cache, static, dcfg)
        copy_back(cache, snap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, out_cache = model.decode_step(params, cache, static, dcfg)
        nxt = argmax(logits)
    replayed, ev_g, first_g = [], [], None
    for _ in range(steps):
        _, ev = timed(graph.replay)
        if first_g is None:
            first_g = logits.clone()
        copy_back(cache, out_cache)
        static.copy_(nxt)
        replayed.append(nxt.clone())
        ev_g.append(ev)
    torch.cuda.synchronize()
    same = (torch.equal(first, first_g)
            and all(torch.equal(x, y) for x, y in zip(replayed, eager))
            and all(torch.equal(x, y) for x, y in zip(
                tree_leaves(cache), tree_leaves(eager_cache))))
    ms = [float(np.median([s.elapsed_time(e) for s, e in evs]))
          for evs in (ev_g, ev_e)]
    del graph
    return same, ms[0], ms[1]


def _graph_decode_overrun(torch, model, cfg, art, tokens, b, room, steps):
    """A deploy decode step captured in a CUDA graph after the prompt, in a
    cache of max_len = prompt + ``room``, replayed ``steps`` times, the
    lengths copied back and each replay's token fed to the next, so the
    lengths pass max_len. Against the same steps run eagerly: through
    ``decode_step`` while they fit, then through ``_decode_step``, below
    its host check (the layer path, whose write clamps as the
    reference's). Checks that the
    card reports no error, that every replay's token equals the eager
    step's, and that the caches equal bit for bit; returns the number of
    steps past max_len."""
    from repro_torch.models import transformer

    p, dcfg = art.params, cfg.replace(cim=art.config)
    max_len = tokens.shape[1] + room

    def prompt():
        cache = model.init_cache(cfg, b, max_len)
        logits, cache = model.decode_step(p, cache, tokens, dcfg)
        return (torch.argmax(logits[:, -1:].float(), dim=-1).to(torch.int32),
                cache)

    tok, eager = prompt()
    eager_toks = []
    for i in range(steps):
        step = transformer.decode_step if i < room else \
            transformer._decode_step
        logits, eager = step(p, eager, tok, dcfg)
        tok = torch.argmax(logits[:, -1:].float(), dim=-1).to(torch.int32)
        eager_toks.append(tok)

    tok, cache = prompt()
    static = tok.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        lens = {k: v["len"].clone() for k, v in cache.items()}
        model.decode_step(p, cache, static, dcfg)
        for k, v in cache.items():
            v["len"].copy_(lens[k])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, out_cache = model.decode_step(p, cache, static, dcfg)
        nxt = torch.argmax(logits[:, -1:].float(), dim=-1).to(torch.int32)
    replayed = []
    for _ in range(steps):
        graph.replay()
        for k, v in cache.items():
            v["len"].copy_(out_cache[k]["len"])
        static.copy_(nxt)
        replayed.append(nxt.clone())
    torch.cuda.synchronize()               # a device-side fault raises here
    del graph
    check(all(torch.equal(x, y) for x, y in zip(replayed, eager_toks)),
          "decode replayed past max_len: tokens differ from the eager steps")
    for k, v in cache.items():
        for f in ("k", "v", "len"):
            check(torch.equal(v[f], eager[k][f]), f"decode replayed past "
                  f"max_len: cache {k}.{f} differs from the eager steps'")
    check(int(cache[next(iter(cache))]["len"].max()) == max_len - room
          + steps, "decode replayed past max_len: lengths not advanced")
    return steps - room


def phase10_adc_free(torch, errs, mc, model, params, arts, tokens,
                     k4_fwd: int):
    """One prefill forward of the MoE transformer on the ``adc_free``
    backend per pack dtype, against emulate with ``psum_quant=False``;
    the counters read ``k4_fwd`` ADC-free matmul launches per forward and
    no other kernel. Then the ADC-free matmul at the operands of one
    prefill forward and one decode step, each call against its plain
    version, timed beside it, its bound and the folded-weight matmul,
    and the forward's calls with
    the planes relaid on every call against relaid once. Returns the
    int8 prefill sums with the counted launches."""
    from repro_torch.kernels.relaid import clear_relaid_planes

    cfg, b, max_len = mc["cfg"], mc["batch"], mc["max_len"]
    em = model.forward(params, tokens,
                       cfg.replace(cim=cfg.cim.replace(psum_quant=False)))
    torch.cuda.synchronize()
    _reset_counters()
    got, ms = {}, {}
    for dt in ("int8", "int4"):
        acfg = cfg.replace(cim=arts[dt].config.replace(mode="adc_free"))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got[dt] = model.forward(arts[dt].params, tokens, acfg)
        end.record()
        ms[dt] = (start, end)
    torch.cuda.synchronize()
    launches, _ = _read_counters()
    check(launches["cim_matmul_adc_free"] == 2 * k4_fwd,
          f"adc_free transformer: ADC-free matmul launched "
          f"{launches['cim_matmul_adc_free']} times in 2 forwards, expected "
          f"{k4_fwd} per forward")
    check(all(v == 0 for k, v in launches.items()
              if k != "cim_matmul_adc_free"),
          f"adc_free transformer: other launches {launches}")
    scale = float(em.float().abs().max())
    diffs = {}
    for dt, y in got.items():
        check(y.shape == em.shape and bool(torch.isfinite(y).all()),
              f"adc_free {dt} transformer logits: shape or non-finite")
        diffs[dt] = float((y.float() - em.float()).abs().max())
        check(diffs[dt] <= 1e-4 * scale, f"adc_free {dt} transformer vs "
              f"emulate(psum_quant=False): max diff {diffs[dt]!r} at max "
              f"|logit| {scale!r}")
    print(f"phase 10 adc_free: prefill forward int8 "
          f"{ms['int8'][0].elapsed_time(ms['int8'][1]):.2f} ms, int4 "
          f"{ms['int4'][0].elapsed_time(ms['int4'][1]):.2f} ms (first "
          f"forward: planes relaid); {launches['cim_matmul_adc_free']} "
          f"ADC-free matmul launches = {k4_fwd} per forward; max |adc_free - "
          f"emulate(psum_quant=False)| {diffs} (max |logit| {scale!r})",
          flush=True)

    k4 = None
    for dt in ("int8", "int4"):
        p = arts[dt].params
        acfg = cfg.replace(cim=arts[dt].config.replace(mode="adc_free"))
        for what, fn in (
                ("prefill", lambda: model.forward(p, tokens, acfg)),
                ("decode", lambda: model.decode_step(
                    p, model.init_cache(cfg, b, max_len), tokens[:, :1],
                    acfg))):
            calls = _capture_kernel_calls(fn)
            lst = calls.pop("cim_matmul_adc_free")
            check(len(lst) == k4_fwd and not any(calls.values()),
                  f"adc_free {dt} {what}: captured {len(lst)} ADC-free "
                  f"matmul calls, expected {k4_fwd}, and "
                  f"{({k: len(v) for k, v in calls.items()})} others")
            tot = _time_captured_calls(torch, {"cim_matmul_adc_free": lst}, errs,
                                  mc["reps"])["cim_matmul_adc_free"]
            every, once = _relayout_ms(torch, lst)
            print(f"phase 10 cim_matmul_adc_free {dt} {what}: "
                  f"{_fmt_total(tot, f'{len(lst)} launches')}; the forward's "
                  f"calls by graph replay: planes relaid on every call "
                  f"{every:.4f} ms, relaid once {once:.4f} ms", flush=True)
            if dt == "int8" and what == "prefill":
                k4 = tot
        before = torch.cuda.memory_allocated()
        clear_relaid_planes()
        print(f"phase 10 adc_free {dt}: relaid planes kept "
              f"{(before - torch.cuda.memory_allocated()) / 1e9:.3f} GB "
              f"(freed)", flush=True)
    k4["launches"] = launches["cim_matmul_adc_free"]
    return k4


def _relayout_ms(torch, calls):
    """Device time of the captured ADC-free matmul calls, all in one CUDA
    graph: (planes relaid by every call, as when nothing is kept; planes
    relaid once and kept)."""
    from repro_torch.kernels.cim_adc_free import cim_matmul_adc_free_cuda
    from repro_torch.kernels.relaid import clear_relaid_planes

    def run():
        for a, kw in calls:
            cim_matmul_adc_free_cuda(*a, **kw)
    once = _graph_ms(torch, run, 1)        # its warm-up keeps the planes
    clear_relaid_planes()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):          # nothing kept: each call relays
        run()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    every = start.elapsed_time(end)
    del graph
    run()                                  # keep the planes again
    return every, once


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

def _trees_bit_equal(torch, got, want, path=""):
    """Two trees of tensors equal in structure, dtype, shape and bits."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want),
              f"{path or '<root>'}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _trees_bit_equal(torch, got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{path}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            _trees_bit_equal(torch, g, w, f"{path}/{i}")
        return
    check(got.dtype == want.dtype and got.shape == want.shape
          and got.device == want.device, f"{path}: {got.dtype} "
          f"{tuple(got.shape)} {got.device} != {want.dtype} "
          f"{tuple(want.shape)} {want.device}")
    check(bool(torch.equal(got, want)), f"{path}: values differ")


def qat_run(torch, qat, data, dev, on_step, deterministic: bool = True):
    """Phase 11's QAT run on ``data``: ResNet-20 at the paper's widths
    16/32/64 at 32x32 under ``paper_cim()``, ``QAT_STEPS`` steps at batch
    ``QAT_BATCH``, lr ``QAT_LR`` cosine, seed 0. Returns ``train_qat``'s
    result and the wall seconds.

    ``deterministic`` runs it on cuDNN's deterministic conv algorithms.
    The default ones sum in no fixed order, so the same seed takes another
    trajectory on every run; at lr 0.05 the harness's LSQ scales grow
    without bound, in the JAX package's harness too (ROADMAP fault 8), and
    some trajectories go non-finite. The deterministic algorithms give the
    same losses on every run."""
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    if deterministic:
        cudnn.deterministic, cudnn.benchmark = True, False
    t0 = time.perf_counter()
    try:
        out = qat.train_qat(paper_cim(), steps=QAT_STEPS, batch=QAT_BATCH,
                            lr=QAT_LR, seed=0, data=data, widths=(16, 32, 64),
                            hw=32, device=dev, on_step=on_step)
        torch.cuda.synchronize()
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    return out, time.perf_counter() - t0


def phase11_qat(torch, dev, smi):
    """train -> checkpoint -> pack -> save -> load -> serve, at full width.
    Returns what phase 17 serves column-parallel: the saved artifacts'
    paths, the config, the BN state and the images (on the host)."""
    import shutil
    from repro_torch.api import DeployArtifact, model_artifact
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import resnet
    from repro_torch.train import qat

    work = ROOT / "build" / "chip_smoke_qat"
    shutil.rmtree(work, ignore_errors=True)
    cim = paper_cim()
    data = qat._data(seed=0, n=QAT_IMAGES, hw=32)
    (xtr, _), (xte, _) = data
    mgr = CheckpointManager(str(work / "ckpt"), keep_n=2, async_save=True)
    saved = {}
    events = []

    def on_step(it, params, state, mom):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if it + 1 == QAT_CKPT_STEP:
            saved.update(params=params, state=state, mom=mom)
            mgr.save(QAT_CKPT_STEP, saved)

    out, wall_s = qat_run(torch, qat, data, dev, on_step)
    step_ms = sorted(events[i - 1].elapsed_time(events[i])
                     for i in range(10, len(events)))
    losses = np.asarray(out["losses"])
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print(f"phase 11 QAT ResNet-20 (widths 16/32/64, 32x32, paper CIFAR-10 "
          f"settings, column-wise W/psum; {len(xtr)} training and "
          f"{len(xte)} held-out images): {QAT_STEPS} steps at batch "
          f"{QAT_BATCH}, lr {QAT_LR} cosine: {wall_s:.2f} s with calibration "
          f"and evaluation; ms per step (CUDA events, steps 10-{QAT_STEPS}) "
          f"median {step_ms[len(step_ms) // 2]:.3f}, min {step_ms[0]:.3f}, "
          f"max {step_ms[-1]:.3f}; mean loss first 20 {first:.4f}, last 20 "
          f"{last:.4f} (ratio {last / first:.4f}); held-out accuracy "
          f"{out['acc']:.4f}; nvidia-smi: {smi}", flush=True)
    check(bool(np.all(np.isfinite(losses))), "QAT losses are not finite")
    check(last <= QAT_LOSS_RATIO * first,
          f"QAT loss fell to {last / first:.4f} x, expected at most "
          f"{QAT_LOSS_RATIO}")
    check(out["acc"] >= QAT_MIN_ACC, f"held-out accuracy {out['acc']:.4f} "
          f"below {QAT_MIN_ACC}")

    # the checkpoint of step 150, restored bit for bit
    mgr.wait()
    check(mgr.latest_step() == QAT_CKPT_STEP, "no checkpoint of step "
          f"{QAT_CKPT_STEP}")
    restored = mgr.restore(saved, step=QAT_CKPT_STEP, device=dev)
    _trees_bit_equal(torch, restored, saved)

    # pack, save, load: each loaded tree equals the packed one
    params, state, cfg = out["params"], out["state"], out["cfg"]
    loaded, io_s = {}, {}
    for dt in ("int8", "int4"):
        art = model_artifact(params, cim.replace(pack_dtype=dt))
        torch.cuda.synchronize()
        path = str(work / f"artifact_{dt}")
        t0 = time.perf_counter()
        art.save(path)
        t1 = time.perf_counter()
        loaded[dt] = DeployArtifact.load(path)
        torch.cuda.synchronize()
        io_s[dt] = (t1 - t0, time.perf_counter() - t1)
        check(loaded[dt].config == art.config
              and loaded[dt].meta == art.meta, f"{dt} artifact header")
        _trees_bit_equal(torch, loaded[dt].params, art.params, dt)

    # deploy of the loaded artifacts against emulate of the trained params
    xb = torch.as_tensor(xte[:BATCH], device=dev)
    want, _ = resnet.forward(params, state, xb, cfg, train=False)
    n_convs = len(resnet.conv_layer_names(cfg))
    _reset_counters()
    got = {dt: resnet.forward(a.params, state, xb, dataclasses.replace(
        cfg, cim=a.config), train=False)[0] for dt, a in loaded.items()}
    torch.cuda.synchronize()
    counted, _ = _read_counters()
    launches = {"cim_conv": n_convs * len(got), "cim_matmul": 0,
                "plain_gathers": 0}
    for k, v in launches.items():
        check(counted[k] == v, f"phase 11 {k}: {counted[k]} in {len(got)} "
              f"deploy forwards of the loaded artifacts, expected {v}")
    worst = 0.0
    for dt, y in got.items():
        check(y.shape == (BATCH, 10) and bool(torch.isfinite(y).all()),
              f"{dt} loaded-artifact logits: shape or non-finite")
        worst = max(worst, float((y - want).abs().max()))
        check(bool(torch.allclose(y, want, **LOGIT_TOL)),
              f"{dt} loaded-artifact deploy vs emulate: max diff "
              f"{float((y - want).abs().max())!r}")
    print(f"phase 11 checkpoint of step {QAT_CKPT_STEP} restored bit for bit "
          f"(params, BN state, momentum); artifacts saved / loaded in "
          + ", ".join(f"{dt} {s:.3f} / {l:.3f} s" for dt, (s, l)
                      in io_s.items())
          + f" (leaves equal in dtype and bits); deploy of the loaded "
          f"artifacts at batch {BATCH}: launches {counted} (cim_conv 20 x "
          f"{len(got)}); max |deploy - emulate| {worst!r}; nvidia-smi: {smi}",
          flush=True)
    shutil.rmtree(work / "ckpt", ignore_errors=True)
    return dict(paths={dt: str(work / f"artifact_{dt}") for dt in loaded},
                cfg=cfg, state=_host(state), xb=xb.cpu())


def _host(tree):
    from repro_torch import tree_map
    return tree_map(lambda v: v.detach().cpu() if hasattr(v, "detach")
                    else v, tree)


# ---------------------------------------------------------------------------
# phase 12: drift, recalibration, the health monitor and the telemetry plane
# ---------------------------------------------------------------------------

#: the drift of tests/test_drift.py::_sched: read noise, per-cell and
#: per-column drift, served from request count DRIFT_T0
DRIFT_SCHED = dict(read_sigma=0.02, read_rate=0.0, cell_rate=2e-4,
                   col_rate=1e-3)
DRIFT_T0 = 300
DRIFT_SEED = 12
COL_T = 400                       # (c): column-only drift, sigma_col 0.4
RECAL_PROBES = 64
RECAL_GATE = 0.34                 # recalibrated error / drifted error, below
FALLBACK_REQUESTS = ((3, 2), (2, 2))
ADC_EVERY_N = 4
SWEEP_DRIFT = dict(cell_rate=2e-4, col_rate=1e-3)
SWEEP_TS = (0, 64, 128, 256, 512)


def _packed_nodes(tree, path=()):
    """(path, node) of every node of a packed tree that holds
    ``w_digits``: the nodes ``drift_tree`` perturbs."""
    if isinstance(tree, dict):
        if "w_digits" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _packed_nodes(v, path + (k,))


def _at(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def _logical_shape(planes):
    shape = tuple(planes.shape)
    if planes.dtype == __import__("torch").uint8:        # nibble pairs
        shape = shape[:-2] + (2 * shape[-2], shape[-1])
    return shape


class _SlicedSource:
    """Layer ``i``'s slice of the drift fields of a stacked packed node
    (logical planes ``full``, a leading layer axis): the emulate forward
    of layer ``i`` asks for (S, kt, rows, N) fields, and gets the slices
    of the fields that ``drift_tree`` draws over the whole stacked
    planes. ``memo`` keeps one step's draws."""

    def __init__(self, source, full, i, memo, key):
        self.source, self.full, self.i = source, full, i
        self.memo, self.key = memo, key

    def _get(self, what, draw):
        k = (self.key, what)
        if k not in self.memo:
            self.memo[k] = draw()
        return self.memo[k][self.i]

    def read(self, shape, t, device=None):
        return self._get(("read", int(t)),
                         lambda: self.source.read(self.full, t, device))

    def cell(self, shape, device=None):
        return self._get(("cell",), lambda: self.source.cell(self.full,
                                                             device))

    def col(self, shape, device=None):
        from repro_torch.core.variation import _column_field_shape
        return self._get(("col",), lambda: self.source.col(
            _column_field_shape(self.full), device))


class _NodeCalls:
    """Within: every CIM forward on a node listed in ``by_weight``
    ({(data_ptr, shape) of its weight leaf: value}) calls ``hit(value,
    kwargs, x)`` first: the linears (``nn.linear._linear_forward``) and
    the convs (``api.conv2d``, which ``models.layers.apply_conv`` calls).
    The model's layers slice stacked nodes with views, so a layer's
    weight is known by its address."""

    def __init__(self, by_weight, leaf, hit):
        self.by_weight, self.leaf, self.hit = by_weight, leaf, hit
        self.hits = 0

    def _wrap(self, orig):
        def fwd(x, params, cim, **kw):
            w = params.get(self.leaf)
            v = None if w is None else self.by_weight.get(
                (w.data_ptr(), tuple(w.shape)))
            if v is not None:
                self.hits += 1
                self.hit(v, kw, x)
            return orig(x, params, cim, **kw)
        return fwd

    def __enter__(self):
        import repro_torch.api as api
        import repro_torch.nn.linear as nn_linear
        self.saved = ((nn_linear, "_linear_forward",
                       nn_linear._linear_forward),
                      (api, "conv2d", api.conv2d))
        for mod, name, orig in self.saved:
            setattr(mod, name, self._wrap(orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)
        return False


def _by_layer(node_leaf):
    """{(data_ptr, shape): i} for each layer slice of a stacked leaf (one
    entry for an unstacked one)."""
    if node_leaf.ndim in (3, 5, 7):         # stacked: a leading layer axis
        return {(node_leaf[i].data_ptr(), tuple(node_leaf.shape[1:])): i
                for i in range(node_leaf.shape[0])}
    return {(node_leaf.data_ptr(), tuple(node_leaf.shape)): None}


def _drifted_emulate(packed, params, source, state, memo):
    """A ``_NodeCalls`` under which the emulate forward of ``params``
    evaluates every CIM linear and conv whose packed node drifts under
    that node's drift fields at ``state`` (the same fields
    ``drift_tree(packed, source, state)`` draws), and leaves the rest (the
    MoE banks) clean."""
    by_w = {}
    for path, node in _packed_nodes(packed):
        src = source.for_layer(path)
        full = _logical_shape(node["w_digits"])
        for k, i in _by_layer(_at(params, path)["w"]).items():
            by_w[k] = (src if i is None else
                       _SlicedSource(src, full, i, memo, path))

    def hit(src, kw, x):
        kw.update(variation=src, variation_std=state)
    return _NodeCalls(by_w, "w", hit)


def _step_events(torch):
    return [torch.cuda.Event(enable_timing=True) for _ in range(3)]


def _time_float_k1(torch, calls, errs, reps: int):
    """The float-plane K1 calls of one captured forward, each against its
    plain version and timed, with its FP64 bound, summed over the
    forward."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cim_matmul import cim_matmul_cuda
    per_call = []
    for a, kw in calls:
        a_t, digits, s_p, deq = a[:4]
        occ = a[4] if len(a) > 4 else kw.get("occ")
        check(digits.dtype == torch.float32, "a drifted linear's K1 call did "
              f"not get float32 planes: {digits.dtype}")
        mq = dict(psum_bits=kw["psum_bits"],
                  psum_quant=kw.get("psum_quant", True))
        per_call.append(_time_calls(torch, {"cim_matmul_drift": (
            lambda a_t=a_t, d=digits, sp=s_p, dq=deq, o=occ:
            cim_matmul_cuda(a_t, d, sp, dq, o, **mq),
            lambda a_t=a_t, d=digits, sp=s_p, dq=deq:
            ref.cim_matmul_ref(a_t, d, sp, dq, **mq),
            None, _moe_bound(torch, a_t, digits, occ, s_p, deq, 0,
                             ops_per_s=FP64_OPS_PER_S))},
            f"cim_matmul_drift {tuple(a_t.shape)}", errs, reps))
    return _sum_layers(per_call)["cim_matmul_drift"]


def _node_inputs(torch, model, packed, tokens, dcfg):
    """{(path, layer or None): input} of every drifting CIM linear (a
    node holding ``w_digits``, sliced per layer) in one prefill forward of
    ``packed``."""
    by_w = {}
    for path, node in _packed_nodes(packed):
        for k, i in _by_layer(node["w_digits"]).items():
            by_w[k] = (path, i)
    inputs = {}
    with _NodeCalls(by_w, "w_digits",
                    lambda v, kw, x: inputs.setdefault(v, x)):
        model.forward(packed, tokens, dcfg)
    return inputs


def _node_slice(tree, path, i):
    node = _at(tree, path)
    return node if i is None else {k: v[i] for k, v in node.items()}


def _calibrated(torch, model, packed, params, tokens, dcfg, calibrate):
    """``packed`` with every drifting node's s_a and s_p calibrated on its
    input in one prefill forward (``calibrate``, from the emulate params
    ``params`` of the same node); everything else shared."""
    out = {}

    def copy(tree, path=()):
        if isinstance(tree, dict):
            if "w_digits" in tree:
                return {k: (v.clone() if k in ("s_a", "s_p") else v)
                        for k, v in tree.items()}
            return {k: copy(v, path + (k,)) for k, v in tree.items()}
        return tree
    out = copy(packed)
    for (path, i), x in _node_inputs(torch, model, packed, tokens,
                                     dcfg).items():
        emu = _node_slice(params, path, i)
        c = calibrate(x, {k: emu[k] for k in ("w", "s_w", "s_p", "s_a")},
                      dcfg.cim)
        node = _at(out, path)
        for k in ("s_a", "s_p"):
            if i is None:
                node[k] = c[k].to(node[k].dtype)
            else:
                node[k][i] = c[k].to(node[k].dtype)
    return out


def phase12_drift(torch, errs, mc, resnet20):
    """Self-healing serving and the telemetry plane on the card, on phase
    10's moonshot packs: (a) a zero schedule, (b) the drifting engine
    against drifted emulate, the float-plane K1 held and timed at its
    path's operands, (c) column drift recalibrated, (d) hard drift and
    the fallback, (e) the ADC collector armed, (f) the metrics, (g) the
    ResNet-20 drift sweep."""
    import math

    from repro_torch.api import linear as api_linear
    from repro_torch.core.variation import DriftSchedule, Sampler, drift_tree
    from repro_torch.data.pipeline import make_image_dataset
    from repro_torch.eval.recalibrate import apply_scale_delta_params
    from repro_torch.eval.robustness import monte_carlo_resnet
    from repro_torch.obs import adc
    from repro_torch.obs import names as M
    from repro_torch.obs.metrics import _sanitize
    from repro_torch.serve.engine import ServingEngine, engine_from_artifact
    from repro_torch.serve.health import DriftMonitor, HealthConfig

    sv = mc.pop("served")
    model, params, arts, tokens = (sv["model"], sv["params"], sv["arts"],
                                   sv["tokens"])
    cfg = mc["cfg"]
    b, new, max_len = mc["batch"], mc["new_tokens"], mc["max_len"]
    prompts = sv["prompts"]
    steps = new + 1                       # one prefill, `new` decode steps
    n_dense = cfg.moe.n_dense_layers
    n_moe = cfg.n_layers - n_dense
    k6_fwd = 3 * n_moe
    k1_fwd = 7 * n_dense + 7 * n_moe
    sched = DriftSchedule(**DRIFT_SCHED)
    source = Sampler(DRIFT_SEED)
    dcfg = {dt: cfg.replace(cim=a.config) for dt, a in arts.items()}
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    def engine(dt, **kw):
        return engine_from_artifact(arts[dt], cfg, batch_size=b,
                                    max_len=max_len, **kw)

    # (a) a zero schedule serves phase 10's tokens
    zero = engine("int8", drift_key=source, drift_schedule=DriftSchedule())
    check(np.array_equal(zero.generate_batch(prompts, new), sv["gen"]),
          "12a: a zero drift schedule changed phase 10's tokens")
    print(f"phase 12a zero drift schedule: generate_batch {b} x "
          f"{prompts.shape[1]} -> {new} equals phase 10's tokens",
          flush=True)

    # (b) drifted deploy against drifted emulate, step by step, from t0
    memo, worst, scale_max, ref_tokens = {}, 0.0, 0.0, []
    cache_d = model.init_cache(cfg, b, max_len)
    cache_e = model.init_cache(cfg, b, max_len)
    tok = tokens
    for i in range(steps):
        st = sched.at(DRIFT_T0 + i)
        lg_d, cache_d = model.decode_step(drift_tree(
            arts["int8"].params, source, st), cache_d, tok, dcfg["int8"])
        memo.clear()
        with _drifted_emulate(arts["int8"].params, params, source, st,
                              memo) as em:
            lg_e, cache_e = model.decode_step(params, cache_e, tok, cfg)
        check(em.hits == k1_fwd, f"12b: drifted emulate step {i} drifted "
              f"{em.hits} linears, expected {k1_fwd}")
        scale = float(lg_e.float().abs().max())
        diff = float((lg_d.float() - lg_e.float()).abs().max())
        check(lg_d.shape == lg_e.shape and bool(torch.isfinite(lg_d).all())
              and diff <= 1e-4 * scale, f"12b: drifted deploy vs drifted "
              f"emulate at step {i} (t {DRIFT_T0 + i}): max diff {diff!r} at "
              f"max |logit| {scale!r}")
        worst, scale_max = max(worst, diff), max(scale_max, scale)
        if i == 0:
            lg0_drift = lg_d
        tok = torch.argmax(lg_d[:, -1:].float(), dim=-1).to(torch.int32)
        ref_tokens.append(tok)
    memo.clear()
    del cache_d, cache_e
    ref_tokens = torch.cat(ref_tokens, dim=1).cpu().numpy()

    # the drifting engine: the main path of this phase, counted
    runs, launched, engines = {}, {}, {}
    for dt, tag in (("int8", "int8"), ("int4", "int4"), ("int8", "again")):
        # the monitor watches and never trips (a trip would serve the
        # fallback): this run is the drifted path
        eng = engine(dt, drift_key=source, drift_schedule=sched,
                     health=DriftMonitor(HealthConfig(
                         hard_threshold=float("inf"))))
        eng.t = DRIFT_T0
        torch.cuda.synchronize()
        _reset_counters()
        runs[tag] = eng.generate_batch(prompts, steps)
        torch.cuda.synchronize()
        launched[tag] = _read_counters()
        engines[tag] = eng
    for tag, (ln, fl) in launched.items():
        check(fl["cim_matmul"] == k1_fwd * steps
              and ln["cim_matmul"] == fl["cim_matmul"]
              and ln["cim_matmul_experts"] == k6_fwd * steps,
              f"12b {tag}: launches {ln}, on float planes {fl}, in {steps} "
              f"drifted forwards; expected {k1_fwd} float-plane K1, 0 "
              f"integer K1 and {k6_fwd} K6 per forward")
        check(np.array_equal(runs[tag], ref_tokens),
              f"12b {tag}: the drifting engine's tokens differ from the "
              "step-by-step drifted deploy's")
    lg_c, _ = model.decode_step(arts["int8"].params,
                                model.init_cache(cfg, b, max_len), tokens,
                                dcfg["int8"])
    moved = float((lg_c.float() - lg0_drift.float()).abs().max())
    check(moved > 0, "12b: the drift left the prefill logits clean")
    del lg_c, lg0_drift
    print(f"phase 12b drifting engine (Sampler({DRIFT_SEED}), "
          f"{DRIFT_SCHED}, from t {DRIFT_T0}; one prefill + {new} decode "
          f"steps): per step, drifted deploy logits vs drifted emulate "
          f"(same fields, {k1_fwd} drifted linears a forward) max diff "
          f"{worst!r} at max |logit| {scale_max!r} (the prefill's moved "
          f"{moved!r} from clean); engine tokens equal the "
          f"step-by-step run's on int8 and int4, and again on a second "
          f"engine; launches per run {launched['int8'][0]}, on float planes "
          f"{launched['int8'][1]} ({k1_fwd} float-plane K1 and {k6_fwd} K6 "
          f"per forward, 0 integer K1; the MoE banks do not drift, as the "
          f"reference's drift_tree)", flush=True)

    # the drifted decode step, eager: CUDA events and the host clock, and
    # the share of it spent drawing the drift (drift_tree)
    p8 = arts["int8"].params
    cache = model.init_cache(cfg, b, max_len)
    _, cache = model.decode_step(p8, cache, tokens, dcfg["int8"])
    tok = torch.from_numpy(ref_tokens[:, :1]).to(tokens.device)
    dev_ms, drift_ms, host_ms = [], [], []
    for i in range(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = _step_events(torch)
        ev[0].record()
        pd = drift_tree(p8, source, sched.at(DRIFT_T0 + 1 + i))
        ev[1].record()
        lg, cache = model.decode_step(pd, cache, tok, dcfg["int8"])
        tok = torch.argmax(lg[:, -1:].float(), dim=-1).to(torch.int32)
        ev[2].record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        dev_ms.append(ev[0].elapsed_time(ev[2]))
        drift_ms.append(ev[0].elapsed_time(ev[1]))
        del pd
    step_ms, d_ms = float(np.median(dev_ms)), float(np.median(drift_ms))
    print(f"phase 12b drifted decode step (int8, batch {b}, eager): "
          f"{step_ms:.2f} ms by CUDA events (median of {new}; min "
          f"{min(dev_ms):.2f}, max {max(dev_ms):.2f}), {np.median(host_ms):.2f}"
          f" ms by the host clock; drift_tree {d_ms:.2f} ms of it "
          f"({d_ms / step_ms:.3f})", flush=True)
    del cache

    # the float-plane K1 at the operands of one drifted prefill and one
    # drifted decode step
    results = {}
    for dt in ("int8", "int4"):
        pd = drift_tree(arts[dt].params, source, sched.at(DRIFT_T0))
        for what, fn in (
                ("prefill", lambda: model.forward(pd, tokens, dcfg[dt])),
                ("decode", lambda: model.decode_step(
                    pd, model.init_cache(cfg, b, max_len), tokens[:, :1],
                    dcfg[dt]))):
            calls = _capture_kernel_calls(fn)
            check(len(calls["cim_matmul_transformer"]) == k1_fwd
                  and len(calls["cim_matmul_experts"]) == k6_fwd,
                  f"12b {dt} {what}: captured "
                  f"{({k: len(v) for k, v in calls.items()})}")
            tot = _time_float_k1(torch, calls["cim_matmul_transformer"],
                                 errs, mc["reps"])
            print(f"phase 12b cim_matmul_drift {dt} {what}: "
                  f"{_fmt_total(tot, f'{k1_fwd} launches', 'FP64 ops')}",
                  flush=True)
            if dt == "int8" and what == "prefill":
                results["cim_matmul_drift"] = tot
        del pd
    results["cim_matmul_drift"]["launches"] = launched["int8"][1][
        "cim_matmul"]
    print(f"phase 12b max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (the "
          f"float-plane K1 writes its planes as float64 per launch)",
          flush=True)

    # (f) the metrics of the counted int8 engine
    eng = engines["int8"]
    m = eng.metrics()
    text = json.dumps(m)
    names = {_sanitize(v) for k, v in vars(M).items() if k.isupper()}
    typed = {ln.split()[2] for ln in eng.registry.to_prometheus().splitlines()
             if ln.startswith("# TYPE")}
    snap = m["metrics"]
    check(snap["counters"][M.TOKENS_GENERATED] == b * steps
          and m["throughput"]["tokens_generated"] == b * steps,
          f"12f: token counter {snap['counters'][M.TOKENS_GENERATED]}, "
          f"{b * steps} tokens emitted")
    check(snap["histograms"][M.DECODE_STEP_SECONDS]["count"] == new
          and snap["histograms"][M.PREFILL_SECONDS]["count"] == 1,
          f"12f: decode histogram {snap['histograms']}, {new} steps")
    check(typed and typed <= names, f"12f: Prometheus names {typed} not "
          f"all among {sorted(names)}")
    print(f"phase 12f metrics(): {len(text)} bytes of JSON; tokens "
          f"{snap['counters'][M.TOKENS_GENERATED]}, decode steps "
          f"{snap['histograms'][M.DECODE_STEP_SECONDS]['count']} (p50 "
          f"{snap['histograms'][M.DECODE_STEP_SECONDS]['p50'] * 1e3:.2f} ms), "
          f"{m['throughput']['tokens_per_sec']:.1f} tokens/s in decode; "
          f"health score {m['health']['score']:.3f}, drifted "
          f"{m['health']['drifted']}; Prometheus metrics {sorted(typed)}",
          flush=True)
    del engines, eng

    # (c) column-only drift at t 400, recalibrated in place. The random
    # init's scales are not calibrated (s_p 8, s_a 1: the 6-bit ADC sees a
    # few levels), and there the ADC's re-rounding of the drifted partial
    # sums sets the error floor. The gate is the reference's, which holds
    # a calibrated linear: each drifting node's s_a and s_p are calibrated
    # on its input in one prefill (the paper's one-batch calibration,
    # ``_calibrate_linear``); the planes do not change. The same delta on
    # the uncalibrated pack is printed beside it.
    from repro_torch.core.cim_linear import _calibrate_linear
    csched = DriftSchedule(col_rate=DRIFT_SCHED["col_rate"])
    csource = Sampler(DRIFT_SEED + 1)
    st = csched.at(COL_T)
    uncal = arts["int8"].params
    cal = _calibrated(torch, model, uncal, params, tokens, dcfg["int8"],
                      _calibrate_linear)
    ceng = engine_from_artifact(dataclasses.replace(arts["int8"], params=cal),
                                cfg, batch_size=b, max_len=max_len,
                                drift_key=csource, drift_schedule=csched)
    ceng.t = COL_T
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    delta = ceng.recalibrate(probes=RECAL_PROBES)
    torch.cuda.synchronize()
    recal_s = time.perf_counter() - t0
    ratios, lerr = {}, {}
    for label, pristine, recal_params in (
            ("calibrated", ceng.params_clean(), ceng.params),
            ("uncalibrated", uncal, apply_scale_delta_params(uncal, delta))):
        inputs = _node_inputs(torch, model, pristine, tokens, dcfg["int8"])
        check(len(inputs) == k1_fwd, f"12c: {len(inputs)} drifting linears "
              "seen in a prefill")
        drifted = drift_tree(pristine, csource, st)
        recal = drift_tree(recal_params, csource, st)
        ratios[label] = []
        for (path, i), x in inputs.items():
            ys = [api_linear(x, _node_slice(tree, path, i),
                             arts["int8"].config, compute_dtype=torch.float32)
                  for tree in (pristine, drifted, recal)]
            e_d = float(torch.linalg.norm((ys[1] - ys[0]).double()))
            e_r = float(torch.linalg.norm((ys[2] - ys[0]).double()))
            ratios[label].append(e_r / e_d)
            if label == "calibrated":
                check(e_r < RECAL_GATE * e_d, f"12c: {'/'.join(path)}[{i}] "
                      f"recalibrated error {e_r!r} not under {RECAL_GATE} x "
                      f"the drifted {e_d!r}")
        lg0 = model.forward(pristine, tokens, dcfg["int8"]).double()
        lerr[label] = [float(torch.linalg.norm(
            model.forward(tree, tokens, dcfg["int8"]).double() - lg0))
            / float(torch.linalg.norm(lg0)) for tree in (drifted, recal)]
        del inputs, drifted, recal, lg0
    print(f"phase 12c column drift (sigma_col {COL_T * csched.col_rate}, t "
          f"{COL_T}): recalibrate(probes={RECAL_PROBES}) in {recal_s:.3f} s, "
          f"{len(delta.gains)} nodes; at one prefill's activations, per "
          f"drifted linear (layer slice), recalibrated / drifted output "
          f"error " + "; ".join(
              f"{k} {min(v):.4f}-{max(v):.4f} (model logit error "
              f"{lerr[k][0]:.6f} drifted, {lerr[k][1]:.6f} recalibrated)"
              for k, v in ratios.items())
          + f"; gate {RECAL_GATE} on the calibrated scales", flush=True)
    del ceng, cal

    # (d) hard drift: the monitor trips, the fallback serves the ref
    # backend on the pristine planes, recalibrate() clears it
    heng = engine_from_artifact(
        arts["int8"], cfg, batch_size=2, max_len=max_len, drift_key=source,
        drift_schedule=sched, health=DriftMonitor(HealthConfig(
            warmup=2, soft_threshold=0.0, hard_threshold=0.0)))
    heng.t = DRIFT_T0
    heng.generate_batch(prompts[:2], 6)
    h = heng.health()
    check(h["fallback_active"] and h["hard_events"] >= 1,
          f"12d: hard drift did not trip the fallback: {h}")
    tripped_at = h["drifted_at"]
    slot_prompts = sv["slot_prompts"][:len(FALLBACK_REQUESTS)]
    first_span = len(heng.tracer.spans)
    torch.cuda.synchronize()
    _reset_counters()
    fb = _slot_run(heng, slot_prompts, FALLBACK_REQUESTS)
    torch.cuda.synchronize()
    fb_launches, _ = _read_counters()
    check(not any(fb_launches.values()), f"12d: fallback steps launched "
          f"CIM kernels: {fb_launches}")
    fb_ms = [1e3 * sp.duration for sp in heng.tracer.spans[first_span:]
             if sp.name == "serve.decode.step"]
    ref_eng = ServingEngine(model, cfg.replace(
        cim=arts["int8"].config.replace(mode="ref")), arts["int8"].params,
        batch_size=2, max_len=max_len)
    ref_slots = _slot_run(ref_eng, slot_prompts, FALLBACK_REQUESTS)
    check(fb == ref_slots and all(fb), f"12d: fallback tokens {fb} against a "
          f"ref-backend engine's {ref_slots}")
    heng.recalibrate()
    h = heng.health()
    check(not h["fallback_active"] and h["recalibrations"] == 1,
          f"12d: recalibrate() left {h}")
    print(f"phase 12d hard drift (HealthConfig warmup 2, thresholds 0): "
          f"fallback active after step {tripped_at}; the slot engine "
          f"on the fallback ({len(FALLBACK_REQUESTS)} requests): launches "
          f"{fb_launches}, tokens equal a ref-backend engine's on the "
          f"pristine planes; a fallback decode step {np.median(fb_ms):.2f} "
          f"ms (host clock, median of {len(fb_ms)}); recalibrate() cleared "
          f"it, recalibrations {h['recalibrations']}", flush=True)
    del heng, ref_eng

    # (e) the ADC collector armed on one clean prefill
    p8, c8 = arts["int8"].params, dcfg["int8"]
    ev = _step_events(torch)
    ev[0].record()
    y_off = model.forward(p8, tokens, c8)
    ev[1].record()
    torch.cuda.synchronize()
    off_ms = ev[0].elapsed_time(ev[1])
    _reset_counters()
    with adc.sampled(every_n=1):
        ev = _step_events(torch)
        ev[0].record()
        y_on = model.forward(p8, tokens, c8)
        ev[1].record()
        s_on = adc.summary()
        torch.cuda.synchronize()
        on_ms = ev[0].elapsed_time(ev[1])
    armed, _ = _read_counters()
    per_expert = k1_fwd + k6_fwd * cfg.moe.n_experts
    check(torch.equal(y_on, y_off), "12e: armed deploy logits differ from "
          "the disarmed ones")
    check(armed["cim_matmul_experts"] == 0
          and armed["cim_matmul"] == per_expert
          and s_on["kernel_invocations"] == per_expert,
          f"12e: armed launches {armed}, collector {s_on}; expected 0 K6 "
          f"and {per_expert} K1 (one per expert)")
    with adc.sampled(every_n=1):
        model.forward(params, tokens, cfg)
        s_em = adc.summary()
    check((s_em["saturated"], s_em["conversions"])
          == (s_on["saturated"], s_on["conversions"]),
          f"12e: deploy's ADC counts {s_on} against emulate's exact "
          f"counters {s_em}")
    with adc.sampled(every_n=ADC_EVERY_N):
        model.forward(p8, tokens, c8)
        s_n = adc.summary()
    check(s_n["kernel_invocations"] == per_expert
          and s_n["samples_folded"] == math.ceil(per_expert / ADC_EVERY_N),
          f"12e: every_n {ADC_EVERY_N} folded {s_n}")
    print(f"phase 12e ADC collector armed (every_n 1) on a clean prefill: "
          f"logits bit-equal to disarmed; launches {armed} (per expert, as "
          f"the reference); deploy (saturated, conversions) "
          f"({s_on['saturated']}, {s_on['conversions']}) = emulate's exact "
          f"counters, clip rate {s_on['clip_rate']:.6f}, worst column "
          f"{s_on['worst_col_rate']:.4f}; every_n {ADC_EVERY_N} folded "
          f"{s_n['samples_folded']} of {s_n['kernel_invocations']}; armed "
          f"forward {on_ms:.2f} ms against {off_ms:.2f} disarmed (CUDA "
          f"events)", flush=True)
    del y_on, y_off

    # (g) the ResNet-20 drift sweep at full width, int8
    rcfg = dataclasses.replace(resnet20["cfg"],
                               cim=resnet20["cim"].replace(mode="deploy"))
    x, y = make_image_dataset(n_classes=10, hw=32, n=BATCH, seed=3)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    sweep = monte_carlo_resnet(resnet20["packed"], resnet20["state"], rcfg,
                               x, y, seed=0, n_samples=SWEEP_SAMPLES,
                               batch=BATCH,
                               drift_schedule=DriftSchedule(**SWEEP_DRIFT),
                               drift_ts=SWEEP_TS)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    ln, fl = _read_counters()
    n_fwd = SWEEP_SAMPLES * len(SWEEP_TS)
    err = sweep.logit_err
    check(bool(np.all(np.isfinite(err)))
          and bool(np.all(np.diff(err, axis=0) >= 0)),
          f"12g: a sample's logit error falls with t: {err.tolist()}")
    check(fl["cim_conv"] == 20 * n_fwd and ln["cim_conv"] == 20 * n_fwd + 20
          and ln["plain_gathers"] == 0,
          f"12g: launches {ln}, on float planes {fl}; expected 20 "
          f"float-plane K3 per drifted forward ({n_fwd}) and 20 clean")
    print(f"phase 12g ResNet-20 drift sweep ({SWEEP_DRIFT}, t {SWEEP_TS}, "
          f"{SWEEP_SAMPLES} samples x {BATCH} images, int8) in "
          f"{sweep_s:.2f} s: mean logit error "
          + ", ".join(f"t {int(t)}: {e:.6f}" for t, e in
                      zip(sweep.sigmas, err.mean(axis=1)))
          + f"; launches {ln}, on float planes {fl} (20 float-plane K3 per "
          f"drifted forward)", flush=True)
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s; max memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 13: the dense and MLA transformers of the zoo at published widths
# ---------------------------------------------------------------------------

#: (results-line entry or None, registry entry, cut, K1 launches per
#: forward, KV cache dtypes served). deepseek-v3-671b keeps its three
#: leading dense layers (``moe=None``: d_ff equals dense_d_ff, so the stack
#: computes exactly those layers; one MoE layer at published widths is
#: 11.3 G weights, which do not fit one card beside emulate); llama3-8b is
#: cut to 4 of 32 layers and serves both its KV caches (the int8 one is
#: the ``flash_kv8`` variant of ``src/repro/launch/perf.py:68``); qwen3-0.6b
#: is cut to 8 of 28 layers (phase 17 serves it uncut). K1 per forward: MLA's 5 CIM linears and the MLP's 3 a layer,
#: GQA's 4 and 3.
ZOO_CASES = (
    ("cim_matmul_mla", "deepseek-v3-671b", dict(n_layers=1, moe=None), 8,
     ("bf16",)),
    ("cim_matmul_llama3", "llama3-8b", dict(n_layers=2), 7,
     ("bf16", "int8")),
    (None, "qwen3-0.6b", dict(n_layers=2), 7, ("bf16",)),
)


def zoo_config(arch: str, cut, reduced: bool = False):
    """The model and traffic of phases 13 and 14 for ``arch``: the
    published config with ``cut`` and the serving launcher's CIM config (at
    ``reduced``, the entry's reduced config with the cut's fields other
    than the depths), phase 10's traffic: 8 prompts of 64 tokens, 16 new
    tokens, max_len 128; the slot engine at batch 2 on 3 requests."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch, reduced=reduced, cim=launcher_cim())
    cfg = cfg.replace(**{k: v for k, v in cut.items()
                         if not (reduced and k in ("n_layers", "enc_layers"))})
    return dict(cfg=cfg, batch=8, prompt_len=64, new_tokens=16, max_len=128,
                requests=((5, 4), (3, 2), (4, 3)), reps=10)


def _cache_bytes(cache) -> int:
    return sum(v.numel() * v.element_size() for c in cache.values()
               for v in c.values())


def phase13_zoo(torch, errs, reduced: bool = False):
    """Each of ``ZOO_CASES`` served through the entry points; returns the
    results-line sums (one decode step's K1 calls, int8) by entry."""
    results = {}
    for entry, arch, cut, k1_layer, kv_dtypes in ZOO_CASES:
        zc = zoo_config(arch, cut, reduced)
        k1 = k1_layer * zc["cfg"].n_layers
        r = _zoo_serving(torch, errs, zc, entry or "cim_matmul_" + arch[:5],
                         ((k1, 0), k1), kv_dtypes=kv_dtypes,
                         keep=None if reduced else _KEEP.get(arch))
        if entry is not None:
            results[entry] = dict(r["cim_matmul"]["decode"],
                                  launches=r["launches"]["cim_matmul"])
        gc.collect()
        torch.cuda.empty_cache()
    return results


def _zoo_serving(torch, errs, zc, k1_name, counts, dtypes=("int8", "int4"),
                 kv_dtypes=("bf16",), frontend_batch_size=None, phase=13,
                 keep=None):
    """One zoo model (phases 13 and 14): random weights from seed 0 on the
    card, packed at ``dtypes``; the deploy forward (with the front-end
    input, over ``frontend_batch_size`` prompts where the family has one)
    against emulate; the served tokens against emulate's per KV cache
    dtype: ``generate_batch`` (whisper: a lockstep run through the
    engine's prefill and decode-step functions, its encoder states in the
    cache, as the reference's example serves it) and the slot engine; the
    launch counters against ``counts`` = ((K1, K3) per forward, K1 per
    decode invocation), no other kernel and no patch gather in torch;
    prefill and decode times, eager and replayed from a CUDA graph (the
    replay bit-equal to the eager steps); every K1 (``k1_name``) and K3
    (``cim_conv_frontend``) call of one prefill forward and of one decode
    step after the prompt against its plain version, timed beside it and
    its bound; peak memory. Returns the int8 pack's sums,
    {"cim_matmul" or "cim_conv": {"prefill" or "decode": sums}}, and the
    counted ``launches``. With ``keep`` (``_KEEP``'s functions), the int8
    pack is saved with what phase 17 holds its mesh runs against."""
    from repro_torch.api import model_artifact
    from repro_torch.kernels.relaid import clear_relaid_planes
    from repro_torch.models import whisper
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import (ServingEngine, engine_from_artifact,
                                          make_decode_step, make_prefill)

    t_model = time.perf_counter()
    cfg = zc["cfg"]
    model = get_model(cfg)
    b, tp, new, max_len = (zc["batch"], zc["prompt_len"], zc["new_tokens"],
                           zc["max_len"])
    arch, fam, tag = cfg.name, cfg.family, f"phase {phase}"
    (k1_fwd, k3_fwd), k1_step = counts
    for k in (k1_name, "cim_conv_frontend"):
        errs.setdefault(k, 0.0)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model.specs(cfg), 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    arts, pack_s = {}, {}
    for dt in dtypes:
        t0 = time.perf_counter()
        arts[dt] = model_artifact(params, cfg.cim.replace(pack_dtype=dt),
                                  meta={"arch": arch})
        torch.cuda.synchronize()
        pack_s[dt] = time.perf_counter() - t0
    planes = {dt: sum(node["w_digits"].numel()
                      for _, node in _packed_nodes(arts[dt].params))
              for dt in arts}

    g = torch.Generator().manual_seed(phase)
    tokens = torch.randint(0, cfg.vocab, (b, tp), generator=g).to(
        torch.device("cuda"))
    prompts = tokens.cpu().numpy().astype(np.int32)
    rng = np.random.default_rng(phase)
    slot_prompts = [rng.integers(0, cfg.vocab, ln).astype(np.int32)
                    for ln, _ in zc["requests"]]
    # the forward with the front-end input: whisper's over every prompt (its
    # decoder then serves them), llava's over the first fb
    fb = frontend_batch_size or b
    extra = frontend_batch(torch, cfg, fb)
    f_tokens = tokens[:fb]

    attn = (f"MLA (q_lora {cfg.mla.q_lora_rank}, kv_lora "
            f"{cfg.mla.kv_lora_rank}, qk_nope {cfg.mla.qk_nope_dim}, qk_rope "
            f"{cfg.mla.qk_rope_dim}, v_head {cfg.mla.v_head_dim})"
            if cfg.mla is not None else
            f"GQA kv {cfg.n_kv_heads}" + (", qk-norm" if cfg.qk_norm else ""))
    layers = {k: getattr(cfg, k) for k in ("n_layers", "enc_layers")
              if getattr(cfg, k)}
    print(f"{tag} {arch}: d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, {attn}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, layers {layers}"
          + (f", ssm {dataclasses.asdict(cfg.ssm)}" if cfg.ssm else "")
          + (f", front end {tuple(extra.shape)}" if extra is not None
             else "")
          + f", tied embeddings {cfg.tie_embeddings}, {cfg.compute_dtype}; "
          f"K1 {k1_fwd} and K3 {k3_fwd} per forward, K1 {k1_step} per "
          f"decode step; init {init_s:.2f} s, pack "
          + ", ".join(f"{dt} {s:.2f} s" for dt, s in pack_s.items())
          + "; digit planes "
          + ", ".join(f"{dt} {n / 1e9:.3f} GB" for dt, n in planes.items())
          + f"; max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)

    def fwd(p, c):
        return model.forward(p, f_tokens, c, extra)

    def encoded(p, c):
        """whisper's encoder states for the served prompts, else None."""
        return whisper.encode(p, extra, c) if fam == "whisper" else None

    def new_cache(kcfg, enc, bs=b):
        cache = model.init_cache(kcfg, bs, max_len)
        if enc is not None:
            cache["enc_out"] = enc[:bs]
        return cache

    def lockstep(p, c, enc):
        """The engine's prefill and decode-step functions over the prompts,
        the encoder states in the cache (whisper): (B, new) tokens."""
        logits, cache = make_prefill(model, c)(p, new_cache(c, enc), tokens)
        tok = torch.argmax(logits[:, -1:].float(), dim=-1).to(torch.int32)
        step = make_decode_step(model, c)
        outs = [tok]
        for _ in range(new - 1):
            tok, cache = step(p, cache, tok, None)
            outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy()

    def serve(p, kcfg, art):
        """Emulate on ``p`` (``art`` None) or deploy on ``art``: the greedy
        tokens of the prompts and of the slot engine, the decode
        invocations, the seconds of the batch run."""
        c = kcfg if art is None else kcfg.replace(cim=art.config)

        def engine(bs):
            return (ServingEngine(model, kcfg, p, batch_size=bs,
                                  max_len=max_len) if art is None else
                    engine_from_artifact(art, kcfg, batch_size=bs,
                                         max_len=max_len))
        enc = encoded(p, c)
        t0 = time.perf_counter()
        if fam == "whisper":
            gen, inv = lockstep(p, c, enc), new
        else:
            eng = engine(b)
            gen, inv = eng.generate_batch(prompts, new), eng.t
        gen_s = time.perf_counter() - t0
        slot = engine(2)
        if enc is not None:
            slot.cache["enc_out"] = enc[:2]
        slots = _slot_run(slot, slot_prompts, zc["requests"])
        return dict(gen=gen, gen_s=gen_s, slots=slots, inv=inv + slot.t,
                    steps=slot.t)

    # emulate: the reference the deploy path is held against
    t0 = time.perf_counter()
    em = fwd(params, cfg)
    em_runs = {kv: serve(params, cfg.replace(kv_cache_dtype=kv), None)
               for kv in kv_dtypes}
    torch.cuda.synchronize()
    em_s = time.perf_counter() - t0
    del params
    gc.collect()

    # the main path: only these deploy runs may move the counters
    _reset_counters()
    out, k1_expect, k3_expect, invocations = {}, 0, 0, 0
    for dt in dtypes:
        dcfg = cfg.replace(cim=arts[dt].config)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dp = fwd(arts[dt].params, dcfg)
        end.record()
        k1_expect, k3_expect = k1_expect + k1_fwd, k3_expect + k3_fwd
        runs = {}
        for kv in kv_dtypes:
            runs[kv] = serve(arts[dt].params, cfg.replace(kv_cache_dtype=kv),
                             arts[dt])
            invocations += runs[kv]["inv"]
            k1_expect += k1_step * runs[kv]["inv"]
            if fam == "whisper":                 # the encoder alone
                k1_expect += k1_fwd - k1_step
                k3_expect += k3_fwd
        torch.cuda.synchronize()
        out[dt] = dict(logits=dp, fwd_ms=start.elapsed_time(end), runs=runs)
    launches, _ = _read_counters()
    check(launches["cim_matmul"] == k1_expect
          and launches["cim_conv"] == k3_expect,
          f"{arch}: K1 launched {launches['cim_matmul']} times and K3 "
          f"{launches['cim_conv']}, expected {k1_expect} and {k3_expect}")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("cim_matmul", "cim_conv")),
          f"{arch}: other launches or torch patch gathers {launches}")
    scale = float(em.float().abs().max())
    t_out = tp + (cfg.n_frontend_tokens if fam == "llava" else 0)
    for dt, r in out.items():
        y = r["logits"]
        check(y.shape == (fb, t_out, cfg.vocab)
              and bool(torch.isfinite(y).all()),
              f"{arch} {dt} deploy logits: shape {tuple(y.shape)} or "
              "non-finite")
        r["diff"] = float((y.float() - em.float()).abs().max())
        check(r["diff"] <= 1e-4 * scale, f"{arch} {dt} deploy vs emulate "
              f"logits: max diff {r['diff']!r} at max |logit| {scale!r}")
        for kv, run in r["runs"].items():
            check(run["gen"].shape == (b, new)
                  and np.array_equal(run["gen"], em_runs[kv]["gen"]),
                  f"{arch} {dt} served tokens ({kv} KV cache) differ from "
                  "emulate's")
            check([len(t or ()) for t in run["slots"]]
                  == [n for _, n in zc["requests"]]
                  and run["slots"] == em_runs[kv]["slots"],
                  f"{arch} {dt} slot engine ({kv} KV cache): {run['slots']} "
                  f"against emulate {em_runs[kv]['slots']}")
    if keep is not None:
        keep(torch, cfg, arts["int8"], fwd, prompts, out["int8"])
    steps = out[dtypes[0]]["runs"][kv_dtypes[0]]["steps"]
    print(f"{tag} {arch} main path: deploy forwards {len(dtypes)}, decode "
          f"invocations {invocations} ({'/'.join(dtypes)}: one forward over "
          f"{fb} x {tp} tokens"
          + (" with the front-end input" if extra is not None else "")
          + f"; per KV cache {'/'.join(kv_dtypes)} "
          + ("a lockstep run" if fam == "whisper" else "generate_batch")
          + f" {b} x {tp} -> {new} and the slot engine on 3 requests at "
          f"batch 2 in {steps} steps); launches {launches} = K1 {k1_fwd} and "
          f"K3 {k3_fwd} per forward, K1 {k1_step} per decode invocation"
          + (f" (and the encoder alone per run: K1 {k1_fwd - k1_step}, K3 "
             f"{k3_fwd})" if fam == "whisper" else "")
          + ", no other kernel, no patch gather in torch; max |deploy - "
          "emulate| "
          + ", ".join(f"{dt} {r['diff']!r}" for dt, r in out.items())
          + f" (max |logit| {scale!r}); served tokens equal emulate's; "
          f"emulate reference runs {em_s:.2f} s", flush=True)
    if "int8" in kv_dtypes:
        nbytes = {kv: _cache_bytes(model.init_cache(
            cfg.replace(kv_cache_dtype=kv), b, max_len)) for kv in kv_dtypes}
        agree = {dt: int((r["runs"]["int8"]["gen"]
                          == r["runs"]["bf16"]["gen"]).sum())
                 for dt, r in out.items()}
        agree["emulate"] = int((em_runs["int8"]["gen"]
                                == em_runs["bf16"]["gen"]).sum())
        print(f"{tag} {arch} int8 KV cache: {nbytes['int8']} bytes against "
              f"{nbytes['bf16']} in bf16 ({nbytes['int8'] / nbytes['bf16']:.4f}"
              f"); greedy tokens equal to the bf16 cache's run: int8 pack "
              f"{agree['int8']}, int4 pack {agree['int4']}, emulate "
              f"{agree['emulate']} of {b * new} (not a gate: the int8 cache "
              f"is another result; on random weights its rounding moves "
              f"6-bit ADC decisions, in emulate alike)", flush=True)

    # times, the graph-replayed decode step, the kernels at the path's
    # operands: outside the counted run
    sums = {"cim_matmul": {}, "cim_conv": {}}
    for dt in dtypes:
        p, dcfg = arts[dt].params, cfg.replace(cim=arts[dt].config)
        enc = encoded(p, dcfg)
        prefill_ms = _events_ms(torch, lambda: fwd(p, dcfg), reps=3,
                                warmup=1)
        for kv in kv_dtypes:
            kcfg = cfg.replace(kv_cache_dtype=kv)
            same, replay_ms, eager_ms = _graph_decode(
                torch, model, kcfg.replace(cim=arts[dt].config), p,
                lambda kcfg=kcfg: new_cache(kcfg, enc), tokens, new - 1)
            check(same, f"{arch} {dt} ({kv} KV cache): the decode step "
                  "replayed from a CUDA graph differs from the eager steps "
                  "(logits, tokens or caches)")
            run = out[dt]["runs"][kv]
            print(f"{tag} {arch} {dt} ({kv} KV cache): prefill forward "
                  f"{prefill_ms:.2f} ms (CUDA events, mean of 3; the counted "
                  f"run's first {out[dt]['fwd_ms']:.2f} ms); decode "
                  f"{eager_ms:.2f} ms per step eager, {replay_ms:.2f} ms "
                  f"replayed from a CUDA graph (medians of {new - 1}; the "
                  f"first step's logits, the tokens and the caches "
                  f"bit-equal to the eager steps'); "
                  + ("lockstep" if fam == "whisper" else "generate_batch")
                  + f" {run['gen_s']:.3f} s = "
                  f"{b * new / run['gen_s']:.1f} tokens/s", flush=True)

        # K1 and K3 at the operands of one prefill forward and of one
        # decode step after the prompt (MLA's wkv_b then reads 8 x 65
        # filled cache rows of 8 x 128)
        _, cache = model.decode_step(p, new_cache(cfg, enc), tokens, dcfg)
        for what, fn in (
                ("prefill", lambda: fwd(p, dcfg)),
                ("decode", lambda: model.decode_step(p, cache, tokens[:, :1],
                                                     dcfg))):
            calls = _capture_kernel_calls(fn)
            k1 = calls.pop("cim_matmul_transformer")
            k3 = calls.pop("cim_conv_frontend")
            n1, n3 = (k1_fwd, k3_fwd) if what == "prefill" else (k1_step, 0)
            check(len(k1) == n1 and len(k3) == n3
                  and not any(calls.values()),
                  f"{arch} {dt} {what}: captured {len(k1)} K1 and {len(k3)} "
                  f"K3 calls, expected {n1} and {n3}; others "
                  f"{({k: len(v) for k, v in calls.items()})}")
            for key, kname, lst in (("cim_matmul", k1_name, k1),
                                    ("cim_conv", "cim_conv_frontend", k3)):
                if not lst:
                    continue
                tot = _time_captured_calls(torch, {kname: lst}, errs,
                                           zc["reps"])[kname]
                shapes = sorted({(tuple(a[0].shape), a[1].shape[-1])
                                 for a, _ in lst})
                print(f"{tag} {kname} {arch} {dt} {what}: "
                      f"{_fmt_total(tot, f'{len(lst)} launches')}; (codes, "
                      f"N) {shapes}", flush=True)
                if dt == "int8":
                    sums[key][what] = tot
        del cache
    print(f"{tag} {arch}: max |kernel - plain| K1 {errs[k1_name]!r}, K3 "
          f"{errs['cim_conv_frontend']!r}; max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"{time.perf_counter() - t_model:.1f} s", flush=True)
    del arts, out, em
    clear_relaid_planes()
    return dict(sums, launches=launches)


def _keep_for_mesh(torch, cfg, art, fwd, prompts, run):
    """Save ``art`` and the single-device references of phase 17 (b)-(f)
    under ``MESH_WORK / "llama3"`` (outside the counted run): the
    prompts, the counted deploy forward's logits, the served tokens (bf16
    cache), the ADC collector's totals over one armed forward and the
    serve cell's one-device run."""
    from repro_torch.obs import adc
    keep = MESH_WORK / "llama3"
    keep.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    art.save(str(keep / "artifact"))
    save_s = time.perf_counter() - t0
    dcfg = cfg.replace(cim=art.config)
    with adc.sampled():
        fwd(art.params, dcfg)
        totals = adc.totals()
    torch.save(dict(cfg=cfg, prompts=prompts, logits=run["logits"].cpu(),
                    tokens=run["runs"]["bf16"]["gen"], adc=totals,
                    serve=_one_device_serve(torch, dcfg, art.params,
                                            prompts, run["logits"].device)),
               keep / "ref.pt")
    print(f"phase 13 {cfg.name} int8 pack saved for phase 17 in "
          f"{save_s:.2f} s; ADC collector over one armed forward: "
          f"{totals[0]} of {totals[1]} conversions clipped", flush=True)


def _keep_for_cells(torch, cfg, art, fwd, prompts, run):
    """Save phase 17(g)'s pack of ``cfg``'s model and its one-device serve
    under ``MESH_WORK / <arch>`` (outside the counted run): zamba2 cut
    to its first ``MESH_CELLS_LAYERS`` layers (the stacked Mamba2 leaves
    sliced, the shared block once), every leaf in the serve cell's dtype
    (deepseek-v3's run hints keep bfloat16 params), the prompts, the
    one-device serve and the K1 calls of its last decode step."""
    from repro_torch import tree_map
    from repro_torch.api import DeployArtifact
    from repro_torch.launch.cells import apply_hints
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import eval_shape_params
    t0 = time.perf_counter()
    arch = cfg.name
    n = MESH_CELLS_LAYERS.get(arch, cfg.n_layers)
    params = dict(art.params)
    if n != cfg.n_layers:
        params["mamba_layers"] = tree_map(lambda x: x[:n].clone(),
                                          params["mamba_layers"])
    cfg = apply_hints(cfg.replace(n_layers=n, cim=art.config), arch)
    params = _as_dtypes(params, eval_shape_params(get_model(cfg).specs(cfg)))
    keep = MESH_WORK / arch
    keep.mkdir(parents=True, exist_ok=True)
    DeployArtifact(kind="model", config=art.config, params=params,
                   meta=art.meta).save(str(keep / "artifact"))
    torch.save(dict(cfg=cfg, prompts=prompts,
                    serve=_one_device_serve(torch, cfg, params, prompts,
                                            run["logits"].device)),
               keep / "ref.pt")
    print(f"phase 13-14 {cfg.name} at {n} layers, int8, saved for phase "
          f"17g with its one-device serve in {time.perf_counter() - t0:.2f}"
          f" s", flush=True)


def _as_dtypes(tree, struct):
    """``tree`` with each leaf cast to the dtype of ``struct``'s leaf at
    the same path (a leaf ``struct`` has not, such as a pack's logical
    shapes, kept as it is)."""
    if isinstance(tree, dict):
        return {k: _as_dtypes(v, struct.get(k)) if isinstance(struct, dict)
                else v for k, v in tree.items()}
    return tree if struct is None else tree.to(struct.dtype)


def _one_device_serve(torch, cfg, params, prompts, dev):
    """Phase 17(f)'s and (g)'s reference on one device: the serve cell's
    config (``attn_chunk`` 0) with flash decode off, a prefill of
    ``prompts`` into a cache of ``MESH_DP_MAX_LEN`` and ``MESH_DP_STEPS``
    greedy decode steps: the prefill's logits, each call's last-position
    logits (float32) and its greedy tokens, on the host, and the K1
    shapes of the last decode step."""
    from repro_torch.models.registry import get_model
    c = cfg.replace(attn_chunk=0, flash_decode=False)
    model = get_model(c)
    tokens = torch.from_numpy(prompts).to(dev)
    cache = model.init_cache(c, tokens.shape[0], MESH_DP_MAX_LEN,
                             device=dev)
    logits, cache = model.decode_step(params, cache, tokens, c)
    out = dict(prefill=logits.cpu(), last=[], tokens=[])
    for i in range(MESH_DP_STEPS + 1):
        last = logits[:, -1].float()
        tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        out["last"].append(last.cpu())
        out["tokens"].append(tok.cpu())
        if i < MESH_DP_STEPS:
            step = (lambda tok=tok: model.decode_step(params, cache, tok, c))
            if i == MESH_DP_STEPS - 1:
                res = []
                k1 = _capture_kernel_calls(lambda: res.append(step()))[
                    "cim_matmul_transformer"]
                out["k1_shapes"] = _k1_shapes(k1)
                logits, cache = res[0]
            else:
                logits, cache = step()
    return out


# ---------------------------------------------------------------------------
# phase 14: the recurrent and multimodal zoo
# ---------------------------------------------------------------------------

#: phase 14's models at their published widths: (arch, config fields and
#: depth cut, pack dtypes, batch of the forward with the front-end input).
#: zamba2-2.7b is cut from 54 to 12 Mamba2 layers (two groups of 6: the
#: shared block applied twice), xlstm-1.3b from 48 to 8 blocks (one 7:1
#: period), llava-next-mistral-7b from 32 to 1 layer, whisper-small from
#: 12 + 12 to 1 + 1 encoder and decoder layers. Whisper takes its conv
#: stem on raw log-mel frames (80 mel bins, 3000 frames), llava its
#: patch-embed conv on 336 x 336 images (patch 14: 576 patches of 1024). int4 on whisper too, where nibble planes reach K3
#: (c_per_array 42 is even). llava's forward with images runs at batch 4
#: (4 x 640 rows): at 8 x 640 emulate's float32 partial sums of one
#: d_ff linear are 18.8 GB a tensor, and its straight-through rounding
#: holds three of them (past the card's 80 GB); its text serving keeps
#: batch 8.
RECURRENT_ZOO = (
    ("zamba2-2.7b", dict(n_layers=12), ("int8",), None),
    ("xlstm-1.3b", dict(n_layers=8), ("int8",), None),
    ("whisper-small", dict(conv_frontend=True, frontend_dim=80, n_layers=1,
                           enc_layers=1), ("int8", "int4"), None),
    ("llava-next-mistral-7b", dict(conv_frontend=True, patch_size=14,
                                   n_layers=1), ("int8",), 4),
)


def _spec_cim_counts(specs):
    """{top-level key: (CIM linears, CIM convs)} of a deploy spec tree: a
    ``w_digits`` of rank 4 is a linear, rank 6 a conv, a leading axis
    more a stack of them."""
    def walk(tree):
        if not isinstance(tree, dict):
            return 0, 0
        if "w_digits" in tree:
            shape = tuple(tree["w_digits"].shape)
            n = shape[0] if len(shape) in (5, 7) else 1
            return (n, 0) if len(shape) in (4, 5) else (0, n)
        k1 = k3 = 0
        for v in tree.values():
            a, b = walk(v)
            k1, k3 = k1 + a, k3 + b
        return k1, k3
    return {k: walk(v) for k, v in specs.items()}


def recurrent_zoo_counts(cfg):
    """(K1, K3) of one forward with the front-end input and K1 of one
    decode invocation, from the CIM nodes of ``cfg``'s deploy spec tree:
    zamba2's shared block once per group of ``attn_every`` layers,
    whisper's decoder layers per decode step, llava's patch embed in the
    forward only."""
    from repro_torch.models.registry import get_model
    dcfg = cfg.replace(cim=cfg.cim.replace(mode="deploy"))
    c = _spec_cim_counts(get_model(dcfg).specs(dcfg))
    if cfg.family == "zamba2":
        k1 = c["mamba_layers"][0] + c["shared_attn"][0] * (
            cfg.n_layers // cfg.attn_every)
        return (k1, 0), k1
    if cfg.family == "whisper":
        dec = c["dec_layers"][0]
        return (c["enc_layers"][0] + dec, c["frontend"][1]), dec
    k1, k3 = (sum(v[i] for v in c.values()) for i in (0, 1))
    return (k1, k3), k1


def frontend_batch(torch, cfg, b):
    """The front-end input of ``cfg`` on the card (whisper's log-mel
    frames, llava's images; ``frontend_input_shape``), standard normal x
    0.1 from generator seed 14, or None."""
    from repro_torch.models.registry import frontend_input_shape
    shape = frontend_input_shape(cfg, b)
    if shape is None:
        return None
    g = torch.Generator().manual_seed(14)
    return (torch.randn(shape, generator=g) * 0.1).to(torch.device("cuda"))


def _conv_bound(torch, a, digits, occ, s_p, deq, kw,
                ops_per_s: float = INT8_OPS_PER_S):
    """(bytes ms, ops ms) of one K3 call from this run's data: the codes,
    planes, map and scales read once, the float32 output written once;
    the MACs of the live planes over the real input rows at ``ops_per_s``
    (int8, or FP64 for float32 planes)."""
    from repro_torch.kernels import ref
    geo = ref.conv_geometry(a.shape, kw["kh"], kw["kw"], kw["stride"],
                            kw["padding"], digits.shape[1],
                            kw["c_per_array"])
    op = dict(occ=occ, c_per_array=kw["c_per_array"], deq=deq, a_int=a,
              kh=kw["kh"], kw=kw["kw"])
    nbytes = (a.numel() + digits.numel() * digits.element_size()
              + (occ.numel() if occ is not None else 0)
              + 4 * (s_p.numel() + deq.numel()) + 4 * geo.m * deq.shape[-1])
    return _bytes_ops_ms(nbytes, _needed_macs(op, geo.m), ops_per_s)


def phase14_recurrent_zoo(torch, errs, reduced: bool = False):
    """Each of ``RECURRENT_ZOO`` served through the entry points (phase
    13's ``_zoo_serving``, the launch counts from the spec trees); returns
    the results-line entries: K3 over the front ends' convs
    (``cim_conv_frontend``: one whisper and one llava prefill forward) and
    K1 at one decode step's operands on zamba2 and xlstm
    (``cim_matmul_ssm``), with the main path's launches."""
    t_phase = time.perf_counter()
    per = {"cim_conv_frontend": [], "cim_matmul_ssm": []}
    launches = dict.fromkeys(per, 0)
    for arch, cut, dtypes, fb in RECURRENT_ZOO:
        zc = zoo_config(arch, cut, reduced)
        fam = zc["cfg"].family
        frontend = fam in ("whisper", "llava")
        r = _zoo_serving(
            torch, errs, zc, "cim_matmul_" + fam if frontend else
            "cim_matmul_ssm", recurrent_zoo_counts(zc["cfg"]), dtypes=dtypes,
            frontend_batch_size=fb, phase=14,
            keep=None if reduced else _KEEP.get(arch))
        if frontend:
            per["cim_conv_frontend"].append(r["cim_conv"]["prefill"])
            launches["cim_conv_frontend"] += r["launches"]["cim_conv"]
        else:
            per["cim_matmul_ssm"].append(r["cim_matmul"]["decode"])
            launches["cim_matmul_ssm"] += r["launches"]["cim_matmul"]
        gc.collect()
        torch.cuda.empty_cache()
    out = {}
    for k, lst in per.items():
        out[k] = dict(_sum_layers([{k: t} for t in lst])[k],
                      launches=launches[k])
        what = f"{launches[k]} launches on the main path"
        print(f"phase 14 {k}: {_fmt_total(out[k], what)}", flush=True)
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the zoo on a drifting chip
# ---------------------------------------------------------------------------

#: phase 15's models: phase 14's configurations at their cuts (``arch``,
#: config fields and depth cut), with the batch of the forward that takes
#: the front-end input: llava's images at batch 2 (phase 14's 4 halved:
#: under drift emulate's partial sums are float64, twice phase 14's
#: float32 ones, 9.4 GB a tensor of one d_ff linear at 2 x 640 rows).
DRIFT_ZOO = tuple((arch, cut, 2 if fb else None)
                  for arch, cut, _, fb in RECURRENT_ZOO)
#: the baked-variation artifact: whisper (conv and stacked nodes) at this
#: sigma of VARIATION_SIGMAS, from this source seed
VARIED_ARCH, VARIED_SIGMA, VARIED_SEED = "whisper-small", 0.3, 15
#: the launcher's run: zamba2 at phase 14's cut, phase 12's drift from t0
LAUNCH_ARCH = "zamba2-2.7b"
ZOO_DRIFT_REPS = 4


def _slot_replay(invoke, b, prompts, requests):
    """The slot engine's schedule (``ServingEngine._admit``/``step``)
    replayed on ``invoke`` (tokens (b, 1) int32 numpy -> next tokens
    numpy, one model invocation each): prompts admitted into free slots in
    order and prefilled one token at a time with the other slots' last
    tokens, then decode steps over every slot. Returns each request's
    tokens in request order."""
    queue = [(r, p, n) for r, (p, (_, n)) in enumerate(zip(prompts,
                                                          requests))]
    slots, last, done = [None] * b, np.zeros((b, 1), np.int32), {}
    while True:
        for i in range(b):
            if slots[i] is None and queue:
                rid, prompt, n = queue.pop(0)
                slots[i] = (rid, n, [])
                for tok in prompt:
                    x = last.copy()
                    x[i, 0] = tok
                    last[i, 0] = invoke(x)[i, 0]
        if all(sl is None for sl in slots):
            return [done[r] for r in range(len(prompts))]
        nxt = invoke(last)
        for i, sl in enumerate(slots):
            if sl is None:
                continue
            sl[2].append(int(nxt[i, 0]))
            last[i, 0] = nxt[i, 0]
            if len(sl[2]) >= sl[1]:
                done[sl[0]] = sl[2]
                slots[i] = None


def _varied_emulate(packed, params, source, sigma):
    """A ``_NodeCalls`` under which the emulate forward of ``params``
    evaluates every CIM linear and conv under the cell variation that
    ``api.pack_model(..., variation=source, variation_std=sigma)`` baked
    into ``packed``: the node at ``path`` from ``source.for_layer(path)``,
    layer ``i`` of a stacked node from the ``i``-th of its ``split``."""
    by_w = {}
    for path, _ in _packed_nodes(packed):
        src = source.for_layer(path)
        layers = _by_layer(_at(params, path)["w"])
        split = (src.split(len(layers)) if None not in layers.values()
                 else None)
        for k, i in layers.items():
            by_w[k] = src if i is None else split[i]

    def hit(src, kw, x):
        kw.update(variation=src, variation_std=sigma)
    return _NodeCalls(by_w, "w", hit)


class _CutConfigs:
    """Within: ``configs.registry.get_config`` gives ``arch``'s published
    config with ``cut`` (the serving launcher has no depth flag)."""

    def __init__(self, arch, cut):
        self.arch, self.cut = arch, cut

    def __enter__(self):
        import repro_torch.configs.registry as registry
        self.mod, self.orig = registry, registry.get_config

        def get_config(name, *a, **kw):
            cfg = self.orig(name, *a, **kw)
            return cfg.replace(**self.cut) if name == self.arch else cfg
        registry.get_config = get_config
        return self

    def __exit__(self, *exc):
        self.mod.get_config = self.orig
        return False


def _zoo_drift(torch, errs, arch, cut, fb, reduced):
    """One family of phase 15 on a drifting chip; returns {"k1": decode
    step sums, "k3": forward sums or None, "launches": (float K1, float
    K3)} of the counted run."""
    from repro_torch.api import model_artifact
    from repro_torch.core.variation import DriftSchedule, Sampler, drift_tree
    from repro_torch.models import whisper
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import engine_from_artifact
    from repro_torch.serve.health import DriftMonitor, HealthConfig

    t_model = time.perf_counter()
    zc = zoo_config(arch, cut, reduced)
    cfg = zc["cfg"]
    fam = cfg.family
    model = get_model(cfg)
    b, tp, new, max_len = (zc["batch"], zc["prompt_len"], zc["new_tokens"],
                           zc["max_len"])
    (k1_fwd, k3_fwd), k1_step = recurrent_zoo_counts(cfg)
    sched, source = DriftSchedule(**DRIFT_SCHED), Sampler(DRIFT_SEED)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model.specs(cfg), 0)
    art = model_artifact(params, cfg.cim, meta={"arch": arch})
    dcfg = cfg.replace(cim=art.config)
    packed = art.params
    g = torch.Generator().manual_seed(15)
    tokens = torch.randint(0, cfg.vocab, (b, tp), generator=g).to(
        torch.device("cuda"))
    prompts = tokens.cpu().numpy().astype(np.int32)
    fb = fb or b
    extra = frontend_batch(torch, cfg, fb)
    f_tokens = tokens[:fb]
    enc_d = whisper.encode(packed, extra, dcfg) if fam == "whisper" else None
    enc_e = whisper.encode(params, extra, cfg) if fam == "whisper" else None
    memo = {}

    def new_cache(enc):
        cache = model.init_cache(cfg, b, max_len)
        if enc is not None:
            cache["enc_out"] = enc
        return cache

    def gate(lg_d, lg_e, what):
        scale = float(lg_e.float().abs().max())
        diff = float((lg_d.float() - lg_e.float()).abs().max())
        check(lg_d.shape == lg_e.shape and bool(torch.isfinite(lg_d).all())
              and diff <= 1e-4 * scale, f"15 {arch}: drifted deploy vs "
              f"drifted emulate {what}: max diff {diff!r} at max |logit| "
              f"{scale!r}")
        return diff, scale

    # (a) the forward with the front-end input, drifted at t0, against
    # emulate under the same fields (the convs' too)
    st = sched.at(DRIFT_T0)
    lg_d = model.forward(drift_tree(packed, source, st), f_tokens, dcfg,
                         extra)
    with _drifted_emulate(packed, params, source, st, memo) as em:
        lg_e = model.forward(params, f_tokens, cfg, extra)
    check(em.hits == k1_fwd + k3_fwd, f"15 {arch}: drifted emulate forward "
          f"drifted {em.hits} CIM calls, expected {k1_fwd} + {k3_fwd}")
    worst, scale_max = gate(lg_d, lg_e, "forward")
    del lg_d, lg_e
    memo.clear()

    # (b) one prefill and `new - 1` decode steps from t0, step by step,
    # drifted deploy against drifted emulate; the deploy tokens are the
    # engine's reference
    cache_d, cache_e, tok, ref_tokens = new_cache(enc_d), new_cache(enc_e), \
        tokens, []
    for i in range(new):
        st = sched.at(DRIFT_T0 + i)
        lg_d, cache_d = model.decode_step(drift_tree(packed, source, st),
                                          cache_d, tok, dcfg)
        with _drifted_emulate(packed, params, source, st, memo) as em:
            lg_e, cache_e = model.decode_step(params, cache_e, tok, cfg)
        memo.clear()
        check(em.hits == k1_step, f"15 {arch}: drifted emulate step {i} "
              f"drifted {em.hits} CIM calls, expected {k1_step}")
        d, sc = gate(lg_d, lg_e, f"step {i} (t {DRIFT_T0 + i})")
        worst, scale_max = max(worst, d), max(scale_max, sc)
        tok = torch.argmax(lg_d[:, -1:].float(), dim=-1).to(torch.int32)
        ref_tokens.append(tok)
    ref_tokens = torch.cat(ref_tokens, dim=1).cpu().numpy()
    del cache_d, cache_e

    # (c) the counted main path: the drifted forward with the front-end
    # input and the drifting engine (the repaired generate_batch: whisper's
    # encoder states in its cache), watched by a monitor that never trips
    eng = engine_from_artifact(art, cfg, batch_size=b, max_len=max_len,
                               drift_key=source, drift_schedule=sched,
                               health=DriftMonitor(HealthConfig(
                                   hard_threshold=float("inf"))))
    eng.t = DRIFT_T0
    if enc_d is not None:
        eng.cache["enc_out"] = enc_d
    torch.cuda.synchronize()
    _reset_counters()
    model.forward(drift_tree(packed, source, sched.at(DRIFT_T0)), f_tokens,
                  dcfg, extra)
    t0 = time.perf_counter()
    gen = eng.generate_batch(prompts, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launched, floats = _read_counters()
    inv = eng.t - DRIFT_T0
    check(np.array_equal(gen, ref_tokens), f"15 {arch}: the drifting "
          f"engine's tokens {gen.tolist()} differ from the step-by-step "
          f"run's {ref_tokens.tolist()}")
    k1_want, k3_want = k1_fwd + k1_step * inv, k3_fwd
    check(floats["cim_matmul"] == launched["cim_matmul"] == k1_want
          and floats["cim_conv"] == launched["cim_conv"] == k3_want
          and not any(v for k, v in launched.items()
                      if k not in ("cim_matmul", "cim_conv")),
          f"15 {arch}: launches {launched}, on float planes {floats}; "
          f"expected {k1_want} float-plane K1 ({k1_fwd} + {k1_step} per "
          f"invocation x {inv}) and {k3_want} float-plane K3, no integer "
          "launch, no patch gather in torch")
    h = eng.health()
    print(f"phase 15 {arch} (fields Sampler({DRIFT_SEED}), from t "
          f"{DRIFT_T0}): drifted deploy vs drifted emulate under the same "
          f"fields, the forward over {fb} x {tp} tokens"
          + (f" with the front-end input {tuple(extra.shape)}"
             if extra is not None else "")
          + f" and one prefill + {new - 1} decode steps of {b} x {tp}: max "
          f"diff {worst!r} at max |logit| {scale_max!r}; generate_batch "
          f"tokens equal the step-by-step run's ({gen_s:.3f} s, "
          f"{b * new / gen_s:.1f} tokens/s, health score "
          f"{h.get('score', 0.0):.3f}, fallback {h['fallback_active']}); "
          f"launches {launched}, all float-plane ({k1_fwd} K1 + {k3_fwd} K3 "
          f"the forward, {k1_step} K1 per invocation x {inv})", flush=True)
    del eng

    if fam == "whisper":
        # the slot engine against the same schedule replayed on drifted
        # emulate, encoder states in both caches
        slot = engine_from_artifact(art, cfg, batch_size=2, max_len=max_len,
                                    drift_key=source, drift_schedule=sched)
        slot.t = DRIFT_T0
        slot.cache["enc_out"] = enc_d[:2]
        rng = np.random.default_rng(15)
        slot_prompts = [rng.integers(0, cfg.vocab, ln).astype(np.int32)
                        for ln, _ in zc["requests"]]
        got = _slot_run(slot, slot_prompts, zc["requests"])
        cache = model.init_cache(cfg, 2, max_len)
        cache["enc_out"] = enc_e[:2]
        clock = [DRIFT_T0]

        def invoke(x):
            st = sched.at(clock[0])
            clock[0] += 1
            with _drifted_emulate(packed, params, source, st, memo):
                lg, new_cache_ = model.decode_step(
                    params, cache, torch.from_numpy(x).cuda(), cfg)
            memo.clear()
            cache.update(new_cache_)
            return torch.argmax(lg[:, -1].float(), dim=-1).to(
                torch.int32)[:, None].cpu().numpy()
        want = _slot_replay(invoke, 2, slot_prompts, zc["requests"])
        check(got == want and clock[0] == slot.t, f"15 {arch}: the drifting "
              f"slot engine {got} (t {slot.t}) against its schedule on "
              f"drifted emulate {want} (t {clock[0]})")
        # generate_batch without encoder states refuses
        blank = engine_from_artifact(art, cfg, batch_size=b, max_len=max_len)
        try:
            blank.generate_batch(prompts, 2)
            check(False, "15 whisper: generate_batch served without "
                  "encoder states")
        except ValueError as e:
            check("enc_out" in str(e), f"15 whisper: {e}")
        print(f"phase 15 {arch}: the drifting slot engine (3 requests at "
              f"batch 2, {slot.t - DRIFT_T0} invocations) equals its "
              f"schedule replayed on drifted emulate; generate_batch "
              f"without encoder states raises", flush=True)
        del slot, blank, cache

    # (d) the drifted decode step after the prompt: eager, each step drawing
    # its own realization (drift_tree and the step, CUDA events), and one
    # realization's step replayed from a CUDA graph against the same steps
    # run eagerly (a step's fields come from freshly seeded generators and
    # its new planes are checked on the host before their first launch, so
    # drift_tree stays outside the graph)
    pd = drift_tree(packed, source, sched.at(DRIFT_T0))
    same, replay_ms, plain_step_ms = _graph_decode(
        torch, model, dcfg, pd, lambda: new_cache(enc_d), tokens, new - 1)
    check(same, f"15 {arch}: the drifted decode step replayed from a CUDA "
          "graph differs from the eager steps (logits, tokens or caches)")
    _, cache = model.decode_step(pd, new_cache(enc_d), tokens, dcfg)
    tok = torch.from_numpy(ref_tokens[:, :1]).to(tokens.device)
    dev_ms, drift_ms = [], []
    for i in range(new - 1):
        ev = _step_events(torch)
        ev[0].record()
        pi = drift_tree(packed, source, sched.at(DRIFT_T0 + 1 + i))
        ev[1].record()
        lg, cache = model.decode_step(pi, cache, tok, dcfg)
        tok = torch.argmax(lg[:, -1:].float(), dim=-1).to(torch.int32)
        ev[2].record()
        torch.cuda.synchronize()
        dev_ms.append(ev[0].elapsed_time(ev[2]))
        drift_ms.append(ev[0].elapsed_time(ev[1]))
        del pi
    step_ms = float(np.median(dev_ms))
    print(f"phase 15 {arch} drifted decode step (batch {b}): eager "
          f"{step_ms:.2f} ms (CUDA events, median of {new - 1}; drift_tree "
          f"{float(np.median(drift_ms)):.2f} ms of it), one realization's "
          f"step {plain_step_ms:.2f} ms eager and {replay_ms:.2f} ms replayed "
          f"from a CUDA graph (its logits, tokens and caches bit-equal to "
          f"the eager steps')", flush=True)
    del cache

    # (e) every float K1 and K3 call of one drifted forward (the front-end
    # input) and of one drifted decode step after the prompt, against the
    # plain versions, timed beside the FP64 bound
    _, cache = model.decode_step(pd, new_cache(enc_d), tokens, dcfg)
    sums = {}
    for what, fn in (
            ("forward", lambda: model.forward(pd, f_tokens, dcfg, extra)),
            ("decode", lambda: model.decode_step(pd, cache, tokens[:, :1],
                                                 dcfg))):
        calls = _capture_kernel_calls(fn)
        k1 = calls.pop("cim_matmul_transformer")
        k3 = calls.pop("cim_conv_frontend")
        n1, n3 = (k1_fwd, k3_fwd) if what == "forward" else (k1_step, 0)
        check(len(k1) == n1 and len(k3) == n3 and not any(calls.values())
              and all(a[1].dtype == torch.float32 for a, _ in k1 + k3),
              f"15 {arch} {what}: captured {len(k1)} K1 and {len(k3)} K3 "
              f"calls, expected {n1} and {n3} on float32 planes")
        for key, kname, lst in (("k1", "cim_matmul_zoo_drift", k1),
                                ("k3", "cim_conv_frontend_float", k3)):
            if not lst:
                continue
            errs.setdefault(kname, 0.0)
            tot = _time_captured_calls(torch, {kname: lst}, errs,
                                       ZOO_DRIFT_REPS, FP64_OPS_PER_S)[kname]
            rows = sorted({a[1].shape[2] for a, _ in lst})
            print(f"phase 15 {kname} {arch} {what}: "
                  f"{_fmt_total(tot, f'{len(lst)} launches', 'FP64 ops')}; "
                  f"tile rows {rows}", flush=True)
            sums.setdefault(key, {})[what] = tot
    del pd, cache
    print(f"phase 15 {arch}: max |kernel - plain| float K1 "
          f"{errs['cim_matmul_zoo_drift']!r}, float K3 "
          f"{errs.get('cim_conv_frontend_float', 0.0)!r}; max memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"{time.perf_counter() - t_model:.1f} s", flush=True)
    out = {"k1": sums["k1"]["decode"], "k3": sums.get("k3", {}).get("forward"),
           "launches": (floats["cim_matmul"], floats["cim_conv"]),
           "step_ms": (step_ms, replay_ms)}
    if arch == VARIED_ARCH:
        out["varied"] = (params, extra, f_tokens, cfg, model)
    else:
        del params
    return out


def _zoo_varied(torch, params, extra, tokens, cfg, model):
    """A baked-variation artifact (``model_artifact`` with a ``Sampler``
    and a sigma of VARIATION_SIGMAS): its deploy forward against emulate
    under the same per-node sources, every K1 and K3 on float planes."""
    from repro_torch.api import model_artifact
    from repro_torch.core.variation import Sampler
    source = Sampler(VARIED_SEED)
    t0 = time.perf_counter()
    art = model_artifact(params, cfg.cim, variation=source,
                         variation_std=VARIED_SIGMA)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    nodes = list(_packed_nodes(art.params))
    check(all(n["w_digits"].dtype == torch.float32 for _, n in nodes),
          "15 varied: a baked node kept integer planes")
    (k1_fwd, k3_fwd), _ = recurrent_zoo_counts(cfg)
    _reset_counters()
    lg_d = model.forward(art.params, tokens, cfg.replace(cim=art.config),
                         extra)
    torch.cuda.synchronize()
    launched, floats = _read_counters()
    with _varied_emulate(art.params, params, source, VARIED_SIGMA) as em:
        lg_e = model.forward(params, tokens, cfg, extra)
    check(em.hits == k1_fwd + k3_fwd, f"15 varied: emulate varied {em.hits} "
          f"CIM calls, expected {k1_fwd} + {k3_fwd}")
    scale = float(lg_e.float().abs().max())
    diff = float((lg_d.float() - lg_e.float()).abs().max())
    check(bool(torch.isfinite(lg_d).all()) and diff <= 1e-4 * scale,
          f"15 varied: deploy vs emulate max diff {diff!r} at max |logit| "
          f"{scale!r}")
    check(floats["cim_matmul"] == k1_fwd and floats["cim_conv"] == k3_fwd,
          f"15 varied: launches {launched}, on float planes {floats}")
    print(f"phase 15 baked variation ({cfg.name}, model_artifact with "
          f"Sampler({VARIED_SEED}) at sigma {VARIED_SIGMA}, {len(nodes)} "
          f"nodes baked in {pack_s:.2f} s): deploy vs emulate under the same "
          f"sources max diff {diff!r} at max |logit| {scale!r}; launches "
          f"{launched}, on float planes {floats}", flush=True)


def _zoo_launcher(torch, reduced):
    """``python -m repro_torch.launch.serve`` on the card, in process:
    LAUNCH_ARCH at its phase 14 cut, deploy, phase 12's drift from t0,
    the health monitor and the metrics JSON."""
    import contextlib
    import io

    from repro_torch.launch import serve
    from repro_torch.obs import names as M
    cut = dict(next(c for a, c, *_ in RECURRENT_ZOO if a == LAUNCH_ARCH))
    out_dir = ROOT / "build" / "chip_smoke_launch"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "metrics.json"
    argv = ["--arch", LAUNCH_ARCH, "--cim", "deploy", "--batch", "8",
            "--prompt-len", "64", "--new-tokens", "16",
            "--drift-col-rate", str(DRIFT_SCHED["col_rate"]),
            "--drift-cell-rate", str(DRIFT_SCHED["cell_rate"]),
            "--drift-read-sigma", str(DRIFT_SCHED["read_sigma"]),
            "--drift-t0", str(DRIFT_T0), "--health", "--report-every", "8",
            "--metrics-out", str(path)]
    if reduced:
        argv += ["--reduced"]
        cut.pop("n_layers", None)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _CutConfigs(LAUNCH_ARCH, cut), contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    check(rc == 0, f"15 launcher: exit {rc}")
    m = json.loads(path.read_text())
    names = {v for k, v in vars(M).items() if k.isupper()}
    seen = {n for kind in ("counters", "gauges", "histograms")
            for n in m["metrics"][kind]}
    check(seen and seen <= names, f"15 launcher: metrics {sorted(seen)} not "
          f"all among obs.names")
    check(m["health"]["drifting"] and m["throughput"]["tokens_generated"]
          == 8 * 16, f"15 launcher: metrics {m['health']}, "
          f"{m['throughput']}")
    rate = next(ln for ln in lines if "tok/s" in ln)
    print(f"phase 15 launcher (main({' '.join(argv)}) at {cut}): exit 0 in "
          f"{wall:.1f} s with the build of its pack; {rate}; metrics JSON "
          f"parses, names {sorted(seen)}, all of obs.names; "
          + " | ".join(ln for ln in lines if "tok/s" not in ln
                       and not ln.startswith("[serve] health")), flush=True)


def phase15_zoo_drift(torch, errs, reduced: bool = False):
    """The recurrent and multimodal zoo on a drifting chip (``DRIFT_ZOO``,
    phase 14's configurations and cuts; phase 12's schedule from t0):
    drifted deploy against drifted emulate under the same fields, the
    drifting engine against a step-by-step run (whisper also the slot
    engine against its schedule replayed), the float-plane K1 and K3
    counts from the spec trees, every float K1/K3 call of one drifted
    forward and decode step against its plain version and timed; a
    baked-variation artifact against emulate; one launcher run. Returns
    the results-line entries ``cim_matmul_zoo_drift`` (one drifted decode
    step's float K1 summed over the four families) and
    ``cim_conv_frontend_float`` (the float K3 of whisper's and llava's
    drifted forwards)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    k1s, k3s, launches, varied = [], [], [0, 0], None
    for arch, cut, fb in DRIFT_ZOO:
        r = _zoo_drift(torch, errs, arch, cut, fb, reduced)
        k1s.append(r["k1"])
        if r["k3"] is not None:
            k3s.append(r["k3"])
        launches[0] += r["launches"][0]
        launches[1] += r["launches"][1]
        if "varied" in r:
            varied = r["varied"]
        del r
        gc.collect()
        torch.cuda.empty_cache()
    _zoo_varied(torch, *varied)
    del varied
    gc.collect()
    torch.cuda.empty_cache()
    _zoo_launcher(torch, reduced)
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for name, lst, n in (("cim_matmul_zoo_drift", k1s, launches[0]),
                         ("cim_conv_frontend_float", k3s, launches[1])):
        out[name] = dict(_sum_layers([{name: t} for t in lst])[name],
                         launches=n)
        what = f"{n} launches on the main path"
        print(f"phase 15 {name}: "
              f"{_fmt_total(out[name], what, 'FP64 ops')}", flush=True)
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s; max memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: the LM training path
# ---------------------------------------------------------------------------

#: (a)-(c): qwen3-0.6b uncut, trained by the launcher under its CIM config
TRAIN_ARCH = "qwen3-0.6b"
#: (a) saves at steps 18 and 20; (b) starts from (a)'s step 18 and saves
#: every ``b_ckpt_every`` steps: the crashed run writes step 19 before it
#: crashes there, and the relaunch resumes from it
TRAIN_RUN = dict(batch=8, seq=256, lr=3e-4, steps=20, ckpt_every=18,
                 b_ckpt_every=19, crash_at=19)
TRAIN_LOSS_RATIO = 0.7            # last-10 mean over first-5 mean, at most
FT_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_fault_tolerance.py:72-76
#: (d): moonshot at published width, cut to one dense and one MoE layer
ROUTE_ARCH = "moonshot-v1-16b-a3b"
ROUTE_RUN = dict(n_layers=2, batch=8, seq=128, steps=2, lr=3e-4)
ROUTE_PROBE = (1, 4)              # (batch, tokens): most experts get none
#: (e) syncs the gradient of the embedding and of this many layers
SYNC_LAYERS = 4


def train_cim():
    """The training launcher's CIM config (``--cim emulate`` with its
    defaults): 4-bit weights on 2-bit cells, 6-bit partial sums, 128x128
    arrays, column-wise scales."""
    from repro_torch.core.cim_linear import CIMConfig
    return CIMConfig(enabled=True, mode="emulate", weight_bits=4,
                     cell_bits=2, psum_bits=6, array_rows=128,
                     array_cols=128)


class _Deterministic:
    """Within: deterministic algorithms (the float32 atomics of the
    embedding's scatter-add backward and of the gathers' backward replaced
    by sorted sums), cuDNN's deterministic convs, and cuBLAS's fixed
    workspace, so a train step is a function of its inputs bit for bit;
    restored after."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import os
        t = self.torch
        fill = t.utils.deterministic
        self.saved = (t.are_deterministic_algorithms_enabled(),
                      t.is_deterministic_algorithms_warn_only_enabled(),
                      fill.fill_uninitialized_memory,
                      t.backends.cudnn.deterministic,
                      t.backends.cudnn.benchmark,
                      os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        t.use_deterministic_algorithms(True)
        # every result is written before it is read: no NaN fill of each
        # new tensor (a third of a step's device time)
        fill.fill_uninitialized_memory = False
        t.backends.cudnn.deterministic, t.backends.cudnn.benchmark = (
            True, False)
        return self

    def __exit__(self, *exc):
        import os
        t = self.torch
        on, warn, fill, det, bench, ws = self.saved
        t.use_deterministic_algorithms(on, warn_only=warn)
        t.utils.deterministic.fill_uninitialized_memory = fill
        t.backends.cudnn.deterministic, t.backends.cudnn.benchmark = (
            det, bench)
        if ws is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ws
        return False


class _FinalParams:
    """Within: the params of each state ``FaultTolerantLoop.run`` returns
    are kept in ``params`` (the launcher keeps its state to itself)."""

    def __enter__(self):
        from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
        self.cls, self.orig, self.params = (FaultTolerantLoop,
                                            FaultTolerantLoop.run, [])

        def run(loop, *a, **kw):
            state = self.orig(loop, *a, **kw)
            self.params.append(state.params)
            return state
        FaultTolerantLoop.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self.orig
        return False


#: the step of 16a that phase 19(a) counts (before the timed steps 6-20)
PROBE_STEP = 3


class _StepProbe:
    """Phase 19(a)'s count of one step of the launcher's run: while inside,
    ``trainer.make_train_step`` hands out a step that runs its call number
    ``at`` under ``FlopCounterMode`` and records the FLOPs, the bytes of
    its arguments (params, optimizer state, batch) and the card's
    ``max_memory_allocated`` over that step (the run's peak before it is
    kept in ``peak_before``)."""

    def __init__(self, torch, at: int):
        self.torch, self.at, self.calls, self.rec = torch, at, 0, {}

    def __enter__(self):
        from repro_torch.train import trainer
        self._make = trainer.make_train_step

        def make(*args, **kw):
            init_state, step = self._make(*args, **kw)

            def probed(params, opt_state, batch):
                self.calls += 1
                if self.calls != self.at:
                    return step(params, opt_state, batch)
                return self._count(step, params, opt_state, batch)
            return init_state, probed
        trainer.make_train_step = make
        return self

    def __exit__(self, *exc):
        from repro_torch.train import trainer
        trainer.make_train_step = self._make

    def _count(self, step, params, opt_state, batch):
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.launch.dryrun import tree_bytes
        torch = self.torch
        torch.cuda.synchronize()
        self.rec["peak_before"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.rec["argument"] = tree_bytes((params, opt_state, batch))
        counter = FlopCounterMode(display=False)
        with counter:
            out = step(params, opt_state, batch)
        torch.cuda.synchronize()
        self.rec["flops"] = int(counter.get_total_flops())
        self.rec["peak"] = torch.cuda.max_memory_allocated()
        return out


def _train_launch(torch, argv, hist=None, probe=None):
    """``repro_torch.launch.train.main(argv)`` in process, deterministic,
    its ``[train]`` lines captured: (exit code, lines, the final params).
    ``hist`` collects (step, loss, grad norm, a CUDA event recorded after
    the step); ``probe``, a ``_StepProbe``, counts one of its steps."""
    import contextlib
    import io

    from repro_torch.launch import train

    def on_metrics(step, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        hist.append((step, float(m["loss"]), float(m["grad_norm"]), ev))

    buf = io.StringIO()
    try:
        with _Deterministic(torch), contextlib.redirect_stdout(buf), \
                _FinalParams() as final, probe or contextlib.nullcontext():
            rc = train.main(argv, on_metrics=None if hist is None
                            else on_metrics)
    finally:
        lines = buf.getvalue().splitlines()
    return rc, lines, final.params[-1]


def _tree_compare(torch, got, want, tol, path=""):
    """(largest |got - want|, every leaf bit-equal) over two trees of
    tensors; fails where a leaf differs beyond ``tol``."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want),
              f"{path or '<root>'}: keys differ")
        worst, equal = 0.0, True
        for k in want:
            w, e = _tree_compare(torch, got[k], want[k], tol, f"{path}/{k}")
            worst, equal = max(worst, w), equal and e
        return worst, equal
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{path}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} "
          f"{want.dtype}")
    g, w = got.to(torch.float32), want.to(torch.float32)
    err = float((g - w).abs().max()) if w.numel() else 0.0
    check(bool(torch.allclose(g, w, **tol)), f"{path}: max |diff| {err!r} "
          f"beyond rtol {tol['rtol']} / atol {tol['atol']}")
    return err, bool(torch.equal(got, want))


def _stream_share(torch, cfg, served, seed, step, batch, prompt_len):
    """(share of the served tokens that are among the stream's 4
    candidates of their state, share inside the 64-token sub-vocabulary):
    the prompts are batch ``step`` of the stream, whose table and states
    the continuation is walked on."""
    from repro_torch.data.pipeline import ORDER_STATES, markov_draws, \
        markov_walk
    d = markov_draws(seed, step, batch, prompt_len, cfg.vocab)
    _, state = markov_walk(d["table"], d["start"], d["choice"])
    hits = 0
    served = torch.as_tensor(np.asarray(served), dtype=torch.long)
    for tok in served.T:
        hits += int((d["table"][state % ORDER_STATES] == tok[:, None]
                     ).any(dim=1).sum())
        state = (state * 31 + tok) % ORDER_STATES
    return (hits / served.numel(),
            float((served < min(64, cfg.vocab)).float().mean()))


def _trained_serving(torch, dev, cfg, params, seed, step, smi):
    """(c): the trained params packed int8 and served through
    ``generate_batch``: the deploy prefill against emulate, the tokens
    against emulate's, 196 K1 a forward and no other kernel."""
    from repro_torch.api import model_artifact
    from repro_torch.data.pipeline import make_lm_pipeline
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ServingEngine, engine_from_artifact

    model = get_model(cfg)
    b, tp, new, max_len = 8, 64, 16, 128
    prompts = next(make_lm_pipeline(vocab=cfg.vocab, seq_len=tp - 1,
                                    global_batch=b, seed=seed,
                                    start_step=step))["tokens"]
    tokens = torch.as_tensor(prompts).to(dev)
    k1_fwd = recurrent_zoo_counts(cfg)[0][0]
    t0 = time.perf_counter()
    art = model_artifact(params, cfg.cim.replace(pack_dtype="int8"),
                         meta={"arch": cfg.name})
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    dcfg = cfg.replace(cim=art.config)
    with torch.no_grad():
        em = model.forward(params, tokens, cfg)
        em_tok = ServingEngine(model, cfg, params, batch_size=b,
                               max_len=max_len).generate_batch(prompts, new)
        _reset_counters()
        dp = model.forward(art.params, tokens, dcfg)
        eng = engine_from_artifact(art, cfg, batch_size=b, max_len=max_len)
        dp_tok = eng.generate_batch(prompts, new)
        torch.cuda.synchronize()
    counted, floats = _read_counters()
    check(dp.shape == em.shape and bool(torch.isfinite(dp).all()),
          f"16c deploy logits {tuple(dp.shape)} or non-finite")
    diff = float((dp.float() - em.float()).abs().max())
    scale = float(em.float().abs().max())
    check(diff <= 1e-4 * scale, f"16c deploy vs emulate of the trained "
          f"params: max |diff| {diff!r} over largest {scale!r}")
    check(np.array_equal(np.asarray(dp_tok), np.asarray(em_tok)),
          "16c served tokens differ between deploy and emulate")
    want = {"cim_matmul": k1_fwd * (1 + eng.t), "cim_conv": 0,
            "cim_matmul_adc_free": 0, "cim_conv_adc_free": 0,
            "cim_matmul_experts": 0, "plain_gathers": 0}
    check(counted == want and not any(floats.values()),
          f"16c launches {counted} (float {floats}), expected {want}")
    follow, inside = _stream_share(torch, cfg, dp_tok, seed, step, b, tp)
    print(f"phase 16c the trained {cfg.name} packed int8 in {pack_s:.2f} s, "
          f"served {b} prompts of {tp} (stream batch {step}) + {new} new "
          f"tokens through generate_batch: max |deploy - emulate| prefill "
          f"{diff!r} (largest {scale:.4f}); tokens equal emulate's; "
          f"launches {counted} ({k1_fwd} K1 x {1 + eng.t} forwards: one "
          f"prefill, {eng.t} engine invocations); of the served tokens "
          f"{follow:.4f} follow the stream's transition table (chance about "
          f"4/64) and {inside:.4f} lie in its 64-token sub-vocabulary; "
          f"sample {np.asarray(dp_tok)[0].tolist()}; nvidia-smi: {smi}",
          flush=True)


class _Routes:
    """Within: each MoE ``route`` call of the port records its experts'
    filled slots (``layers.expert_counts``)."""

    def __enter__(self):
        from repro_torch.models import layers
        self.mod, self.orig, self.counts = layers, layers.route, []

        def route(logits, cfg):
            out = self.orig(logits, cfg)
            self.counts.append(layers.expert_counts(
                out[2], cfg.moe.n_experts, out[3]).cpu())
            return out
        layers.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig
        return False


def _routing_gradients(torch, grads, counts, tag):
    """Every expert with filled slots has nonzero gradients on its weights
    and column scales in each bank; every other expert zero ones.
    Returns (routed, unrouted) expert counts."""
    moe = grads["moe_layers"]["moe"]
    routed = counts > 0
    for nm in ("wg", "wu", "wd"):
        for key in (nm, f"{nm}_s_w", f"{nm}_s_p"):
            g = moe[key][0]                      # the one MoE layer
            live = g.reshape(g.shape[0], -1).abs().amax(dim=1).cpu() > 0
            check(bool((live == routed).all()), f"16d {tag} {key}: experts "
                  f"with a nonzero gradient {live.nonzero().flatten()}, with "
                  f"routed tokens {routed.nonzero().flatten()}")
    return int(routed.sum()), int((~routed).sum())


def _moe_training(torch, dev, smi, reduced):
    """(d): moonshot at published width cut to ROUTE_RUN's 2 layers, trained
    ROUTE_RUN steps under emulate; the routing gradients of the last
    batch, and of a ROUTE_PROBE batch that leaves most experts empty."""
    from repro_torch import tree_leaves
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_lm_pipeline
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    from repro_torch.train.trainer import (lm_loss_fn, loss_and_grads,
                                           make_train_step)

    r = ROUTE_RUN
    cfg = get_config(ROUTE_ARCH, reduced=reduced, cim=train_cim())
    if not reduced:
        cfg = cfg.replace(n_layers=r["n_layers"])
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model.specs(cfg), 0, device=dev)
    n = sum(p.numel() for p in tree_leaves(params))
    init_state, step = make_train_step(model, cfg, RunConfig(
        lr=r["lr"], total_steps=r["steps"], warmup_steps=1))
    opt = init_state(params)
    pipe = make_lm_pipeline(vocab=cfg.vocab, seq_len=r["seq"],
                            global_batch=r["batch"])
    losses, norms, ms = [], [], []
    for _ in range(r["steps"]):
        batch = {"tokens": torch.as_tensor(next(pipe)["tokens"]).to(dev)}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    check(bool(np.all(np.isfinite(losses + norms))),
          f"16d losses {losses} or grad norms {norms} not finite")
    del opt
    gc.collect()
    loss_fn = lm_loss_fn(model, cfg)
    seen = []
    g = torch.Generator().manual_seed(16)
    probe = {"tokens": torch.randint(0, cfg.vocab, ROUTE_PROBE,
                                     generator=g).to(dev)}
    for tag, b in (("last batch", batch), ("probe", probe)):
        with _Routes() as routes:
            _, grads = loss_and_grads(loss_fn, params, b)
        torch.cuda.synchronize()
        # under remat the forward's route runs again in the backward
        check(all(torch.equal(c, routes.counts[0]) for c in routes.counts),
              f"16d {tag}: the recomputed routing differs")
        seen.append(_routing_gradients(torch, grads, routes.counts[0], tag))
        del grads
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mo = cfg.moe
    print(f"phase 16d {cfg.name} cut to {cfg.n_layers} layers ("
          f"{mo.n_dense_layers} dense with d_ff {mo.dense_d_ff}, "
          f"{cfg.n_layers - mo.n_dense_layers} MoE: {mo.n_experts} experts "
          f"top-{mo.top_k} of d_ff {mo.d_ff} + {mo.n_shared} shared; d "
          f"{cfg.d_model}, vocab {cfg.vocab}; {n / 1e9:.3f} B params), "
          f"emulate, AdamW: {r['steps']} steps at batch {r['batch']} x "
          f"{r['seq']}: ms per step (CUDA events, beside the kernels' build) "
          + ", ".join(f"{t:.1f}" for t in ms)
          + f"; losses {[round(v, 4) for v in losses]}, grad norms "
          f"{[round(v, 4) for v in norms]}; routing gradients: last batch "
          f"{seen[0][0]} experts routed (nonzero on weights, s_w, s_p), "
          f"{seen[0][1]} not (zero); probe {ROUTE_PROBE[0]} x "
          f"{ROUTE_PROBE[1]} tokens {seen[1][0]} routed, {seen[1][1]} with "
          f"none (zero); max memory allocated {peak:.2f} GiB; nvidia-smi: "
          f"{smi}", flush=True)



def _compressed_sync(torch, dev, cfg, params, seed, step, smi):
    """(e): ``compressed_psum_tree`` on the gradient of the trained params
    at the run's last batch, in a one-rank NCCL group on the card, against
    the same function on the CPU (no group), bit for bit."""
    import socket

    import torch.distributed as dist

    from repro_torch import tree_leaves, tree_map
    from repro_torch.data.pipeline import make_lm_pipeline
    from repro_torch.models.registry import get_model
    from repro_torch.train.grad_compress import (compressed_psum_tree,
                                                 init_error_feedback)
    from repro_torch.train.trainer import lm_loss_fn, loss_and_grads

    batch = next(make_lm_pipeline(vocab=cfg.vocab, seq_len=TRAIN_RUN["seq"],
                                  global_batch=TRAIN_RUN["batch"], seed=seed,
                                  start_step=step - 1))
    with _Deterministic(torch):
        _, grads = loss_and_grads(lm_loss_fn(get_model(cfg), cfg), params,
                                  {"tokens": torch.as_tensor(
                                      batch["tokens"]).to(dev)})
    # the stacked layers' gradients cut to the first SYNC_LAYERS (the CPU
    # side's time grows with the values synced)
    grads = dict(grads, layers=tree_map(lambda g: g[:SYNC_LAYERS],
                                        grads["layers"]))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        ef = init_error_feedback(grads)
        compressed_psum_tree(grads, ef, dist.group.WORLD)      # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        synced, new_ef = compressed_psum_tree(grads, ef, dist.group.WORLD)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    want_s, want_ef = compressed_psum_tree(
        *(tree_map(lambda v: v.cpu(), t) for t in (grads, ef)))
    cpu_s = time.perf_counter() - t0
    for name, got, want in (("synced", synced, want_s),
                            ("error feedback", new_ef, want_ef)):
        bad = [i for i, (a, b) in enumerate(zip(tree_leaves(got),
                                                tree_leaves(want)))
               if not torch.equal(a.cpu(), b)]
        check(not bad, f"16e {name}: {len(bad)} leaves differ from the CPU's")
    n = sum(v.numel() for v in tree_leaves(grads))
    print(f"phase 16e compressed_psum_tree on the trained model's gradient "
          f"(the embedding and {SYNC_LAYERS} layers: {n / 1e9:.3f} G values, "
          f"{len(list(tree_leaves(grads)))} leaves) "
          f"in a "
          f"one-rank NCCL group: {ms:.3f} ms on the card (CUDA events), the "
          f"synced gradient and the error feedback bit-equal to the CPU's "
          f"({cpu_s:.2f} s there); nvidia-smi: {smi}", flush=True)



def phase16_train(torch, smi, reduced: bool = False, dev=None):
    """Phase 16's (a) and (b): qwen3-0.6b trained uncut by the launcher,
    then crashed and resumed. Returns the trained params (on the host)
    and (a)'s step ``PROBE_STEP`` as ``_StepProbe`` counted it, with the
    median step ms, for phase 19(a)."""
    import shutil

    from repro_torch import tree_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime.fault_tolerance import InjectedFailure

    t_phase = time.perf_counter()
    dev = torch.device("cuda") if dev is None else dev
    r = TRAIN_RUN
    work = ROOT / "build" / "chip_smoke_lm"
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--cim", "emulate", "--batch",
            str(r["batch"]), "--seq", str(r["seq"]), "--lr", str(r["lr"]),
            "--steps", str(r["steps"]), "--log-every", "1", "--seed", "0",
            "--device", str(dev)]
    if reduced:
        argv += ["--reduced"]
    cfg = get_config(TRAIN_ARCH, reduced=reduced, cim=train_cim())

    # (a) the uninterrupted run
    torch.cuda.reset_peak_memory_stats()
    hist = []
    probe = _StepProbe(torch, PROBE_STEP)
    t0 = time.perf_counter()
    rc, lines, trained = _train_launch(
        torch, argv + ["--ckpt-every", str(r["ckpt_every"]), "--ckpt-dir",
                       str(work / "a")], hist, probe)
    wall = time.perf_counter() - t0
    check(set(probe.rec) == {"peak_before", "argument", "flops", "peak"},
          f"16a: step {PROBE_STEP} was not counted ({probe.calls} steps)")
    peak = max(torch.cuda.max_memory_allocated(),
               probe.rec["peak_before"]) / 2 ** 30
    check(rc == 0, f"16a launcher exit {rc}")
    steps = [h[0] for h in hist]
    check(steps == list(range(1, r["steps"] + 1)), f"16a logged steps "
          f"{steps}")
    losses = np.array([h[1] for h in hist])
    norms = np.array([h[2] for h in hist])
    check(bool(np.all(np.isfinite(losses)) and np.all(np.isfinite(norms))),
          "16a a loss or grad norm is not finite")
    first, last = float(losses[:5].mean()), float(losses[-10:].mean())
    gaps = [hist[i - 1][3].elapsed_time(hist[i][3])
            for i in range(5, len(hist))]
    step_ms = sorted(gaps)
    med = step_ms[len(step_ms) // 2]
    n = sum(p.numel() for p in tree_leaves(trained))
    print(f"phase 16a {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"GQA kv {cfg.n_kv_heads}, qk-norm {cfg.qk_norm}, tied embeddings "
          f"of {cfg.vocab}; {n / 1e9:.3f} B params) trained by "
          f"launch.train.main({' '.join(argv)}): exit 0 in {wall:.1f} s; "
          f"ms per step (CUDA events, steps 6-{r['steps']}) median "
          f"{med:.2f}, min {step_ms[0]:.2f}, max {step_ms[-1]:.2f} (by step: "
          + " ".join(f"{t:.0f}" for t in gaps) + "); "
          f"{r['batch'] * r['seq'] / (med / 1e3):.0f} tokens/s; max memory "
          f"allocated {peak:.2f} GiB; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, mean first 5 {first:.4f}, last 10 {last:.4f} "
          f"(ratio {last / first:.4f}); grad norm {norms[0]:.3f} -> "
          f"{norms[-1]:.3f}; nvidia-smi: {smi}", flush=True)
    print("phase 16a " + " | ".join(
        ln for ln in lines if not ln.startswith("[train] step")
        or int(ln.split()[2]) % 10 == 0 or int(ln.split()[2]) == 1),
        flush=True)
    check(last <= TRAIN_LOSS_RATIO * first, f"16a loss fell to "
          f"{last / first:.4f} x, expected at most {TRAIN_LOSS_RATIO}")
    step16 = dict(probe.rec, step=PROBE_STEP, step_ms=med)

    # (b) crashed at crash_at, relaunched: its directory starts with (a)'s
    # last checkpoint before crash_at (the same launcher and flags wrote
    # it); the crashed run resumes there, saves crash_at (async, waited for
    # before the failure) and crashes; the relaunch resumes from that save
    start = r["crash_at"] // r["ckpt_every"] * r["ckpt_every"]
    crashed = r["crash_at"] // r["b_ckpt_every"] * r["b_ckpt_every"]
    check(start < crashed, f"16b: the crashed run saves no step after "
          f"{start}")
    (work / "b").mkdir()
    (work / "a" / f"step_{start:08d}").rename(
        work / "b" / f"step_{start:08d}")
    shutil.rmtree(work / "a", ignore_errors=True)
    b_argv = argv + ["--ckpt-every", str(r["b_ckpt_every"]), "--ckpt-dir",
                     str(work / "b")]
    t0 = time.perf_counter()
    try:
        _train_launch(torch, b_argv + ["--crash-at", str(r["crash_at"])])
        check(False, "16b --crash-at: no InjectedFailure")
    except InjectedFailure:
        pass
    crash_s = time.perf_counter() - t0
    check((work / "b" / f"step_{crashed:08d}").is_dir(), f"16b: the crashed "
          f"run left no step-{crashed} checkpoint")
    t0 = time.perf_counter()
    rc, lines, resumed_params = _train_launch(torch, b_argv)
    resume_s = time.perf_counter() - t0
    check(rc == 0 and f"[train] resumed from step {crashed}" in lines
          and lines[-1].startswith(f"[train] done at step {r['steps']}"),
          f"16b relaunch: exit {rc}, lines {lines[:1] + lines[-1:]}")
    worst, equal = _tree_compare(torch, resumed_params, trained, FT_TOL)
    del resumed_params
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 16b --crash-at {r['crash_at']} --ckpt-every "
          f"{r['b_ckpt_every']} from (a)'s step-{start} checkpoint: the "
          f"step-{crashed} checkpoint written, then InjectedFailure after "
          f"{crash_s:.1f} s; the relaunch resumed from step {crashed} and "
          f"ended at {r['steps']} in {resume_s:.1f} s; its params against "
          f"(a)'s: max |diff| {worst!r} (rtol {FT_TOL['rtol']}, atol "
          f"{FT_TOL['atol']}), bit-equal {equal}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16a-b took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return trained, step16


def phase16_lm_training(torch, smi, reduced: bool = False, dev=None):
    """The LM training path but (d), which ``main`` runs beside the build
    (``_moe_training``): (a) and (b) (``phase16_train``), (c) the trained
    params packed and served on K1, (e) the compressed gradient sync on
    the card against the CPU. ``reduced`` and ``dev`` rehearse it on the
    reduced configs (the CPU: ``dev`` "cpu"). Returns (a)'s counted step
    for phase 19(a)."""
    from repro_torch.configs.registry import get_config

    t_phase = time.perf_counter()
    trained, step16 = phase16_train(torch, smi, reduced, dev)
    dev = torch.device("cuda") if dev is None else dev
    r = TRAIN_RUN
    cfg = get_config(TRAIN_ARCH, reduced=reduced, cim=train_cim())

    # (c) packed and served on K1
    _trained_serving(torch, dev, cfg, trained, 0, r["steps"], smi)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the compressed gradient sync on the card against the CPU
    _compressed_sync(torch, dev, cfg, trained, 0, r["steps"], smi)
    del trained
    gc.collect()
    torch.cuda.empty_cache()

    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s for (a)-(c) "
          f"and (e); "
          f"nvidia-smi: {smi}", flush=True)
    return step16


# ---------------------------------------------------------------------------
# phase 17: column-parallel serving over a rank mesh
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_JOIN_S = 200                 # the ranks' join limit, and their group's
MESH_WORK = ROOT / "build" / "chip_smoke_mesh"
MESH_LM_ARCH = "llama3-8b"        # phase 13's cut and traffic
MESH_LAUNCH_ARCH = "qwen3-0.6b"   # uncut: spawned ranks see no in-process cut
MESH_DRIFT_T = 256                # phase 12g's schedule, one realization
MESH_DECODE_REPS = 7
#: (d): flash decode over the llama3 pack's ranks, both KV caches. The
#: logits gate: flash decode weights the values as the plain path does
#: (the softmax weights rounded to bf16) and differs from it only in the
#: float32 order of its sums before the bf16 cast of the attention output,
#: so an output element moves by at most one bf16 ulp (2^-8 of its
#: magnitude) where the two sums round apart; the gate allows two such
#: ulps a layer at the logits' scale: 2^-7 of their largest magnitude per
#: layer of the cut
MESH_FD_KV = ("bf16", "int8")
MESH_FD_TOL = 2.0 ** -7
#: (f): data parallel serving of the llama3 pack on the same ranks as a
#: (data, model) mesh: 4 rows a data rank, max_len 128 with flash decode
#: over "model", a prefill and ``MESH_DP_STEPS`` decode steps; phase 13
#: saves the one-device serve of the same cell config (flash decode off)
MESH_DP = ((2, 2), ("data", "model"))
MESH_DP_MAX_LEN = 128
MESH_DP_STEPS = 8
#: (g): every decode cache placed as the serve cell says, on the same
#: (2, 2) ranks as (f) with (f)'s traffic: deepseek-v3 at phase 13's cut
#: and int8 pack with flash decode (MLA's latent cache's time over
#: "model": the sequence-parallel MLA decode), and zamba2 at phase 14's
#: int8 pack cut to one period of 6 layers, the shared block once (the
#: SSD state's heads over "model"; flash decode off, its K/V gathered at
#: use); (arch, flash decode, the cache leaves placed over "model" by
#: this slice: a rank holds a quarter of each). Logits: deepseek within
#: (d)'s gate, zamba2 at rtol 1e-5 / atol 1e-4 of one device's
MESH_CELLS = (("deepseek-v3-671b", True, ("ckv", "krope")),
              ("zamba2-2.7b", False, ("ssd",)))
MESH_CELLS_LAYERS = {"zamba2-2.7b": 6}
#: what phases 13 and 14 save for phase 17, by arch
_KEEP = {MESH_LM_ARCH: _keep_for_mesh,
         **{arch: _keep_for_cells for arch, _, _ in MESH_CELLS}}
#: (e): moonshot at published widths, phase 16d's depth, expert parallel
#: under the training launcher's CIM config; 4 x 64 tokens (+1 for the
#: labels). The loss against the single device's to 1e-5 relative; each
#: gradient leaf within 2^-6 of its largest magnitude (four bf16 ulps: the
#: ranks sum the block's partial outputs in float32 in another order than
#: one device, and the bf16 cast after the sum moves an element by one
#: ulp where the two sums round apart)
MESH_MOE_ARCH = "moonshot-v1-16b-a3b"
MESH_MOE_RUN = dict(n_layers=2, batch=4, seq=64)
MESH_MOE_GRAD_TOL = 2.0 ** -6
#: (a)'s runs on phase 11's artifacts: (name, pack dtype, backend, forward
#: keywords, drifted, counter, on float planes)
MESH_RESNET_RUNS = (
    ("deploy int8", "int8", "deploy", {}, False, "cim_conv", False),
    ("deploy int4", "int4", "deploy", {}, False, "cim_conv", False),
    ("adc_free int8", "int8", "adc_free", {}, False, "cim_conv_adc_free",
     False),
    (f"sigma {SIGMA} int8", "int8", "deploy", {"sigma": SIGMA}, False,
     "cim_conv", True),
    (f"drift t {MESH_DRIFT_T} int8", "int8", "deploy", {}, True, "cim_conv",
     True),
)


def _mesh_resnet_forward(torch, art, run, state, xb, cfg):
    """One of ``MESH_RESNET_RUNS`` on ``art`` (single-device or sharded:
    the session mesh decides)."""
    from repro_torch.core.variation import DriftSchedule, Sampler, drift_tree
    from repro_torch.models import resnet
    _, _, mode, kw, drifted, _, _ = run
    c = dataclasses.replace(cfg, cim=art.config.replace(mode=mode))
    p = (drift_tree(art.params, Sampler(DRIFT_SEED),
                    DriftSchedule(**SWEEP_DRIFT).at(MESH_DRIFT_T))
         if drifted else art.params)
    fkw = ({} if "sigma" not in kw else
           dict(variation=Sampler(0), variation_std=kw["sigma"]))
    return resnet.forward(p, state, xb, c, train=False, **fkw)[0]


def _phase17_references(torch, qat, work):
    """(a)'s single-device logits of phase 11's artifacts, saved beside
    what the ranks need to run them."""
    from repro_torch import to_device
    from repro_torch.api import DeployArtifact
    dev = torch.device("cuda")
    state, xb = to_device(qat["state"], dev), qat["xb"].to(dev)
    arts = {dt: DeployArtifact.load(p) for dt, p in qat["paths"].items()}
    logits = {run[0]: _mesh_resnet_forward(torch, arts[run[1]], run, state,
                                           xb, qat["cfg"]).cpu()
              for run in MESH_RESNET_RUNS}
    torch.save(dict(qat, logits=logits), work / "resnet.pt")


def _conv_widths():
    """Record the column count of every K3 / K5 launch: (widths, undo)."""
    import repro_torch.kernels.ops as kops
    widths = []
    orig = {w: getattr(kops, w) for w in ("cim_conv_cuda",
                                          "cim_conv_adc_free_cuda")}

    def rec(f):
        def wrapped(a, digits, *rest, **kw):
            widths.append(int(digits.shape[-1]))
            return f(a, digits, *rest, **kw)
        return wrapped
    for w, f in orig.items():
        setattr(kops, w, rec(f))
    return widths, lambda: [setattr(kops, w, f) for w, f in orig.items()]


def _mesh_resnet(torch, mesh, work):
    """(a) on this rank: phase 11's artifacts loaded with ``mesh=``, run
    under it as the session mesh."""
    from repro_torch import to_device
    from repro_torch.api import DeployArtifact
    from repro_torch.nn.module import session_mesh
    ref = torch.load(work / "resnet.pt", weights_only=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    state, xb = to_device(ref["state"], dev), ref["xb"].to(dev)
    arts = {dt: DeployArtifact.load(p, mesh=mesh, device="cuda")
            for dt, p in ref["paths"].items()}
    c_out = sorted(n["w_digits"].shape[-1]
                   for _, n in _packed_nodes(arts["int8"].params))
    out = {}
    for run in MESH_RESNET_RUNS:
        name, dt, _, _, _, counter, floats = run
        torch.cuda.synchronize()
        _reset_counters()
        widths, undo = _conv_widths()
        try:
            with session_mesh(mesh):
                y = _mesh_resnet_forward(torch, arts[dt], run, state, xb,
                                         ref["cfg"])
            torch.cuda.synchronize()
        finally:
            undo()
        launches, on_float = _read_counters()
        want = ref["logits"][name]
        out[name] = dict(
            equal=bool(torch.equal(y.cpu(), want)),
            diff=float((y.cpu().float() - want.float()).abs().max()),
            launches=launches, floats=on_float,
            widths_ok=sorted(widths) == sorted(n // MESH_RANKS
                                               for n in c_out),
            gate=(launches[counter] == len(c_out)
                  and on_float[counter] == (len(c_out) if floats else 0)
                  and all(v == 0 for k, v in launches.items()
                          if k != counter)))
    return out


def _mesh_llama3(torch, mesh, work, rank):
    """(b) on this rank: phase 13's int8 llama3 pack served through
    ``engine_from_artifact(path, cfg, mesh=)``."""
    import torch.distributed as dist

    from repro_torch.core import colshard
    from repro_torch.models.registry import get_model
    from repro_torch.obs import adc
    from repro_torch.serve.engine import engine_from_artifact
    ref = torch.load(work / "llama3" / "ref.pt", weights_only=False)
    cfg, prompts = ref["cfg"], ref["prompts"]
    b, tp = prompts.shape
    model = get_model(cfg)
    t0 = time.perf_counter()
    eng = engine_from_artifact(str(work / "llama3" / "artifact"), cfg,
                               mesh=mesh, batch_size=b, max_len=128)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    p, dcfg = eng.params, eng.cfg
    tokens = torch.from_numpy(prompts).cuda()
    nodes = [n["w_digits"] for _, n in _packed_nodes(p)]
    sharded = (sum(colshard.is_col_sharded(d) for d in nodes), len(nodes))

    torch.cuda.synchronize()
    _reset_counters()
    logits = model.forward(p, tokens, dcfg)
    torch.cuda.synchronize()
    launches, on_float = _read_counters()
    y = logits.cpu()
    gen = eng.generate_batch(prompts, ref["tokens"].shape[1])
    with adc.sampled():
        model.forward(p, tokens, dcfg)
        totals = adc.totals()

    # the eager decode step after the prompt, and its all-gathers' share
    _, cache = model.decode_step(p, model.init_cache(dcfg, b, 128), tokens,
                                 dcfg)
    tok = tokens[:, :1]
    step_ms, shares = [], []
    for _ in range(MESH_DECODE_REPS):
        torch.cuda.synchronize()
        g0, t0 = colshard.gather_cols.seconds, time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, cache = model.decode_step(p, cache, tok, dcfg)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms.append(start.elapsed_time(end))
        shares.append((colshard.gather_cols.seconds - g0) / wall)
    calls = _capture_kernel_calls(
        lambda: model.decode_step(p, cache, tok, dcfg))
    k1 = calls.pop("cim_matmul_transformer")
    others = sum(len(v) for v in calls.values())
    k1_sum = None
    if rank == 0:          # the other ranks wait: one rank on the card
        errs = {"cim_matmul_llama3_shard": 0.0}
        k1_sum = _time_captured_calls(
            torch, {"cim_matmul_llama3_shard": k1}, errs, reps=10)[
                "cim_matmul_llama3_shard"]
        k1_sum["max_abs_err"] = errs["cim_matmul_llama3_shard"]
    dist.barrier()
    order = np.argsort(step_ms)
    mid = int(order[len(order) // 2])
    return dict(
        load_s=load_s, sharded_nodes=sharded, launches=launches,
        floats=on_float, equal=bool(torch.equal(y, ref["logits"])),
        diff=float((y.float() - ref["logits"].float()).abs().max()),
        tokens=gen.tolist(), tokens_equal=bool(np.array_equal(
            gen, ref["tokens"])), adc=list(totals), adc_single=list(ref["adc"]),
        step_ms=step_ms[mid], gather_share=shares[mid], k1_calls=len(k1),
        k1_shapes=sorted({(tuple(a[0].shape), int(a[1].shape[-1]))
                          for a, _ in k1}), other_calls=others,
        k1_timed=k1_sum), eng


def _mesh_flash_decode(torch, mesh, work, rank, eng):
    """(d) on this rank: phase 13's llama3 pack as the engine of (b)
    placed it, decoded greedily with and without flash decode under the
    mesh, with the bf16 and the int8 KV caches; flash decode through the
    engine; the flash step timed on rank 0."""
    import torch.distributed as dist

    from repro_torch.core import colshard
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ServingEngine
    ref = torch.load(work / "llama3" / "ref.pt", weights_only=False)
    prompts = ref["prompts"]
    b, new = prompts.shape[0], ref["tokens"].shape[1]
    p, base = eng.params, eng.cfg
    tokens = torch.from_numpy(prompts).cuda()
    out = {}
    for kv in MESH_FD_KV:
        runs = {}
        for flash in (False, True):
            c = base.replace(kv_cache_dtype=kv, flash_decode=flash)
            model = get_model(c)
            cache = model.init_cache(c, b, 128)
            logits, cache = model.decode_step(p, cache, tokens, c)
            last, gen = [], []
            for i in range(new):
                last.append(logits[:, -1].float().cpu())
                gen.append(torch.argmax(last[-1], dim=-1)[:, None].to(
                    torch.int32))
                if i < new - 1:
                    logits, cache = model.decode_step(p, cache,
                                                      gen[-1].cuda(), c)
            k = cache["layers"]["k"]
            runs[flash] = (torch.stack(last), torch.cat(gen, dim=1), cache,
                           type(k).__name__)
        (l0, t0, c0, _), (l1, t1, c1, kind) = runs[False], runs[True]
        differ = (t0 != t1).nonzero().tolist()
        out[kv] = dict(
            tokens_equal=bool(torch.equal(t0, t1)), tokens=t1.tolist(),
            diff=float((l1 - l0).abs().max()),
            scale=float(l0.abs().max()), placed=kind,
            differ=[(r_, s_, torch.topk(l0[s_, r_], 2).values.tolist(),
                     torch.topk(l1[s_, r_], 2).values.tolist())
                    for r_, s_ in differ[:4]],
            cache_bytes=sum(colshard.local(v).numel() * v.element_size()
                            for n, v in c1["layers"].items() if n != "len"),
            cache_bytes_whole=sum(v.numel() * v.element_size()
                                  for n, v in c1["layers"].items()
                                  if n != "len"))
        if kv == "bf16":
            c = base.replace(flash_decode=True)
            cache, model = c1, get_model(c)
            tok = t1[:, -1:].cuda()
            step_ms, shares = [], []
            for _ in range(MESH_DECODE_REPS):
                torch.cuda.synchronize()
                s0, w0 = colshard.collective.seconds, time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                calls0 = colshard.collective.calls
                _reset_counters()
                _, cache = model.decode_step(p, cache, tok, c)
                end.record()
                torch.cuda.synchronize()
                launches, _ = _read_counters()
                step_ms.append(start.elapsed_time(end))
                shares.append((colshard.collective.seconds - s0)
                              / (time.perf_counter() - w0))
                reduces = colshard.collective.calls - calls0
            mid = int(np.argsort(step_ms)[len(step_ms) // 2])
            out["step_ms"], out["reduce_share"] = step_ms[mid], shares[mid]
            out["reduces"], out["k1_step"] = reduces, launches["cim_matmul"]
            del cache
            eng_fd = ServingEngine(model, c, p, batch_size=b, max_len=128)
            gen = eng_fd.generate_batch(prompts, new)
            out["engine_tokens_equal"] = bool(np.array_equal(gen,
                                                             ref["tokens"]))
            out["engine_placed"] = type(
                eng_fd.cache["layers"]["k"]).__name__
            del eng_fd
        del runs, c0, c1
        gc.collect()
    dist.barrier()
    return out


def _mesh_data_parallel(torch, work, rank, dev, eng):
    """(f) on this rank: phase 13's int8 llama3 pack as (b)'s engine loaded
    it (its planes gathered from the ("model",) mesh, ``full_tree``, and
    placed again over the "model" ranks of the (data, model) mesh of the
    same ranks, ``DeployArtifact.shard``), served through the serve cell's
    step: a prefill and ``MESH_DP_STEPS`` greedy decode steps with flash
    decode, each rank on its rows (the main path: the counters and the
    collectives counted around it); then one more step's K1 calls timed
    on rank 0."""
    import torch.distributed as dist

    from repro_torch.api import DeployArtifact
    from repro_torch.core import colshard
    from repro_torch.launch import mesh as lm
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import session_mesh
    ref = torch.load(work / "llama3" / "ref.pt", weights_only=False)
    one = ref["serve"]
    mesh = lm.make_mesh(*MESH_DP, device=dev, backend="gloo")
    t0 = time.perf_counter()
    art = DeployArtifact(kind="model", config=eng.cfg.cim,
                         params=colshard.full_tree(eng.params)).shard(
                             mesh, device=dev)
    load_s = time.perf_counter() - t0
    b = ref["prompts"].shape[0]
    cell, rows = _dp_cell(MESH_LM_ARCH, ref["cfg"].replace(
        cim=art.config, flash_decode=True), mesh, b)
    p = art.params

    with session_mesh(mesh, cell.rules):
        cache = get_model(cell.cfg).init_cache(cell.cfg, b,
                                               MESH_DP_MAX_LEN, device=dev)
        placed = {k: (type(v).__name__, tuple(colshard.local(v).shape))
                  for k, v in cache["layers"].items()}
        run = _serve_cell_steps(torch, cell, p, cache, ref["prompts"],
                                rows, mesh, dev)
        calls = _capture_kernel_calls(
            lambda: cell.step_fn(p, run["cache"], run["glob"]))
    k1 = calls.pop("cim_matmul_transformer")
    k1_sum = None
    if rank == 0:          # the other ranks wait: one rank on the card
        errs = {"cim_matmul_llama3_dp": 0.0}
        k1_sum = _time_captured_calls(
            torch, {"cim_matmul_llama3_dp": k1}, errs, reps=10)[
                "cim_matmul_llama3_dp"]
        k1_sum["max_abs_err"] = errs["cim_matmul_llama3_dp"]
    dist.barrier()
    return dict(
        load_s=load_s, rows=(rows.start, rows.stop), placed=placed,
        **_against_one_device(torch, run, one, rows),
        launches=run["launches"], floats=run["floats"], axes=run["axes"],
        step_ms=run["step_ms"], k1_calls=len(k1), k1_shapes=_k1_shapes(k1),
        other_calls=sum(len(v) for v in calls.values()), k1_timed=k1_sum)


def _dp_cell(arch, cfg, mesh, b):
    """The serve cell of ``arch`` on ``mesh`` with every field of ``cfg``
    (its CIM config the loaded pack's), for ``b`` prompts into
    ``MESH_DP_MAX_LEN`` positions, and this rank's rows of the batch."""
    from repro_torch.configs.base import Shape
    from repro_torch.core import colshard
    from repro_torch.launch.cells import build_cell
    cell = build_cell(arch, Shape("chip_smoke_dp", "decode", MESH_DP_MAX_LEN,
                                  b), mesh, cim=cfg.cim,
                      overrides={f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)})
    n, d = colshard.batch_shard(mesh, ("data",))
    return cell, slice(d * b // n, (d + 1) * b // n)


def _serve_cell_steps(torch, cell, p, cache, prompts, rows, mesh, dev):
    """The main path of (f) and (g) on this rank: the serve cell's step
    (``cell.step_fn``) on a prefill of ``prompts`` (the global batch) and
    ``MESH_DP_STEPS`` greedy decode steps, each rank on its ``rows``, with
    the launch counters and the collectives counted around them: the
    prefill's logits and each call's last-position logits with the vocab
    gathered over "model", the greedy tokens, each decode step's CUDA-event
    ms, the counters, the collectives by kind and mesh dim, the cache
    after the steps and the last step's global tokens."""
    from repro_torch.core import colshard
    b = prompts.shape[0]

    def whole_vocab(logits):
        """This rank's logits rows with the vocab gathered over model."""
        return colshard.all_gather(colshard.local(logits), mesh,
                                   ("model",), -1)
    tokens = torch.from_numpy(prompts).to(dev)
    last, toks, step_ms = [], [], []
    torch.cuda.synchronize()
    _reset_counters()
    colshard.reset_collective_counts()
    logits, cache = cell.step_fn(p, cache, tokens)
    prefill = whole_vocab(logits)
    logits = prefill
    for i in range(MESH_DP_STEPS + 1):
        last.append(logits[:, -1].float())
        toks.append(torch.argmax(last[-1], dim=-1)[:, None].to(torch.int32))
        if i == MESH_DP_STEPS:
            break
        glob = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        glob[rows] = toks[-1]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = cell.step_fn(p, cache, glob)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        logits = whole_vocab(logits)
    torch.cuda.synchronize()
    launches, on_float = _read_counters()
    return dict(prefill=prefill, last=last, toks=toks,
                step_ms=float(np.median(step_ms)), launches=launches,
                floats=on_float, cache=cache, glob=glob,
                axes={k: dict(v) for k, v in colshard.collective.axes.items()
                      if v})


def _against_one_device(torch, run, one, rows):
    """A ``_serve_cell_steps`` run against its rows of the one-device
    serve (``_one_device_serve``): the prefill logits bit for bit, the
    tokens, the largest difference of the last-position logits and their
    largest magnitude, and whether every logit is within rtol 1e-5 / atol
    1e-4 of one device's."""
    want = one["prefill"][rows]
    got = run["prefill"].cpu()
    ref_last = torch.stack([x[rows] for x in one["last"]])
    ours = torch.stack(run["last"]).cpu()
    mine = torch.cat(run["toks"], dim=1).cpu()
    theirs = torch.cat([x[rows] for x in one["tokens"]], dim=1)
    return dict(
        prefill_equal=bool(torch.equal(got, want)),
        prefill_diff=float((got.float() - want.float()).abs().max()),
        tokens=mine.tolist(), tokens_equal=bool(torch.equal(mine, theirs)),
        diff=float((ours - ref_last).abs().max()),
        scale=float(ref_last.abs().max()),
        close=bool(torch.allclose(ours, ref_last, rtol=1e-5, atol=1e-4)))


def _k1_shapes(k1):
    """The (a_t shape, N) of captured K1 calls, each shape once."""
    return sorted({(tuple(a[0].shape), int(a[1].shape[-1])) for a, _ in k1})


def _report_data_parallel(res, ref, smi):
    """(f)'s gates and line."""
    cfg = ref["cfg"]
    calls = 1 + MESH_DP_STEPS
    k1 = 7 * cfg.n_layers
    for r, rr in enumerate(res):
        g = rr["dp"]
        check(g["prefill_equal"], f"17f rank {r}: prefill logits differ "
              f"from its rows of phase 13's one-device prefill by "
              f"{g['prefill_diff']!r}")
        check(g["tokens_equal"], f"17f rank {r}: tokens {g['tokens']} "
              "differ from the one-device decode's")
        check(g["diff"] <= MESH_FD_TOL * cfg.n_layers * g["scale"],
              f"17f rank {r}: logits differ by {g['diff']!r}, over 2^-7 x "
              f"{cfg.n_layers} layers x {g['scale']!r}")
        check(g["axes"].get("all-gather", {}).get("data", 0) == 0,
              f"17f rank {r}: all-gathers over data in the steps: "
              f"{g['axes']}")
        check(g["launches"]["cim_matmul"] == k1 * calls
              and all(v == 0 for k, v in g["launches"].items()
                      if k != "cim_matmul")
              and g["k1_calls"] == k1 and g["other_calls"] == 0,
              f"17f rank {r}: launches {g['launches']}, a step's K1 calls "
              f"{g['k1_calls']}, others {g['other_calls']}; expected "
              f"{k1 * calls} K1 and nothing else")
        check(all(s_[0][0] == ref["prompts"].shape[0] // 2
                  for s_ in g["k1_shapes"]), f"17f rank {r}: K1 at "
              f"{g['k1_shapes']}, not the rank's rows")
    f0 = res[0]["dp"]
    t = f0["k1_timed"]
    print(f"phase 17f {MESH_LM_ARCH} ({cfg.n_layers} layers, phase 13's "
          f"int8 pack as (b) loaded it, placed again over the new mesh's "
          f"'model' ranks in {f0['load_s']:.2f} s) served data parallel "
          f"on the (2, 2) ('data', 'model') mesh of the same gloo ranks "
          f"through build_cell(...).step_fn, flash decode: "
          f"{ref['prompts'].shape[0]} prompts of {ref['prompts'].shape[1]} "
          f"tokens, rows {[rr['dp']['rows'] for rr in res]} a rank, cache "
          f"blocks {f0['placed']}; prefill logits bit-equal to phase 13's "
          f"one-device rows on every rank; {MESH_DP_STEPS} decode steps: "
          f"tokens equal the one-device decode's, max |logit diff| "
          f"{max(rr['dp']['diff'] for rr in res):.4g} (gate "
          f"{MESH_FD_TOL * cfg.n_layers * f0['scale']:.4g}); collectives "
          f"of the steps by mesh dim {f0['axes']} (no all-gather over "
          f"'data'); per rank {f0['launches']['cim_matmul']} K1 ({k1} a "
          f"call at M = {f0['k1_shapes'][0][0][0]} rows, N/2 columns "
          f"{[s[1] for s in f0['k1_shapes']]}) and no other kernel; rank "
          f"0's decode step eager {f0['step_ms']:.2f} ms (CUDA events, "
          f"median of {MESH_DP_STEPS}) against (d)'s ('model',) x "
          f"{MESH_RANKS} flash step {res[0]['flash']['step_ms']:.2f} ms; "
          f"rank 0's {f0['k1_calls']} K1 calls of a step: "
          f"{_fmt_total(t, 'graph replay')}; max |kernel - plain| "
          f"{t['max_abs_err']!r}; {res[0]['dp_s']:.1f} s on rank 0; "
          f"nvidia-smi: {smi}", flush=True)


def _mesh_cells(torch, work, rank, dev):
    """(g) on this rank: each of ``MESH_CELLS`` loaded placed over the
    "model" ranks of the (2, 2) mesh (``DeployArtifact.load(mesh=)``) and
    served through its serve cell's step as (f) serves llama3: the cache
    from ``init_cache`` under the session mesh (the block bytes of the
    leaves this slice places beside the whole leaves'), a prefill and
    ``MESH_DP_STEPS`` greedy decode steps (the main path: the counters and
    the collectives counted around it); then one more decode step's
    collective bytes by kind and its K1 calls (deepseek: the same step
    again with flash decode off, the latent cache gathered at use); rank 0
    times that step's K1 calls and, alone, ``wkv_b``'s."""
    import torch.distributed as dist

    from repro_torch.api import DeployArtifact
    from repro_torch.core import colshard
    from repro_torch.launch import mesh as lm
    from repro_torch.launch.cells import serve_rows
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import session_mesh
    mesh = lm.make_mesh(*MESH_DP, device=dev, backend="gloo")
    out = {}
    for arch, flash, leaves in MESH_CELLS:
        t_cell = time.perf_counter()
        ref = torch.load(work / arch / "ref.pt", weights_only=False)
        t0 = time.perf_counter()
        art = DeployArtifact.load(str(work / arch / "artifact"), mesh=mesh,
                                  device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        b = ref["prompts"].shape[0]
        cell, rows = _dp_cell(arch, ref["cfg"].replace(
            cim=art.config, flash_decode=flash), mesh, b)
        model, p = get_model(cell.cfg), art.params

        def coll():
            return {k: v for k, v in colshard.collective.bytes.items() if v}
        with session_mesh(mesh, cell.rules):
            cache = model.init_cache(cell.cfg, b, MESH_DP_MAX_LEN,
                                     device=dev)
            blocks = {path: (colshard.local(v).numel() * v.element_size(),
                             v.numel() * v.element_size())
                      for path, v in _flat_leaves(cache)
                      if path.rsplit("/", 1)[-1] in leaves}
            run = _serve_cell_steps(torch, cell, p, cache, ref["prompts"],
                                    rows, mesh, dev)
            colshard.reset_collective_counts()
            calls = _capture_kernel_calls(
                lambda: cell.step_fn(p, run["cache"], run["glob"]))
            step = dict(bytes=coll(), axes={
                k: dict(v) for k, v in colshard.collective.axes.items() if v})
            gathered = None
            if flash:
                colshard.reset_collective_counts()
                serve_rows(model, cell.cfg.replace(flash_decode=False), p,
                           run["cache"], run["glob"])
                gathered = coll()
        k1 = calls.pop("cim_matmul_transformer")
        wide = [c for c in k1 if _is_wkv_b(c[0][0].shape,
                                            c[0][1].shape[-1], cell.cfg)]
        timed = None
        if rank == 0:          # the other ranks wait: one rank on the card
            errs = {"k1": 0.0, "wkv_b": 0.0}
            timed = _time_captured_calls(torch, {"k1": k1, "wkv_b": wide},
                                         errs, reps=10)
            timed["max_abs_err"] = max(errs.values())
        dist.barrier()
        out[arch] = dict(
            load_s=load_s, rows=(rows.start, rows.stop), blocks=blocks,
            **_against_one_device(torch, run, ref["serve"], rows),
            launches=run["launches"], axes=run["axes"],
            step_ms=run["step_ms"], step=step, gathered=gathered,
            k1_calls=len(k1), k1_shapes=_k1_shapes(k1),
            wkv_b=_k1_shapes(wide), one_k1_shapes=ref["serve"]["k1_shapes"],
            other_calls=sum(len(v) for v in calls.values()), timed=timed,
            n_layers=cell.cfg.n_layers, s=time.perf_counter() - t_cell)
        del art, p, cache, run, calls, k1, wide
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _flat_leaves(tree, path=""):
    """(path, leaf) over a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _is_wkv_b(a_shape, n: int, cfg) -> bool:
    """Whether a K1 call of tiled codes ``a_shape`` (M, k_tiles, rows) on
    ``n`` columns is MLA's ``wkv_b`` (its K and N under ``cfg``'s
    tiling)."""
    m = cfg.mla
    if m is None:
        return False
    cols = cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
    t = cfg.cim.tiling(m.kv_lora_rank, cols)
    return (tuple(a_shape[-2:]), n) == ((t.k_tiles, t.array_rows), cols)


def _report_cells(torch, res, work, smi):
    """(g)'s gates and lines."""
    for arch, flash, leaves in MESH_CELLS:
        ref = torch.load(work / arch / "ref.pt", weights_only=False)
        cfg = ref["cfg"]
        calls = 1 + MESH_DP_STEPS
        k1 = (recurrent_zoo_counts(cfg)[1] if cfg.family == "zamba2" else
              next(k for _, a, _, k, _ in ZOO_CASES if a == arch)
              * cfg.n_layers)
        for r, rr in enumerate(res):
            g = rr["cells"][arch]
            tag = f"17g {arch} rank {r}"
            check(g["prefill_equal"], f"{tag}: prefill logits differ from "
                  f"its rows of the one-device prefill by "
                  f"{g['prefill_diff']!r}")
            check(g["tokens_equal"], f"{tag}: tokens {g['tokens']} differ "
                  "from the one-device decode's")
            if flash:
                check(g["diff"] <= MESH_FD_TOL * cfg.n_layers * g["scale"],
                      f"{tag}: logits differ by {g['diff']!r}, over 2^-7 x "
                      f"{cfg.n_layers} layers x {g['scale']!r}")
            else:
                check(g["close"], f"{tag}: logits differ by {g['diff']!r}, "
                      "over rtol 1e-5 / atol 1e-4 of one device's")
            check(set(n.rsplit("/", 1)[-1] for n in g["blocks"])
                  == set(leaves) and all(4 * loc == whole
                          for loc, whole in g["blocks"].values()),
                  f"{tag}: cache blocks (rank, whole bytes) {g['blocks']}, "
                  "not a quarter")
            check(g["axes"].get("all-gather", {}).get("data", 0) == 0,
                  f"{tag}: all-gathers over data in the steps: {g['axes']}")
            check(g["launches"]["cim_matmul"] == k1 * calls
                  and all(v == 0 for k, v in g["launches"].items()
                          if k != "cim_matmul")
                  and g["k1_calls"] == k1 and g["other_calls"] == 0,
                  f"{tag}: launches {g['launches']}, a step's K1 calls "
                  f"{g['k1_calls']}, others {g['other_calls']}; expected "
                  f"{k1 * calls} K1 and nothing else")
            if flash:
                m = ref["prompts"].shape[0] // 2 * MESH_DP_MAX_LEN // 2
                check([s_[0][0] for s_ in g["wkv_b"]] == [m]
                      and [s_[0][0] for s_ in g["one_k1_shapes"]
                           if _is_wkv_b(*s_, cfg)]
                      == [ref["prompts"].shape[0] * MESH_DP_MAX_LEN],
                      f"{tag}: wkv_b's K1 at {g['wkv_b']} (one device "
                      f"{g['one_k1_shapes']}), not M = {m} rows on all its "
                      "columns")
        g0 = res[0]["cells"][arch]
        t = g0["timed"]
        mb = {k: round(v / 2 ** 20, 3) for k, v in g0["step"]["bytes"].items()}
        line = (f"phase 17g {arch} ({cfg.n_layers} layers, int8, flash "
                f"decode {'on' if flash else 'off'}) served data parallel "
                f"on the (2, 2) ('data', 'model') mesh of (f)'s ranks "
                f"(loaded placed in {g0['load_s']:.2f} s): "
                f"{ref['prompts'].shape[0]} prompts of "
                f"{ref['prompts'].shape[1]} tokens, rows "
                f"{[rr['cells'][arch]['rows'] for rr in res]} a rank; cache "
                f"blocks a rank / whole (bytes) {g0['blocks']}; prefill "
                f"logits bit-equal to the one-device rows on every rank; "
                f"{MESH_DP_STEPS} decode steps: tokens equal, max |logit "
                f"diff| {max(rr['cells'][arch]['diff'] for rr in res):.4g} "
                f"(largest |logit| {g0['scale']:.4g}); collectives of the "
                f"steps by mesh dim {g0['axes']} (no all-gather over "
                f"'data'); a decode step's collective MiB by kind {mb} "
                f"(by mesh dim {g0['step']['axes']})")
        if flash:
            off = {k: round(v / 2 ** 20, 3) for k, v in g0["gathered"].items()}
            line += (f", the same step with flash decode off (the latent "
                     f"cache gathered at use, wkv_b column-parallel over "
                     f"all {MESH_DP_MAX_LEN} positions) {off}; wkv_b's K1 "
                     f"at {g0['wkv_b']} (a_t shape, N) a rank, one device's "
                     f"at M = {ref['prompts'].shape[0] * MESH_DP_MAX_LEN}: "
                     f"{_fmt_total(t['wkv_b'], 'one call, graph replay')}")
        line += (f"; per rank {g0['launches']['cim_matmul']} K1 ({k1} a "
                 f"call) and no other kernel; rank 0's decode step eager "
                 f"{g0['step_ms']:.2f} ms (CUDA events, median of "
                 f"{MESH_DP_STEPS}); its {g0['k1_calls']} K1 calls: "
                 f"{_fmt_total(t['k1'], 'graph replay')}; max |kernel - "
                 f"plain| {t['max_abs_err']!r}; {g0['s']:.1f} s on rank 0; "
                 f"nvidia-smi: {smi}")
        print(line, flush=True)


def _mesh_moe_cfg():
    """(e)'s config: moonshot at published widths cut to phase 16d's
    depth, the training launcher's CIM config, the reference's expert
    dispatch (``moe_impl="auto"``)."""
    from repro_torch.configs.registry import get_config
    return get_config(MESH_MOE_ARCH, cim=train_cim()).replace(
        n_layers=MESH_MOE_RUN["n_layers"], moe_impl="auto")


def _mesh_moe_batch(torch):
    r = MESH_MOE_RUN
    g = torch.Generator().manual_seed(17)
    return {"tokens": torch.randint(0, _mesh_moe_cfg().vocab,
                                    (r["batch"], r["seq"] + 1),
                                    generator=g).cuda()}


def _is_bank(key: str) -> bool:
    return key in ("wg", "wu", "wd") or key.startswith(("wg_", "wu_", "wd_"))


def _phase17e_references(torch, work):
    """(e)'s single-device loss and gradients of the seed-0 weights: each
    rank's block of every expert bank's gradient, the router's, and the
    global gradient norm, saved for the ranks. It runs no kernel: ``main``
    runs it beside the build."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    from repro_torch.optim.optimizer import global_norm
    from repro_torch.train.trainer import lm_loss_fn, loss_and_grads
    cfg = _mesh_moe_cfg()
    model = get_model(cfg)
    params = init_params(model.specs(cfg), 0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(lm_loss_fn(model, cfg), params,
                                 _mesh_moe_batch(torch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moe = grads["moe_layers"]["moe"]
    e_loc = cfg.moe.n_experts // MESH_RANKS
    (work / "moe").mkdir(parents=True, exist_ok=True)
    for r in range(MESH_RANKS):
        part = {k: v[:, r * e_loc:(r + 1) * e_loc].cpu()
                for k, v in moe.items() if _is_bank(k)}
        part["router"] = moe["router"]["w"].cpu()
        torch.save(dict(loss=float(loss), grad_norm=float(global_norm(grads)),
                        grads=part, s=wall,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30),
                   work / "moe" / f"rank{r}.pt")
    del params, grads, moe


def _mesh_moe_ep(torch, mesh, work, rank):
    """(e) on this rank: the seed-0 weights with this rank's 16 experts
    placed (``shard_params``), one forward and backward of the LM loss
    under the mesh, against the single device's."""
    from repro_torch import tree_leaves
    from repro_torch.core import colshard
    from repro_torch.launch.mesh import expert_parallel_rules
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, session_mesh, shard_params
    from repro_torch.optim.optimizer import global_norm
    from repro_torch.train.trainer import lm_loss_fn, loss_and_grads
    ref = torch.load(work / "moe" / f"rank{rank}.pt", weights_only=False)
    cfg = _mesh_moe_cfg()
    model = get_model(cfg)
    specs = model.specs(cfg)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    full = init_params(specs, 0, device=dev)
    params = shard_params(full, specs, mesh, expert_parallel_rules(mesh))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    held = sum(colshard.local(v).numel() for v in tree_leaves(params))
    batch = _mesh_moe_batch(torch)
    with session_mesh(mesh):
        torch.cuda.synchronize()
        c0, t0 = colshard.collective.seconds, time.perf_counter()
        loss, grads = loss_and_grads(lm_loss_fn(model, cfg), params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        share = (colshard.collective.seconds - c0) / wall
        gn = float(global_norm(grads))
    moe = grads["moe_layers"]["moe"]
    errs = {}
    for k, want in ref["grads"].items():
        got = (moe["router"]["w"] if k == "router"
               else colshard.local(moe[k])).float().cpu()
        errs[k] = (float((got - want).abs().max())
                   / max(float(want.abs().max()), 1e-30))
    out = dict(loss=float(loss), loss_single=ref["loss"], grad_norm=gn,
               grad_norm_single=ref["grad_norm"], errs=errs,
               placed=[k for k, v in moe.items() if colshard.is_col_sharded(
                   params["moe_layers"]["moe"][k])],
               held=held, s=wall, s_single=ref["s"], reduce_share=share,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               peak_single=ref["peak_gib"])
    del params, grads, moe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _report_flash_decode(res, ref, smi):
    """(d)'s gates and line."""
    n_layers = ref["cfg"].n_layers
    for r, rr in enumerate(res):
        got = rr["flash"]
        for kv in MESH_FD_KV:
            g = got[kv]
            check(g["tokens_equal"] and g["tokens"] == res[0]["flash"][kv][
                "tokens"], f"17d {kv} rank {r}: flash-decode tokens differ "
                  f"from the plain decode's (or rank 0's) at (row, step, "
                  f"plain top-2, flash top-2) {g['differ']}")
            check(g["diff"] <= MESH_FD_TOL * n_layers * g["scale"],
                  f"17d {kv} rank {r}: logits differ by {g['diff']!r}, over "
                  f"2^-7 x {n_layers} layers x {g['scale']!r}")
            check(g["placed"] == "DTensor" and g["cache_bytes"] * MESH_RANKS
                  == g["cache_bytes_whole"], f"17d {kv} rank {r}: cache "
                  f"{g['placed']}, {g['cache_bytes']} of "
                  f"{g['cache_bytes_whole']} bytes")
        check(got["engine_tokens_equal"] and got["engine_placed"] == "DTensor",
              f"17d rank {r}: the engine's flash-decode tokens differ from "
              "phase 13's, or its cache is whole")
        check(got["k1_step"] == 7 * n_layers and got["reduces"]
              == 3 * n_layers, f"17d rank {r}: {got['k1_step']} K1 and "
              f"{got['reduces']} all-reduces a step")
    d0 = res[0]["flash"]
    print(f"phase 17d {MESH_LM_ARCH} ({n_layers} layers, phase 13's int8 "
          f"pack, {ref['prompts'].shape[0]} prompts of "
          f"{ref['prompts'].shape[1]} tokens, {ref['tokens'].shape[1]} new, "
          f"max_len 128) with flash decode on {MESH_RANKS} gloo ranks: "
          + "; ".join(
              f"{kv} cache: tokens equal the plain decode's on every rank, "
              f"max |logit diff| {d0[kv]['diff']:.4g} (gate "
              f"{MESH_FD_TOL * n_layers * d0[kv]['scale']:.4g}: 2^-7 x "
              f"{n_layers} layers x max |logit| {d0[kv]['scale']:.4g}), "
              f"cache {d0[kv]['cache_bytes']} bytes a rank against "
              f"{d0[kv]['cache_bytes_whole']} whole"
              for kv in MESH_FD_KV)
          + f"; generate_batch with flash decode equals phase 13's tokens on "
          f"every rank; rank 0's flash step eager {d0['step_ms']:.2f} ms "
          f"(CUDA events, median of {MESH_DECODE_REPS}), all-reduce share "
          f"{d0['reduce_share']:.3f} (host clock, {d0['reduces']} a step), "
          f"{d0['k1_step']} K1 a step; {res[0]['flash_s']:.1f} s on rank 0; "
          f"nvidia-smi: {smi}", flush=True)


def _report_moe_ep(res, smi):
    """(e)'s gates and line."""
    cfg = _mesh_moe_cfg()
    for r, rr in enumerate(res):
        g = rr["moe_ep"]
        check(abs(g["loss"] - g["loss_single"]) <= 1e-5 * abs(
            g["loss_single"]), f"17e rank {r}: loss {g['loss']!r} against "
              f"the single device's {g['loss_single']!r}")
        check(g["loss"] == res[0]["moe_ep"]["loss"], f"17e rank {r}: loss "
              "differs from rank 0's")
        bad = {k: e for k, e in g["errs"].items() if not e
               <= MESH_MOE_GRAD_TOL}
        check(not bad, f"17e rank {r}: gradients off by (max |diff| / max "
              f"|single|) {bad}")
        check(abs(g["grad_norm"] - g["grad_norm_single"]) <= 1e-3 * g[
            "grad_norm_single"], f"17e rank {r}: global grad norm "
              f"{g['grad_norm']!r} against {g['grad_norm_single']!r}")
        check(set(g["placed"]) == {k for k in g["errs"] if k != "router"},
              f"17e rank {r}: placed leaves {g['placed']}")
    e0 = res[0]["moe_ep"]
    mo = cfg.moe
    r = MESH_MOE_RUN
    print(f"phase 17e {cfg.name} cut to {cfg.n_layers} layers (1 dense, 1 "
          f"MoE: {mo.n_experts} experts top-{mo.top_k} + {mo.n_shared} "
          f"shared, d {cfg.d_model}), emulate, expert parallel on "
          f"{MESH_RANKS} gloo ranks ({mo.n_experts // MESH_RANKS} experts "
          f"a rank, shard_params): one forward and backward at batch "
          f"{r['batch']} x {r['seq']}: loss {e0['loss']!r} against the "
          f"single device's {e0['loss_single']!r}; per leaf max |grad diff| "
          f"/ max |grad| "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(e0["errs"].items()))
          + f" (gate {MESH_MOE_GRAD_TOL:.4g}); global grad norm "
          f"{e0['grad_norm']:.6g} against {e0['grad_norm_single']:.6g}; "
          f"{e0['held'] / 1e9:.3f} B params a rank; forward and backward "
          f"{e0['s']:.2f} s on rank 0 (all-reduce share "
          f"{e0['reduce_share']:.3f}), {e0['s_single']:.2f} s on one device "
          f"alone (beside the build); peak memory per rank "
          + ", ".join(f"{rr['moe_ep']['peak_gib']:.2f}" for rr in res)
          + f" GiB (one device {e0['peak_single']:.2f}); "
          f"{res[0]['moe_ep_s']:.1f} s on rank 0; nvidia-smi: {smi}",
          flush=True)


def _phase17_rank(rank, world, port, work):
    """One rank of phase 17: gloo on the shared card, a ("model",) mesh
    for (a), (b), (d) and (e), the same ranks as a (data, model) mesh for
    (f); results to ``work/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as lm
    work = Path(work)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = lm.init_rank(rank, world, port, backend="gloo", device="cuda",
                       timeout_s=MESH_JOIN_S)
    try:
        mesh = lm.make_mesh(world, device=dev, backend="gloo")
        t0 = time.perf_counter()
        res = {"resnet": _mesh_resnet(torch, mesh, work)}
        res["resnet_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["llama3"], eng = _mesh_llama3(torch, mesh, work, rank)
        res["llama3_s"] = time.perf_counter() - t0
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        res["flash"] = _mesh_flash_decode(torch, mesh, work, rank, eng)
        res["flash_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["dp"] = _mesh_data_parallel(torch, work, rank, dev, eng)
        res["dp_s"] = time.perf_counter() - t0
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["moe_ep"] = _mesh_moe_ep(torch, mesh, work, rank)
        res["moe_ep_s"] = time.perf_counter() - t0
        res["cells"] = _mesh_cells(torch, work, rank, dev)
        (work / f"rank{rank}.json").write_text(json.dumps(res, default=str))
    finally:
        dist.destroy_process_group()


#: 2 prompts of 8 tokens, 2 new: every decode step of the uncut model on
#: 4 gloo ranks takes 196 host-staged all-gathers
MESH_LAUNCH_FLAGS = ("--arch", MESH_LAUNCH_ARCH, "--cim", "deploy",
                     "--batch", "2", "--prompt-len", "8", "--new-tokens",
                     "2")


def _mesh_launch(flags):
    """``repro_torch.launch.serve`` on ``MESH_LAUNCH_ARCH``: with ``--mesh
    N`` in a process of its own (its rank 0 prints there), with ``--mesh
    1`` in this one. (exit code, its ``[serve]`` lines, seconds)."""
    import contextlib
    import io
    import os
    t0 = time.perf_counter()
    if "--mesh" in flags and flags[flags.index("--mesh") + 1] != "1":
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve",
             *MESH_LAUNCH_FLAGS, *flags], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=MESH_JOIN_S)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
        rc, out = proc.returncode, proc.stdout
    else:
        from repro_torch.launch import serve
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = serve.main([*MESH_LAUNCH_FLAGS, *flags])
        out = buf.getvalue()
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
    return rc, lines, time.perf_counter() - t0


def phase17_column_parallel(torch, smi, qat):
    """Column-parallel serving over a mesh of ``MESH_RANKS`` gloo ranks
    sharing the card: (a) phase 11's ResNet-20 artifacts, (b) phase 13's
    int8 llama3 pack, each rank on its columns and bit-equal to the
    single device; (c) the serving launcher with ``--mesh 4``."""
    import shutil

    from repro_torch.launch import mesh as lm
    t_phase = time.perf_counter()
    work = MESH_WORK
    check((work / "llama3" / "ref.pt").exists(), "phase 17: phase 13 saved "
          "no llama3 pack")
    _phase17_references(torch, qat, work)
    gc.collect()
    torch.cuda.empty_cache()
    check((work / "moe" / "rank0.pt").exists(), "phase 17: no (e) "
          "references (main computes them beside the build)")
    t0 = time.perf_counter()
    try:
        lm.spawn(_phase17_rank, MESH_RANKS,
                 (MESH_RANKS, lm.free_port(), str(work)),
                 timeout_s=MESH_JOIN_S)
    except Exception as e:           # a rank raised, or the ranks hung
        check(False, f"phase 17 ranks: {type(e).__name__}: {e}")
    ranks_s = time.perf_counter() - t0
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(MESH_RANKS)]

    # (a) ResNet-20
    for run in MESH_RESNET_RUNS:
        name = run[0]
        for r, rr in enumerate(res):
            got = rr["resnet"][name]
            check(got["equal"], f"17a {name} rank {r}: logits differ from "
                  f"the single device's by {got['diff']!r}")
            check(got["gate"] and got["widths_ok"], f"17a {name} rank {r}: "
                  f"launches {got['launches']}, on float planes "
                  f"{got['floats']}, widths ok {got['widths_ok']}")
    a0 = res[0]["resnet"]
    print(f"phase 17a ResNet-20 at batch {BATCH} on {MESH_RANKS} gloo ranks "
          f"sharing the card (phase 11's artifacts loaded with mesh=): "
          + "; ".join(f"{name} bit-equal to the single device on every "
                      f"rank, per rank {a0[name]['launches'][run[5]]} "
                      f"{'float-plane ' if run[6] else ''}{run[5]} launches "
                      f"on C_out/{MESH_RANKS} columns"
                      for run in MESH_RESNET_RUNS for name in (run[0],))
          + f"; no K1 and no patch gather in torch; {res[0]['resnet_s']:.1f}"
          f" s on rank 0", flush=True)

    # (b) llama3-8b
    ref = torch.load(work / "llama3" / "ref.pt", weights_only=False)
    k1_fwd = 7 * ref["cfg"].n_layers
    for r, rr in enumerate(res):
        got = rr["llama3"]
        check(got["equal"], f"17b rank {r}: prefill logits differ from the "
              f"single device's by {got['diff']!r}")
        check(got["tokens_equal"] and got["tokens"] == res[0]["llama3"][
            "tokens"], f"17b rank {r}: tokens differ from phase 13's or "
              "rank 0's")
        check(got["launches"]["cim_matmul"] == k1_fwd
              and all(v == 0 for k, v in got["launches"].items()
                      if k != "cim_matmul")
              and got["k1_calls"] == k1_fwd and got["other_calls"] == 0,
              f"17b rank {r}: launches {got['launches']}, decode-step K1 "
              f"calls {got['k1_calls']}, others {got['other_calls']}; "
              f"expected {k1_fwd} K1 and nothing else")
        check(got["adc"] == got["adc_single"], f"17b rank {r}: ADC totals "
              f"over the mesh {got['adc']} against the single device's "
              f"{got['adc_single']}")
        n_sharded, n_nodes = got["sharded_nodes"]
        check(n_sharded == n_nodes, f"17b rank {r}: {n_sharded} of "
              f"{n_nodes} packed nodes sharded (every linear divides by "
              f"{MESH_RANKS})")
    b0 = res[0]["llama3"]
    t = b0["k1_timed"]
    print(f"phase 17b {MESH_LM_ARCH} ({ref['cfg'].n_layers} layers, "
          f"published widths, int8, bf16 KV cache, {ref['prompts'].shape[0]} "
          f"prompts of {ref['prompts'].shape[1]} tokens, "
          f"{ref['tokens'].shape[1]} new) on {MESH_RANKS} gloo ranks: "
          f"engine_from_artifact(path, cfg, mesh=) loaded in "
          f"{b0['load_s']:.2f} s (all {b0['sharded_nodes'][1]} stacked "
          f"nodes sharded); "
          f"prefill logits bit-equal to the single device on every rank; "
          f"generate_batch tokens equal phase 13's on every rank; per rank "
          f"{b0['launches']['cim_matmul']} K1 a forward and no other "
          f"kernel; ADC totals over the mesh {b0['adc']} = the single "
          f"device's; decode step eager {b0['step_ms']:.2f} ms (CUDA events, "
          f"median of {MESH_DECODE_REPS}), all-gather share "
          f"{b0['gather_share']:.3f} (host clock); rank 0's {b0['k1_calls']}"
          f" K1 calls of a decode step at the shard's shapes "
          f"{b0['k1_shapes']}: {_fmt_total(t, 'graph replay')}; max "
          f"|kernel - plain| {t['max_abs_err']!r}; peak memory per rank "
          + ", ".join(f"{rr['peak_gib']:.2f}" for rr in res)
          + f" GiB; the ranks took {ranks_s:.1f} s; nvidia-smi: {smi}",
          flush=True)

    _report_flash_decode(res, ref, smi)
    _report_data_parallel(res, ref, smi)
    _report_moe_ep(res, smi)
    _report_cells(torch, res, work, smi)

    # (c) the launcher
    rc4, lines4, s4 = _mesh_launch(["--mesh", str(MESH_RANKS),
                                    "--dist-backend", "gloo"])
    rc1, lines1, s1 = _mesh_launch(["--mesh", "1"])
    gc.collect()
    torch.cuda.empty_cache()
    cont = [[ln for ln in lines if "sample continuation" in ln]
            for lines in (lines4, lines1)]
    check(rc4 == 0 and rc1 == 0, f"17c launcher exits {rc4} (--mesh "
          f"{MESH_RANKS}) and {rc1} (--mesh 1)")
    check(len(cont[0]) == 1 and cont[0] == cont[1], f"17c tokens: "
          f"{cont[0]} against {cont[1]}")
    gen4 = [ln for ln in lines4 if "generated" in ln]
    print(f"phase 17c launch.serve {' '.join(MESH_LAUNCH_FLAGS)}: --mesh "
          f"{MESH_RANKS} --dist-backend gloo exit 0 in {s4:.1f} s ("
          f"{gen4[0] if gen4 else ''}), --mesh 1 exit 0 in {s1:.1f} s; "
          f"the same tokens {cont[0][0].split(':', 1)[1].strip()}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(Path(qat["paths"]["int8"]).parent, ignore_errors=True)
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s; "
          f"nvidia-smi: {smi}", flush=True)


# ---------------------------------------------------------------------------
# phase 18: FSDP and tensor parallelism over a (data, model) mesh of ranks
# ---------------------------------------------------------------------------

FSDP_ARCH = "llama3-8b"
#: published widths cut to 2 layers; the global batch 4 x 64 (+1 for the
#: labels): emulate's float32 partial sums (M x S x kt x N a linear, 0.94 GB
#: for wu at 256 rows on one device) and AdamW's float32 state (18 GB at
#: this depth, the 128,256-word embedding and head 12.6 GB of it) beside
#: four ranks' blocks on one card. lr 3e-4 after one warm-up step; 2 steps,
#: the checkpoint after the first (each gloo step on the shared card
#: takes 9-18 s)
FSDP_RUN = dict(n_layers=2, batch=4, seq=64, steps=2, ckpt_at=1, lr=3e-4,
                warmup=1)
FSDP_MESH = ((2, 2), ("data", "model"))
FSDP_WORK = ROOT / "build" / "chip_smoke_fsdp"
#: (a)'s step-1 gradient gate, PERF.md section 2's mesh gate: each leaf's
#: clipped gradient (its first moment / 0.1) within 2^-6 of its largest
#: magnitude (four bf16 ulps: the ranks sum the row-parallel partial
#: products and the batch blocks' gradients in another order than one
#: device, and each bf16 cast after a sum moves an element by an ulp where
#: the two sums round apart)
FSDP_GRAD_TOL = 2.0 ** -6
#: (a)'s params after its last step: tests/_torch_lm_train.py's one-step
#: bound,
#: per element REL x the leaf's largest magnitude + lr_t x 2 (the most a
#: first AdamW update's direction can move), applied per step and summed
FSDP_STEP_REL = 1e-4
#: (c): the trained tree packed int8 and served on 4 ranks of ("model",)
FSDP_SERVE = dict(batch=4, prompt=64, new=4, max_len=128)
#: the parent's device (a rehearsal on the CPU sets "cpu")
FSDP_DEV = "cuda"
#: the ranks' join limit, and their group's
FSDP_JOIN_S = 400


def _fsdp_cfg():
    from repro_torch.configs.registry import get_config
    return get_config(FSDP_ARCH, cim=train_cim()).replace(
        n_layers=FSDP_RUN["n_layers"])


def _fsdp_cell(mesh):
    """``build_cell``'s placements of the phase on ``mesh``
    (``RUN_HINTS``: FSDP on; one microbatch: the hints' 8 do not divide a
    batch of 4)."""
    from repro_torch.launch.cells import build_cell
    return build_cell(FSDP_ARCH, "train_4k", mesh, cim=train_cim(),
                      overrides={"n_layers": FSDP_RUN["n_layers"]}, accum=1)


def _fsdp_run(cell):
    r = FSDP_RUN
    return dataclasses.replace(cell.run, lr=r["lr"], warmup_steps=r["warmup"],
                               total_steps=r["steps"])


def _fsdp_batch(torch, dev):
    r = FSDP_RUN
    g = torch.Generator().manual_seed(25)
    return {"tokens": torch.randint(0, _fsdp_cfg().vocab,
                                    (r["batch"], r["seq"] + 1),
                                    generator=g).to(dev, torch.int32)}


def _lrs():
    """The learning rate of each step of the phase's run."""
    from repro_torch.optim.schedule import cosine_warmup
    r = FSDP_RUN
    return [float(cosine_warmup(t, base_lr=r["lr"], warmup_steps=r["warmup"],
                                total_steps=r["steps"]))
            for t in range(r["steps"])]


def _phase18_references(torch, work):
    """The single device's run of the phase (seed-0 weights, its AdamW
    steps on deterministic algorithms) in a fresh ``work``: its losses, the
    first moment after step 1 and the params after the last step saved as
    checkpoints
    (the ranks read their blocks), its step time and peak memory. It runs
    no kernel: ``main`` runs it beside the build."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    from repro_torch.train.trainer import make_train_step
    from repro_torch.launch.mesh import MeshShape
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = _fsdp_cfg()
    cell = _fsdp_cell(MeshShape(*FSDP_MESH))
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    with _Deterministic(torch):
        params = init_params(model.specs(cfg), 0, device=FSDP_DEV)
        init_state, step = make_train_step(model, cfg, _fsdp_run(cell))
        state = init_state(params)
        batch = _fsdp_batch(torch, FSDP_DEV)
        losses, ms = [], []
        for i in range(FSDP_RUN["steps"]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, m = step(params, state, batch)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            if i == 0:
                ckpt.save(str(work / "single_m1"), 1, state["m"])
    ckpt.save(str(work / "single_last"), FSDP_RUN["steps"], params)
    out = dict(losses=losses, ms=ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               n_params=sum(int(v.numel()) for v in _leaf_list(params)))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaf_list(tree):
    from repro_torch import tree_leaves
    return list(tree_leaves(tree))


def _checksum(torch, tree):
    """A position-weighted integer sum of every leaf's bits (its local
    block), in leaf order: equal trees give equal sums, and a flipped bit
    anywhere changes them."""
    from repro_torch.core import colshard
    out = []
    for leaf in _leaf_list(tree):
        x = colshard.local(leaf).detach().contiguous()
        bits = x.view(torch.int32) if x.element_size() == 4 else x.view(
            torch.int16)
        bits = bits.reshape(-1).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append(int((bits * w).sum()))
    return out


def _block_errs(torch, got, want, mesh):
    """{leaf path: (max |got - want|, max |want|)} over the whole leaves of
    two trees of this rank's blocks (maxima over the mesh)."""
    from repro_torch.core import colshard
    out = {}

    def walk(g, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        gl = colshard.local(g).float()
        wl = colshard.local(w).float()
        v = torch.stack([(gl - wl).abs().max(), wl.abs().max()])
        v = colshard.all_reduce(v, mesh, tuple(mesh.mesh_dim_names), "max")
        out[path] = (float(v[0]), float(v[1]))
    walk(got, want, "")
    return out


def _one_device_loss(torch, params, batch, model, cfg, rank, dev):
    """The loss of the mesh's params on one device, on rank 0: the whole
    tree gathered there leaf by leaf (``colshard.gather_first``: every
    rank takes part, rank 0 alone keeps it), then a forward with no mesh
    and no grad: the state the mesh's next step starts from, so the two
    losses hold the distributed arithmetic against one device's."""
    from repro_torch.core import colshard
    from repro_torch.nn.module import session_mesh
    from repro_torch.train.trainer import lm_loss_fn

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        full = colshard.gather_first(t)
        return None if full is None else full.to(dev)
    full = walk(params)
    if rank != 0:
        return None
    with torch.no_grad(), session_mesh(None):
        loss = float(lm_loss_fn(model, cfg)(full, batch))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def _fsdp_steps(torch, mesh, cell, step, params, state, batch, n, first=0):
    """``n`` steps on ``mesh`` from step ``first``: (params, state, losses,
    step ms on CUDA events, collective share of each step on the host
    clock)."""
    from repro_torch.core import colshard
    from repro_torch.nn.module import session_mesh
    losses, ms, share = [], [], []
    with session_mesh(mesh):
        for _ in range(n):
            torch.cuda.synchronize()
            c0, t0 = colshard.collective.seconds, time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, m = step(params, state, batch)
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ms.append(start.elapsed_time(end))
            share.append((colshard.collective.seconds - c0) / wall)
            losses.append(float(m["loss"]))
    return params, state, losses, ms, share


def _resume(torch, mesh, cell, dev):
    """The (a)'s checkpoint restored by ``resume_or_init`` under
    ``cell``'s placements on ``mesh``: (params, state, step)."""
    from repro_torch.runtime.fault_tolerance import (FaultTolerantLoop,
                                                     TrainLoopState)

    def init_fn():
        # the structure of a fresh state; the checkpoint is there, so no
        # weights are drawn
        def rec(t):
            if isinstance(t, dict):
                return {k: rec(v) for k, v in t.items()}
            return torch.empty((), device=dev)
        return TrainLoopState(params=rec(cell.arg_structs[0]),
                              opt_state=rec(cell.arg_structs[1]), step=0)
    loop = FaultTolerantLoop(str(FSDP_WORK / "ckpt"), async_save=False)
    st = loop.resume_or_init(init_fn, shardings={
        "params": cell.in_shardings[0], "opt_state": cell.in_shardings[1]},
        mesh=mesh)
    return st.params, st.opt_state, st.step


class _RowsRead:
    """While inside, the bytes of the batch rows that a data parallel
    train step takes (``train.trainer._rows``, each call's result)."""

    def __enter__(self):
        from repro_torch.launch.dryrun import tree_bytes
        from repro_torch.train import trainer
        self._rows, self.bytes = trainer._rows, 0

        def rows(*args):
            got = self._rows(*args)
            self.bytes += tree_bytes(got)
            return got
        trainer._rows = rows
        return self

    def __exit__(self, *exc):
        from repro_torch.train import trainer
        trainer._rows = self._rows


def _fsdp_train(torch, mesh, rank, dev):
    """(a) and (b) on this rank of the (2, 2) mesh."""
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt
    from repro_torch.core import colshard
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, place_tree
    from repro_torch.runtime.fault_tolerance import (FaultTolerantLoop,
                                                     TrainLoopState)
    from repro_torch.train.trainer import make_train_step
    cfg = _fsdp_cfg()
    cell = _fsdp_cell(mesh)
    model = get_model(cfg)
    init_state, step = make_train_step(model, cfg, _fsdp_run(cell))
    batch = _fsdp_batch(torch, dev)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model.specs(cfg), 0, device=dev,
                         placements=cell.in_shardings[0], mesh=mesh)
    state = place_tree(init_state(params), cell.in_shardings[1], mesh)
    blocks = {}
    for kind, tree in (("params", params), ("m", state["m"]),
                       ("v", state["v"])):
        layer = tree["layers"]
        for node in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wg",
                     "mlp/wu", "mlp/wd"):
            a, b = node.split("/")
            w = layer[a][b]["w"]
            blocks[f"{kind}/{node}"] = (list(w.shape),
                                        list(colshard.local(w).shape))
        blocks[f"{kind}/embed"] = (list(tree["embed"].shape), list(
            colshard.local(tree["embed"]).shape))
    out["blocks"] = blocks
    out["held"] = sum(colshard.local(v).numel() for v in _leaf_list(params))

    # (a) the steps; the first moment after step 1 against one device's,
    # the checkpoint after step ckpt_at, the params after the last step
    loop = FaultTolerantLoop(str(FSDP_WORK / "ckpt"), async_save=False)
    losses, ms, share = [], [], []
    t0 = time.perf_counter()
    for i in range(FSDP_RUN["steps"]):
        if i == 1:
            # one device on the mesh's step-1 state (step 1's is the
            # parent's run; the restore of the checkpoint checks the last
            # step again, in (b))
            out["same2"] = _one_device_loss(torch, params, batch, model, cfg,
                                            rank, dev)
        if i == 0:
            # 19(b): what this rank holds for step 1 (the params, the
            # optimizer state and the rows of the global batch that its
            # step reads) and its collectives over the step
            held = tree_bytes(params) + tree_bytes(state)
            colshard.reset_collective_counts()
        with _RowsRead() if i == 0 else contextlib.nullcontext() as rows:
            params, state, ls, tms, sh = _fsdp_steps(
                torch, mesh, cell, step, params, state, batch, 1)
        if i == 0:
            out["count1"] = dict(
                argument=held + rows.bytes, rows=rows.bytes,
                collectives=dict(colshard.collective.bytes),
                ops=sum(colshard.collective.ops.values()))
        losses += ls
        ms += tms
        share += sh
        if i == 0:
            m1_want = ckpt.restore(str(FSDP_WORK / "single_m1"), params,
                                   shardings=cell.in_shardings[0], mesh=mesh,
                                   device=dev)
            out["m1_errs"] = _block_errs(torch, state["m"], m1_want, mesh)
            del m1_want
        if i + 1 == FSDP_RUN["ckpt_at"]:
            c0 = time.perf_counter()
            loop.mgr.save(i + 1, FaultTolerantLoop._pack(
                TrainLoopState(params, state, i + 1)))
            loop.mgr.wait()
            out["save_s"] = time.perf_counter() - c0
    out["train_s"] = time.perf_counter() - t0
    out.update(losses=losses, ms=ms, share=share,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out["sum_last"] = _checksum(torch, [params, state["m"], state["v"]])
    last_want = ckpt.restore(str(FSDP_WORK / "single_last"), params,
                           shardings=cell.in_shardings[0], mesh=mesh,
                           device=dev)
    out["last_errs"] = _block_errs(torch, params, last_want, mesh)
    del params, state, last_want
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same mesh resumes from the checkpoint: its last step equals
    # (a)'s bit for bit
    t0 = time.perf_counter()
    params, state, at = _resume(torch, mesh, cell, dev)
    out["restore_s"] = time.perf_counter() - t0
    params, state, ls, _, _ = _fsdp_steps(torch, mesh, cell, step, params,
                                          state, batch, 1, at)
    out["resumed"] = dict(at=at, loss=ls[0], sum_last=_checksum(
        torch, [params, state["m"], state["v"]]))
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # (b) a ("model",) mesh of 2 ranks (ranks 0 and 1) restores it with
    # its own build_cell's placements; ranks 2 and 3 wait
    pair = mesh["model"]
    if rank < 2:
        pc = _fsdp_cell(pair)
        p2, s2, at2 = _resume(torch, pair, pc, dev)
        _, _, ls2, _, _ = _fsdp_steps(torch, pair, pc, step, p2, s2, batch,
                                      1, at2)
        held2 = sum(colshard.local(v).numel() for v in _leaf_list(p2))
        out["pair"] = dict(at=at2, loss=ls2[0], held=held2)
        del p2, s2
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return out, params


def _fsdp_serve(torch, mesh4, rank, dev, trained, work):
    """(c) on this rank: (a)'s trained tree (the resumed last step,
    bit-equal to it) gathered, packed int8, served by one device on rank 0
    and on the ("model",) mesh of 4 under the full ``sharding_rules``."""
    import torch.distributed as dist

    from repro_torch.api import model_artifact
    from repro_torch.core import colshard
    from repro_torch.launch.mesh import sharding_rules
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import session_mesh
    from repro_torch.serve.engine import engine_from_artifact
    cfg = _fsdp_cfg()
    sv = FSDP_SERVE
    full = colshard.full_tree(trained)
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    art = model_artifact(full, cfg.cim.replace(pack_dtype="int8"),
                         device=dev)
    pack_s = time.perf_counter() - t0
    del full
    gc.collect()
    torch.cuda.empty_cache()
    dcfg = cfg.replace(cim=art.config)
    model = get_model(dcfg)
    g = torch.Generator().manual_seed(26)
    prompts = torch.randint(0, cfg.vocab, (sv["batch"], sv["prompt"]),
                            generator=g)
    tokens = prompts.to(dev)
    out = {"pack_s": pack_s}
    if rank == 0:                      # the single device
        with torch.no_grad(), session_mesh(None):
            y1 = model.forward(art.params, tokens, dcfg).float()
            eng1 = engine_from_artifact(art, cfg, batch_size=sv["batch"],
                                        max_len=sv["max_len"], device=dev)
            t1 = eng1.generate_batch(prompts.numpy(), sv["new"])
        torch.save(dict(tokens=np.asarray(t1)), work / "serve_ref.pt")
        del eng1
    dist.barrier()
    t0 = time.perf_counter()
    eng = engine_from_artifact(art, cfg, mesh=mesh4,
                               rules=sharding_rules(mesh4),
                               batch_size=sv["batch"],
                               max_len=sv["max_len"], device=dev)
    del art
    gc.collect()
    torch.cuda.empty_cache()
    out["load_s"] = time.perf_counter() - t0
    p = eng.params
    nodes = [n["w_digits"] for _, n in _packed_nodes(p)]
    out["sharded_nodes"] = (sum(colshard.is_col_sharded(d) for d in nodes),
                            len(nodes))
    out["raw_placed"] = {k: str(getattr(v, "placements", None)) for k, v in (
        ("embed", p["embed"]), ("lm_head", p["lm_head"]["w"]))}
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counters()
        y = eng.model.forward(p, tokens, eng.cfg).float()
        torch.cuda.synchronize()
        out["launches"], out["floats"] = _read_counters()
        calls = _capture_kernel_calls(
            lambda: eng.model.forward(p, tokens, eng.cfg))
        out["k1_widths"] = sorted({int(a[1].shape[-1]) for a, _ in calls[
            "cim_matmul_transformer"]})
        out["k1_full"] = sorted({int(n.shape[-1]) for n in nodes})
        gen = eng.generate_batch(prompts.numpy(), sv["new"])
    out["finite"] = bool(torch.isfinite(y).all())
    out["logit_sum"] = float(y.double().sum())
    if rank == 0:
        out["diff"] = float((y - y1).abs().max())
        out["scale"] = float(y1.abs().max())
    ref = torch.load(work / "serve_ref.pt", weights_only=False)
    out["tokens_equal"] = bool(np.array_equal(np.asarray(gen),
                                              ref["tokens"]))
    out["sample"] = np.asarray(gen)[0].tolist()
    return out


def _phase18_rank(rank, world, port, work):
    """One rank of phase 18: gloo on the shared card; (a), (b) on the (2,
    2) mesh and its ("model",) pair, (c) on a ("model",) mesh of 4;
    results to ``work/rank<r>.json``."""
    import os
    # four ranks' blocks, gathered layers and emulate's partial sums share
    # one card: segments that grow in place waste less of it
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as lm
    work = Path(work)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = lm.init_rank(rank, world, port, backend="gloo", device="cuda",
                       timeout_s=FSDP_JOIN_S)
    try:
        mesh = lm.make_mesh(*FSDP_MESH, device=dev, backend="gloo")
        mesh4 = lm.make_mesh(world, ("model",), device=dev, backend="gloo")
        t0 = time.perf_counter()
        with _Deterministic(torch):
            res, trained = _fsdp_train(torch, mesh, rank, dev)
        res["train_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["serve"] = _fsdp_serve(torch, mesh4, rank, dev, trained, work)
        res["serve_s"] = time.perf_counter() - t0
        (work / f"rank{rank}.json").write_text(json.dumps(res, default=str))
    finally:
        dist.destroy_process_group()


def _phase18_single_restore(torch):
    """(b) on one device: (a)'s checkpoint restored by ``resume_or_init``
    with ``build_cell``'s placements on a mesh of one, then the next
    step."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import make_train_step
    cfg = _fsdp_cfg()
    cell = _fsdp_cell(MeshShape((1,), ("model",)))
    _, step = make_train_step(get_model(cfg), cfg, _fsdp_run(cell))
    with _Deterministic(torch):
        params, state, at = _resume(torch, cell.mesh, cell,
                                    torch.device(FSDP_DEV))
        _, _, m = step(params, state, _fsdp_batch(torch, FSDP_DEV))
        loss = float(m["loss"])
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return at, loss


def phase18_fsdp(torch, smi, single):
    """FSDP and tensor parallelism over a ("data", "model") mesh of (2, 2)
    gloo ranks sharing the card: (a) llama3-8b at published widths cut to 2
    layers, trained ``FSDP_RUN["steps"]`` AdamW steps under CIM emulate
    with ``build_cell``'s placements, against one device; (b) its
    checkpoint resumed on the same mesh (the last step bit-equal), on a
    ("model",) mesh of 2 and on one
    device; (c) the trained tree packed int8 and served on a ("model",)
    mesh of 4 under the full ``sharding_rules`` (K1 on N/4 columns, the
    embedding and the head vocab-parallel). ``single`` is
    ``_phase18_references``'s run, made beforehand in ``FSDP_WORK``."""
    import shutil

    from repro_torch.launch import mesh as lm
    t_phase = time.perf_counter()
    work = FSDP_WORK
    single["left_gib"] = torch.cuda.memory_reserved() / 2 ** 30
    print(f"phase 18 one device (run beside the build): losses "
          f"{single['losses']}, step ms "
          f"{[round(v, 2) for v in single['ms']]}, peak "
          f"{single['peak_gib']:.2f} GiB, {single['left_gib']:.2f} GiB "
          f"still reserved before the ranks", flush=True)
    t0 = time.perf_counter()
    try:
        lm.spawn(_phase18_rank, MESH_RANKS,
                 (MESH_RANKS, lm.free_port(), str(work)),
                 timeout_s=FSDP_JOIN_S)
    except Exception as e:           # a rank raised, or the ranks hung
        check(False, f"phase 18 ranks: {type(e).__name__}: {e}")
    ranks_s = time.perf_counter() - t0
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(MESH_RANKS)]
    at1, loss1 = _phase18_single_restore(torch)
    cfg = _fsdp_cfg()
    lrs = _lrs()
    steps = FSDP_RUN["steps"]

    # (a) each step's loss against one device's on the same params: step
    # 1's the one device's own run (the seed-0 weights), step 2's rank 0's
    # forward on the gathered step-1 state and, as the last step, the one
    # device's restore of the checkpoint ((b)). The one device's own run
    # parts from the mesh's after step 1 and is printed beside: AdamW's
    # first update is lr x sign(g), and a gradient within rounding of zero
    # takes either sign
    same = [single["losses"][0], res[0]["same2"]]
    for r, rr in enumerate(res):
        for i, (got, want) in enumerate(zip(rr["losses"], same)):
            check(abs(got - want) <= 1e-5 * abs(want), f"18a rank {r} step "
                  f"{i + 1}: loss {got!r} against one device's {want!r} on "
                  "the same params")
        check(rr["losses"] == res[0]["losses"], f"18a rank {r}: losses "
              "differ from rank 0's")
        bad = {k: e / s for k, (e, s) in rr["m1_errs"].items()
               if not e <= FSDP_GRAD_TOL * s}
        check(not bad, f"18a rank {r}: step-1 gradients (first moments) off "
              f"by (max |diff| / max |single|) {bad}")
        lim = steps * FSDP_STEP_REL
        bad = {k: e for k, (e, s) in rr["last_errs"].items()
               if not e <= lim * s + 2 * sum(lrs)}
        check(not bad, f"18a rank {r}: params after step {steps} off by "
              f"{bad}")
        for k, (shape, local) in rr["blocks"].items():
            check(int(np.prod(local)) * 4 == int(np.prod(shape)),
                  f"18a rank {r}: {k} holds {local} of {shape}")
    a0 = res[0]
    m1 = max(e / s for e, s in a0["m1_errs"].values())
    plast = max(e for e, _ in a0["last_errs"].values())
    mid = int(np.argsort(a0["ms"][1:])[len(a0["ms"][1:]) // 2]) + 1
    print(f"phase 18a {cfg.name} ({cfg.n_layers} layers, published widths, "
          f"{single['n_params'] / 1e9:.3f} B params, CIM emulate, AdamW in "
          f"float32) on a (data, model) = {FSDP_MESH[0]} mesh of gloo ranks "
          f"sharing the card, build_cell's placements (FSDP: embed over "
          f"data; heads, mlp, vocab over model), batch {FSDP_RUN['batch']} "
          f"x {FSDP_RUN['seq']}, {steps} steps: losses "
          f"{a0['losses']} against one device's on the same params {same} "
          f"(gate 1e-5 relative; the one device's own run "
          f"{single['losses']}); step-1 gradients within "
          f"{m1:.3g} of each leaf's largest magnitude (gate "
          f"{FSDP_GRAD_TOL:.4g}); params after step {steps} within "
          f"{plast:.3g} "
          f"(gate {steps} x ({FSDP_STEP_REL:g} of the leaf's scale + 2 lr)); "
          f"each rank holds a quarter of every embed x (heads|mlp) weight "
          f"and of its moments ({a0['held'] / 1e9:.3f} B params a rank); "
          f"step ms on rank 0 {[round(v, 2) for v in a0['ms']]} (CUDA "
          f"events; one device {[round(v, 2) for v in single['ms']]}), "
          f"collectives' share {a0['share'][mid]:.3f} (host clock, the "
          f"median step); peak memory per rank "
          + ", ".join(f"{rr['peak_gib']:.2f}" for rr in res)
          + f" GiB (one device {single['peak_gib']:.2f}); the step-"
          f"{FSDP_RUN['ckpt_at']} checkpoint written in {a0['save_s']:.1f} s;"
          f" nvidia-smi: {smi}",
          flush=True)

    # (b)
    for r, rr in enumerate(res):
        g = rr["resumed"]
        check(g["at"] == FSDP_RUN["ckpt_at"] and g["loss"] == rr["losses"][
            -1] and g["sum_last"] == rr["sum_last"], f"18b rank {r}: the "
              f"resume on the same mesh (from step {g['at']}) gave loss {g['loss']!r} "
              f"against {rr['losses'][-1]!r}; bit-equal state "
              f"{g['sum_last'] == rr['sum_last']}")
    want = a0["losses"][-1]
    for r in (0, 1):
        g = res[r]["pair"]
        check(g["at"] == FSDP_RUN["ckpt_at"] and abs(g["loss"] - want)
              <= 1e-5 * abs(want), f"18b rank {r} on the ('model',) mesh of "
              f"2: step-{steps} loss {g['loss']!r} against {want!r}")
    check(at1 == FSDP_RUN["ckpt_at"] and abs(loss1 - want) <= 1e-5 * abs(
        want), f"18b one device: step-{steps} loss {loss1!r} against "
        f"{want!r}")
    print(f"phase 18b the step-{FSDP_RUN['ckpt_at']} checkpoint (written "
          f"once by rank 0 in the reference's format) resumed by "
          f"resume_or_init(shardings=) on the same mesh: step {steps} "
          f"bit-equal to 18a's on every rank (loss {want!r}, params and "
          f"moments), restored in {a0['restore_s']:.1f} s; on a ('model',) "
          f"mesh of 2 ({res[0]['pair']['held'] / 1e9:.3f} B params a rank): "
          f"step-{steps} "
          f"loss {res[0]['pair']['loss']!r}; on one device: "
          f"{loss1!r}; nvidia-smi: {smi}", flush=True)

    # (c)
    dcfg_k1 = 7 * cfg.n_layers
    for r, rr in enumerate(res):
        g = rr["serve"]
        check(g["finite"] and g["tokens_equal"], f"18c rank {r}: finite "
              f"{g['finite']}, tokens equal the single device's "
              f"{g['tokens_equal']}")
        check(g["logit_sum"] == res[0]["serve"]["logit_sum"], f"18c rank {r}"
              ": prefill logits differ from rank 0's")
        want_l = {"cim_matmul": dcfg_k1, "cim_conv": 0,
                  "cim_matmul_adc_free": 0, "cim_conv_adc_free": 0,
                  "cim_matmul_experts": 0, "plain_gathers": 0}
        check(g["launches"] == want_l and not any(g["floats"].values()),
              f"18c rank {r}: launches {g['launches']}, expected {want_l}")
        check(g["k1_widths"] == sorted({n // MESH_RANKS for n in g[
            "k1_full"]}), f"18c rank {r}: K1 widths {g['k1_widths']} "
              f"against N/{MESH_RANKS} of {g['k1_full']}")
        check(g["sharded_nodes"][0] == g["sharded_nodes"][1], f"18c rank {r}"
              f": {g['sharded_nodes']} packed nodes sharded")
        check("Shard(dim=0)" in g["raw_placed"]["embed"] and "Shard(dim=1)"
              in g["raw_placed"]["lm_head"], f"18c rank {r}: raw leaves "
              f"placed {g['raw_placed']}")
    c0 = res[0]["serve"]
    check(c0["diff"] <= 1e-4 * c0["scale"], f"18c prefill logits: max |mesh "
          f"- single| {c0['diff']!r} over largest {c0['scale']!r}")
    sv = FSDP_SERVE
    print(f"phase 18c the trained tree gathered and packed int8 "
          f"({c0['pack_s']:.2f} s), {sv['batch']} prompts of {sv['prompt']} "
          f"+ {sv['new']} new tokens on a ('model',) mesh of {MESH_RANKS} "
          f"under sharding_rules (embedding {c0['raw_placed']['embed']} and "
          f"head {c0['raw_placed']['lm_head']}: vocab-parallel; packed "
          f"columns): prefill logits within {c0['diff']!r} of the single "
          f"device's (largest {c0['scale']:.4f}; gate 1e-4 of it), tokens "
          f"equal the single device's on every rank, sample {c0['sample']}; "
          f"per rank {c0['launches']['cim_matmul']} K1 a forward on widths "
          f"{c0['k1_widths']} (N/{MESH_RANKS}) and no other kernel; loaded "
          f"in {c0['load_s']:.2f} s; nvidia-smi: {smi}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 18 took {time.perf_counter() - t_phase:.1f} s (the ranks "
          f"{ranks_s:.1f} s: rank 0's training {a0['train_s']:.1f} s, (a)-(b) "
          f"{a0['train_phase_s']:.1f} s, (c) {a0['serve_s']:.1f} s); "
          f"nvidia-smi: {smi}", flush=True)
    return res[0]["count1"]


# ---------------------------------------------------------------------------
# phase 19: the dry run against the card
# ---------------------------------------------------------------------------

#: the whole script's seconds, the build included, that it is cut to fit
RUN_BUDGET_S = 750
DRY_OUT = ROOT / "build" / "chip_smoke_dryrun.json"
#: the dry runs' time limit (they count in seconds; started before the
#: build, they are done long before phase 19)
DRY_LIMIT_S = 300


def _start_dry_runs():
    """Start ``_dry_runs`` in a process of its own, with no card visible
    (it counts on ``meta`` tensors and joins the fake process group, so
    nothing of this process's CUDA or group state is near it); its output
    goes to a log beside ``DRY_OUT``."""
    import os
    DRY_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRY_OUT.unlink(missing_ok=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import chip_smoke; chip_smoke._dry_runs()")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    with open(DRY_OUT.with_suffix(".log"), "w") as log:
        return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def _dry_runs() -> None:
    """Phase 19's two cells counted by ``launch.dryrun.run_cell``, their
    records written to ``DRY_OUT``: (a) phase 16a's run, qwen3-0.6b uncut
    on one device at batch 8 x 256 under the training launcher's CIM
    config, AdamW, one microbatch; (b) phase 18's cell, llama3-8b cut to
    2 layers on the (2, 2) mesh with ``build_cell``'s placements at batch
    4 x 64, as rank 0 of the fake process group, with the bytes of the
    batch rows that rank holds under the cell's placements apart."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import argument_bytes, rank_cell, run_cell
    from repro_torch.launch.mesh import MeshShape
    train = SHAPES["train_4k"]
    t0 = time.perf_counter()
    a = run_cell(TRAIN_ARCH, dataclasses.replace(
        train, seq_len=TRAIN_RUN["seq"], global_batch=TRAIN_RUN["batch"]),
        mesh=MeshShape((1, 1), ("data", "model")), cim=train_cim(),
        accum=1, verbose=False)
    shape = dataclasses.replace(train, seq_len=FSDP_RUN["seq"],
                                global_batch=FSDP_RUN["batch"])
    kw = dict(cim=train_cim(), overrides={"n_layers": FSDP_RUN["n_layers"]},
              accum=1)
    b = run_cell(FSDP_ARCH, shape, mesh=MeshShape(*FSDP_MESH), verbose=False,
                 **kw)
    with rank_cell(FSDP_ARCH, shape, MeshShape(*FSDP_MESH), **kw) as (cell,
                                                                     _):
        b["batch_placed"] = argument_bytes(cell, 2)
    DRY_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRY_OUT.write_text(json.dumps({"a": a, "b": b,
                                   "seconds": time.perf_counter() - t0}))


def _bound(rec):
    r = rec["roofline"]
    terms = {k: r[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(terms.values()) * 1e3, max(terms, key=terms.get)[:-2]


def phase19_dry_run(dry, step16, step18, smi) -> None:
    """The dry run against the card: (a) phase 16a's step ``PROBE_STEP``
    (``_StepProbe``): the dry run's argument bytes equal the bytes of the
    params, AdamW state and batch the step took on the card, and its
    FLOPs ``FlopCounterMode``'s count of that step, exactly; its meta peak
    beside the card's ``max_memory_allocated`` over the step and its
    roofline bound beside 16a's median step are printed, no gate. (b)
    phase 18's first step on rank 0: the dry run's argument bytes a rank
    (and its batch's bytes apart: the rows the rank's step read, counted
    by ``_RowsRead``) and its collective bytes by kind (and ops) equal
    what the rank held and counted, exactly."""
    t_phase = time.perf_counter()
    rc = dry.wait(timeout=DRY_LIMIT_S)
    log = DRY_OUT.with_suffix(".log").read_text()
    check(rc == 0 and DRY_OUT.exists(), f"phase 19: the dry runs exited "
          f"{rc}: {log[-3000:]}")
    res = json.loads(DRY_OUT.read_text())
    a, b = res["a"], res["b"]
    check(a["status"] == "ok" and b["status"] == "ok", f"phase 19: dry-run "
          f"status {a['status']}, {b['status']}")

    pa = a["per_device"]
    check(pa["bytes_per_device_argument"] == step16["argument"], f"19a "
          f"argument bytes: the dry run's {pa['bytes_per_device_argument']}"
          f", the card's {step16['argument']}")
    check(pa["hlo_flops"] == step16["flops"], f"19a FLOPs: the dry run's "
          f"{pa['hlo_flops']}, FlopCounterMode's on the card "
          f"{step16['flops']}")
    bound_ms, by = _bound(a)
    gib = 2 ** 30
    print(f"phase 19a {TRAIN_ARCH} (uncut, batch {TRAIN_RUN['batch']} x "
          f"{TRAIN_RUN['seq']}, one device, the training launcher's CIM "
          f"config on emulate, AdamW): the dry run's argument bytes "
          f"{pa['bytes_per_device_argument']} = the params, AdamW state and "
          f"batch of 16a's step {step16['step']} on the card; its FLOPs "
          f"{pa['hlo_flops']} = FlopCounterMode's count of that step on "
          f"the card (by dtype {pa['flops_by_dtype']}); meta peak "
          f"{pa['bytes_per_device_peak'] / gib:.2f} GiB beside the card's "
          f"max_memory_allocated over the step {step16['peak'] / gib:.2f} "
          f"GiB (ratio {pa['bytes_per_device_peak'] / step16['peak']:.3f});"
          f" roofline bound {bound_ms:.2f} ms by {by} (compute "
          f"{a['roofline']['compute_s'] * 1e3:.2f}, memory "
          f"{a['roofline']['memory_s'] * 1e3:.2f} ms) beside 16a's median "
          f"step {step16['step_ms']:.2f} ms (bound / step "
          f"{bound_ms / step16['step_ms']:.3f}); counted in "
          f"{a['count_s']} s; nvidia-smi: {smi}", flush=True)

    pb = b["per_device"]
    check(pb["bytes_per_device_argument"] == step18["argument"], f"19b "
          f"argument bytes a rank: the dry run's "
          f"{pb['bytes_per_device_argument']}, rank 0's {step18['argument']}")
    check(b["batch_placed"] == step18["rows"], f"19b batch bytes a rank: "
          f"the placements' {b['batch_placed']}, the rows rank 0's step "
          f"read {step18['rows']}")
    check(b["collectives"] == step18["collectives"]
          and pb["collective_ops"] == step18["ops"], f"19b collectives: the "
          f"dry run's {b['collectives']} ({pb['collective_ops']} ops), rank "
          f"0's {step18['collectives']} ({step18['ops']} ops)")
    bound_ms, by = _bound(b)
    print(f"phase 19b {FSDP_ARCH} ({FSDP_RUN['n_layers']} layers, batch "
          f"{FSDP_RUN['batch']} x {FSDP_RUN['seq']}, (data, model) = "
          f"{FSDP_MESH[0]}, build_cell's placements) as rank 0 of the fake "
          f"process group: argument bytes a rank "
          f"{pb['bytes_per_device_argument']} (the batch's "
          f"{b['batch_placed']} of them = the bytes of the rows rank 0's "
          f"step read, counted as it took them) and collective bytes of "
          f"one step by kind {b['collectives']} ({pb['collective_ops']} "
          f"ops) = what rank 0 of phase 18's gloo run held and counted "
          f"over its step 1; "
          f"FLOPs a rank {pb['hlo_flops']}, roofline bound {bound_ms:.2f} "
          f"ms by {by} on one H100 (NVLink 4); counted in {b['count_s']} s",
          flush=True)
    print(f"phase 19 took {time.perf_counter() - t_phase:.1f} s (the two "
          f"dry runs counted in {res['seconds']:.1f} s in a process of "
          f"their own, started before the build)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
