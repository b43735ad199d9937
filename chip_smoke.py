#!/usr/bin/env python3
"""The quickest proof that coral_tpu_torch runs on an NVIDIA GPU (one H100).

Run from the root of the repository:

    python3 chip_smoke.py

It drives the port's paths through the hand-written CUDA kernels, with seeded
random weights in bf16, at every model config of the repository: wav2vec2
serving, ``ASRPipeline`` with XLS-R-300M (24 layers, 30 s window, batch 8),
also from a checkpoint written to disk with an n-gram LM beside it;
wav2vec2 training, the CTC train step of ``Wav2Vec2Setup.make_train_step`` (8
clips of 6-10 s padded to 10 s, 2 accumulation microbatches); Whisper
serving, ``ASRPipeline("openai/whisper-large-v3")`` (32 + 32 layers, d 1280,
30 s windows, batch 8, greedy generation to 225 tokens), also from an F16
checkpoint written to disk; Whisper training,
the seq2seq train step of ``WhisperSetup.make_train_step`` (8 clips of 6-10 s
padded to 30 s, 2 accumulation microbatches); XLS-R-2B's production
fine-tune and serving at full width and depth (48 layers, d 1920, 16 heads x
120); XLS-R-1B (d 1280, 16 x 80), whisper-small, -base and -tiny at full
width, each served and trained; the production fine-tune's kernel routes
off the defaults; and fine-tuning through the port's loop (``finetune``:
the config composer, the data pipeline, checkpoints, resume, evaluation and
the saved model served), wav2vec2-small and whisper-small, then
evaluation, validation, the n-gram LM and the demo through ``python -m
coral_tpu_torch`` on the directories it saved. It runs in
phases; any failing phase exits non-zero before the result line is printed:

1. a CUDA card is required (no CPU fallback); the card's name and power limit
   (nvidia-smi), torch, CUDA and nvcc versions are printed;
2. the kernels are built from ``coral_tpu_torch/csrc`` (the native decoder
   from ``coral_tpu_torch/native`` with g++ beside them) and the build time is
   printed, with the registers and spill bytes of the backward mainloop's
   instantiations (the flash backward's and the short-T backwards' pairs)
   and v1's from ptxas's report; then the LayerNorm wrappers' host path
   piece by piece (``coral_tpu_torch/tools/probe_ln_host.py``, microseconds
   a call over 1,000 calls), with the pieces the earlier path ran and this
   one no longer does timed as it ran them;
3. each kernel runs at its path's own shapes in bf16 against its plain
   PyTorch version: errors against a stated tolerance, and both times (CUDA
   events, median of 10), with the least time the card could take for the
   same work (its bound, from the shapes) and, where one PyTorch call computes
   the same function, that call's time as a yardstick the port never uses;
   the feature encoder's training forward and backward at FE blocks 1 and 5,
   its rows with cuDNN's convolution alone beside them (the forward; dgrad
   and wgrad for the backward), a yardstick the port never calls, and the
   device kernels one K3 backward call launches;
   Whisper's encoder flash attention, decode self-attention (K = 1, and K = 5
   beams at a reduced batch), decode cross-attention (each decode wrapper's
   device kernels a call by the profiler, which must be 1, and its host
   microseconds a call over 1,000 calls) and the FFN at D = 1280 (the
   FFN wrappers' device kernels a call, the forward's must be 1, and their
   microseconds a call at D 1280 on 16 rows; every K5 row of this
   phase and of the width checks prints cuBLAS's fc1 product alone at its
   shape beside it, a yardstick the port never calls);
   Whisper training's flash forward with its row stats, the flash backward's
   dq and dkv kernels (dq first: it writes the di that dkv reads) and the
   pair as one call, launched twice for the same bits (so too with segment
   ids at head_dim 64, 80 and 120), each instantiation's registers and spill
   bytes from ptxas's report, and the FFN's dropout forward, its backward (at
   the encoder's and the decoder's rows) and the LN backward at D = 1280; and
   each kernel at the other configs' widths: the LN forward at 1280 and 1920,
   the attention forward and backward at head_dim 80 and 120, the FFN's three
   kernels at 384, 512, 768 and 1920, the LN backward at 384, 768 and 1920;
   the attention backwards beside PyTorch's memory-efficient attention
   backward with the key or segment mask as its bias, the LN backwards beside
   ``aten.native_layer_norm_backward``; the CTC recursions at T' 499, B 8,
   S 257 with the same bits on two calls, the kernel alone, its latency
   floor (``coral_tpu_torch/tools/probe_ctc.py``: the recursion without
   the emission ring or stores) and ``F.ctc_loss`` forward and backward at
   the same shapes (it computes the loss and gradient too: no yardstick of
   K6's function); one LayerNorm as training runs it
   (``ln_fused`` forward and backward under autograd with bf16 work copies of
   gamma and beta, at 8 x 499 x 1024) beside ``F.layer_norm``'s, each side's
   events and device time and its device kernels by the profiler; each row's share of its bound and
   its ratio to the library call, by events and by device time (a single
   call's events time holds its host launch path); the host time a forward
   launch and a flash backward launch spend encoding their TMA tensor maps,
   at head_dim 64, 80 and 120; then the H100 probes
   (``coral_tpu_torch/tools``): the K3 backward's seven modes at FE blocks 1
   and 5 (batch 8 x 10 s; ``full`` bit for bit the production backward),
   each launch timed by CUDA events, and the gelu_cost and lane_reduce
   kernels' cases, checked at a few steps and timed at the probes' own;
4. serving: ``transcribe_batch`` on 12 clips of 3-30 s (the second device
   batch is partial, with fully masked filler rows) and ``transcribe`` on a
   45 s clip (long-form windows), with the kernels' launch counts over that
   run; then finite logits, the kernel path's logits against the plain path's
   on the same weights and batch, audio-seconds per second, latency per batch
   and peak device memory;
5. serving from disk (t): the serving phase's seeded XLS-R-300M written as
   an F32 ``Wav2Vec2ForCTC`` checkpoint (``model.safetensors``, the
   positional conv as weight norm's g and v) beside a ``3gram.arpa`` that
   the port's ``NGramModel.train`` makes from seeded sentences, then
   ``ASRPipeline(dir)`` (its load seconds): every parameter bit for bit the
   written one (the folded conv within 1e-6 relative), the logits on 8 x
   30 s against the seeded model's and the plain path's, one forward's
   launches the greedy serving phase's exactly, ``no_lm=True`` the greedy
   decode of the same logits; then the 12 clips through ``transcribe_batch``
   with the LM (launches counted; each device batch split into its forward
   and the host's decode) and without it, audio-s/s each, and the four
   shortest clips' LM transcripts again (the same strings);
6. training: (a) the kernel path's loss and gradients against the plain
   path's (``Wav2Vec2ForCTC(plain=True)``: every kernel's plain version,
   forward and backward, and the plain CTC recursions) on the same weights,
   batch and generator seed, the feature encoder training under save_qk_ctx,
   at activation dropout 0 with SpecAugment on; (b) the frozen encoder under
   nothing_saveable, augmentation off, and (c) the production configuration
   (the feature encoder training, save_qk_ctx, the augmentation chain with a
   seeded synthetic noise bank), each for several optimizer steps on one
   fixed batch with the same draws each step: exact launch counts over the
   first step, finite losses and a last loss below the first, training
   audio-s/s, ms per step against the plain path's, peak memory, and a
   ``torch.profiler`` breakdown of one step;
7. Whisper serving (d): ``transcribe_batch`` on 12 clips of 3-30 s (two
   device batches, the second partial) with exact launch counts (flash
   attention and the 1280-wide FFN 32 per encoder call, decode self- and
   cross-attention 32 per decode step) and the number of decode steps;
   audio-s/s, latency per batch, encoder ms, ms per decode step, peak memory,
   a profile of one batch; then the kernel path against the plain path
   (``WhisperForConditionalGeneration(plain=True)``) on the same weights and
   batch: the encoder output, and the logits of every decode step with both
   paths fed the kernel path's ids;
8. Whisper serving from disk (u): a seeded large-v3 at the published
   vocabulary written as F16 (``model.safetensors``, ~3.2 GB) beside a
   ``vocab.json`` of 50,257 BPE tokens and ``merges.txt``, then
   ``ASRPipeline(dir)`` (its load seconds): 51,866 ids, every parameter
   bit for bit the file's after the cast to fp32; one batch of 8 x 30 s
   through the encoder and greedy decoding capped at 16 tokens with exact
   launch counts, the encoder output and the teacher-forced logits against
   the plain path;
8'. Whisper beam search (v): config/model/whisper-large.yaml with
   ``generation_num_beams: 5`` through ``WhisperSetup.make_predictor`` on one
   batch of 8 x 30 s (max_length 225): exact launch counts (flash attention
   and the 1280-wide FFN 32 per encoder call, decode self- and
   cross-attention 32 per beam step), the first 72 steps' logits against the
   plain path fed the kernel path's tokens and slot masks; beam 5 against
   greedy on the same batch at large-v3 and whisper-small (ms per batch and
   per decode step, the host's ms a step outside ``decode_step``, the busy
   share of a beam batch); ``return_timestamps: true`` greedy and beam 5,
   every row held to the timestamp grammar; ``transcribe_longform`` and
   ``transcribe_longform_timestamps`` on a 75 s clip; ``run_validation``
   with the beam predictor over (d)'s 12 clips against seeded references;
9. Whisper training (e): config/model/whisper-large.yaml with
   config/asr_finetuning.yaml (save_flash_ctx, activation dropout 0.1,
   SpecAugment, the augmentation chain with a seeded synthetic noise bank,
   bf16 gradients over fp32 masters, a bf16 first Adam moment): the kernel
   path's loss and gradients against the plain path's on one microbatch,
   then several optimizer steps on one fixed batch with exact launch counts
   over the first, finite losses and a last loss below the first, ms per
   step, training audio-s/s, peak memory and a profile of one step;
10. training (f), the slice's main path: config/model/wav2vec2-large.yaml
   (XLS-R-2B) with config/asr_finetuning.yaml through
   ``Wav2Vec2Setup.make_train_step``, (c)'s configuration and traffic: the
   kernel path's loss and gradients against the plain path's on one
   microbatch at 24 of the 48 layers, then 10 steps at full depth (the
   config's 1000-step warmup, the same draws each step, as (b) and (c))
   with exact launch counts over the first, a
   falling loss, ms per step, audio-s/s, the step state against the peak
   memory and a profile of one step;
11. serving (f'): ``ASRPipeline("facebook/wav2vec2-xls-r-2b")`` on the 12 clips
   of phase 4, the logits against the plain path, audio-s/s, latency and
   peak memory;
12. (g) XLS-R-1B (wav2vec2-medium.yaml): serving as (f'), then 3 steps of
   the production step with exact launch counts and finite losses;
13. (h), (i) whisper-small, whisper-xsmall (base), whisper-xxsmall and
   test-whisper (tiny) through ``WhisperSetup``: one batch of 8 clips served
   greedily with exact launch counts, the encoder output and 32 steps of
   teacher-forced logits against the plain path; then (test-whisper aside)
   3 steps of the seq2seq step with exact launch counts over the first and
   finite losses;
14. the unfused routes: the flash kernels with segment ids and GELU +
   dropout checked with the other kernels in phase 3; (j)
   config/model/wav2vec2-small.yaml + config/asr_finetuning.yaml with
   ``attention_impl: flash`` and ``fused_ffn: false``: the serving clips
   through ``Wav2Vec2Setup.make_predictor``, the kernel path against the
   plain path on one microbatch with activation dropout on, 10 steps of (c)
   with exact launch counts and a falling loss (the route phases (j)-(s')
   time no plain step); (j') the same with
   ``attention_impl: xla``, one batch and 2 steps; (k) (e) with
   ``fused_ffn: false``, the kernel path against the plain path and 2 steps;
15. the FFN without the folded LayerNorm or the block: fc1's kernels N1-N4
   checked with the other kernels in phase 3 (at rate 0 and 0.1, at D 384
   and 1920 too); (l) (c)'s configuration with ``fused_ffn_ln: false`` (LN2
   apart, the LayerNorm-less block): one serving batch through the setup's
   predictor, the kernel path against the plain path on one microbatch at
   activation dropout 0.1, 2 steps; (l') with ``fused_ffn_block: false``
   added (fc1 alone, its forward again in each replay): one batch and 2
   steps; (m) (e) with ``fused_ffn_block: false`` (the LayerNorm-folded fc1
   and its backward N4): the kernel path against the plain path and 2 steps;
   each with exact launch counts;
16. the LayerNorm-folded block's variants: N5 (dg read in), N6 (the weight
   gradients in the kernels) and N7 (fc2 in the forward kernel) checked with
   the other kernels in phase 3 (at rate 0 and 0.1, at D 384, 512, 768 and
   1920 too; N7's mask against N5's, bit for bit; N7's y and N6's dW1 and
   dW2 the same bits on a second call; N7's cluster size and the clusters
   the card holds at once, N6's row ranges); (n) (c)'s configuration with
   ``fused_ffn_block_fc2: true``: one serving batch, the kernel path against
   the plain path on one microbatch at activation dropout 0.1, 2 steps; (n')
   with ``fused_ffn_block_dw: true``: kernel against plain, 2 steps; (n'')
   with ``fused_ffn_block_dg: false``: 2 steps; (o) (e) with
   ``fused_ffn_block_dw: true``: kernel against plain, 2 steps; (o') (e)
   with ``fused_ffn_block_fc2: true``: one batch served, 2 steps; each with
   exact launch counts;
17. the packed QKV projection and the attention without biases: the
   LayerNorm-folded projection's forward and backward and the v3 attention's
   kernels without their bias loads checked with the other kernels in phase
   3 (at D 1024 on the paths' shapes, at 1280 and 1920, head_dim 80 and 120;
   the projection's forward beside cuBLAS's product alone and the two-call
   composition, ``F.layer_norm`` then ``F.linear``, and timed at 1280 and
   1920 too; the attention's outputs those of the biased kernels at zero
   biases, bit for bit); (p) (c)'s configuration with ``fused_qkv_ln: true``: one
   serving batch, the kernel path against the plain path on one microbatch
   at activation dropout 0.1, 2 steps; (p') with
   ``attention_fused_qkv_bias: false``: one batch, kernel against plain, 2
   steps; each with exact launch counts and its ms per step beside (c)'s;
18. the attention's other routes: the forward without stats, v1's forward
   and the three backwards (their dq kernels sweeping twice) checked and timed with
   the other kernels in phase 3 (forwards at 8 x 1499 rows beside SDPA, v1's
   at 8 x 499 too, backwards at 8 x 499, head_dim 64, 80 and 120; the fully
   masked row without gradient on the stats routes, with the uniform
   average's on the others; the forward without stats bit for bit the v2
   forward's o, v1's lse bit for bit the v2 forward's lse; v1's p = e times
   1 / l against e / l, rounded to bf16 on the card; one backward on packed
   lane thirds); (q) (c)'s configuration with
   ``attention_save_stats: false``: one serving batch, the kernel path against
   the plain path on one microbatch at activation dropout 0.1, 2 steps; (q')
   with ``attention_o_residual: true``, (r) ``attention_save_stats: v2``: kernel
   against plain, 2 steps each; (r') ``attention_save_stats: true``: one
   batch, kernel against plain, 2 steps; each with exact launch counts and
   its ms per step beside (c)'s;
19. the flash route at XLS-R-1B's and -2B's widths: the flash kernels with
   segment ids at head_dim 80 and 120 checked and timed with the other
   kernels in phase 3 (8 x 1499 -> 1536 and 8 x 499 -> 512); (s) (g)'s
   configuration (wav2vec2-medium.yaml) and (s') (f)'s (wav2vec2-large.yaml)
   with ``attention_impl: flash``: one serving batch through the setup's
   predictor, the kernel path against the plain path on one microbatch at
   activation dropout 0.1 (24 of the 48 layers), 2 steps at full depth, each
   with exact launch counts and its ms per step beside (g)'s and (f)'s;
20. fine-tuning through the port's loop (w): ``compose("asr_finetuning")``
   with config/model/wav2vec2-small.yaml (``model.use_decoder=false``), the
   ``synthetic://`` data source, 2 x 8 clips a step and an eval pass and a
   checkpoint every 2 steps, then three runs of ``finetune``: A to step 2, B
   resuming A to step 4 (steps 3-4 traced through ``profile_step``), C
   straight to step 4; each with exact launch counts (the production step's
   a step, the serving forward's a batch of each eval pass) and its
   checkpoint steps, best and latest step against orbax's rule; B's batches
   at steps 3-4 (their hashes) and losses against C's, the masters' max|diff|
   after step 4; C's saved directory through ``load_saved_predictor`` on the
   serving clips, the strings (and logits) of a predictor on C's final state;
   the loop's step against the bare train step on one of C's batches, the
   device busy share of B's traced steps, audio-s/s and infeed MB a step, the
   eval pass, and the train state's checkpoint: GB, host snapshot, write and
   restore ms; (w') the same loop on config/model/whisper-small.yaml (max_length
   32) to step 2 with one eval pass over 8 clips: exact launch counts (the
   train step's, the eval generation's encoder and decode steps), the saved
   directory served with the in-memory predictor's strings and ids, the
   loop's step against the bare step;
21. the port's entry points on those saved directories (x): ``python -m
   coral_tpu_torch train-ngram`` trains the n-gram LM into (w)'s (synthetic
   sentences less those of the evaluation set; ARPA and binary at order 3),
   ``evaluate`` in-process without the LM (exact launch counts; its overall
   CER/WER those of a fresh predictor's strings), the stream's forward
   against the LM's host decode, then the ``evaluate`` command with the LM
   (200 bootstrap samples) and without it (its overall row the in-process
   one), ``validate`` (its predictions ``add_validations``'s in-process,
   whose kept and dropped rows add up) and ``demo``'s stdin loop on a 4 s and
   a 25 s WAV (``make_transcriber``'s lines), the four started together, and
   Whisper's ``evaluate`` on (w')'s (exact launch counts), with each
   command's wall seconds;
22. the wav2vec2 configurations off XLS-R's routes: (y) facebook/wav2vec2-base's
   published architecture (hidden 768, 12 layers of 12 x 64 heads, FFN 3072,
   the feature encoder's 7 x 512 convs without biases under group norm, the
   post-LN encoder; ``Wav2Vec2Config.base`` with the production kernel flags
   passed explicitly, the LayerNorm-less FFN block) on (c)'s configuration
   otherwise: one serving batch, the kernel path against the plain path on
   one microbatch at activation dropout 0.1, 3 steps; (z) (c) with
   ``do_stable_layer_norm: false`` (post-LN; ``fused_ffn_ln`` and
   ``fused_qkv_ln`` false); (z') (c) with ``fused_fe_conv: false`` and
   ``remat_feature_encoder: true`` (every feature-encoder block as the conv
   + K1, K1 replayed in the backward); (z'') (c) with ``encoder_ln_impl:
   xla`` and ``remat_policy: dots_saveable``: each one batch, kernel vs
   plain, 2 steps (post-LN, the query and key gradients bf16 cannot
   resolve held to an fp32 plain path that must reject a planted fault);
   (c remat) (c) with ``remat_feature_encoder: true``, kernel vs plain, 2
   steps, and (z' no remat) (z') without it, 2 steps; each with exact
   launch counts, and their ms per step and forward and backward's peak
   memory beside (c)'s; the LayerNorm forward at 768 and K1 forward and
   backward at the feature encoder's blocks 1-6 are checked and timed with
   the other kernels in phase 3;
23. a JSON line with every kernel (its launches summed over the counted runs
   of the main paths; the probes' 0), then the last line
   ``{"ok": true, "device": {...}}``.

Numbers are measured in this run and printed beside the card's name and power
limit. It imports nothing of JAX or of the JAX package, and fails if the port
did.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SR = 16_000
BATCH = 8
# The feature encoder's output rows at a 30 s window, blocks 0-6.
FE_ROWS = (95999, 47999, 23999, 11999, 5999, 2999, 1499)
# The same at the training clips' 10 s.
FE_TRAIN_ROWS = (31999, 15999, 7999, 3999, 1999, 999, 499)
REPS = 10
# |kernel - plain| <= atol + rtol |plain|, elementwise, outputs in bf16. Both
# sides compute in fp32 and round once to bf16; a reordered fp32 sum may move
# that rounding by one ulp, so rtol is two bf16 ulps (2**-6). Attention rounds
# its bf16 probabilities against the running row max of the online softmax,
# the plain version against the final max; the largest error this gave at
# these inputs on an H100 was 2**-8 = 0.0039, and its atol is twice that.
TOLERANCE = {
    "ln_gelu": (1e-2, 2.0**-6),
    "ln_fused": (1e-2, 2.0**-6),
    "conv_ln_gelu": (1e-2, 2.0**-6),
    "attention": (8e-3, 2.0**-6),
    "ffn_ln": (1e-2, 2.0**-6),
    "ffn_ln_drop": (1e-2, 2.0**-6),
    "ln_bwd": (1e-2, 2.0**-6),
    "conv_ln_gelu_train": (1e-2, 2.0**-6),
    # rstd is fp32 on both sides, from the conv's fp32 sums in another order
    # (measured 9.5e-7 relative on an H100).
    "conv_ln_gelu_train rstd": (0.0, 1e-4),
    "ctc_alpha": (1e-3, 1e-5),  # fp32 on both sides, the same order of sums
    "ctc_beta": (1e-3, 1e-5),
    # The encoder's flash attention rounds its bf16 probabilities against the
    # running max, as the wav2vec2 attention does.
    "flash_attention": (8e-3, 2.0**-6),
    # The decode kernels keep the probabilities in fp32 where the plain
    # version rounds them to bf16 before p @ v (2**-9 of each term, over
    # weights that sum to 1); atol is one bf16 ulp at |o| = 0.5.
    "decode_self_attention": (4e-3, 2.0**-6),
    "decode_cross_attention": (4e-3, 2.0**-6),
    "ffn_ln_1280": (1e-2, 2.0**-6),
    "flash_attention_train": (8e-3, 2.0**-6),
    # m and l are fp32 on both sides: a max of fp32 sums of 64 products, and
    # a sum of up to 1500 exponentials, each in another order.
    "flash_attention_train stats": (1e-4, 1e-4),
    "ffn_ln_drop_1280": (1e-2, 2.0**-6),
    "ln_bwd_1280": (1e-2, 2.0**-6),
    # wav2vec2's flash route: the flash kernels with segment ids, as above.
    "flash_attention_seg": (8e-3, 2.0**-6),
    "flash_attention_seg_train": (8e-3, 2.0**-6),
    "flash_attention_seg_train stats": (1e-4, 1e-4),
    # GELU + dropout: fp32 on both sides, rounded once to bf16.
    "gelu_dropout_4096": (1e-2, 2.0**-6),
    "gelu_dropout_5120": (1e-2, 2.0**-6),
    "gelu_dropout_bwd_4096": (1e-2, 2.0**-6),
    "gelu_dropout_bwd_5120": (1e-2, 2.0**-6),
    # fc1 without the block or the folded LayerNorm: g (and ln_out) as the
    # other FFN outputs, fp32 sums rounded once to bf16.
    "ffn_fc1": (1e-2, 2.0**-6),
}
# Gradients that sum over rows, keys or F columns: |kernel - plain| <= frac
# max|plain| + 2**-6 |plain|. Their bf16 operands (ds, dh, p) are rounded from
# fp32 products that the kernel and torch sum in other orders, so a value may
# round one ulp apart before hundreds of them are summed.
# Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W): attention_bwd 2.1e-3 of
# max|plain|, ffn_bwd 5.2e-3, conv_ln_gelu_bwd 4.8e-3 (dx; dW 1.2e-4), the fp32
# partial sums 1.0e-4; the bounds are 4 to 10 times those.
GRAD_FRAC = {"attention_bwd": 1e-2, "ffn_bwd": 2e-2, "partials": 1e-3, "conv_bwd": 2e-2,
             # fc1's backwards: dx = dh @ W1 rounded once (N2, N3) at 2**-8 of
             # its max; N4's dx through the LayerNorm backward as K5's; db1,
             # dgamma and dbeta at 5e-3.
             "fc1_dx": 2.0**-8, "fc1_vectors": 5e-3,
             "flash_bwd": 1e-2,
             # N6's dW1 and dW2, fp32 sums over every row of bf16 products
             # whose operands (dh, g) may round one ulp apart from the plain
             # version's: 1e-2 of their max, as the card tests; the dW kernel
             # alone on the same operands (sums in another order) 1e-3.
             "dw": 1e-2, "dw_kernel": 1e-3}
LSE_ATOL = 1e-3  # lse is fp32 on both sides; sums in another order
LOG2E = math.log2(math.e)
# Kernel path vs plain path logits over the whole model: max |diff| / max |plain|.
# Both paths round the bf16 residual stream after each of the 24 layers at
# slightly different values, so the bound is loose; the argmax agreement over
# valid frames is reported beside it.
LOGITS_TOL = 5e-2
SOURCES = {
    "ln_gelu": ("coral_tpu_torch/csrc/ln_gelu.cu", "coral_tpu/ops/ln_gelu_pallas.py:49"),
    "ln_fused": ("coral_tpu_torch/csrc/ln_gelu.cu", "coral_tpu/ops/ln_gelu_pallas.py:49"),
    "conv_ln_gelu": ("coral_tpu_torch/csrc/conv_ln_gelu.cu",
                     "coral_tpu/ops/conv_ln_gelu_pallas.py:133"),
    "attention": ("coral_tpu_torch/csrc/attention.cu",
                  "coral_tpu/ops/attention_pallas.py:237"),
    "ffn_ln": ("coral_tpu_torch/csrc/ffn.cu", "coral_tpu/ops/ffn_pallas.py:163"),
    "ln_bwd": ("coral_tpu_torch/csrc/ln_gelu.cu", "coral_tpu/ops/ln_gelu_pallas.py:58"),
    "attention_bwd": ("coral_tpu_torch/csrc/attention.cu",
                      "coral_tpu/ops/attention_pallas.py:276"),
    "ffn_ln_drop": ("coral_tpu_torch/csrc/ffn.cu", "coral_tpu/ops/ffn_pallas.py:169"),
    "ffn_bwd": ("coral_tpu_torch/csrc/ffn.cu", "coral_tpu/ops/ffn_pallas.py:385"),
    "ctc_alpha": ("coral_tpu_torch/csrc/ctc.cu", "coral_tpu/ops/ctc_pallas.py:81"),
    "ctc_beta": ("coral_tpu_torch/csrc/ctc.cu", "coral_tpu/ops/ctc_pallas.py:125"),
    "conv_ln_gelu_train": ("coral_tpu_torch/csrc/conv_ln_gelu.cu",
                           "coral_tpu/ops/conv_ln_gelu_pallas.py:133"),
    # The backward kernels, the k = 3 halo fixup (:374) folded into their dx.
    "conv_ln_gelu_bwd": ("coral_tpu_torch/csrc/conv_ln_gelu.cu",
                         "coral_tpu/ops/conv_ln_gelu_pallas.py:174"),
    # JAX's stock TPU flash kernel, through `_flash` and `_fwd_cp`.
    "flash_attention": ("coral_tpu_torch/csrc/flash_attention.cu",
                        "coral_tpu/ops/flash_attention.py:57"),
    "decode_self_attention": ("coral_tpu_torch/csrc/decode_attention.cu",
                              "coral_tpu/ops/decode_attention.py:210"),
    "decode_cross_attention": ("coral_tpu_torch/csrc/decode_attention.cu",
                               "coral_tpu/ops/decode_attention.py:279"),
    "ffn_ln_1280": ("coral_tpu_torch/csrc/ffn.cu", "coral_tpu/ops/ffn_pallas.py:163"),
    # The stock kernel with save_residuals, through `_flash_res`; its backward
    # `_grads`: the stock dkv kernel, and the patched dq kernel.
    "flash_attention_train": ("coral_tpu_torch/csrc/flash_attention.cu",
                              "coral_tpu/ops/flash_attention.py:78"),
    "flash_attention_bwd_dkv": ("coral_tpu_torch/csrc/flash_attention.cu",
                                "coral_tpu/ops/flash_attention.py:123"),
    "flash_attention_bwd_dq": ("coral_tpu_torch/csrc/flash_attention.cu",
                               "coral_tpu/ops/_flash_bwd_patch.py:145"),
    "ffn_ln_drop_1280": ("coral_tpu_torch/csrc/ffn.cu", "coral_tpu/ops/ffn_pallas.py:169"),
    "ffn_bwd_1280": ("coral_tpu_torch/csrc/ffn.cu", "coral_tpu/ops/ffn_pallas.py:385"),
    "ln_bwd_1280": ("coral_tpu_torch/csrc/ln_gelu.cu", "coral_tpu/ops/ln_gelu_pallas.py:58"),
    # wav2vec2's `attention_impl: flash` route: JAX's stock kernel with
    # segment ids (`_flash_attention`), forward, with stats, dkv and dq.
    **{f"flash_attention_seg{k}": ("coral_tpu_torch/csrc/flash_attention.cu",
                                   "coral_tpu/models/wav2vec2.py:440")
       for k in ("", "_train", "_bwd_dkv", "_bwd_dq")},
    # `fused_ffn: false`: GELU + dropout, `_fwd_kernel` and `_bwd_kernel`
    # through `_call`'s pallas_call (:194), at XLS-R-300M's and Whisper
    # large-v3's F.
    **{f"gelu_dropout{k}_{F}": ("coral_tpu_torch/csrc/gelu_dropout.cu",
                                f"coral_tpu/ops/gelu_dropout_pallas.py:{line}")
       for k, line in (("", 162), ("_bwd", 173)) for F in (4096, 5120)},
}
# fc1 without the block or the folded LayerNorm (`fused_ffn_ln: false`,
# `fused_ffn_block: false`): N1 forward (`_fwd_kernel[_drop]`), N2 and N3
# backward (`_bwd_kernel_drop`, `_bwd_kernel_g_drop`) at XLS-R-300M's width,
# N4 (`_bwd_kernel_ln_drop`) at Whisper large-v3's, each at its path's shape.
SOURCES.update({
    "ffn_fc1": ("coral_tpu_torch/csrc/ffn_fc1.cu", "coral_tpu/ops/ffn_pallas.py:87"),
    "ffn_fc1_drop": ("coral_tpu_torch/csrc/ffn_fc1.cu", "coral_tpu/ops/ffn_pallas.py:92"),
    "ffn_fc1_bwd": ("coral_tpu_torch/csrc/ffn_fc1.cu", "coral_tpu/ops/ffn_pallas.py:139"),
    "ffn_block_bwd": ("coral_tpu_torch/csrc/ffn_fc1.cu", "coral_tpu/ops/ffn_pallas.py:418"),
    "ffn_ln_fc1_bwd_1280": ("coral_tpu_torch/csrc/ffn_ln_fc1.cu",
                            "coral_tpu/ops/ffn_pallas.py:433"),
})
# The LayerNorm-folded block's variants: N5 (`_bwd_kernel_ln_g_drop`, the
# backward of `fused_ffn_block_dg: false` and of `fused_ffn_block_fc2`), N6
# (`_bwd_kernel_ln_dw`, `fused_ffn_block_dw`) and N7 (`_fwd_kernel_ln_fc2`
# and `_fwd_kernel_ln_fc2_drop`, `fused_ffn_block_fc2`), at XLS-R-300M's and
# Whisper large-v3's widths. N7's y holds fc2's fp32 sum over F rounded once,
# as the other FFN outputs.
for _tail in ("", "_1280"):
    SOURCES.update({
        f"ffn_ln_fc2{_tail}": ("coral_tpu_torch/csrc/ffn_ln_fc2.cu",
                               "coral_tpu/ops/ffn_pallas.py:451"),
        f"ffn_ln_fc2_drop{_tail}": ("coral_tpu_torch/csrc/ffn_ln_fc2.cu",
                                    "coral_tpu/ops/ffn_pallas.py:467"),
        f"ffn_ln_g_bwd{_tail}": ("coral_tpu_torch/csrc/ffn_ln_g.cu",
                                 "coral_tpu/ops/ffn_pallas.py:263"),
        f"ffn_ln_dw_bwd{_tail}": ("coral_tpu_torch/csrc/ffn_ln_g.cu",
                                  "coral_tpu/ops/ffn_pallas.py:282"),
    })
TOLERANCE["ffn_ln_fc2"] = (1e-2, 2.0**-6)
# The instantiations at the other widths of the repository's configs: each has
# its base kernel's tolerance and TPU source.
NEW_FFN_D = (384, 512, 768, 1920)
for _D in NEW_FFN_D:
    for _base, _line in (("ffn_ln", 163), ("ffn_ln_drop", 169), ("ffn_bwd", 385)):
        SOURCES[f"{_base}_{_D}"] = ("coral_tpu_torch/csrc/ffn.cu",
                                    f"coral_tpu/ops/ffn_pallas.py:{_line}")
        if _base in TOLERANCE:
            TOLERANCE[f"{_base}_{_D}"] = TOLERANCE[_base]
for _C in (768, 1280, 1920):
    SOURCES[f"ln_fused_{_C}"] = SOURCES["ln_fused"]
    TOLERANCE[f"ln_fused_{_C}"] = TOLERANCE["ln_fused"]
for _C in (384, 768, 1920):
    SOURCES[f"ln_bwd_{_C}"] = SOURCES["ln_bwd"]
    TOLERANCE[f"ln_bwd_{_C}"] = TOLERANCE["ln_bwd"]
# The LayerNorm-folded packed QKV projection (`fused_qkv_ln`: `_fwd_kernel_lnmm`,
# `_bwd_kernel_lnmm`) and the v3 attention without in-kernel biases
# (`_fwd_kernel_stats_v2`, `_bwd_kernel_stats_ctx`), at XLS-R-300M's width;
# checked at 1280 and 1920 (head_dim 80, 120) too. y and ln_out are rounded
# outputs as the FFN's, the attention's o as the biased kernel's.
SOURCES.update({
    "ln_dense": ("coral_tpu_torch/csrc/ln_dense.cu", "coral_tpu/ops/ffn_pallas.py:485"),
    "ln_dense_bwd": ("coral_tpu_torch/csrc/ln_dense.cu", "coral_tpu/ops/ffn_pallas.py:493"),
    "attention_nb": ("coral_tpu_torch/csrc/attention.cu",
                     "coral_tpu/ops/attention_pallas.py:123"),
    "attention_nb_bwd": ("coral_tpu_torch/csrc/attention.cu",
                         "coral_tpu/ops/attention_pallas.py:348"),
})
TOLERANCE.update({"ln_dense": (1e-2, 2.0**-6), "attention_nb": TOLERANCE["attention"]})
# Checks of a second route of a kernel that has its row under another check:
# they must pass and are printed, but give no row of the kernels line.
ROUTE_KEYS = {"ln_bwd_1280": "ln_bwd_1280 bf16 dy"}
for _d in (80, 120):
    SOURCES[f"attention_fwd_hd{_d}"] = SOURCES["attention"]
    SOURCES[f"attention_bwd_hd{_d}"] = SOURCES["attention_bwd"]
    TOLERANCE[f"attention_fwd_hd{_d}"] = TOLERANCE["attention"]
# The attention's other routes (K15): the forward without stats (`_fwd_kernel`
# through `_fwd_pallas` :565) and v1's (`_fwd_kernel_stats`, :631), which
# normalises p before rounding it (its o as the online forward's, within the
# same tolerance); the backwards whose dq kernel sweeps twice: recomputing the
# softmax (`_bwd_kernel`, :581), with o's delta (`_bwd_kernel_ctx`, :597),
# from the lse alone (`_bwd_kernel_stats`, :676). The rows at head_dim 64; at
# 80 and 120 they are checked and timed but launched on no main path.
SOURCES.update({
    "attention_ns": ("coral_tpu_torch/csrc/attention.cu", "coral_tpu/ops/attention_pallas.py:565"),
    "attention_v1": ("coral_tpu_torch/csrc/attention.cu", "coral_tpu/ops/attention_pallas.py:631"),
    "attention_ns_bwd": ("coral_tpu_torch/csrc/attention_rows.cu",
                         "coral_tpu/ops/attention_pallas.py:581"),
    "attention_ctx_bwd": ("coral_tpu_torch/csrc/attention_rows.cu",
                          "coral_tpu/ops/attention_pallas.py:597"),
    "attention_stats_bwd": ("coral_tpu_torch/csrc/attention_rows.cu",
                            "coral_tpu/ops/attention_pallas.py:676"),
})
TOLERANCE.update({name: TOLERANCE["attention"] for name in ("attention_ns", "attention_v1")})
# K7 with segment ids at XLS-R-1B's and -2B's head dims (80, 120; 120 padded
# to 128 in the tiles), the rows of phases (s) and (s').
for _d in (80, 120):
    for _k in ("", "_train", "_bwd_dkv", "_bwd_dq"):
        SOURCES[f"flash_attention_seg{_k}_hd{_d}"] = SOURCES["flash_attention_seg"]
# The H100 probes (coral_tpu_torch/tools), ports of the three TPU probes in
# tools/: the K3 backward's modes (`_variant_kernel`, its pallas_call
# `_bwd_variant` :148), the polynomial epilogues (`_kernel`, `run` :54), the
# row reductions (`_kernel`, `run` :69). Launched on no main path: 0.
PROBE_MODES = ("full", "no_vpu", "no_dvec", "no_dw", "no_dx", "no_inter", "mm_only")
PROBE_GELU = ("probe_gelu_cost_mm", "probe_gelu_cost_poly13", "probe_gelu_cost_poly13_poly17",
              "probe_gelu_cost_poly7_poly9", "probe_gelu_cost_prng")
PROBE_LANE = tuple(f"probe_lane_reduce_{m}_{n}" for n in (1, 2, 4) for m in ("vpu", "mxu"))
SOURCES.update({f"probe_fe_bwd_{m}": ("coral_tpu_torch/csrc/conv_ln_gelu.cu",
                                      "tools/probe_fe_bwd.py:50") for m in PROBE_MODES})
SOURCES.update({name: ("coral_tpu_torch/csrc/probe_gelu_cost.cu", "tools/probe_gelu_cost.py:37")
                for name in PROBE_GELU})
SOURCES.update({name: ("coral_tpu_torch/csrc/probe_lane_reduce.cu",
                       "tools/probe_lane_reduce.py:51") for name in PROBE_LANE})
# The probes' bf16 outputs are fp32 sums and epilogues rounded once, as the
# FFN's outputs.
TOLERANCE.update({"probe_gelu_cost": (1e-2, 2.0**-6), "probe_lane_reduce": (1e-2, 2.0**-6)})
# gelu_cost and lane_reduce are checked at these steps (the probes' widths)
# and timed at the probes' own (256 and 2048).
PROBE_CHECK_STEPS = 8
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor cores,
# fp32 outside them, and device memory. A kernel's bound is the larger of its
# operations over the rate of their type and its bytes (each input read once,
# each output written once) over the memory rate.
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# Operations per element of the row kernels, counted from their code: a
# two-pass LayerNorm (sum, centre, square-sum, scale, affine) 8, its backward
# 12, the polynomial GELU 10 (its derivative 12), a CTC cell's three-way
# log-sum-exp 12. Products count 2 per multiply-add.
LN_OPS, LN_BWD_OPS, GELU_OPS, CTC_CELL_OPS = 8, 12, 10, 12
# Philox4x32-10 per element: 10 rounds of two 32-bit products (high and low
# words), two xors and two key adds per 4 elements, about 25 integer
# operations each, counted at the fp32 rate.
PHILOX_OPS = 25
# Whisper serving (d): whisper-large-v3 (config/model/whisper-large.yaml),
# batch 8, greedy to max_length 225. Kernel path vs plain path: the encoder
# output and each decode step's logits, max |diff| / max |plain|; bf16
# through 32 layers that round the residual stream at slightly different
# values, as the wav2vec2 logits bound.
WHISPER_ID = "openai/whisper-large-v3"
WHISPER_ENC_TOL = 5e-2
WHISPER_LOGITS_TOL = 5e-2
# Phases (t) and (u): checkpoints written here in the Hugging Face layout and
# served from disk. (t): the serving phase's seeded XLS-R-300M as an F32
# Wav2Vec2ForCTC checkpoint (the positional conv as weight norm's g and v)
# beside a 3-gram LM trained on LM_SENTENCES seeded sentences of LM_WORDS
# words over the pipeline's characters; the folded conv within
# FOLD_RTOL of the weight it was split from, and the loaded model's logits
# bit for bit those of the seeded model given the folded conv. The seeded
# logits are nearly flat, so many tokens a frame pass the beam search's
# token floor: its decode time is bracketed by peaked log-probs of the same
# shape (PEAK_P on one token a frame, the rest below the floor) laying out
# corpus sentences. (u): a seeded large-v3 in F16
# beside a vocab.json of V3_BPE_TOKENS tokens (51,866 ids with the specials,
# the golden manifest's), greedy decoding capped at V3_MAX_LENGTH tokens.
# Phase (v): Whisper beam search, timestamps, long-form and the eval loop
# through WhisperSetup, seeded weights at full width and depth, max_length
# 225: (d)'s whisper-large.yaml and (h)'s whisper-small.yaml with
# `generation_num_beams: BEAMS`, on one batch of 8 x 30 s of seeded noise.
# Kernel path vs plain path: the main path's logits of its first REPLAY_STEPS
# beam steps (the first cache phase and the start of the second) against the
# plain path fed its tokens and slot masks, max |diff| / max |plain| within
# WHISPER_LOGITS_TOL. Long-form: one LONGFORM_SECONDS clip in windows of 30 s
# with a 5 s stride (four windows, one generate call); run_validation over
# (d)'s 12 clips in one batch against seeded strings of REFERENCE_WORDS. Beam
# against greedy: two runs of each on one batch, alternated, their medians.
BEAMS = 5
REPLAY_STEPS = 72
LONGFORM_SECONDS = 75.0
REFERENCE_WORDS = ["hej", "med", "dig", "og", "tak", "for", "sidst", "det", "er", "en",
                   "god", "dag", "i", "dag", "vi", "ses", "i", "morgen", "klokken", "tre"]
W2V2_ID = "facebook/wav2vec2-xls-r-300m"
PIPELINE_CHARS = "abcdefghijklmnopqrstuvwxyzæøå0123456789éü"
LM_WORDS, LM_SENTENCES = 2000, 20_000
FOLD_RTOL = 1e-6
PEAK_P = 0.95
V3_BPE_TOKENS, V3_VOCAB = 50_257, 51_866
V3_MAX_LENGTH = 16
# Training (b): XLS-R-300M with config/model/test-wav2vec2.yaml's values and
# config/asr_finetuning.yaml's optimisation, the feature encoder frozen,
# augmentation off and the replay of everything (nothing_saveable).
TRAIN_CONFIG = {
    "model": {
        "type": "wav2vec2", "pretrained_model_id": "facebook/wav2vec2-xls-r-300m",
        "freeze_feature_encoder": True,
        "characters_to_keep": "abcdefghijklmnopqrstuvwxyzæøå0123456789éü",
        "sampling_rate": 16_000, "activation_dropout": 0.1, "attention_dropout": 0.0,
        "hidden_dropout": 0.0, "feat_proj_dropout": 0.0, "final_dropout": 0.0,
        "mask_time_prob": 0.5, "mask_time_length": 10, "mask_feature_prob": 0.5,
        "mask_feature_length": 64, "layerdrop": 0.1, "ctc_loss_reduction": "sum",
        "learning_rate": 1e-4,
    },
    "max_seconds_per_example": 10.0, "per_device_batch_size": 8,
    "adam_first_momentum": 0.9, "adam_second_momentum": 0.98, "max_grad_norm": 1.0,
    "adam_mu_dtype": "bfloat16", "grad_dtype": "bfloat16",
    "gradient_checkpointing": True, "remat_policy": "nothing_saveable",
    "augment_audio": False,
}
# Training (c), the production configuration: config/model/wav2vec2-small.yaml
# (the feature encoder trains) with config/asr_finetuning.yaml (augmentation
# on, a background-noise bank, no remat_policy key: the default save_qk_ctx).
PRODUCTION_CONFIG = {
    **{k: v for k, v in TRAIN_CONFIG.items() if k != "remat_policy"},
    "model": {**TRAIN_CONFIG["model"], "freeze_feature_encoder": False},
    "augment_audio": True,
}
# The synthetic stand-in for the ESC-50 bank: 64 clips of 5 s of seeded noise.
NOISE_CLIPS, NOISE_SECONDS = 64, 5
ACCUM = 2
MAX_LABEL = 128
# Adam's first update moves every weight by about the learning rate (m /
# sqrt(v) is +-1 per element), which at random init first raises the CTC loss
# (+43% measured at lr 1e-4 without warmup); a 3-step warmup shrinks that
# jump, and 10 steps at the config's lr 1e-4 leave the loss below its start.
# Every step of a wav2vec2 training phase takes the same draws (SpecAugment,
# dropout, augmentation: a generator seeded alike), so that the losses show
# the learning and not the draws: with new draws each step, (c)'s last loss
# came out above its first (1086.5 -> 1124.1, 444.0 the step before; H100)
# and new draws alone moved XLS-R-2B's loss by 2% at learning rate 0.
TRAIN_STEPS = 10
WARMUP_STEPS = 3
# XLS-R-2B at lr 1e-4 after that warmup first climbs (1113.6 to 1439.3 in 8
# steps, the path itself not bit for bit the same between runs), so (f) keeps
# config/asr_finetuning.yaml's own warmup of 1000 steps.
FINETUNE_WARMUP_STEPS = 1000
# Kernel path vs plain path in training, on one microbatch: the loss and the
# gradient norm relative to the plain path's, and each parameter's gradient
# max|diff| / max|plain|. Both paths round the bf16 residual stream at
# slightly different values through 24 layers forward and 24 back. Measured
# on an H100 (700 W): loss 3.9e-5, gradient norm 1.4e-3, worst parameter
# 0.047, k_proj.bias noise 1.0e-3; the bounds are 2 to 25 times those.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_NORM_RTOL = 5e-3
TRAIN_GRAD_TOL = 0.1
K_BIAS_NOISE = 1e-2
# Post-LN at seeded weights ((y), (z)) the token states are nearly alike, so
# the late layers' query and key gradients nearly cancel and bf16 cannot
# resolve them: the plain bf16 path itself misses an fp32 plain path by
# 0.15-0.41 of its max there (H100, 700 W). Only on a post-LN model, and only
# for the parameters ``POST_LN_ARBITRATED`` names, a gradient beyond
# TRAIN_GRAD_TOL is held to an fp32 plain path on the same weights and draws
# instead: the plain bf16 path must miss fp32 by more than TRAIN_GRAD_TOL of
# its max, and the kernel path's distance from fp32 (the L2 norm of the
# difference) stay within FP32_ARBITER times the plain path's. The same
# comparison runs on a planted fault, the attention backward's dq and dk
# (and the q and k bias gradients) scaled by PLANTED_DQK_SCALE, and must
# reject it on every parameter it admitted. The limit lies between two
# readings (H100, 700 W): the sound runs' largest ratio, 1.527 ((z), 1.302 in
# (y)), and the planted fault's smallest, 1.976 ((z), 2.143 in (y)).
POST_LN_ARBITRATED = re.compile(
    r"encoder\.layers\.\d+\.attention\.(q_proj\.(weight|bias)|k_proj\.weight)$")
FP32_ARBITER = 1.75
PLANTED_DQK_SCALE = 0.5
# Launches of each kernel per microbatch of a training step. (b), frozen
# encoder, nothing_saveable: the 24 layers run forward and again in the
# replay, except the FFN block, whose residuals are its inputs; ln_bwd is LN1's
# backward and the FFN backward's LN.
PER_MICROBATCH = {"ln_gelu": 1, "conv_ln_gelu": 6, "ln_fused": 48, "attention": 48,
                  "ffn_ln_drop": 24, "attention_bwd": 24, "ffn_bwd": 24, "ln_bwd": 48,
                  "ctc_alpha": 1, "ctc_beta": 1}
# (c), the feature encoder training under save_qk_ctx: the replay runs LN1 but
# not the attention forward (q, k, o and lse are kept); FE blocks 1-6 take the
# training forward and their backward, FE conv 0's LN+GELU its ln_bwd.
PRODUCTION_PER_MICROBATCH = {
    "ln_gelu": 1, "conv_ln_gelu_train": 6, "conv_ln_gelu_bwd": 6, "ln_fused": 48,
    "attention": 24, "ffn_ln_drop": 24, "attention_bwd": 24, "ffn_bwd": 24, "ln_bwd": 49,
    "ctc_alpha": 1, "ctc_beta": 1}
# Whisper training (e): config/model/whisper-large.yaml with
# config/asr_finetuning.yaml (its optimisation and augmentation; no
# remat_policy key, so the 1280-wide default save_flash_ctx). Whisper pads
# every clip to its 30 s window.
WHISPER_TRAIN_CONFIG = {
    "model": {
        "name": "whisper-large", "type": "whisper", "pretrained_model_id": WHISPER_ID,
        "freeze_feature_encoder": False, "sampling_rate": 16_000, "dropout": 0.0,
        "activation_dropout": 0.1, "attention_dropout": 0.0, "mask_time_prob": 0.5,
        "mask_time_length": 10, "mask_feature_prob": 0.5, "mask_feature_length": 64,
        "layerdrop": 0.1, "max_length": 225, "learning_rate": 1e-6,
    },
    "max_seconds_per_example": 10.0, "per_device_batch_size": 8,
    "adam_first_momentum": 0.9, "adam_second_momentum": 0.98, "max_grad_norm": 1.0,
    "adam_mu_dtype": "bfloat16", "grad_dtype": "bfloat16", "gradient_checkpointing": True,
    "augment_audio": True,
}
# The config's learning rate (1e-6) with a 1-step warmup (the config's 1000
# would leave every update of a short run near 0), over a few steps.
WHISPER_TRAIN_STEPS = 6
WHISPER_WARMUP_STEPS = 1
# Launches per microbatch under save_flash_ctx: the flash forward once per
# encoder layer (its o, l and m are kept, so the replay skips it), its two
# backward kernels once; the FFN block's dropout forward, backward and LN
# backward once per encoder and decoder layer; the serving launches never.
WHISPER_PER_MICROBATCH = {
    "flash_attention_train": 32, "flash_attention_bwd_dkv": 32, "flash_attention_bwd_dq": 32,
    "ffn_ln_drop_1280": 64, "ffn_bwd_1280": 64, "ln_bwd_1280": 64}

# Phases (f)-(i): the six configs whose widths the kernels gained in this
# slice. (f) config/model/wav2vec2-large.yaml (XLS-R-2B) and (g)
# wav2vec2-medium.yaml (XLS-R-1B) differ from wav2vec2-small.yaml only in
# their checkpoint id: the production configuration (c) with their widths.
XLSR_2B_ID, XLSR_1B_ID = "facebook/wav2vec2-xls-r-2b", "facebook/wav2vec2-xls-r-1b"
W2V2_LARGE_CONFIG = {**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], "name": "wav2vec2-large", "pretrained_model_id": XLSR_2B_ID}}
W2V2_MEDIUM_CONFIG = {**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], "name": "wav2vec2-medium", "pretrained_model_id": XLSR_1B_ID}}
# (f) kernel vs plain on one microbatch at 24 of the 48 layers: a plain twin
# is a second 2 B model, and 24 layers are the depth the tolerances were set
# at (XLS-R-300M); then the steps at full depth, (c)'s warmup and count.
XLSR_2B_COMPARE_LAYERS = 24
# (g): a few steps at full depth, the loss finite (no claim that it falls).
FEW_STEPS = 3
# The route phases (j')-(s'): two steps (the first counted, the second
# timed), the plain path's time per step not taken; the kernel path is held
# against the plain path on one microbatch where the phase compares.
ROUTE_STEPS = 2
# (h), (i): whisper-small.yaml, -xsmall.yaml (whisper-base), -xxsmall.yaml and
# test-whisper.yaml (whisper-tiny): whisper-large.yaml's values but for the
# checkpoint id and the learning rate (test-whisper also sets dropout and
# attention dropout 0.1 and freezes nothing the port trains otherwise).
# (label, name, checkpoint, learning rate, other keys, (d_model, encoder
# layers, decoder layers, heads, FFN), train steps).
WHISPER_SIZES = [
    ("(h)", "whisper-small", "openai/whisper-small", 1e-5, {}, (768, 12, 12, 12, 3072),
     FEW_STEPS),
    ("(i)", "whisper-xsmall", "openai/whisper-base", 2.5e-5, {}, (512, 6, 6, 8, 2048),
     FEW_STEPS),
    ("(i)", "whisper-xxsmall", "openai/whisper-tiny", 3.75e-5, {}, (384, 4, 4, 6, 1536),
     FEW_STEPS),
    ("(i)", "test-whisper", "openai/whisper-tiny", 3.75e-5,
     {"freeze_feature_encoder": True, "dropout": 0.1, "attention_dropout": 0.1},
     (384, 4, 4, 6, 1536), 0),
]
# Teacher-forced decode steps of the kernel-vs-plain check at these sizes.
WHISPER_COMPARE_STEPS = 32
# Phases (j), (j') and (k): the JAX package's unfused routes.
# (j) config/model/wav2vec2-small.yaml + config/asr_finetuning.yaml, (c)'s
# production configuration and traffic, with `attention_impl: flash` (the
# flash kernel with segment ids) and `fused_ffn: false` (the LayerNorm, fc1,
# GELU+dropout and fc2 apart): the serving clips through the setup's
# predictor, kernel vs plain on one microbatch with activation dropout on,
# then (c)'s 10 steps. (j') the same with `attention_impl: xla` (plain
# attention math): one served batch and 3 steps. (k)
# config/model/whisper-large.yaml with `fused_ffn: false`: (e)'s kernel vs
# plain and 3 of its steps, the GELU+dropout kernel at F = 5120 in both
# stacks.
UNFUSED_FLASH_CONFIG = {**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], "attention_impl": "flash", "fused_ffn": False}}
UNFUSED_XLA_CONFIG = {**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], "attention_impl": "xla", "fused_ffn": False}}
WHISPER_UNFUSED_CONFIG = {**WHISPER_TRAIN_CONFIG, "model": {
    **WHISPER_TRAIN_CONFIG["model"], "fused_ffn": False}}
# Launches per microbatch of (k) under save_flash_ctx: the flash kernels as
# (e); the GELU+dropout forward in the forward and again in the replay of
# every encoder and decoder layer (fc2's weight gradient reads its output,
# which no policy keeps), its backward once; no LN kernel (`ln_impl: xla`).
WHISPER_UNFUSED_PER_MICROBATCH = {
    "flash_attention_train": 32, "flash_attention_bwd_dkv": 32, "flash_attention_bwd_dq": 32,
    "gelu_dropout_5120": 128, "gelu_dropout_bwd_5120": 64}
# Phases (l), (l') and (m): the FFN without the block or the folded
# LayerNorm. (l) (c)'s configuration (config/model/wav2vec2-small.yaml +
# config/asr_finetuning.yaml) with `fused_ffn_ln: false`: LN2 through
# `ln_fused`, then `ffn_block` without a LayerNorm (N1 forward, N3
# backward); the serving clips through the setup's predictor, kernel vs plain
# on one microbatch at activation dropout 0.1, 3 steps. (l') the same with
# `fused_ffn_block: false` added: `ffn_fc1` (N1, N2) and fc2 as a product,
# one served batch and 3 steps. (m) (e)'s configuration with
# `fused_ffn_block: false`: `ffn_ln_fc1` (K5's forward, N4) and fc2 as a
# product in both stacks; kernel vs plain and 3 steps.
LN_APART_CONFIG = {**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], "fused_ffn_ln": False}}
FC1_CONFIG = {**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], "fused_ffn_ln": False, "fused_ffn_block": False}}
WHISPER_FC1_CONFIG = {**WHISPER_TRAIN_CONFIG, "model": {
    **WHISPER_TRAIN_CONFIG["model"], "fused_ffn_block": False}}
# Launches per microbatch of (m) under save_flash_ctx: the flash kernels as
# (e); K5's dropout forward in the forward and again in the replay of every
# encoder and decoder layer (fc2's weight gradient reads g, which no Whisper
# policy keeps), N4 and its LayerNorm backward once.
WHISPER_FC1_PER_MICROBATCH = {
    "flash_attention_train": 32, "flash_attention_bwd_dkv": 32, "flash_attention_bwd_dq": 32,
    "ffn_ln_drop_1280": 128, "ffn_ln_fc1_bwd_1280": 64, "ln_bwd_1280": 64}


# Phases (n)-(o'): the LayerNorm-folded block's variants. (n) (c)'s
# configuration (config/model/wav2vec2-small.yaml + config/asr_finetuning.yaml)
# with `fused_ffn_block_fc2: true`: N7 forward, N5 backward; one served batch
# through the setup's predictor, kernel vs plain on one microbatch at
# activation dropout 0.1, 3 steps. (n') with `fused_ffn_block_dw: true`: K5's
# forward, N6; kernel vs plain, 3 steps. (n'') with `fused_ffn_block_dg:
# false`: K5's forward, N5; 2 steps (one counted, one timed). (o) (e)'s
# configuration with `fused_ffn_block_dw: true` in both stacks: kernel vs
# plain, 3 steps; (o') with `fused_ffn_block_fc2: true`: one batch served,
# 2 steps.
FC2_CONFIG, DW_CONFIG, DG_OUT_CONFIG = ({**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], key: value}} for key, value in (
        ("fused_ffn_block_fc2", True), ("fused_ffn_block_dw", True),
        ("fused_ffn_block_dg", False)))
WHISPER_DW_CONFIG = {**WHISPER_TRAIN_CONFIG, "model": {
    **WHISPER_TRAIN_CONFIG["model"], "fused_ffn_block_dw": True}}
# Launches per microbatch of (o) under save_flash_ctx: (e)'s with N6 in the
# place of K5's backward.
WHISPER_DW_PER_MICROBATCH = {
    "flash_attention_train": 32, "flash_attention_bwd_dkv": 32, "flash_attention_bwd_dq": 32,
    "ffn_ln_drop_1280": 64, "ffn_ln_dw_bwd_1280": 64, "ln_bwd_1280": 64}
# Phases (p) and (p'): the packed QKV projection and the attention without
# in-kernel biases. (p) (c)'s configuration (config/model/wav2vec2-small.yaml +
# config/asr_finetuning.yaml) with `fused_qkv_ln: true` (the pre-attention
# LayerNorm folded into one packed (3D, D) projection, the attention without
# biases on its lane thirds): one served batch through the setup's predictor,
# kernel vs plain on one microbatch at activation dropout 0.1, 3 steps. (p')
# with `attention_fused_qkv_bias: false` (LN1 apart, the q/k/v biases in the
# projections): one batch, kernel vs plain, 2 steps.
QKV_LN_CONFIG, QKV_BIAS_OFF_CONFIG = ({**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], key: value}} for key, value in (
        ("fused_qkv_ln", True), ("attention_fused_qkv_bias", False)))
# Phases (q)-(r'): the attention's other routes (K15), on (c)'s configuration
# (config/model/wav2vec2-small.yaml + config/asr_finetuning.yaml, save_qk_ctx),
# where the setup resolves attention_fused_qkv_bias to false. (q)
# `attention_save_stats: false` (the forward without stats, the backward that
# recomputes the softmax): one served batch through the setup's predictor,
# kernel vs plain on one microbatch at activation dropout 0.1, 2 steps; (q')
# with `attention_o_residual: true` (the backward's delta from o): kernel vs
# plain, 2 steps; (r) `attention_save_stats: v2` (the v2 forward, the
# lse-only backward): kernel vs plain, 2 steps; (r') `true` (the v1 forward,
# twice a layer in training: its lse has no name): one served batch, kernel vs
# plain, 2 steps.
VARIANT_PHASES = [(label, {**PRODUCTION_CONFIG, "model": {**PRODUCTION_CONFIG["model"], **flags}},
                   serve) for label, flags, serve in (
    ("(q)", {"attention_save_stats": False}, 1),
    ("(q')", {"attention_save_stats": False, "attention_o_residual": True}, 0),
    ("(r)", {"attention_save_stats": "v2"}, 0),
    ("(r')", {"attention_save_stats": True}, 1))]
# Phases (s), (s'): the flash route (K7 with segment ids at head_dim 80 and
# 120) on XLS-R-1B's and -2B's production fine-tune, (g)'s and (f)'s
# configurations with `attention_impl: flash`: one served batch through the
# setup's predictor, kernel vs plain on one microbatch at activation dropout
# 0.1 (at 24 of the 48 layers, as (f)), 2 steps at full depth.
FLASH_1B_CONFIG, FLASH_2B_CONFIG = ({**cfg, "model": {**cfg["model"], "attention_impl": "flash"}}
                                    for cfg in (W2V2_MEDIUM_CONFIG, W2V2_LARGE_CONFIG))
# Phases (y)-(z''): the wav2vec2 configurations off XLS-R's routes. (y)
# facebook/wav2vec2-base's published architecture (``Wav2Vec2Config.base``:
# hidden 768, 12 layers of 12 x 64 heads, FFN 3072, FE 7 x 512 without conv
# biases under group norm, post-LN, positional conv 128 taps / 16 groups) at
# vocab 46, on (c)'s configuration otherwise (config/asr_finetuning.yaml's
# optimisation and augmentation, save_qk_ctx, the feature encoder training).
# The setups have no base architecture, as the JAX setup has none
# (coral_tpu/training/model_setup.py:35-40), so ``phase_setup`` builds (c)'s
# setup and gives it this config, the production kernel flags passed
# explicitly: the dataclass has the JAX dataclass's defaults. Post-LN the JAX
# setup refuses the LayerNorm folds, so the FFN is the LayerNorm-less block.
BASE_FLAGS = dict(attention_impl="pallas", attention_save_stats="v3",
                  attention_o_residual=False, attention_fused_qkv_bias=True,
                  fused_qkv_ln=False, fused_ffn=True, fused_ffn_ln=False, fused_ffn_block=True,
                  fused_ffn_block_dw=False, fused_ffn_block_fc2=False, fused_ffn_block_dg=True,
                  fused_fe_conv=True, encoder_ln_impl="pallas")
BASE_CONFIG = {**PRODUCTION_CONFIG, "model": {**PRODUCTION_CONFIG["model"],
                                              "name": "wav2vec2-base"},
               "architecture": "wav2vec2-base"}
BASE_STEPS = 3
# (z) (c) post-LN; (z') (c) with every feature-encoder block as the conv +
# K1, the feature encoder replayed in the backward; (z'') (c) with the plain
# encoder LayerNorms and the dots_saveable policy. Each: one served batch,
# kernel vs plain on one microbatch (the feature encoder's replay included),
# and 2 steps.
POST_LN_CONFIG = {**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], "do_stable_layer_norm": False, "fused_ffn_ln": False,
    "fused_qkv_ln": False}}
FE_APART_CONFIG = {**PRODUCTION_CONFIG, "model": {**PRODUCTION_CONFIG["model"],
                                                  "fused_fe_conv": False},
                   "remat_feature_encoder": True}
LN_XLA_DOTS_CONFIG = {**PRODUCTION_CONFIG, "model": {
    **PRODUCTION_CONFIG["model"], "encoder_ln_impl": "xla", "remat_policy": "dots_saveable"}}
# The feature encoder's replay alone, on each of its routes: (c) with it (K3's
# training forward twice; kernel vs plain, 2 steps) and (z') without it (2
# steps). Nothing served: their peaks set against (c)'s and (z')'s show what
# the replay saves.
REMAT_FE_CONFIG = {**PRODUCTION_CONFIG, "remat_feature_encoder": True}
FE_APART_KEPT_CONFIG = {**FE_APART_CONFIG, "remat_feature_encoder": False}
# Each production step's ms and its forward and backward's peak GiB
# (``production_run``), to set a phase beside (c).
STEP_MS: dict = {}
FWD_BWD_PEAK_GIB: dict = {}


def fail(msg: str) -> None:
    """Prints the failure on both streams (a caller that keeps only the
    errors' tail still sees which check failed) and exits 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"{' '.join(cmd)} exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip()


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` calls after two warm-ups."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = REPS) -> float | None:
    """The device time of one call of ``fn``: the summed durations of the CUDA
    kernels of ``reps`` calls under ``torch.profiler``, over ``reps``. Unlike
    the events' time it leaves out the host's time to launch them, which sets
    the events' time of a launch shorter than its Python wrapper. A window in
    which the profiler caught no kernel is profiled once more; None (not
    measured) if it caught none again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        total = sum(e.time_range.end - e.time_range.start for e in kernels)
        if total > 0:
            return total / 1e3 / reps
    return None


def timed(fn, reps: int) -> float:
    """Median wall seconds of ``fn`` over ``reps`` calls, each ending in a
    synchronise."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    return float(np.median(walls))


def compare(name: str, got: torch.Tensor, want: torch.Tensor, key: str | None = None) -> dict:
    """|kernel - plain| <= atol + rtol |plain| with the tolerance of ``key``
    (default ``name``), elementwise."""
    torch.cuda.synchronize()
    atol, rtol = TOLERANCE[key or name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= atol + rtol * want.abs()).all())
    result = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max() / want.abs().max()),
        "ok": ok,
    }
    print(f"  {name}: max_abs_err {result['max_abs_err']:.6g} max_rel_err "
          f"{result['max_rel_err']:.6g} tolerance atol {atol} + rtol {rtol:.6g}|plain|: "
          f"{'ok' if ok else 'EXCEEDED'}", flush=True)
    return result


def compare_grad(name: str, got: torch.Tensor, want: torch.Tensor, frac: float) -> dict:
    """As ``compare`` with atol = frac max|plain| (gradients summed over rows)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and bool((err <= frac * scale + 2.0**-6 * want.abs()).all())
    res = {"max_abs_err": float(err.max()), "max_rel_err": float(err.max()) / max(scale, 1e-30),
           "ok": ok}
    print(f"  {name}: max_abs_err {res['max_abs_err']:.6g} max_rel_err "
          f"{res['max_rel_err']:.6g} tolerance {frac} max|plain| + 2**-6|plain|: "
          f"{'ok' if ok else 'EXCEEDED'}", flush=True)
    return res


def bound(flops: float, rate: float, moved: float) -> tuple[float, str]:
    """The least time in ms the card could take, and what sets it."""
    ops_ms = flops / rate * 1e3
    mem_ms = moved / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _measure(results: dict, card: str, name: str, kernel, plain, check, work, library=None):
    """Checks kernel ``name`` against its plain version, then times the kernel,
    the plain version and the library yardstick (CUDA events, median of
    ``REPS``), and computes the bound from ``work`` = (operations, their peak
    rate, bytes moved)."""
    res = check()
    res["ms"] = median_ms(kernel)
    res["device_ms"] = device_ms(kernel)
    res["plain_ms"] = median_ms(plain)
    res["library_ms"] = None if library is None else median_ms(library)
    res["library_device_ms"] = None if library is None else device_ms(library)
    res["bound_ms"], res["bound_by"] = bound(*work)
    dev = {key: "not measured" if res[key] is None else f"{res[key]:.4f} ms"
           for key in ("device_ms", "library_device_ms")}
    lib = "none" if library is None else (
        f"{res['library_ms']:.4f} ms (device {dev['library_device_ms']})")
    ratio = "" if library is None else (
        f", {res['ms'] / res['library_ms']:.3f}x the library's events time" +
        ("" if None in (res["device_ms"], res["library_device_ms"]) else
         f", {res['device_ms'] / res['library_device_ms']:.3f}x its device time"))
    print(f"  {name}: kernel {res['ms']:.4f} ms (device {dev['device_ms']}), plain "
          f"{res['plain_ms']:.4f} ms, library {lib}, bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']} ({res['bound_ms'] / res['ms']:.1%} of it{ratio}; median of "
          f"{REPS}; {card})", flush=True)
    results[name] = res


def merge(*results) -> dict:
    """One kernel's result over several outputs: the first output's errors,
    ok only if every output is."""
    out = dict(results[0])
    out["ok"] = all(r["ok"] for r in results)
    return out


def ln_host_split(card: str, calls: int = 1000) -> None:
    """The LayerNorm wrappers' host path piece by piece
    (``coral_tpu_torch/tools/probe_ln_host.py``): microseconds a call over
    ``calls`` calls with no synchronise between them; what the parent tree's
    wrappers ran and these no longer run ("gone:") timed as it ran."""
    from coral_tpu_torch.ops import _build, ln_gelu
    from coral_tpu_torch.tools import probe_ln_host

    for wrapper, fns in probe_ln_host.pieces(ln_gelu, _build).items():
        parts = [f"{piece} {probe_ln_host.per_call_us(fn, calls):.2f}"
                 for piece, fn in fns.items()]
        print(f"  {wrapper} host path, us a call over {calls} calls ({card}): "
              + "; ".join(parts), flush=True)
    _build.reset_launch_counts()


def device_kernels(fn) -> list[str]:
    """The names of the device kernels one call of ``fn`` launches, by
    ``torch.profiler`` (after one call outside it). A window in which the
    profiler caught no kernel is profiled again, up to three times, as in
    ``device_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return names


def graph_device_nodes(fn) -> int:
    """The device work of one call of ``fn`` (after one call outside it)
    captured into a CUDA graph: its kernel, memcpy and memset nodes, read
    through `libcuda` (`cuGraphGetNodes`). It needs no profiler."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes could not count a captured call's nodes")
    nodes = (ctypes.c_void_p * n.value)()
    cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes[: n.value]:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    del graph
    # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
    return sum(kind in (0, 1, 2) for kind in kinds)


def one_kernel_a_call(name: str, fn) -> list[str]:
    """Fails unless one call of ``fn`` launches one device kernel, counted
    twice: by the profiler (``device_kernels``; on the card it at times
    records nothing of any window, and then gives no count) and by the
    nodes of the call captured into a CUDA graph (``graph_device_nodes``).
    Returns the profiler's kernel names."""
    kernels = device_kernels(fn)
    nodes = graph_device_nodes(fn)
    if kernels and len(kernels) != 1:
        fail(f"{name} launched {len(kernels)} device kernels a call, not 1")
    if nodes != 1:
        fail(f"{name}: a captured call holds {nodes} kernel, memcpy or memset nodes, not 1")
    return kernels


def ln_training_pattern(card: str, randn) -> dict:
    """One LayerNorm as a training step runs it: ``ln_fused`` forward and
    backward under autograd at (8, 499, 1024), x and bf16 work copies of
    gamma and beta requiring gradients, against ``F.layer_norm`` forward and
    backward under autograd with the same bf16 weights: the kernel path's
    gradients against the plain path's, then each side's events and device
    ms (median of ``REPS``) and its device kernels by the profiler."""
    from coral_tpu_torch.ops import ln_gelu

    bf16 = torch.bfloat16
    x = randn(BATCH, 499, 1024, dtype=bf16).requires_grad_(True)
    g = randn(1024, scale=0.1, offset=1.0, dtype=bf16).requires_grad_(True)
    b = randn(1024, scale=0.1, dtype=bf16).requires_grad_(True)
    dy = randn(BATCH, 499, 1024, dtype=bf16)
    leaves = (x, g, b)

    def port(plain=False):
        return torch.autograd.grad(ln_gelu.ln_fused(*leaves, plain=plain), leaves, dy)

    def library():
        return torch.autograd.grad(torch.nn.functional.layer_norm(x, (1024,), g, b, 1e-5),
                                   leaves, dy)

    got, want = port(), port(plain=True)
    res = merge(compare("ln training pattern dx", got[0], want[0], "ln_bwd"),
                *(compare_grad(f"ln training pattern {n} (bf16)", gg, ww, GRAD_FRAC["partials"])
                  for n, gg, ww in zip(("dgamma", "dbeta"), got[1:], want[1:])))
    res["ok"] = res["ok"] and all(t.dtype == bf16 for t in got)
    for name, fn in (("ln_fused", port), ("F.layer_norm", library)):
        ms, dev, names = median_ms(fn), device_ms(fn), device_kernels(fn)
        print(f"  ln training pattern, {name} forward and backward under autograd, bf16 "
              f"gamma and beta: {ms:.4f} ms (device "
              f"{'not measured' if dev is None else f'{dev:.4f} ms'}), {len(names)} device "
              f"kernels: {', '.join(n[:48] for n in names)} (median of {REPS}; {card})",
              flush=True)
    return res


def kernel_checks(card: str) -> dict:
    """Each kernel against its plain version at the serving slice's shapes."""
    from coral_tpu_torch.ops import attention, conv_ln_gelu, ffn, ln_gelu
    from coral_tpu_torch.tools import probe_conv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    bf16 = torch.bfloat16
    results = {}

    measure = functools.partial(_measure, results, card)

    # FE conv 0's output: (8, 95999, 512), LN + GELU.
    x = randn(BATCH, 95999, 512, scale=2.0, offset=0.3, dtype=bf16)
    g, b = randn(512, scale=0.1, offset=1.0), randn(512, scale=0.1)
    measure("ln_gelu", lambda: ln_gelu.ln_gelu(x, g, b),
            lambda: ln_gelu.ln_gelu_plain(x, g, b),
            lambda: compare("ln_gelu", ln_gelu.ln_gelu(x, g, b), ln_gelu.ln_gelu_plain(x, g, b)),
            ((LN_OPS + GELU_OPS) * x.numel(), FP32_FLOPS, 2 * nbytes(x) + nbytes(g, b)))

    # The pre-attention LN: (8, 1499, 1024).
    x = randn(BATCH, 1499, 1024, dtype=bf16)
    g, b = randn(1024, scale=0.1, offset=1.0), randn(1024, scale=0.1)
    gb, bb = g.to(bf16), b.to(bf16)
    measure("ln_fused", lambda: ln_gelu.ln_fused(x, g, b),
            lambda: ln_gelu.ln_gelu_plain(x, g, b, apply_gelu=False),
            lambda: compare("ln_fused", ln_gelu.ln_fused(x, g, b),
                            ln_gelu.ln_gelu_plain(x, g, b, apply_gelu=False)),
            (LN_OPS * x.numel(), FP32_FLOPS, 2 * nbytes(x) + nbytes(g, b)),
            lambda: torch.nn.functional.layer_norm(x, (1024,), gb, bb))

    # FE conv 1 (k=3, 95999 -> 47999 rows) timed; conv 5 (k=2) checked too.
    def conv_args(k, T_in):
        return (randn(BATCH, T_in, 512, dtype=bf16),
                randn(512, 512, k, scale=math.sqrt(2.0 / (512 * k)), dtype=bf16),
                randn(512, scale=0.1), randn(512, scale=0.1, offset=1.0),
                randn(512, scale=0.1))

    a2 = conv_args(2, 5999)
    res2 = compare("conv_ln_gelu", conv_ln_gelu.conv_ln_gelu(*a2),
                   conv_ln_gelu.conv_ln_gelu_plain(*a2))
    del a2
    a3 = conv_args(3, 95999)

    def conv_check():
        res = compare("conv_ln_gelu", conv_ln_gelu.conv_ln_gelu(*a3),
                      conv_ln_gelu.conv_ln_gelu_plain(*a3))
        res["ok"] = res["ok"] and res2["ok"]
        res["max_abs_err"] = max(res["max_abs_err"], res2["max_abs_err"])
        return res

    T_out = (a3[0].shape[1] - 3) // 2 + 1
    y_bytes = BATCH * T_out * 512 * 2
    measure("conv_ln_gelu", lambda: conv_ln_gelu.conv_ln_gelu(*a3),
            lambda: conv_ln_gelu.conv_ln_gelu_plain(*a3), conv_check,
            (2 * BATCH * T_out * 512 * 512 * 3, BF16_FLOPS, nbytes(*a3) + y_bytes))
    conv_yardstick(card, "conv_ln_gelu", probe_conv.cudnn_forward(a3[0], a3[1]),
                   "convolution (8 x 95999 -> 47999, k 3, bf16)")
    del a3

    # Attention: (8, 1499, 16 x 64), padded rows and one fully masked row.
    T = 1499
    q, k, v = (randn(BATCH, T, 1024, dtype=bf16) for _ in range(3))
    bias = tuple(randn(1024, scale=0.1) for _ in range(3))
    lengths = torch.tensor([1499, 1200, 900, 600, 300, 1499, 50, -1], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]

    def attn_check():
        o, lse = attention.short_t_attention_flat(q, k, v, mask, 64, bias)
        want_o, want_lse = attention.attention_plain(q, k, v, mask, 64, bias)
        res = compare("attention", o, want_o)
        lse_err = float((lse - want_lse).abs().max())
        print(f"  attention lse: max_abs_err {lse_err:.6g} (tolerance {LSE_ATOL}); "
              f"masked row clamped: {bool((lse[-1] == -1e25).all())}", flush=True)
        res["ok"] = res["ok"] and lse_err <= LSE_ATOL and bool((lse[-1] == -1e25).all())
        return res

    heads = [(t + bb.to(bf16)).view(BATCH, T, 16, 64).transpose(1, 2)
             for t, bb in zip((q, k, v), bias)]
    key_bias = torch.where(mask, 0.0, -1e30).to(bf16)[:, None, None, :]
    measure("attention", lambda: attention.short_t_attention_flat(q, k, v, mask, 64, bias),
            lambda: attention.attention_plain(q, k, v, mask, 64, bias), attn_check,
            (4 * BATCH * 16 * T * T * 64, BF16_FLOPS, 4 * nbytes(q) + nbytes(mask, *bias)),
            lambda: torch.nn.functional.scaled_dot_product_attention(*heads,
                                                                     attn_mask=key_bias))
    del heads
    del q, k, v

    # FFN up-projection block: (8, 1499, 1024) -> (8, 1499, 4096).
    x = randn(BATCH, T, 1024, dtype=bf16)
    w1 = randn(4096, 1024, scale=1.0 / 32, dtype=bf16)
    b1, g, b = randn(4096, scale=0.1), randn(1024, scale=0.1, offset=1.0), randn(1024, scale=0.1)
    M = BATCH * T
    measure("ffn_ln", lambda: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b),
            lambda: ffn.ffn_ln_fc1_plain(x, w1, b1, g, b),
            lambda: compare("ffn_ln", ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b),
                            ffn.ffn_ln_fc1_plain(x, w1, b1, g, b)),
            (2 * M * 1024 * 4096, BF16_FLOPS, nbytes(x, w1, b1, g, b) + M * 4096 * 2))
    fc1_yardstick(card, "ffn_ln", x, w1)
    return results


def mainloop_registers(lines: list[str]) -> list[str]:
    """The registers and spill bytes of the backward mainloop's kernels (the
    flash backward's and the short-T backwards' pairs, by policy) and v1's
    forward, one line per instantiation, from ptxas's report (``-Xptxas
    -v``): the launch's registers a thread (setmaxnreg then splits them
    between the producer and the consumers: 24 / 240 for dq, 40 / 232 with
    K4's bias pass; 40 / 232 for K7's dkv, 56 / 224 for the short-T dkv; for
    v1 24 / 240, 32 / 160 with three consumers at head_dim 64) and the spill
    stores and loads."""
    found, current, spill = [], None, "spills not reported"
    pattern = re.compile(r"(flash_bwd_(?:dq|dkv)_kernel)ILi(\d+)ELb([01])E"
                         r"|(attention_fwd_v1_kernel)ILi(\d+)E"
                         r"|(attention_bwd_(?:dq|dkv)_kernel)ILi(\d+)E.*?bwd\d+"
                         r"(?:K4ILb([01])E|(Stats|Recompute|Ctx))")
    for line in lines:
        match = pattern.search(line)
        if "Compiling entry function" in line:
            spill = "spills not reported"
            if match is None:
                current = None
            elif match[1]:
                current = f"{match[1]}<{match[2]}, {'true' if match[3] == '1' else 'false'}>"
            elif match[4]:
                current = f"{match[4]}<{match[5]}>"
            else:
                policy = match[9] or f"K4<{'true' if match[8] == '1' else 'false'}>"
                current = f"{match[6]}<{match[7]}, {policy}>"
        elif current and "spill" in line:
            spill = line.strip()
        elif current and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            found.append(f"{current}: {regs[1] if regs else '?'} registers at launch, {spill}")
            current = None
        elif current and ("setmaxnreg" in line or "warning" in line):
            found.append(f"{current}: {line.strip()}")
    return found


def map_encode_us(card: str) -> None:
    """Prints the host time a forward launch spends encoding its TMA tensor
    maps (q, k and v; two per operand at head_dim 80), and a flash backward
    launch (q, k, v and do): the mean of 1,000 encodings at the serving
    shapes' strides, packed q, k, v."""
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.ops.attention import KERNEL_HEAD_DIMS

    for d in KERNEL_HEAD_DIMS:
        x = torch.empty(BATCH, 1499, 3 * 16 * d, device="cuda", dtype=torch.bfloat16)
        q, k, v = x.split(16 * d, dim=-1)
        ns = _build.library().coral_attention_fwd_map_ns(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), BATCH, 1499, 16, d, q.stride(0),
            q.stride(1), 1000)
        if ns < 0:
            fail(f"the tensor maps at head_dim {d} could not be encoded")
        print(f"  tensor maps of one forward launch at head_dim {d}: {ns / 1e3:.3f} us of "
              f"host time ({6 if d == 80 else 3} maps, mean of 1000; {card})", flush=True)
        do = torch.empty(BATCH, 1499, 16 * d, device="cuda", dtype=torch.bfloat16)
        ns = _build.library().coral_flash_attention_bwd_map_ns(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), BATCH, 1499, 16, d,
            q.stride(0), q.stride(1), 1000)
        if ns < 0:
            fail(f"the backward's tensor maps at head_dim {d} could not be encoded")
        print(f"  tensor maps of one flash backward launch at head_dim {d}: {ns / 1e3:.3f} us of "
              f"host time ({8 if d == 80 else 4} maps, mean of 1000; {card})", flush=True)


def train_kernel_checks(card: str) -> dict:
    """The training slice's kernels against their plain versions at its
    shapes: 8 clips of 10 s (T' = 499 frames), XLS-R-300M widths."""
    from coral_tpu_torch.ops import attention, conv_ln_gelu, ffn, ln_gelu, philox
    from coral_tpu_torch.tools import probe_conv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    bf16 = torch.bfloat16
    results = {}

    measure = functools.partial(_measure, results, card)

    T = 499
    # LN backward: the pre-attention LN (8, 499, 1024), timed; the FE conv 0
    # shape with GELU (8, 31999, 512); the FFN's use, fp32 dy.
    x = randn(BATCH, T, 1024, dtype=bf16)
    dy = randn(BATCH, T, 1024, dtype=bf16)
    g, b = randn(1024, scale=0.1, offset=1.0), randn(1024, scale=0.1)

    def ln_check():
        out = []
        for args, gelu in (((x, g, b, dy), False),
                           ((randn(BATCH, 31999, 512, scale=2.0, dtype=bf16),
                             g[:512].contiguous(), b[:512].contiguous(),
                             randn(BATCH, 31999, 512, dtype=bf16)), True),
                           ((x, g, b, dy.float()), False)):
            got = ln_gelu.ln_bwd(*args, apply_gelu=gelu)
            want = ln_gelu.ln_bwd_plain(*args, apply_gelu=gelu)
            out.append(compare("ln_bwd", got[0], want[0]))
            out += [compare_grad("ln_bwd partials", gg, ww, GRAD_FRAC["partials"])
                    for gg, ww in zip(got[1:], want[1:])]
        return merge(*out)

    measure("ln_bwd", lambda: ln_gelu.ln_bwd(x, g, b, dy, apply_gelu=False),
            lambda: ln_gelu.ln_bwd_plain(x, g, b, dy, apply_gelu=False), ln_check,
            (LN_BWD_OPS * x.numel(), FP32_FLOPS, 3 * nbytes(x) + 3 * nbytes(g)),
            layer_norm_bwd_yardstick(x, g, b, dy))
    del x, dy
    results["ln training pattern"] = ln_training_pattern(card, randn)

    # The feature encoder's training forward and backward: FE block 1 (k = 3,
    # 31999 -> 15999 rows), timed, and block 5 (k = 2, 1999 -> 999 rows: input
    # row 1998 is read by no output and must get dx = 0).
    def conv_args(k, T_in):
        return (randn(BATCH, T_in, 512, dtype=bf16),
                randn(512, 512, k, scale=math.sqrt(2.0 / (512 * k)), dtype=bf16),
                randn(512, scale=0.1), randn(512, scale=0.1, offset=1.0),
                randn(512, scale=0.1))

    blocks = {"block 1": conv_args(3, 31999), "block 5": conv_args(2, 1999)}

    def conv_fwd_check():
        out = []
        for args in blocks.values():
            got = conv_ln_gelu.conv_ln_gelu_fwd(*args)
            want = conv_ln_gelu.conv_ln_gelu_fwd_plain(*args)
            out += [compare("conv_ln_gelu_train", got[0], want[0]),
                    compare("conv_ln_gelu_train", got[1], want[1]),
                    compare("conv_ln_gelu_train rstd", got[2], want[2])]
        return merge(*out)

    c1 = blocks["block 1"]
    T1 = (c1[0].shape[1] - 3) // 2 + 1
    measure("conv_ln_gelu_train", lambda: conv_ln_gelu.conv_ln_gelu_fwd(*c1),
            lambda: conv_ln_gelu.conv_ln_gelu_fwd_plain(*c1), conv_fwd_check,
            (2 * BATCH * T1 * 512 * 512 * 3, BF16_FLOPS,
             nbytes(*c1) + 2 * BATCH * T1 * 512 * 2 + BATCH * T1 * 4))
    conv_yardstick(card, "conv_ln_gelu_train", probe_conv.cudnn_forward(c1[0], c1[1]),
                   "convolution (8 x 31999 -> 15999, k 3, bf16)")
    bwd_args = {}
    for name, args in blocks.items():
        _, xhat, rstd = conv_ln_gelu.conv_ln_gelu_fwd(*args)
        bwd_args[name] = (*args[:2], *args[3:], xhat, rstd, randn(*xhat.shape, dtype=bf16))

    def conv_bwd_check():
        out = []
        for name, args in bwd_args.items():
            x, k, T_out = args[0], args[1].shape[-1], args[4].shape[1]
            want = conv_ln_gelu.conv_ln_gelu_bwd_plain(*args)
            # Free blocks of dx's and da's sizes full of NaN: the kernels'
            # outputs come from the same allocator.
            dirty = [torch.full_like(x, float("nan")), torch.full_like(args[6], float("nan"))]
            del dirty
            got = conv_ln_gelu.conv_ln_gelu_bwd(*args)
            out += [compare_grad(f"conv_ln_gelu_bwd {name} {n}", gg, ww, GRAD_FRAC["conv_bwd"])
                    for n, gg, ww in (("dx", got[0], want[0]), ("dW", got[1], want[1]))]
            out += [compare_grad(f"conv_ln_gelu_bwd {name} {n}", gg, ww, GRAD_FRAC["partials"])
                    for n, gg, ww in zip(("dgamma", "dbeta", "dbias"), got[2], want[2])]
            read = 2 * (T_out - 1) + k
            unread = not bool(got[0][:, read:].any())
            rows = f"rows {read}..{x.shape[1] - 1}" if read < x.shape[1] else "no rows"
            print(f"  conv_ln_gelu_bwd {name}: T_in {x.shape[1]}, T_out {T_out}, k {k}: input "
                  f"{rows} unread, their dx 0: {unread}", flush=True)
            out[-1]["ok"] = out[-1]["ok"] and unread
        return merge(*out)

    b1 = bwd_args["block 1"]
    # dx and dW: two products of the forward's size; dGELU and the LN backward
    # per output element. Outputs dx, dW and the three vectors.
    measure("conv_ln_gelu_bwd", lambda: conv_ln_gelu.conv_ln_gelu_bwd(*b1),
            lambda: conv_ln_gelu.conv_ln_gelu_bwd_plain(*b1), conv_bwd_check,
            (2 * 2 * BATCH * T1 * 512 * 512 * 3, BF16_FLOPS,
             nbytes(*b1) + nbytes(b1[0], b1[1]) + 3 * 512 * 4))
    conv_yardstick(card, "conv_ln_gelu_bwd", probe_conv.cudnn_backward(b1[0], b1[1], b1[6]),
                   "convolution backward, dgrad and wgrad (8 x 31999 -> 15999, k 3, bf16)")
    names = device_kernels(lambda: conv_ln_gelu.conv_ln_gelu_bwd(*b1))
    print(f"  conv_ln_gelu_bwd: {len(names)} device kernels a call: "
          f"{', '.join(n.split('(')[0][:48] for n in names)}", flush=True)
    del blocks, bwd_args, c1, b1

    # Attention backward: (8, 499, 16 x 64), padded keys and a fully masked row.
    q, k, v, do = (randn(BATCH, T, 1024, dtype=bf16) for _ in range(4))
    bq, bk, bv = (randn(1024, scale=0.1, dtype=bf16) for _ in range(3))
    lengths = torch.tensor([499, 400, 300, 250, 200, 499, 50, -1], device=dev)
    key_bias = torch.where(torch.arange(T, device=dev)[None, :] < lengths[:, None], 0.0,
                           -1e30).float()
    o, lse = attention._fwd(q, k, v, bq, bk, bv, key_bias, 64, 0.125)
    args = (q, k, v, bq, bk, bv, key_bias, do, lse, o, 64, 0.125)

    def attn_check():
        got, want = attention.attention_bwd(*args), attention.attention_bwd_plain(*args)
        out = [compare_grad(f"attention_bwd {n}", gg, ww, GRAD_FRAC["attention_bwd"])
               for n, gg, ww in zip(("dq", "dk", "dv"), got[:3], want[:3])]
        out.append(compare_grad("attention_bwd db", got[3], want[3], GRAD_FRAC["partials"]))
        masked_zero = all(not t[-1].any() for t in got[:3])
        print(f"  attention_bwd: fully masked row gets no gradient: {masked_zero}", flush=True)
        res = merge(*out)
        res["ok"] = res["ok"] and masked_zero
        return res

    # Five T x T x 64 products per head (s, dp, dv, dq, dk); outputs dq, dk,
    # dv and the bias sums.
    heads = [heads_of(t + bb, 16) for t, bb in zip((q, k, v), (bq, bk, bv))]
    measure("attention_bwd", lambda: attention.attention_bwd(*args),
            lambda: attention.attention_bwd_plain(*args), attn_check,
            (5 * 2 * BATCH * 16 * T * T * 64, BF16_FLOPS,
             nbytes(*args[:10]) + 3 * nbytes(q) + 3 * 1024 * 4),
            sdpa_bwd_yardstick(*heads, heads_of(do, 16),
                               attention_bias(key_bias[:, None, None, :], (BATCH, 16, T, T)),
                               0.125))
    del q, k, v, do, o, heads

    # FFN: (8, 499, 1024) -> 4096 at rate 0 and 0.1.
    x = randn(BATCH, T, 1024, offset=0.2, dtype=bf16)
    w1 = randn(4096, 1024, scale=1.0 / 32, dtype=bf16)
    w2 = randn(1024, 4096, scale=1.0 / 64, dtype=bf16)
    b1 = randn(4096, scale=0.1)
    dy = randn(BATCH, T, 1024, dtype=bf16)
    seeds = torch.randint(-(2**31), 2**31, (BATCH,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    keep = philox.keep_mask(seeds, T, 4096, 0.1)

    def drop_check():
        got = ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=0.1, seeds=seeds)
        res = compare("ffn_ln_drop", got, ffn.ffn_ln_fc1_plain(x, w1, b1, g, b, rate=0.1,
                                                               seeds=seeds))
        same = bool(torch.equal(got != 0, keep))
        frac = float(keep.float().mean())
        print(f"  ffn_ln_drop: kernel mask == plain Philox mask: {same}; keep fraction "
              f"{frac:.6f} (rate 0.1)", flush=True)
        res["ok"] = res["ok"] and same and abs(frac - 0.9) < 1e-3
        return res

    M = BATCH * T
    measure("ffn_ln_drop", lambda: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=0.1, seeds=seeds),
            lambda: ffn.ffn_ln_fc1_plain(x, w1, b1, g, b, rate=0.1, seeds=seeds), drop_check,
            (2 * M * 1024 * 4096, BF16_FLOPS, nbytes(x, w1, b1, g, b, seeds) + M * 4096 * 2))
    fc1_yardstick(card, "ffn_ln_drop", x, w1)

    def bwd_check():
        out = []
        for rate in (0.0, 0.1):
            got = ffn.ffn_bwd(x, w1, b1, g, b, dy, w2, rate=rate, seeds=seeds)
            want = ffn.ffn_bwd_plain(x, w1, b1, g, b, dy, w2, rate=rate, seeds=seeds)
            g_fwd = ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=rate, seeds=seeds)
            same_g = bool(torch.equal(got[0], g_fwd))
            dropped_zero = rate == 0.0 or not bool(got[1][~keep].any())
            print(f"  ffn_bwd rate {rate}: g regenerated bit for bit: {same_g}; dh zero "
                  f"where dropped: {dropped_zero}", flush=True)
            res = [compare_grad(f"ffn_bwd rate {rate} {n}", gg, ww, GRAD_FRAC["ffn_bwd"])
                   for n, gg, ww in (("dh", got[1], want[1]), ("dx", got[3], want[3]))]
            res.append(compare("ffn_ln", got[2], want[2]))  # ln_out, a rounded LN
            res += [compare_grad(f"ffn_bwd rate {rate} {n}", gg, ww, GRAD_FRAC["partials"])
                    for n, gg, ww in zip(("db1", "dgamma", "dbeta"), got[4:], want[4:])]
            merged = merge(*res)
            merged["ok"] = merged["ok"] and same_g and dropped_zero
            out.append(merged)
        return merge(*out)

    # Three products of 2 M D F (h again, dg, dl); outputs g, dh, ln_out, dx
    # and the vectors.
    measure("ffn_bwd", lambda: ffn.ffn_bwd(x, w1, b1, g, b, dy, w2, rate=0.1, seeds=seeds),
            lambda: ffn.ffn_bwd_plain(x, w1, b1, g, b, dy, w2, rate=0.1, seeds=seeds),
            bwd_check,
            (3 * 2 * M * 1024 * 4096, BF16_FLOPS,
             nbytes(x, w1, b1, g, b, dy, w2, seeds) + 2 * M * 4096 * 2 + 2 * nbytes(x)
             + (4096 + 2 * 1024) * 4))
    fc1_yardstick(card, "ffn_bwd", x, w1)
    del x, dy, keep

    ctc_rows(card, results, measure, randn, gen)
    return results


def ctc_rows(card: str, results: dict, measure, randn, gen) -> None:
    """K6 at T' = 499, B = 8, L = 128 (S = 257), row 7 infeasible: each
    recursion against its plain version and timed (the wrapper, its mask
    conversions included), the same bits on two calls, the kernel alone
    and its latency floor (``tools/probe_ctc.py``: coral_ctc_probe's modes),
    and ``F.ctc_loss`` at the same shapes, which computes the loss and its
    gradient too (no single call computes K6's function: ``library_ms``
    stays null)."""
    from coral_tpu_torch.ops import ctc
    from coral_tpu_torch.tools import probe_ctc

    dev, T = torch.device("cuda"), 499
    log_probs = torch.log_softmax(randn(T, BATCH, 46, scale=3.0), dim=-1)
    labels = torch.randint(1, 46, (BATCH, MAX_LABEL), generator=gen, device=dev)
    in_len = torch.tensor(probe_ctc.IN_LEN, device=dev)
    lab_len = torch.tensor(probe_ctc.LAB_LEN, device=dev)
    ext = ctc._extended_labels(labels, 0)
    skip, skip_fwd, valid, terminal = ctc._state_masks(ext, lab_len, 0)
    emit = ctc._emissions(log_probs, ext)  # rows of S rounded up to 4, as ctc_loss gathers them
    a_args, b_args = (emit, skip, valid, in_len), (emit, skip_fwd, valid, in_len, terminal)
    # The recursion visits every (t, b, s) cell once; it reads the emissions
    # and masks and writes one fp32 value per cell.
    measure("ctc_alpha", lambda: ctc.ctc_alpha(*a_args), lambda: ctc.ctc_alpha_plain(*a_args),
            lambda: compare("ctc_alpha", ctc.ctc_alpha(*a_args), ctc.ctc_alpha_plain(*a_args)),
            (CTC_CELL_OPS * emit.numel(), FP32_FLOPS, nbytes(*a_args) + nbytes(emit)))
    measure("ctc_beta", lambda: ctc.ctc_beta(*b_args), lambda: ctc.ctc_beta_plain(*b_args),
            lambda: compare("ctc_beta", ctc.ctc_beta(*b_args), ctc.ctc_beta_plain(*b_args)),
            (CTC_CELL_OPS * emit.numel(), FP32_FLOPS, nbytes(*b_args) + nbytes(emit)))

    def dev(fn) -> str:
        ms = device_ms(fn)
        return "not measured" if ms is None else f"{ms:.4f} ms"

    for name, fn, beta, args in (("ctc_alpha", ctc.ctc_alpha, False, a_args),
                                 ("ctc_beta", ctc.ctc_beta, True, b_args)):
        same = bool(torch.equal(fn(*args), fn(*args)))
        floor = device_ms(probe_ctc.launcher(args, beta, 1))
        floor_text = ("not measured" if floor is None else
                      f"{floor:.4f} ms device, {floor * 1e6 / T:.1f} ns a step over {T} steps")
        print(f"  {name}: two calls give the same bits: {same}; the kernel alone (masks "
              f"converted outside) {dev(probe_ctc.launcher(args, beta, 0))} device; latency "
              f"floor (the recursion alone: state in registers, no emission ring, no stores) "
              f"{floor_text} ({card})", flush=True)
        results[name]["ok"] = results[name]["ok"] and same
    lp = log_probs.detach().clone().requires_grad_(True)

    def loss():
        return torch.nn.functional.ctc_loss(lp, labels, in_len, lab_len, blank=0,
                                            reduction="sum", zero_infinity=True)

    def loss_and_grad():
        lp.grad = None
        loss().backward()

    print(f"  F.ctc_loss at ({T}, {BATCH}, V 46, L {MAX_LABEL}), which computes the loss and "
          f"its gradient too (not K6's function; the port never calls it): forward "
          f"{median_ms(loss):.4f} ms (device {dev(loss)}), forward and backward "
          f"{median_ms(loss_and_grad):.4f} ms (device {dev(loss_and_grad)}; median of {REPS}; "
          f"{card})", flush=True)
    nll = ctc.ctc_loss(log_probs, labels, in_len, lab_len, reduction="none")
    print(f"  ctc_loss: per-row losses {[round(float(v), 3) for v in nll]} (row 7 "
          f"infeasible -> 0)", flush=True)
    if float(nll[7]) != 0.0 or not bool(torch.isfinite(nll).all()):
        results["ctc_alpha"]["ok"] = False


def w2v2_forward_launches(cfg) -> dict:
    """The kernel launches of one wav2vec2 forward (serving) at cfg's widths."""
    from coral_tpu_torch.ops import attention, ffn, ln_gelu

    D, L = cfg.hidden_size, cfg.num_hidden_layers
    hd = D // cfg.num_attention_heads
    return {"ln_gelu": 1, "conv_ln_gelu": 6, ln_gelu._name("ln_fused", D): L,
            attention._name("fwd", hd): L, ffn._name("ffn_ln", D): L}


def serving_run(card: str, model_id: str = "facebook/wav2vec2-xls-r-300m",
                arch: tuple = (1024, 24, 16), label: str = "serving",
                long_clip: bool = True, reps: tuple = (5, 3, 3)) -> tuple[dict, dict]:
    """The main path through ASRPipeline; returns (launch counts, metrics).
    ``reps``: the timed runs of the latency, the plain path's latency and the
    transcription of the clips."""
    from coral_tpu_torch import ASRPipeline
    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.training.model_setup import GreedyCtcPredictor

    t0 = time.perf_counter()
    asr = ASRPipeline(model_id, batch_size=BATCH, device="cuda")
    predictor = asr.predictor
    cfg = predictor.model.config
    print(f"{label} model {model_id}: hidden {cfg.hidden_size}, {cfg.num_hidden_layers} "
          f"layers, {cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, {cfg.dtype}, "
          f"window {asr.window_seconds} s, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.dtype) != (*arch, torch.bfloat16):
        fail(f"the pipeline did not build {model_id} in bf16")

    rng = np.random.default_rng(0)
    seconds = np.linspace(3.0, 30.0, 12)
    clips = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]
    long_audio = (rng.standard_normal(45 * SR) * 0.1).astype(np.float32)
    T = int(asr.window_seconds * SR)
    step = T - 2 * (T // 6)  # ASRPipeline.transcribe's windows overlap by T // 6 a side
    n_windows = 1 + math.ceil((len(long_audio) - T) / step) if long_clip else 0
    forwards = math.ceil(len(clips) / BATCH) + math.ceil(n_windows / BATCH)

    # The main path, counted.
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    texts = asr.transcribe_batch(clips)
    long_text = asr.transcribe(long_audio) if long_clip else ""
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"{label} main path: {forwards} forwards, launch counts {counts}", flush=True)
    for name, n in w2v2_forward_launches(cfg).items():
        if counts.get(name, 0) < n * forwards:
            fail(f"{name} launched {counts.get(name, 0)} times, expected >= {n * forwards}")
    if len(texts) != len(clips) or not all(isinstance(t, str) for t in texts):
        fail("transcribe_batch returned the wrong transcripts")
    if not isinstance(long_text, str):
        fail("transcribe returned no transcript for the long clip")
    print(f"{label} transcripts: {len(texts)} clips, first {texts[0][:40]!r}"
          + (f"; 45 s clip in {n_windows} windows, {len(long_text)} characters"
             if long_clip else ""), flush=True)

    # Kernel path vs plain path on the second, partial batch.
    batch_audio = np.zeros((BATCH, T), np.float32)
    lengths = np.ones((BATCH,), np.int32)
    for j, clip in enumerate(clips[BATCH:]):
        batch_audio[j, : len(clip)] = clip
        lengths[j] = len(clip)
    batch = {"input_values": batch_audio, "input_lengths": lengths}
    logits, frames = predictor.logits(batch)
    with torch.device("meta"):
        plain_model = Wav2Vec2ForCTC(cfg, plain=True)
    plain_model = plain_model.to_empty(device="cuda").eval()
    plain_model.load_state_dict(predictor.model.state_dict())
    plain = GreedyCtcPredictor(plain_model, predictor.tokenizer)
    plain_logits, plain_frames = plain.logits(batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        fail("the kernel path's logits are not finite")
    if logits.shape != (BATCH, 1499, cfg.vocab_size) or not torch.equal(frames, plain_frames):
        fail(f"unexpected logits {tuple(logits.shape)} or frame lengths")
    diff = float((logits.float() - plain_logits.float()).abs().max()
                 / plain_logits.float().abs().max())
    agree, total = 0, 0
    for i in range(BATCH):
        n = int(frames[i])
        if n > 0:
            agree += int((logits[i, :n].argmax(-1) == plain_logits[i, :n].argmax(-1)).sum())
            total += n
    print(f"{label} logits kernel vs plain: max|diff|/max|plain| {diff:.6g} (tolerance "
          f"{LOGITS_TOL}); argmax agreement over {total} valid frames {agree / total:.6f}; "
          f"filler rows frame lengths {frames[len(clips) - BATCH:].tolist()}", flush=True)
    if diff > LOGITS_TOL:
        fail("kernel path and plain path disagree")

    full = {"input_values": np.stack([np.resize(c, T) for c in clips[-BATCH:]]),
            "input_lengths": np.full((BATCH,), T, np.int32)}

    latency = timed(lambda: predictor(full), reps[0])
    plain_latency = timed(lambda: plain(full), reps[1])
    del plain, plain_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wall = timed(lambda: asr.transcribe_batch(clips), reps[2])
    peak = torch.cuda.max_memory_allocated()
    metrics = {
        "audio_s_per_s": float(seconds.sum() / wall),
        "latency_ms_per_batch": latency * 1e3,
        "plain_latency_ms_per_batch": plain_latency * 1e3,
        "peak_memory_gib": peak / 2**30,
        "logits_max_rel_diff": diff,
        "argmax_agreement": agree / total,
    }
    print(f"{label} ({card}): {metrics['audio_s_per_s']:.3f} audio-s/s over "
          f"{seconds.sum():.1f} s of audio in 12 clips (median of {reps[2]}); latency "
          f"{metrics['latency_ms_per_batch']:.3f} ms per batch of {BATCH} x 30 s (median of "
          f"{reps[0]}; plain path {metrics['plain_latency_ms_per_batch']:.3f} ms); peak memory "
          f"{metrics['peak_memory_gib']:.3f} GiB", flush=True)
    return counts, metrics


def profile_window(card: str, label: str, fn) -> float:
    """Runs ``fn`` once under ``torch.profiler`` and prints the device's busy
    share (the union of the kernels' intervals over the window), the device
    time by kernel and the host's self time by op; returns the busy share.
    It reads the profiler's raw events: building its event tree
    (``prof.events()``, ``key_averages()``) takes minutes for a decode loop's
    million events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    kernels, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == DeviceType.CPU:
            cpu.append((e.start_thread_id(), e.start_ns(), -e.end_ns(), e.name()))
    window = (max(-e[2] for e in cpu) - min(e[1] for e in cpu)) / 1e6
    busy, end = 0.0, -math.inf
    for a, b, _ in sorted(kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e6
    by_name: dict = {}
    for a, b, name in kernels:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e6, n + 1)
    rows = sorted(((ms, n, k) for k, (ms, n) in by_name.items()), reverse=True)
    print(f"profile of {label} ({card}): window {window:.3f} ms (profiler on), device busy "
          f"{busy:.3f} ms (union of {len(kernels)} kernels), busy share {busy / window:.4f}; "
          f"device time by kernel:", flush=True)
    for ms, n, key in rows[:16]:
        print(f"    {ms:10.3f} ms  {n:6d}x  {key[:96]}", flush=True)
    print(f"    {sum(r[0] for r in rows[16:]):10.3f} ms  {sum(r[1] for r in rows[16:]):6d}x  "
          f"the other {max(len(rows) - 16, 0)} kernels", flush=True)
    # Self time: an op's span less its children's, ops nested by thread and time.
    self_ns: dict = collections.defaultdict(lambda: [0, 0])
    stack: list = []
    for thread, start, neg_end, name in sorted(cpu):
        while stack and (stack[-1][0] != thread or stack[-1][1] <= start):
            stack.pop()
        if stack:
            self_ns[stack[-1][2]][0] -= -neg_end - start
        self_ns[name][0] += -neg_end - start
        self_ns[name][1] += 1
        stack.append((thread, -neg_end, name))
    host = sorted(self_ns.items(), key=lambda kv: kv[1][0], reverse=True)
    print("  host time by op (self CPU ms, profiler on): " + "; ".join(
        f"{name} {ns / 1e6:.1f} ({n}x)" for name, (ns, n) in host[:8]), flush=True)
    return busy / window


def phase_setup(config: dict):
    """``load_model_setup(config)`` on the card; for ``config["architecture"]
    == "wav2vec2-base"`` its model config is wav2vec2-base's (``BASE_FLAGS``,
    the model keys' dropouts and masks), its widths checked as a setup
    checks them."""
    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from coral_tpu_torch.training.model_setup import check_kernel_widths, load_model_setup

    setup = load_model_setup(config, device="cuda")
    if config.get("architecture") == "wav2vec2-base":
        m = config["model"]
        setup.model_config = Wav2Vec2Config.base(
            vocab_size=setup.tokenizer.vocab_size, dtype=torch.bfloat16,
            **{k: m[k] for k in ("hidden_dropout", "activation_dropout", "attention_dropout",
                                 "feat_proj_dropout", "final_dropout", "layerdrop",
                                 "mask_time_prob", "mask_time_length", "mask_feature_prob",
                                 "mask_feature_length")},
            **BASE_FLAGS)
        check_kernel_widths(setup.model_config)
    return setup


def train_batch(seed: int) -> tuple[dict, float]:
    """A fixed (ACCUM, 8, 160000) batch: clips of 6-10 s of seeded noise, padded
    to 10 s, with random label sequences of 64-128 ids (the blank excluded).
    Returns the batch and the seconds of audio in it."""
    rng = np.random.default_rng(seed)
    T = int(TRAIN_CONFIG["max_seconds_per_example"] * SR)
    lengths = rng.integers(6 * SR, T + 1, size=(ACCUM, BATCH)).astype(np.int32)
    audio = np.zeros((ACCUM, BATCH, T), np.float32)
    for a in range(ACCUM):
        for i in range(BATCH):
            audio[a, i, : lengths[a, i]] = rng.standard_normal(lengths[a, i]) * 0.1
    label_lengths = rng.integers(64, MAX_LABEL + 1, size=(ACCUM, BATCH)).astype(np.int32)
    labels = np.full((ACCUM, BATCH, MAX_LABEL), -100, np.int32)
    for a in range(ACCUM):
        for i in range(BATCH):
            labels[a, i, : label_lengths[a, i]] = rng.integers(1, 46, label_lengths[a, i])
    batch = {"input_values": audio, "input_lengths": lengths, "labels": labels,
             "label_lengths": label_lengths}
    return batch, float(lengths.sum()) / SR


def plain_twin(model):
    """The plain-path model (``Wav2Vec2ForCTC(plain=True)``) on ``model``'s
    weights, checkpointed under its remat policy, its feature encoder
    replayed where ``model``'s is."""
    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC

    with torch.device("meta"):
        plain = Wav2Vec2ForCTC(model.config, plain=True)
    plain = plain.to_empty(device="cuda")
    plain.load_state_dict(model.state_dict())
    encoder = model.wav2vec2.encoder
    plain.wav2vec2.encoder.gradient_checkpointing = encoder.gradient_checkpointing
    plain.wav2vec2.encoder.remat_policy = encoder.remat_policy
    plain.wav2vec2.feature_extractor.remat = model.wav2vec2.feature_extractor.remat
    return plain


def training_compare(card: str, batch: dict, config: dict = PRODUCTION_CONFIG,
                     label: str = "(a)", layers: int | None = None,
                     activation_dropout: float = 0.0) -> dict:
    """Training (a): the kernel path's loss and gradients against the plain
    path's on one microbatch, the feature encoder training under the
    config's remat policy (save_qk_ctx unless it names one); ``layers`` cuts
    the encoder's depth (the plain twin is a second model);
    ``activation_dropout`` (both paths draw the same Philox bits). On a
    post-LN model a ``POST_LN_ARBITRATED`` parameter beyond
    ``TRAIN_GRAD_TOL`` is held to an fp32 plain path (``FP32_ARBITER``),
    which must reject the planted fault (``PLANTED_DQK_SCALE``)."""
    import copy
    import dataclasses

    from coral_tpu_torch.ops import attention
    from coral_tpu_torch.training.optimizer import global_norm
    from coral_tpu_torch.training.train_state import _load_work_params, ctc_loss_and_grads

    cfg_a = copy.deepcopy(config)
    cfg_a["model"]["activation_dropout"] = activation_dropout
    cfg_a["augment_audio"] = False
    policy = cfg_a["model"].get("remat_policy", "save_qk_ctx")
    setup = phase_setup(cfg_a)
    if layers is not None:
        setup.model_config = dataclasses.replace(setup.model_config, num_hidden_layers=layers)
    model = setup.init_params(seed=0)
    if (setup.freeze_feature_encoder, model.wav2vec2.encoder.remat_policy) != (False, policy):
        fail(f"training {label} did not get the feature encoder training under {policy}")
    plain = plain_twin(model)
    masters = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    one = {k: torch.as_tensor(v[:1]).cuda() for k, v in batch.items()}

    def grads_of(m, dtype=torch.bfloat16):
        _load_work_params(m, masters, dtype)
        gen = torch.Generator(device="cuda").manual_seed(7)
        return ctc_loss_and_grads(m, one, gen, setup.blank_id, "sum", False)

    out = {name: grads_of(m) for name, m in (("kernel", model), ("plain", plain))}
    torch.cuda.synchronize()
    (loss_k, grads_k), (loss_p, grads_p) = out["kernel"], out["plain"]
    norm_k, norm_p = float(global_norm(list(grads_k.values()))), float(
        global_norm(list(grads_p.values())))
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    norm_rel = abs(norm_k - norm_p) / norm_p
    ratios, k_bias = [], []
    for n, gp in grads_p.items():
        scale = float(gp.abs().max())
        if scale == 0.0:
            if bool(grads_k[n].any()):
                fail(f"{n}: the kernel path has a gradient where the plain path has none")
            continue
        if n.endswith("k_proj.bias"):
            # Adding bk shifts every score of a query by q.bk, which softmax
            # ignores: its gradient is 0 and both paths hold rounding noise.
            k_bias.append((max(scale, float(grads_k[n].abs().max()))
                           / float(grads_p[n.replace("k_proj", "v_proj")].abs().max())))
            continue
        ratios.append((float((grads_k[n] - gp).abs().max()) / scale, n))
    ratios.sort(reverse=True)
    post_ln = not model.config.do_stable_layer_norm
    unresolved = sorted(n for r, n in ratios
                        if r > TRAIN_GRAD_TOL and post_ln and POST_LN_ARBITRATED.search(n))
    arbitrated = []
    if unresolved:
        from coral_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC

        del plain
        torch.cuda.empty_cache()
        with torch.device("meta"):
            f32 = Wav2Vec2ForCTC(dataclasses.replace(model.config, dtype=torch.float32),
                                 plain=True)
        f32 = f32.to_empty(device="cuda")
        f32.load_state_dict(model.state_dict())
        f32.wav2vec2.encoder.gradient_checkpointing = True
        f32.wav2vec2.encoder.remat_policy = model.wav2vec2.encoder.remat_policy
        _, grads_f = grads_of(f32, torch.float32)
        del f32
        # The planted fault: the kernel path again, the attention backward's
        # dq and dk (and the q and k bias gradients) scaled.
        sound_bwd, planted = attention.attention_bwd, []

        def faulty_bwd(*args, **kwargs):
            dq, dk, dv, db = sound_bwd(*args, **kwargs)
            planted.append(1)
            if db is not None:
                db = torch.cat([db[:2] * PLANTED_DQK_SCALE, db[2:]])
            return dq * PLANTED_DQK_SCALE, dk * PLANTED_DQK_SCALE, dv, db

        attention.attention_bwd = faulty_bwd
        try:
            _, grads_x = grads_of(model)
        finally:
            attention.attention_bwd = sound_bwd
        if len(planted) != model.config.num_hidden_layers:
            fail(f"training {label}: the planted fault reached {len(planted)} attention "
                 f"backwards, not one a layer")
        for n in unresolved:
            gf = grads_f[n].float()
            d_p = (grads_p[n].float() - gf).norm()
            missed = float((grads_p[n].float() - gf).abs().max()) / float(gf.abs().max())
            arbitrated.append((n, missed, float((grads_k[n].float() - gf).norm() / d_p),
                               float((grads_x[n].float() - gf).norm() / d_p)))
        del grads_f, grads_x
        ratios = [(r, n) for r, n in ratios if n not in unresolved]
        plain = None
    worst = ratios[0][0]
    fe = [(r, n) for r, n in ratios if "feature_extractor" in n]
    cfg = model.config
    del model, plain, masters, out
    torch.cuda.empty_cache()
    print(f"training {label} kernel vs plain, hidden {cfg.hidden_size}, {cfg.num_hidden_layers} "
          f"layers, one microbatch of {BATCH}, feature encoder training, activation dropout "
          f"{activation_dropout}, {policy}: loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
          f"(rel {loss_rel:.6g}, tolerance {TRAIN_LOSS_RTOL}); grad norm {norm_k:.6f} vs {norm_p:.6f} (rel "
          f"{norm_rel:.6g}, tolerance {TRAIN_GRAD_NORM_RTOL}); gradient max|diff|/max|plain| over "
          f"{len(ratios)} parameters (tolerance {TRAIN_GRAD_TOL}), worst: "
          + "; ".join(f"{r:.6g} {n}" for r, n in ratios[:5]), flush=True)
    print(f"  feature encoder, {len(fe)} parameters with gradients: worst "
          + "; ".join(f"{r:.6g} {n}" for r, n in fe[:3]), flush=True)
    arbiter_ok = all(missed > TRAIN_GRAD_TOL and k <= FP32_ARBITER < x
                     for _, missed, k, x in arbitrated)
    if arbitrated:
        ks, xs = [a[2] for a in arbitrated], [a[3] for a in arbitrated]
        print(f"  post-LN: {len(arbitrated)} query/key parameters beyond {TRAIN_GRAD_TOL} held to "
              f"an fp32 plain path (the plain bf16 path's max|diff| / max|fp32| must exceed "
              f"{TRAIN_GRAD_TOL}: {min(a[1] for a in arbitrated):.4g} to "
              f"{max(a[1] for a in arbitrated):.4g}; the L2 distance from fp32, kernel / plain, "
              f"must be within {FP32_ARBITER}: {min(ks):.4g} to {max(ks):.4g}; with dq and dk "
              f"scaled by {PLANTED_DQK_SCALE}, planted, it must exceed {FP32_ARBITER} on each: "
              f"{min(xs):.4g} to {max(xs):.4g}), worst by the kernel's ratio: " + "; ".join(
                  f"{n} plain {m:.4g}, kernel/plain {k:.4g}, planted {x:.4g}"
                  for n, m, k, x in sorted(arbitrated, key=lambda a: -a[2])[:5])
              + ("" if arbiter_ok else " FAILED"), flush=True)
    print(f"  k_proj.bias gradients (0 in exact arithmetic), max|g| / max|g of v_proj.bias| "
          f"over {len(k_bias)} layers: worst {max(k_bias):.6g} (tolerance "
          f"{K_BIAS_NOISE})", flush=True)
    fe_params = [n for n in grads_k if "feature_extractor" in n]
    fe_live = all(bool(torch.isfinite(grads_k[n]).all()) and bool(grads_k[n].any())
                  for n in fe_params)
    if not (math.isfinite(float(loss_k)) and loss_rel <= TRAIN_LOSS_RTOL
            and norm_rel <= TRAIN_GRAD_NORM_RTOL and worst <= TRAIN_GRAD_TOL
            and max(k_bias) <= K_BIAS_NOISE and fe_live and len(fe) == len(fe_params)
            and arbiter_ok):
        fail(f"the training {label} kernel path and plain path disagree")
    return {"loss_rel": loss_rel, "grad_norm_rel": norm_rel, "worst_grad": worst,
            "worst_fe_grad": fe[0][0]}


def production_run(card: str, label: str, config: dict, per_microbatch: dict,
                   batch: dict, audio_seconds: float, arch: tuple = (1024, 24),
                   steps: int = TRAIN_STEPS, plain_steps: int = 2, falling: bool = True,
                   warmup: int = WARMUP_STEPS) -> tuple[dict, dict]:
    """``steps`` optimizer steps through ``Wav2Vec2Setup.make_train_step`` on
    one fixed batch with the same draws each step, then ``plain_steps`` of
    the plain path for its time; returns (launch counts of the first step,
    metrics)."""
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.training import TrainState, create_optimizer

    setup = phase_setup(config)
    model = setup.init_params(seed=0)
    cfg = setup.model_config
    print(f"training {label}: hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"activation dropout {cfg.activation_dropout}, SpecAugment time "
          f"{cfg.mask_time_prob}/{cfg.mask_time_length} feature {cfg.mask_feature_prob}/"
          f"{cfg.mask_feature_length}, {cfg.dtype}, feature encoder "
          f"{'frozen' if setup.freeze_feature_encoder else 'training'}, remat "
          f"{setup.remat_policy}, augmentation {config['augment_audio']}, batch {ACCUM} x "
          f"{BATCH} x {batch['input_values'].shape[-1]} samples", flush=True)
    if (cfg.hidden_size, cfg.num_hidden_layers, cfg.dtype) != (*arch, torch.bfloat16):
        fail(f"training {label}: the setup did not build hidden {arch[0]}, {arch[1]} layers "
             "in bf16")

    def optimizer():
        return create_optimizer(
            learning_rate=setup.learning_rate, warmup_steps=warmup, max_steps=1000,
            adam_beta1=config["adam_first_momentum"], adam_beta2=config["adam_second_momentum"],
            max_grad_norm=config["max_grad_norm"], mu_dtype=config["adam_mu_dtype"])

    def draws():
        return torch.Generator(device="cuda").manual_seed(0)

    tx, schedule = optimizer()
    state = TrainState.create(model, tx)
    step = setup.make_train_step(tx, schedule)

    # The main path, counted: the first optimizer step.
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    state, metrics = step(state, batch, draws())
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"training {label} main path: 1 step of {ACCUM} microbatches, launch counts "
          f"{counts}", flush=True)
    expected = {name: n * ACCUM for name, n in per_microbatch.items()}
    if counts != expected:
        fail(f"training {label}: launch counts {counts}, expected {expected}")
    losses = [float(metrics["loss"])]
    walls = []
    # The forward and backward alone: the first timed step's peak from its
    # start (the optimizer state exists) to the optimizer's update, above
    # what was held at its start.
    update, fb_peaks = tx.update, []

    def peak_then_update(*args):
        torch.cuda.synchronize()
        fb_peaks.append(torch.cuda.max_memory_allocated())
        return update(*args)

    tx.update = peak_then_update
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps - 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, metrics = step(state, batch, draws())
        losses.append(float(metrics["loss"]))  # synchronises
        walls.append(time.perf_counter() - start)
    peak = torch.cuda.max_memory_allocated()
    tx.update = update
    # The step state: fp32 masters and second moment, the bf16 first moment
    # and work copies; the rest of the peak is activations and temporaries.
    state_bytes = sum(nbytes(*d.values()) for d in (state.params, state.opt_state.mu,
                                                    state.opt_state.nu))
    state_bytes += nbytes(*model.parameters())
    print(f"training {label} losses over {steps} steps: {[round(v, 4) for v in losses]}; "
          f"last grad norm {float(metrics['grad_norm']):.6f}, learning rate "
          f"{float(metrics['learning_rate']):.6g}; step state {state_bytes / 2**30:.3f} GiB of "
          f"the {peak / 2**30:.3f} GiB peak", flush=True)
    if not all(math.isfinite(v) for v in losses) or (falling and not losses[-1] < losses[0]):
        fail(f"training {label} loss not finite" + (" or not falling" if falling else ""))

    # One step under the profiler: device time by kernel, and the busy share.
    def one_step():
        nonlocal state, metrics
        state, metrics = step(state, batch, draws())

    profile_window(card, f"one training {label} step", one_step)

    # The plain path's time per step on the same weights and batch.
    pwalls = []
    if plain_steps:
        plain = plain_twin(model)
        ptx, pschedule = optimizer()
        pstate = TrainState.create(plain, ptx)
        pstep = setup.make_train_step(ptx, pschedule)
        pgen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(plain_steps):
            torch.cuda.synchronize()
            start = time.perf_counter()
            pstate, pm = pstep(pstate, batch, pgen)
            float(pm["loss"])
            pwalls.append(time.perf_counter() - start)
        del plain, pstate
    del state, model, step
    torch.cuda.empty_cache()
    wall = float(np.median(walls))
    metrics = {
        "train_audio_s_per_s": audio_seconds / wall,
        "ms_per_step": wall * 1e3,
        "plain_ms_per_step": pwalls[-1] * 1e3 if pwalls else None,
        "peak_memory_gib": peak / 2**30,
        "fwd_bwd_peak_gib": (fb_peaks[0] - held) / 2**30,
        "losses": losses,
    }
    STEP_MS[label] = metrics["ms_per_step"]
    FWD_BWD_PEAK_GIB[label] = metrics["fwd_bwd_peak_gib"]
    plain_text = (f"; plain path {metrics['plain_ms_per_step']:.3f} ms" if pwalls else "")
    print(f"training {label} ({card}): {metrics['train_audio_s_per_s']:.3f} audio-s/s "
          f"({audio_seconds:.3f} s of audio per step of {ACCUM} x {BATCH} clips); "
          f"{metrics['ms_per_step']:.3f} ms per optimizer step (median of "
          f"{len(walls)}{plain_text}); peak memory {metrics['peak_memory_gib']:.3f} GiB, "
          f"of the forward and backward {metrics['fwd_bwd_peak_gib']:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held at the step's start", flush=True)
    return counts, metrics


def training_run(card: str) -> dict:
    """Training (a), (b) and (c); returns the launch counts summed over the
    counted first steps of (b) and (c)."""
    import tempfile

    batch, audio_seconds = train_batch(0)
    training_compare(card, batch)
    torch.cuda.empty_cache()
    counts_b, _ = production_run(card, "(b)", TRAIN_CONFIG, PER_MICROBATCH, batch,
                                 audio_seconds)
    with tempfile.TemporaryDirectory() as tmp:
        bank = np.random.default_rng(1).standard_normal(
            (NOISE_CLIPS, NOISE_SECONDS * SR)).astype(np.float32) * 0.1
        np.save(Path(tmp) / "noise.npy", bank)
        config = {**PRODUCTION_CONFIG, "background_noise_path": str(Path(tmp) / "noise.npy")}
        counts_c, _ = production_run(card, "(c)", config, PRODUCTION_PER_MICROBATCH, batch,
                                     audio_seconds)
    return {name: counts_b.get(name, 0) + counts_c.get(name, 0)
            for name in {*counts_b, *counts_c}}


def decode_launch_path(card: str, calls: dict, host_calls: int = 1000) -> None:
    """Each decode wrapper at the rows' shapes: its device kernels a call
    (``one_kernel_a_call``: fails unless 1, the key split combined inside the
    kernel's cluster) and its host microseconds a call over ``host_calls`` calls with
    no synchronise between them."""
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.tools.probe_ln_host import per_call_us

    for name, fn in calls.items():
        kernels = one_kernel_a_call(name, fn)
        print(f"  {name}: {len(kernels)} device kernel(s) a call by the profiler: "
              f"{', '.join(k[:60] for k in kernels)}; 1 node a captured call", flush=True)
    parts = [f"{name} {per_call_us(fn, host_calls):.2f}" for name, fn in calls.items()]
    print(f"  decode wrappers' host path, us a call over {host_calls} calls, no synchronise "
          f"between them ({card}): " + "; ".join(parts), flush=True)
    _build.reset_launch_counts()


def fc1_yardstick(card: str, name: str, x: torch.Tensor, w1: torch.Tensor) -> None:
    """cuBLAS's fc1 product alone at a K5 row's shape (x @ W1^T in bf16: no
    LayerNorm, bias, GELU or mask), printed beside the row as its yardstick
    (the backward's rows make three such products); the port never calls
    it."""
    x2 = x.reshape(-1, x.shape[-1])

    def product():
        return torch.matmul(x2, w1.t())

    ms, dev = median_ms(product), device_ms(product)
    print(f"  {name}: cuBLAS's fc1 product alone ({x2.shape[0]} x {x2.shape[1]} @ "
          f"{w1.shape[1]} x {w1.shape[0]}, bf16) {ms:.4f} ms (device "
          f"{'not measured' if dev is None else f'{dev:.4f} ms'}; median of {REPS}; {card})",
          flush=True)


def conv_yardstick(card: str, name: str, fn, what: str) -> None:
    """cuDNN's stride-2 convolution alone at a K3 row's shape
    (``coral_tpu_torch/tools/probe_conv.py``: ``F.conv1d(x.transpose(1, 2),
    w, stride=2)``, or its dgrad and wgrad for the backward; no bias,
    LayerNorm or GELU), printed beside the row as its yardstick; the port
    never calls it."""
    ms, dev = median_ms(fn), device_ms(fn)
    print(f"  {name}: cuDNN's {what} alone {ms:.4f} ms (device "
          f"{'not measured' if dev is None else f'{dev:.4f} ms'}; median of {REPS}; {card})",
          flush=True)


def ffn_launch_path(card: str, randn, host_calls: int = 1000) -> None:
    """``ffn_ln_fc1_fwd`` and ``ffn_bwd`` at D 1280, F 5120 on 16 rows: each
    wrapper's device kernels a call by the profiler (the forward must launch
    1, ``one_kernel_a_call``) and its microseconds a call over ``host_calls``
    calls with no synchronise between them (the tensor maps of the weights kept, the
    activations' encoded each call). The forward's is its host path; the
    backward's dl kernel walks all of K = F in one block a column tile, so
    its figure is the device's at that shape."""
    from coral_tpu_torch.ops import _build, ffn
    from coral_tpu_torch.tools.probe_ln_host import per_call_us

    bf16 = torch.bfloat16
    D, F = 1280, 5120
    x, dy = randn(1, 16, D, dtype=bf16), randn(1, 16, D, dtype=bf16)
    w1, w2 = randn(F, D, scale=D**-0.5, dtype=bf16), randn(D, F, scale=F**-0.5, dtype=bf16)
    b1, g, b = randn(F, scale=0.1), randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1)
    calls = {"ffn_ln_fc1_fwd": lambda: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b),
             "ffn_bwd": lambda: ffn.ffn_bwd(x, w1, b1, g, b, dy, w2)}
    for name, fn in calls.items():
        kernels = one_kernel_a_call(name, fn) if name == "ffn_ln_fc1_fwd" else device_kernels(fn)
        print(f"  {name} at 1280 x 5120: {len(kernels)} device kernel(s) a call by the "
              f"profiler: {', '.join(k[:48] for k in kernels)}"
              f"{'; 1 node a captured call' if name == 'ffn_ln_fc1_fwd' else ''}", flush=True)
    parts = [f"{name} {per_call_us(fn, host_calls):.2f}" for name, fn in calls.items()]
    print(f"  FFN wrappers at 1280 x 5120, 16 rows, us a call over {host_calls} "
          f"calls, no synchronise between them ({card}): " + "; ".join(parts), flush=True)
    _build.reset_launch_counts()


def whisper_kernel_checks(card: str) -> dict:
    """Whisper serving's kernels against their plain versions at its shapes:
    whisper-large-v3 (d 1280, 20 heads x 64, 32 layers), 8 x 30 s (T = 1500
    encoder rows), the decode caches at their largest phase (225 slots)."""
    from coral_tpu_torch.ops import decode_attention, ffn, flash_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    bf16 = torch.bfloat16
    results = {}
    measure = functools.partial(_measure, results, card)
    T, H, d, D, L, F = 1500, 20, 64, 1280, 32, 5120

    # Encoder self-attention: q, k, v (8, 1500, 20, 64), views of the projections.
    q, k, v = (randn(BATCH, T, D, dtype=bf16).view(BATCH, T, H, d) for _ in range(3))
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    measure("flash_attention", lambda: flash_attention.flash_self_attention(q, k, v),
            lambda: flash_attention.flash_self_attention_plain(q, k, v),
            lambda: compare("flash_attention", flash_attention.flash_self_attention(q, k, v),
                            flash_attention.flash_self_attention_plain(q, k, v)),
            (4 * BATCH * H * T * T * d, BF16_FLOPS, 4 * nbytes(q)),
            lambda: sdpa(*heads))
    del q, k, v, heads

    # Decode self-attention over layer 17 of the (32, 8, 225, 1280) cache at
    # position 150 (K = 1, the causal mask), and at K = 5 beams of 2 items
    # with a random ancestor mask. Scores and p @ v are fp32 FMAs.
    T_b, pos, layer = 225, 150, 17
    qd = randn(BATCH, D, dtype=bf16)
    ck, cv = (randn(L, BATCH, T_b, D, dtype=bf16) for _ in range(2))
    onehot = (torch.arange(T_b, device=dev) <= pos).float()[None, None, :].expand(
        BATCH, 1, T_b).contiguous()
    K = 5
    q5 = randn(2 * K, D, dtype=bf16)
    c5k, c5v = (randn(L, 2 * K, T_b, D, dtype=bf16) for _ in range(2))
    ancestors = torch.randint(0, K, (2, K, pos + 1), generator=gen, device=dev)
    onehot5 = torch.zeros(2, K, K * T_b, device=dev)
    onehot5.scatter_(2, ancestors * T_b + torch.arange(pos + 1, device=dev), 1.0)

    def self_check():
        r1 = compare("decode_self_attention",
                     decode_attention.decode_self_attention(qd, ck, cv, onehot, H, layer),
                     decode_attention.decode_self_attention_plain(qd, ck, cv, onehot, H, layer))
        print(f"  decode_self_attention above: K = 1, batch {BATCH}; below: K = {K} beams, "
              f"batch 2, a random ancestor mask", flush=True)
        r5 = compare("decode_self_attention",
                     decode_attention.decode_self_attention(q5, c5k, c5v, onehot5, H, layer),
                     decode_attention.decode_self_attention_plain(q5, c5k, c5v, onehot5, H,
                                                                  layer))
        out = merge(r1, r5)
        out["max_abs_err"] = max(r1["max_abs_err"], r5["max_abs_err"])
        return out

    sq = qd.view(BATCH, 1, H, d).transpose(1, 2)
    sk, sv = (t[layer].view(BATCH, T_b, H, d).transpose(1, 2) for t in (ck, cv))
    smask = torch.where(onehot > 0, 0.0, -1e30).to(bf16).view(BATCH, 1, 1, T_b)
    measure("decode_self_attention",
            lambda: decode_attention.decode_self_attention(qd, ck, cv, onehot, H, layer),
            lambda: decode_attention.decode_self_attention_plain(qd, ck, cv, onehot, H, layer),
            self_check,
            (4 * BATCH * T_b * D, FP32_FLOPS, 2 * nbytes(qd) + 2 * nbytes(ck[layer]) + nbytes(onehot)),
            lambda: sdpa(sq, sk, sv, attn_mask=smask))
    del c5k, c5v, sk, sv

    # Decode cross-attention over layer 17 of the (32, 8, 1500, 1280) encoder K/V.
    xk, xv = (randn(L, BATCH, T, D, dtype=bf16) for _ in range(2))
    hk, hv = (t[layer].view(BATCH, T, H, d).transpose(1, 2) for t in (xk, xv))
    measure("decode_cross_attention",
            lambda: decode_attention.decode_cross_attention(qd, xk, xv, H, layer),
            lambda: decode_attention.decode_cross_attention_plain(qd, xk, xv, H, layer),
            lambda: compare("decode_cross_attention",
                            decode_attention.decode_cross_attention(qd, xk, xv, H, layer),
                            decode_attention.decode_cross_attention_plain(qd, xk, xv, H, layer)),
            (4 * BATCH * T * D, FP32_FLOPS, 2 * nbytes(qd) + 2 * nbytes(xk[layer])),
            lambda: sdpa(sq, hk, hv))
    # Phase (v)'s shapes: K = 5 beams of each of the 8 items (40 query rows),
    # the self cache at its last phase (225 slots) with a slot mask from
    # ancestor chains that branch as a beam search's do, and K9's five query
    # rows an item over that item's encoder K/V. Checked and timed; their
    # launches are K8's and K9's rows.
    from coral_tpu_torch.models.whisper import beam_slot_mask

    anc = torch.arange(K, device=dev, dtype=torch.int32)[None, :, None].repeat(BATCH, 1, T_b)
    for step in range(pos):
        parent = torch.randint(0, K, (BATCH, K), generator=gen, device=dev)
        anc = anc.gather(1, parent[:, :, None].expand(BATCH, K, T_b))
        anc[:, :, step + 1] = torch.arange(K, device=dev, dtype=torch.int32)
    onehot_v = beam_slot_mask(anc, pos, T_b)
    q_v = randn(BATCH * K, D, dtype=bf16)
    ck_v, cv_v = (randn(L, BATCH * K, T_b, D, dtype=bf16) for _ in range(2))
    kt = K * T_b
    mask_v = torch.where(onehot_v > 0, 0.0, -1e30).to(bf16).view(BATCH, 1, K, kt)
    measure("decode_self_attention_k5",
            lambda: decode_attention.decode_self_attention(q_v, ck_v, cv_v, onehot_v, H, layer),
            lambda: decode_attention.decode_self_attention_plain(q_v, ck_v, cv_v, onehot_v, H,
                                                                 layer),
            lambda: compare("decode_self_attention_k5",
                            decode_attention.decode_self_attention(q_v, ck_v, cv_v, onehot_v, H,
                                                                   layer),
                            decode_attention.decode_self_attention_plain(q_v, ck_v, cv_v,
                                                                         onehot_v, H, layer),
                            "decode_self_attention"),
            (4 * BATCH * K * kt * D, FP32_FLOPS,
             2 * nbytes(q_v) + 2 * nbytes(ck_v[layer]) + nbytes(onehot_v)),
            lambda: sdpa(q_v.view(BATCH, K, H, d).transpose(1, 2),
                         *(t[layer].view(BATCH, kt, H, d).transpose(1, 2) for t in (ck_v, cv_v)),
                         attn_mask=mask_v))
    del ck_v, cv_v, mask_v
    measure("decode_cross_attention_k5",
            lambda: decode_attention.decode_cross_attention(q_v, xk, xv, H, layer),
            lambda: decode_attention.decode_cross_attention_plain(q_v, xk, xv, H, layer),
            lambda: compare("decode_cross_attention_k5",
                            decode_attention.decode_cross_attention(q_v, xk, xv, H, layer),
                            decode_attention.decode_cross_attention_plain(q_v, xk, xv, H, layer),
                            "decode_cross_attention"),
            (4 * BATCH * K * T * D, FP32_FLOPS, 2 * nbytes(q_v) + 2 * nbytes(xk[layer])),
            lambda: sdpa(q_v.view(BATCH, K, H, d).transpose(1, 2), hk, hv))
    decode_calls = {
        "decode_self_attention": lambda: decode_attention.decode_self_attention(
            qd, ck, cv, onehot, H, layer),
        "decode_cross_attention": lambda: decode_attention.decode_cross_attention(
            qd, xk, xv, H, layer)}
    decode_launch_path(card, decode_calls)
    del ck, cv, xk, xv, hk, hv, decode_calls

    # The encoder FFN's LN + fc1 + GELU at D = 1280: (8, 1500, 1280) -> 5120.
    x = randn(BATCH, T, D, dtype=bf16)
    w1 = randn(F, D, scale=D**-0.5, dtype=bf16)
    b1, g, b = randn(F, scale=0.1), randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1)
    M = BATCH * T
    measure("ffn_ln_1280", lambda: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b),
            lambda: ffn.ffn_ln_fc1_plain(x, w1, b1, g, b),
            lambda: compare("ffn_ln_1280", ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b),
                            ffn.ffn_ln_fc1_plain(x, w1, b1, g, b)),
            (2 * M * D * F, BF16_FLOPS, nbytes(x, w1, b1, g, b) + M * F * 2))
    fc1_yardstick(card, "ffn_ln_1280", x, w1)
    ffn_launch_path(card, randn)
    return results


def decode_steps(ids: np.ndarray, eos: int) -> int:
    """The decode steps greedy generation ran for one batch: it stops once every
    row has emitted EOS, or at max_length - 1."""
    done = [int(np.argmax(row[1:] == eos)) + 1 if (row[1:] == eos).any() else len(row) - 1
            for row in ids]
    return min(ids.shape[1] - 1, max(done))


def whisper_compare(model, feats, ids, steps: int, n_forced: int, eos: int):
    """The kernel path against the plain path
    (``WhisperForConditionalGeneration(plain=True)``) on ``model``'s weights:
    the encoder output on ``feats``, then both decode loops fed the kernel
    path's ``ids`` for ``steps`` steps. Returns (encoder max|diff|/max|plain|,
    the worst step's logits max|diff|/max|plain|, whether the kernel path's
    argmax gives its own ids, the first step where the plain path's greedy
    token parts or None). The plain model lives only inside this call."""
    from coral_tpu_torch.models import whisper as W

    cfg = model.config
    with torch.device("meta"):
        plain = W.WhisperForConditionalGeneration(cfg, plain=True)
    plain = plain.to_empty(device="cuda").eval()
    plain.load_state_dict(model.state_dict())
    phases = W._decode_phases(ids.shape[1])
    with torch.inference_mode():
        enc = {"kernel": W.encode(model, feats), "plain": W.encode(plain, feats)}
        if not bool(torch.isfinite(enc["kernel"]).all()) or enc["kernel"].shape != (
                BATCH, 1500, cfg.d_model):
            fail("whisper encoder output not finite or of the wrong shape")
        enc_diff = float((enc["kernel"].float() - enc["plain"].float()).abs().max()
                         / enc["plain"].float().abs().max())
        paths = {name: [m, W.precompute_cross_kv(m, enc[name]), W.decoder_linears(m),
                        W.init_self_cache(cfg, BATCH, phases[0], "cuda")]
                 for name, m in (("kernel", model), ("plain", plain))}
        del enc
        worst, parted, agree_k = 0.0, None, True
        for pos in range(steps):
            t_b = next(t for t in phases if pos < t)
            out = {}
            for name, (m, kv, lin, cache) in paths.items():
                out[name], paths[name][3] = W.decode_step(m, ids[:, pos], pos,
                                                          W._pad_cache(cache, t_b), kv,
                                                          linears=lin)
            if not bool(torch.isfinite(out["kernel"]).all()):
                fail(f"whisper logits not finite at step {pos}")
            worst = max(worst, float((out["kernel"] - out["plain"]).abs().max()
                                     / out["plain"].abs().max()))
            active = ~(ids[:, 1 : pos + 1] == eos).any(dim=1)
            if pos + 1 >= n_forced and bool(active.any()):
                nxt = ids[active, pos + 1]
                agree_k = agree_k and bool((out["kernel"][active].argmax(-1) == nxt).all())
                if parted is None and not bool((out["plain"][active].argmax(-1) == nxt).all()):
                    parted = pos
    return enc_diff, worst, agree_k, parted


def whisper_device_times(model, feats, tokens) -> tuple[float, int, float]:
    """(encoder ms per batch, CUDA events, median of 3; the steps timed; ms per
    decode step, host clock over them, with a cache of 64 slots)."""
    from coral_tpu_torch.models import whisper as W

    with torch.inference_mode():
        encoder_ms = median_ms(lambda: W.encode(model, feats), 3)
        kv = W.precompute_cross_kv(model, W.encode(model, feats))
        lin = W.decoder_linears(model)
        cache = W.init_self_cache(model.config, feats.shape[0], 64, "cuda")
        n = 63

        def run_steps():
            for pos in range(n):
                W.decode_step(model, tokens, pos, cache, kv, linears=lin)

        return encoder_ms, n, timed(run_steps, 2) * 1e3 / n


def whisper_run(card: str) -> dict:
    """Phase (d), Whisper serving through ASRPipeline; returns the launch counts."""
    from coral_tpu_torch import ASRPipeline
    from coral_tpu_torch.audio.augment import peak_normalize
    from coral_tpu_torch.audio.mel import log_mel_spectrogram
    from coral_tpu_torch.models import whisper as W
    from coral_tpu_torch.ops import _build

    t0 = time.perf_counter()
    asr = ASRPipeline(WHISPER_ID, batch_size=BATCH, device="cuda")
    predictor = asr.predictor
    model, eos = predictor.model, predictor.tokenizer.eos_token_id
    cfg = model.config
    print(f"whisper (d): d_model {cfg.d_model}, {cfg.encoder_layers} + {cfg.decoder_layers} "
          f"layers, {cfg.encoder_attention_heads} heads, FFN {cfg.ffn_dim}, {cfg.num_mel_bins} "
          f"mels, vocab {cfg.vocab_size} (byte-fallback tokenizer), {cfg.dtype}, window "
          f"{asr.window_seconds} s, built in {time.perf_counter() - t0:.2f} s", flush=True)
    if (cfg.d_model, cfg.encoder_layers, cfg.decoder_layers, cfg.encoder_attention_heads,
            cfg.ffn_dim, cfg.num_mel_bins, cfg.dtype) != (1280, 32, 32, 20, 5120, 128,
                                                          torch.bfloat16):
        fail("the pipeline did not build whisper-large-v3 in bf16")

    rng = np.random.default_rng(3)
    seconds = np.linspace(3.0, 30.0, 12)
    clips = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]
    generate = predictor.generate
    seen: list = []

    def keep_ids(m, batch):
        ids = generate(m, batch)
        seen.append(ids.cpu().numpy())
        return ids

    # The main path, counted.
    predictor.generate = keep_ids
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    texts = asr.transcribe_batch(clips)
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    predictor.generate = generate
    steps = [decode_steps(ids, eos) for ids in seen]
    n_layers = cfg.encoder_layers
    expected = {"flash_attention": n_layers * len(seen), "ffn_ln_1280": n_layers * len(seen),
                "decode_self_attention": cfg.decoder_layers * sum(steps),
                "decode_cross_attention": cfg.decoder_layers * sum(steps)}
    print(f"whisper (d) main path: {len(seen)} encoder calls, decode steps {steps} (max_length "
          f"{seen[0].shape[1]}), launch counts {counts}", flush=True)
    if counts != expected:
        fail(f"whisper (d): launch counts {counts}, expected {expected}")
    if len(texts) != len(clips) or not all(isinstance(t, str) for t in texts):
        fail("whisper transcribe_batch returned the wrong transcripts")
    print(f"whisper transcripts: {len(texts)} clips, first {texts[0][:40]!r}", flush=True)

    # Kernel path vs plain path on the first batch, whose ids the main path kept.
    T = int(asr.window_seconds * SR)
    audio = np.zeros((BATCH, T), np.float32)
    for j, clip in enumerate(clips[:BATCH]):
        audio[j, : len(clip)] = clip
    feats = log_mel_spectrogram(peak_normalize(torch.from_numpy(audio).cuda()),
                                n_mels=cfg.num_mel_bins, dtype=cfg.dtype)
    ids = torch.from_numpy(seen[0]).cuda().long()
    n_forced = len(predictor.tokenizer.forced_decoder_ids)
    enc_diff, worst, agree_k, parted = whisper_compare(model, feats, ids, steps[0], n_forced,
                                                       eos)
    torch.cuda.empty_cache()
    print(f"whisper kernel vs plain: encoder output max|diff|/max|plain| {enc_diff:.6g} "
          f"(tolerance {WHISPER_ENC_TOL}); teacher-forced logits over {steps[0]} steps, worst "
          f"{worst:.6g} (tolerance {WHISPER_LOGITS_TOL}); the kernel path's own argmax gives "
          f"its ids: {agree_k}; first step where the plain path's greedy token parts: "
          f"{parted if parted is not None else 'none'}", flush=True)
    if enc_diff > WHISPER_ENC_TOL or worst > WHISPER_LOGITS_TOL or not agree_k:
        fail("whisper kernel path and plain path disagree")

    full = {"input_values": np.stack([np.resize(c, T) for c in clips[-BATCH:]]),
            "input_lengths": np.full((BATCH,), T, np.int32)}
    encoder_ms, n, step_ms = whisper_device_times(model, feats, ids[:, 0])
    latency = timed(lambda: predictor(full), 1)
    full_steps = decode_steps(predictor.generate(model, full).cpu().numpy(), eos)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wall = timed(lambda: asr.transcribe_batch(clips), 1)
    peak = torch.cuda.max_memory_allocated()
    print(f"whisper serving ({card}): {seconds.sum() / wall:.3f} audio-s/s over "
          f"{seconds.sum():.1f} s of audio in {len(clips)} clips (one timed call); latency "
          f"{latency * 1e3:.3f} ms per batch of {BATCH} x 30 s ({full_steps} decode steps); "
          f"encoder {encoder_ms:.3f} ms per batch (median of 3); {step_ms:.3f} ms per decode "
          f"step (host clock over {n} steps, cache of 64); peak memory {peak / 2**30:.3f} GiB",
          flush=True)
    profile_window(card, f"one whisper batch of {BATCH} x 30 s", lambda: predictor(full))
    return counts


def serving_clips(T: int) -> tuple[list, np.ndarray, dict]:
    """The serving phase's 12 clips of 3-30 s (seed 0), their lengths in
    seconds and a batch of 8 full 30 s windows of them."""
    rng = np.random.default_rng(0)
    seconds = np.linspace(3.0, 30.0, 12)
    clips = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]
    full = {"input_values": np.stack([np.resize(c, T) for c in clips[-BATCH:]]),
            "input_lengths": np.full((BATCH,), T, np.int32)}
    return clips, seconds, full


def write_safetensors(path: Path, tensors: dict[str, torch.Tensor],
                      metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (F32, F16 or BF16, on any device) to ``path`` in
    the safetensors layout, as a published checkpoint holds them: an 8-byte
    little-endian header length, the JSON header (the largest dtypes first,
    then by name) padded with spaces to a multiple of 8 bytes, the bytes."""
    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    order = sorted(tensors, key=lambda k: (-tensors[k].dtype.itemsize, k))
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.dtype.itemsize
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)


def lm_corpus(path: Path) -> int:
    """LM_SENTENCES sentences of 2-12 words drawn from LM_WORDS seeded words
    over the pipeline's characters (Zipf-weighted); returns the lines."""
    rng = np.random.default_rng(5)
    letters = list(PIPELINE_CHARS[:29])
    words = np.array(["".join(rng.choice(letters, size=int(n)))
                      for n in rng.integers(1, 10, size=LM_WORDS)])
    weights = 1.0 / np.arange(1, LM_WORDS + 1)
    weights /= weights.sum()
    lines = [" ".join(rng.choice(words, size=int(n), p=weights))
             for n in rng.integers(2, 13, size=LM_SENTENCES)]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return len(lines)


def peaked_log_probs(tokenizer, corpus: Path, lengths: np.ndarray, frames: int,
                     blank_id: int) -> tuple[np.ndarray, list[str]]:
    """(len(lengths), frames, V) log-probs that spell corpus sentences in
    each row's first ``lengths`` frames (sentences drawn until 20 in turn
    do not fit): a token's frame, then 1-3 blank frames, blanks to the end;
    PEAK_P on the frame's token and the rest shared by the others (each log
    below the beam search's token floor). Returns them and the texts they
    spell ('' for a row of no frame)."""
    rng = np.random.default_rng(6)
    lines = corpus.read_text(encoding="utf-8").splitlines()
    V = tokenizer.vocab_size
    out = np.full((len(lengths), frames, V), np.log((1.0 - PEAK_P) / (V - 1)), np.float32)
    texts = []
    for b, n in enumerate(int(x) for x in lengths):
        words: list[str] = []
        path: list[int] = []
        misses = 0
        while n > 0 and misses < 20:
            sentence = lines[int(rng.integers(len(lines)))].split()
            ids = tokenizer.encode(" ".join(words + sentence))
            steps = [int(g) for g in rng.integers(2, 5, size=len(ids))]
            if sum(steps) > n:
                misses += 1
                continue
            misses = 0
            words += sentence
            path = [i for i, k in zip(ids, steps) for i in [i] + [blank_id] * (k - 1)]
        path += [blank_id] * (frames - len(path))
        out[b, np.arange(frames), path] = np.log(PEAK_P)
        texts.append(" ".join(words))
    return out, texts


def checkpoint_lm_run(card: str) -> dict:
    """Phase (t): XLS-R-300M served from an HF-layout checkpoint with an
    n-gram LM beside it through ``ASRPipeline(dir)``; returns the launch
    counts of the LM path's transcription of the 12 clips."""
    import tempfile

    from coral_tpu_torch import ASRPipeline
    from coral_tpu_torch.decoding import NGramModel
    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.training.model_setup import BeamCtcPredictor, GreedyCtcPredictor

    pos = "wav2vec2.encoder.pos_conv_embed.conv"
    seeded = ASRPipeline(W2V2_ID, batch_size=BATCH, device="cuda").predictor
    with tempfile.TemporaryDirectory() as tmp:
        directory = Path(tmp) / "wav2vec2-xls-r-300m-lm"
        directory.mkdir()
        # The Wav2Vec2ForCTC layout: the positional conv as weight norm's g
        # (the norm over dims 0 and 1) and v.
        tensors = dict(seeded.model.state_dict())
        weight = tensors.pop(f"{pos}.weight")
        tensors[f"{pos}.parametrizations.weight.original0"] = weight.square().sum(
            dim=(0, 1), keepdim=True).sqrt()
        tensors[f"{pos}.parametrizations.weight.original1"] = weight
        start = time.perf_counter()
        write_safetensors(directory / "model.safetensors", tensors, {"format": "pt"})
        write_s = time.perf_counter() - start
        start = time.perf_counter()
        lines = lm_corpus(Path(tmp) / "corpus.txt")
        NGramModel.train(Path(tmp) / "corpus.txt", directory / "3gram.arpa", order=3)
        lm_s = time.perf_counter() - start
        size = (directory / "model.safetensors").stat().st_size
        print(f"(t) wrote model.safetensors ({size / 2**30:.3f} GiB, F32, {len(tensors)} "
              f"tensors) in {write_s:.2f} s; trained 3gram.arpa on {lines} sentences "
              f"({(directory / '3gram.arpa').stat().st_size / 2**20:.3f} MiB) in {lm_s:.2f} s",
              flush=True)

        torch.cuda.synchronize()
        start = time.perf_counter()
        asr = ASRPipeline(directory, batch_size=BATCH, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        predictor = asr.predictor
        cfg = predictor.model.config
        print(f"(t) ASRPipeline({directory.name}) loaded the checkpoint and the LM in "
              f"{load_s:.2f} s ({card}): hidden {cfg.hidden_size}, {cfg.num_hidden_layers} "
              f"layers, {cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, "
              f"{cfg.dtype}, {type(predictor).__name__}, beam {predictor.decoder.beam_width}, "
              f"alpha {predictor.decoder.alpha}, beta {predictor.decoder.beta}", flush=True)
        if not isinstance(predictor, BeamCtcPredictor) or (
                cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
                cfg.intermediate_size, cfg.dtype) != (1024, 24, 16, 4096, torch.bfloat16):
            fail("(t): the pipeline did not build XLS-R-300M in bf16 with the LM")
        got, want = predictor.model.state_dict(), seeded.model.state_dict()
        if got.keys() != want.keys():
            fail("(t): the loaded model's keys differ from the seeded model's")
        differ = [k for k in want if k != f"{pos}.weight" and not torch.equal(got[k], want[k])]
        fold = float((got[f"{pos}.weight"] - want[f"{pos}.weight"]).abs().max()
                     / want[f"{pos}.weight"].abs().max())
        print(f"(t) {len(want) - 1} tensors bit for bit the written ones: {not differ}; the "
              f"folded positional conv max|diff|/max|written| {fold:.3g} (tolerance "
              f"{FOLD_RTOL})", flush=True)
        if differ or fold > FOLD_RTOL:
            fail(f"(t): loaded parameters differ from the written ones: {differ[:5]}")

        T = int(asr.window_seconds * SR)
        clips, seconds, full = serving_clips(T)
        logits, frames = predictor.logits(full)
        # The seeded model given the folded conv holds the loaded model's
        # every parameter: the same kernels give the same bits.
        with torch.no_grad():
            seeded.model.get_parameter(f"{pos}.weight").copy_(got[f"{pos}.weight"])
        seeded_logits, _ = seeded.logits(full)
        with torch.device("meta"):
            plain_model = Wav2Vec2ForCTC(cfg, plain=True)
        plain_model = plain_model.to_empty(device="cuda").eval()
        plain_model.load_state_dict(predictor.model.state_dict())
        plain_logits, _ = GreedyCtcPredictor(plain_model, predictor.tokenizer).logits(full)
        del plain_model
        torch.cuda.synchronize()

        def rel(a, b):
            return float((a.float() - b.float()).abs().max() / b.float().abs().max())

        same_bits, vs_plain = torch.equal(logits, seeded_logits), rel(logits, plain_logits)
        print(f"(t) logits on {BATCH} x 30 s: loaded bit for bit the seeded model's given "
              f"the folded conv: {same_bits}; kernel against plain max|diff|/max|ref| "
              f"{vs_plain:.6g} (tolerance {LOGITS_TOL}); finite "
              f"{bool(torch.isfinite(logits).all())}", flush=True)
        if (not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 1499, 46)
                or not same_bits or vs_plain > LOGITS_TOL):
            fail("(t): the loaded model's logits disagree")

        # One forward each way: the LM path's launches are the greedy path's.
        forward = {}
        for name, fn in (("beam", lambda: predictor.log_probs(full)),
                         ("greedy", lambda: seeded(full))):
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            forward[name] = dict(_build.launch_counts)
        expected = w2v2_forward_launches(cfg)
        print(f"(t) launches of one forward: LM path {forward['beam']}, greedy serving "
              f"{forward['greedy']}", flush=True)
        if not forward["beam"] == forward["greedy"] == expected:
            fail(f"(t): forward launches {forward}, expected {expected} each")

        greedy_asr = ASRPipeline(directory, batch_size=BATCH, no_lm=True, device="cuda")
        greedy = greedy_asr.predictor
        ids = logits.argmax(-1).cpu().numpy()
        want_texts = [predictor.tokenizer.decode(ids[i, : frames[i]]) for i in range(BATCH)]
        same = type(greedy) is GreedyCtcPredictor and greedy(full) == want_texts
        print(f"(t) no_lm=True: {type(greedy).__name__}, the greedy decode of the LM path's "
              f"logits: {same}", flush=True)
        if not same:
            fail("(t): no_lm=True did not decode greedily")

        # The main path, counted: the 12 clips through transcribe_batch with
        # the LM, each device batch split into its forward (the model, the
        # log-softmax and the copy to the host) and the host's decode.
        splits, seen, frame_lengths = [], [], []
        log_probs, decode = predictor.log_probs, predictor.decode

        def timed_log_probs(batch):
            seen.append(batch)
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = log_probs(batch)
            splits.append([time.perf_counter() - start])
            frame_lengths.append(out[1])
            return out

        def timed_decode(*args):
            start = time.perf_counter()
            out = decode(*args)
            splits[-1].append(time.perf_counter() - start)
            return out

        predictor.log_probs, predictor.decode = timed_log_probs, timed_decode
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        start = time.perf_counter()
        texts = asr.transcribe_batch(clips)
        torch.cuda.synchronize()
        lm_wall = time.perf_counter() - start
        counts = dict(_build.launch_counts)
        predictor.log_probs, predictor.decode = log_probs, decode
        batches = len(splits)
        print(f"(t) LM path main path: {batches} forwards, launch counts {counts}", flush=True)
        if counts != {k: v * batches for k, v in expected.items()}:
            fail(f"(t): launch counts {counts}, expected {expected} a forward")
        # The four shortest clips (3-10.4 s) through the LM path again, the
        # other rows of the first device batch filler rows.
        short = {k: v.copy() for k, v in seen[0].items()}
        short["input_values"][4:] = 0.0
        short["input_lengths"][4:] = 1
        again = predictor(short)
        print(f"(t) the LM path's first 4 transcripts twice: the same strings "
              f"{again[:4] == texts[:4]} (the filler rows empty: {again[4:] == [''] * 4}); "
              f"first {texts[0][:40]!r}", flush=True)
        if again[:4] != texts[:4] or any(again[4:]) or len(texts) != len(clips):
            fail("(t): the LM path decoded other strings the second time")
        greedy_asr.transcribe_batch(clips)
        torch.cuda.synchronize()
        start = time.perf_counter()
        greedy_texts = greedy_asr.transcribe_batch(clips)
        torch.cuda.synchronize()
        greedy_wall = time.perf_counter() - start
        print(f"(t) serving from the checkpoint ({card}): {seconds.sum() / lm_wall:.3f} "
              f"audio-s/s with the LM (beam {predictor.decoder.beam_width}) against "
              f"{seconds.sum() / greedy_wall:.3f} with no_lm, over {seconds.sum():.1f} s of "
              f"audio in 12 clips (one timed call each; {sum(a != b for a, b in zip(texts, greedy_texts))} "
              f"of 12 transcripts differ); per device batch, forward ms (host clock: the "
              f"model, the log-softmax, the copy of the log-probs) / host decode ms: "
              + ", ".join(f"{f * 1e3:.3f} / {d * 1e3:.3f}" for f, d in splits)
              + " (seeded logits, nearly flat: the decode an upper bound)", flush=True)
        # The decode's lower bound: each device batch's rows again as peaked
        # log-probs of the same shape and frame lengths (one token a frame
        # passes the token floor), against the seeded model's nearly flat ones.
        peaked_ms = []
        for lengths in frame_lengths:
            peaked, peaked_texts = peaked_log_probs(
                predictor.tokenizer, Path(tmp) / "corpus.txt", lengths, logits.shape[1],
                predictor.tokenizer.pad_token_id)
            start = time.perf_counter()
            peaked_got = predictor.decode(peaked, lengths)
            peaked_ms.append((time.perf_counter() - start) * 1e3)
            if peaked_got != peaked_texts:
                fail("(t): the beam search did not decode the peaked rows to their text")
        print(f"(t) host decode a device batch ({card}; one timed call each, beam "
              f"{predictor.decoder.beam_width}), forward ms / decode ms on the seeded "
              f"model's log-probs / on peaked log-probs of the same shape and frame lengths "
              f"(p {PEAK_P} on one token a frame, the rows decoded to their text): "
              + ", ".join(f"{f * 1e3:.3f} / {d * 1e3:.3f} / {p:.3f}"
                          for (f, d), p in zip(splits, peaked_ms))
              + "; decode / forward between "
              + ", ".join(f"{p / (f * 1e3):.3f} and {d / f:.3f}"
                          for (f, d), p in zip(splits, peaked_ms)), flush=True)
        del greedy_asr, greedy, asr, predictor, seeded
    torch.cuda.empty_cache()
    return counts


def whisper_checkpoint_run(card: str) -> dict:
    """Phase (u): Whisper large-v3 served from an HF-layout F16 checkpoint
    with a vocab.json of the published size beside it; returns the launch
    counts of one batch's greedy generation."""
    import dataclasses
    import tempfile

    from coral_tpu_torch import ASRPipeline
    from coral_tpu_torch.audio.augment import peak_normalize
    from coral_tpu_torch.audio.mel import log_mel_spectrogram
    from coral_tpu_torch.models import whisper as W
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.text.bpe import bytes_to_unicode
    from coral_tpu_torch.training.model_setup import WhisperPredictor, load_model_setup
    from coral_tpu_torch.training.train_state import make_whisper_generate_step

    # The seeded model: (d)'s setup's config at the published vocabulary.
    config = load_model_setup({"model": {"type": "whisper", "pretrained_model_id": WHISPER_ID}},
                              device="cuda").model_config
    seeded = W.build_model(dataclasses.replace(config, vocab_size=V3_VOCAB), "cuda", seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        directory = Path(tmp) / "whisper-large-v3"
        directory.mkdir()
        units = sorted(set(bytes_to_unicode().values()))
        vocab = {**{u: i for i, u in enumerate(units)},
                 **{f"tok{i}": i for i in range(len(units), V3_BPE_TOKENS)},
                 "<|endoftext|>": V3_BPE_TOKENS}
        (directory / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
        (directory / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
        tensors = {k: v.half() for k, v in seeded.state_dict().items()}
        start = time.perf_counter()
        write_safetensors(directory / "model.safetensors", tensors, {"format": "pt"})
        write_s = time.perf_counter() - start
        size = (directory / "model.safetensors").stat().st_size
        print(f"(u) wrote model.safetensors ({size / 2**30:.3f} GiB, F16, {len(tensors)} "
              f"tensors, proj_out tied) and a vocab.json of {len(vocab)} tokens in "
              f"{write_s:.2f} s", flush=True)

        torch.cuda.synchronize()
        start = time.perf_counter()
        asr = ASRPipeline(directory, batch_size=BATCH, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        predictor = asr.predictor
        model, tokenizer = predictor.model, predictor.tokenizer
        cfg = model.config
        print(f"(u) ASRPipeline({directory.name}) loaded the checkpoint in {load_s:.2f} s "
              f"({card}): d_model {cfg.d_model}, {cfg.encoder_layers} + {cfg.decoder_layers} "
              f"layers, {cfg.num_mel_bins} mels, vocab {cfg.vocab_size} (tokenizer "
              f"{tokenizer.vocab_size}), {cfg.dtype}", flush=True)
        if (not isinstance(predictor, WhisperPredictor)
                or tokenizer.vocab_size != V3_VOCAB or cfg.vocab_size != V3_VOCAB
                or (cfg.d_model, cfg.encoder_layers, cfg.decoder_layers, cfg.dtype)
                != (1280, 32, 32, torch.bfloat16)):
            fail("(u): the pipeline did not build large-v3 at the published vocabulary")
        got, want = model.state_dict(), seeded.state_dict()
        differ = [k for k in want if not torch.equal(got[k], tensors[k].float())]
        print(f"(u) {len(want)} tensors bit for bit the file's after the cast to fp32: "
              f"{not differ}", flush=True)
        if got.keys() != want.keys() or differ:
            fail(f"(u): loaded parameters differ from the file's: {differ[:5]}")
        del seeded, tensors, got, want
        torch.cuda.empty_cache()

        T = int(asr.window_seconds * SR)
        clips, _, full = serving_clips(T)
        generate = make_whisper_generate_step(
            cfg, forced_ids=tokenizer.forced_decoder_ids, max_length=V3_MAX_LENGTH,
            eos_id=tokenizer.eos_token_id)
        capped = WhisperPredictor(model, tokenizer, generate)
        seen = []

        def keep_ids(m, batch):
            ids = generate(m, batch)
            seen.append(ids.cpu().numpy())
            return ids

        # The main path, counted: one batch through the capped generation.
        capped.generate = keep_ids
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        texts = capped(full)
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        capped.generate = generate
        eos = tokenizer.eos_token_id
        steps = decode_steps(seen[0], eos)
        expected = {"flash_attention": cfg.encoder_layers, "ffn_ln_1280": cfg.encoder_layers,
                    "decode_self_attention": cfg.decoder_layers * steps,
                    "decode_cross_attention": cfg.decoder_layers * steps}
        print(f"(u) main path: 1 encoder call, {steps} decode steps (max_length "
              f"{V3_MAX_LENGTH}), launch counts {counts}", flush=True)
        if counts != expected:
            fail(f"(u): launch counts {counts}, expected {expected}")
        if len(texts) != BATCH or not all(isinstance(t, str) for t in texts):
            fail("(u): the capped generation returned the wrong transcripts")

        audio = torch.from_numpy(full["input_values"]).cuda()
        feats = log_mel_spectrogram(peak_normalize(audio), n_mels=cfg.num_mel_bins,
                                    dtype=cfg.dtype)
        ids = torch.from_numpy(seen[0]).cuda().long()
        enc_diff, worst, agree_k, parted = whisper_compare(
            model, feats, ids, steps, len(tokenizer.forced_decoder_ids), eos)
        print(f"(u) kernel vs plain on the loaded weights: encoder output max|diff|/max|plain| "
              f"{enc_diff:.6g} (tolerance {WHISPER_ENC_TOL}); teacher-forced logits over "
              f"{steps} steps, worst {worst:.6g} (tolerance {WHISPER_LOGITS_TOL}); the kernel "
              f"path's argmax gives its ids: {agree_k}; first step where the plain path's "
              f"greedy token parts: {parted if parted is not None else 'none'}", flush=True)
        if enc_diff > WHISPER_ENC_TOL or worst > WHISPER_LOGITS_TOL or not agree_k:
            fail("(u): the kernel path and the plain path disagree on the loaded weights")
        latency = timed(lambda: capped(full), 1)
        print(f"(u) serving from the checkpoint ({card}): {latency * 1e3:.3f} ms for a batch "
              f"of {BATCH} x 30 s to {V3_MAX_LENGTH} tokens; first transcript "
              f"{texts[0][:40]!r}", flush=True)
        del asr, predictor, model, capped
    torch.cuda.empty_cache()
    return counts


class DecodeSpy:
    """Wraps ``models.whisper.decode_step`` (which ``greedy_generate`` and
    ``beam_generate`` call) for the runs inside ``with``: counts the decode
    steps, sums the host seconds spent inside ``decode_step``, notes when the
    first step began and, for the first ``keep`` steps, keeps each step's
    position, tokens, slot mask and logits for a replay (three device copies
    a step, made outside the timed ``decode_step``)."""

    def __init__(self, keep: int = 0) -> None:
        self.keep, self.steps, self.host, self.first, self.kept = keep, 0, 0.0, None, []

    def __enter__(self):
        from coral_tpu_torch.models import whisper as W

        self._orig = W.decode_step

        def step(model, tokens, pos, cache, cross_kv, onehot=None, linears=None):
            start = time.perf_counter()
            if self.first is None:
                self.first = start
            out = self._orig(model, tokens, pos, cache, cross_kv, onehot, linears)
            self.host += time.perf_counter() - start
            self.steps += 1
            if len(self.kept) < self.keep:
                self.kept.append((pos, tokens.clone(), onehot.clone(), out[0].clone()))
            return out

        W.decode_step = step
        return self

    def __exit__(self, *exc) -> None:
        from coral_tpu_torch.models import whisper as W

        W.decode_step = self._orig


def generation_times(predictor, batch, keep: int = 0) -> tuple[dict, torch.Tensor, DecodeSpy]:
    """One synchronised generate call of ``predictor`` on ``batch``: ms per
    batch, the decode steps, ms per step (host clock from the first step's
    start to the end), the host ms a step inside ``decode_step``, and the
    rest of a step (the loop's bookkeeping and its stop test's read); the ids
    and the spy (``keep`` steps kept)."""
    with DecodeSpy(keep) as spy:
        torch.cuda.synchronize()
        start = time.perf_counter()
        ids = predictor.generate(predictor.model, batch)
        torch.cuda.synchronize()
        end = time.perf_counter()
    step = (end - spy.first) / spy.steps * 1e3
    inside = spy.host / spy.steps * 1e3
    return ({"batch_ms": (end - start) * 1e3, "steps": spy.steps, "step_ms": step,
             "decode_step_ms": inside, "rest_ms": step - inside}, ids, spy)


def beam_replay(model, feats, kept: list) -> float:
    """The kernel path's logits of its first beam steps against the plain
    path's (``WhisperForConditionalGeneration(plain=True)`` on ``model``'s
    weights), fed the kernel path's tokens and slot masks (``kept``: position,
    tokens, slot mask and logits) over a cache of B x K rows grown by the same
    phases; returns the worst step's max|diff| / max|plain|."""
    from coral_tpu_torch.models import whisper as W

    cfg, dev = model.config, feats.device
    with torch.device("meta"):
        plain = W.WhisperForConditionalGeneration(cfg, plain=True)
    plain = plain.to_empty(device=dev).eval()
    plain.load_state_dict(model.state_dict())
    rows = kept[0][1].shape[0]
    worst = 0.0
    with torch.inference_mode():
        kv = W.precompute_cross_kv(plain, W.encode(plain, feats))
        lin, cache = W.decoder_linears(plain), W.init_self_cache(cfg, rows, 64, dev)
        for pos, tokens, onehot, got in kept:
            t_b = onehot.shape[2] // (rows // feats.shape[0])
            want, cache = W.decode_step(plain, tokens, pos, W._pad_cache(cache, t_b), kv, onehot,
                                        lin)
            if not bool(torch.isfinite(got).all()):
                fail(f"whisper beam logits not finite at step {pos}")
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    del plain, kv, cache
    torch.cuda.empty_cache()
    return worst


def timestamp_grammar(ids: np.ndarray, n_forced: int, tokenizer) -> list[str]:
    """The rows of ``ids`` that break the timestamp grammar (the checks of
    ``tests/test_whisper_generation.py::test_timestamp_grammar``): the first
    generated token a timestamp of at most ``timestamp_begin + 50``,
    ``<|notimestamps|>`` never, no three timestamps in a row, timestamps never
    decreasing."""
    tb, eos = tokenizer.timestamp_begin, tokenizer.eos_token_id
    bad = []
    for r, row in enumerate(ids):
        gen = [int(t) for t in row[n_forced:]]
        gen = gen[: gen.index(eos)] if eos in gen else gen
        ts = [t for t in gen if t >= tb]
        run, runs = 0, []
        for t in gen:
            run = run + 1 if t >= tb else 0
            runs.append(run)
        if not gen or not tb <= gen[0] <= tb + 50 or tokenizer.notimestamps_token_id in gen \
                or max(runs) > 2 or ts != sorted(ts):
            bad.append(f"row {r}: {gen[:12]}")
    return bad


def whisper_beam_run(card: str) -> dict:
    """Phase (v): Whisper beam search, the timestamp grammar, long-form
    merging and the validation loop through ``WhisperSetup`` on the card;
    returns the launch counts of the counted beam batches (large-v3 and
    whisper-small)."""
    from coral_tpu_torch.evaluation.eval_loop import run_validation
    from coral_tpu_torch.evaluation.longform import (chunk_waveform, transcribe_longform,
                                                     transcribe_longform_timestamps)
    from coral_tpu_torch.audio.augment import peak_normalize
    from coral_tpu_torch.audio.mel import log_mel_spectrogram
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.training.model_setup import load_model_setup

    def setup_of(name, checkpoint, **keys):
        return load_model_setup({**WHISPER_TRAIN_CONFIG, "model": {
            **WHISPER_TRAIN_CONFIG["model"], "name": name, "pretrained_model_id": checkpoint,
            **keys}}, device="cuda")

    rng = np.random.default_rng(8)
    T = 30 * SR
    batch = {"input_values": (rng.standard_normal((BATCH, T)) * 0.1).astype(np.float32),
             "input_lengths": np.full((BATCH,), T, np.int32)}
    counts: collections.Counter = collections.Counter()
    figures = {}
    for label, name, checkpoint in (("large-v3", "whisper-large", WHISPER_ID),
                                    ("whisper-small", "whisper-small", "openai/whisper-small")):
        t0 = time.perf_counter()
        setup = setup_of(name, checkpoint, generation_num_beams=BEAMS)
        cfg = setup.model_config
        model = setup.init_params(seed=0)
        beam = setup.make_predictor(model)
        greedy = setup_of(name, checkpoint).make_predictor(model)
        Le, Ld = cfg.encoder_layers, cfg.decoder_layers
        print(f"(v) {label}: d_model {cfg.d_model}, {Le} + {Ld} layers, vocab "
              f"{cfg.vocab_size}, {BEAMS} beams, max_length {setup.generation_max_length}, "
              f"built in {time.perf_counter() - t0:.2f} s", flush=True)

        # The main path, counted and timed: one beam batch, its first steps
        # kept for the replay.
        _build.reset_launch_counts()
        beam_times, ids, spy = generation_times(beam, batch,
                                                REPLAY_STEPS if label == "large-v3" else 0)
        run = dict(_build.launch_counts)
        expected = {"flash_attention": Le, block_kernels(cfg, cfg.d_model)[0]: Le,
                    "decode_self_attention": Ld * spy.steps,
                    "decode_cross_attention": Ld * spy.steps}
        texts = beam.tokenizer.batch_decode(ids.cpu().numpy())
        print(f"(v) {label} beam {BEAMS} main path: 1 batch of {BATCH} x 30 s, {spy.steps} "
              f"beam steps ({BATCH * BEAMS} decode rows), launch counts {run}", flush=True)
        if run != expected:
            fail(f"(v) {label}: launch counts {run}, expected {expected}")
        if ids.shape != (BATCH, setup.generation_max_length) or len(texts) != BATCH:
            fail(f"(v) {label}: beam ids of shape {tuple(ids.shape)}")
        counts.update(run)
        if spy.kept:
            feats = log_mel_spectrogram(peak_normalize(torch.from_numpy(batch["input_values"])
                                                       .cuda()),
                                        n_mels=cfg.num_mel_bins, dtype=cfg.dtype)
            start = time.perf_counter()
            worst = beam_replay(model, feats, spy.kept)
            phases = sorted({k[2].shape[2] // BEAMS for k in spy.kept})
            print(f"(v) {label} kernel vs plain: the main path's logits of its first "
                  f"{len(spy.kept)} of {spy.steps} beam steps (slot masks at cache phases "
                  f"{phases}) against the plain path fed its tokens and masks, worst "
                  f"max|diff|/max|plain| {worst:.6g} (tolerance {WHISPER_LOGITS_TOL}; the "
                  f"plain replay {time.perf_counter() - start:.1f} s) ({card})", flush=True)
            if worst > WHISPER_LOGITS_TOL:
                fail(f"(v) {label}: kernel path and plain path disagree")
            del feats
        del spy

        # Beam against greedy on the same batch.
        # Beam against greedy on the same batch, alternated (beam, greedy,
        # greedy, beam: the counted run is the first), medians of two: the
        # host's speed drifts within a run.
        runs = {"beam": [beam_times], "greedy": []}
        for what in ("greedy", "greedy", "beam"):
            runs[what].append(generation_times(beam if what == "beam" else greedy, batch)[0])
        b, g = ({key: float(np.median([r[key] for r in runs[what]])) for key in beam_times}
                for what in ("beam", "greedy"))
        busy = profile_window(card, f"(v) one {label} beam-{BEAMS} batch of {BATCH} x 30 s",
                              lambda: beam.generate(model, batch))
        figures[label] = (b, g, busy)
        print(f"(v) {label} ms per step of each run, in turn: beam "
              f"{[round(r['step_ms'], 3) for r in runs['beam']]}, greedy "
              f"{[round(r['step_ms'], 3) for r in runs['greedy']]}", flush=True)
        print(f"(v) {label} beam {BEAMS} against greedy ({card}; medians of two): "
              f"{b['batch_ms']:.3f} against "
              f"{g['batch_ms']:.3f} ms per batch ({b['batch_ms'] / g['batch_ms']:.4f}x), "
              f"{b['steps']:.0f} against {g['steps']:.0f} decode steps, {b['step_ms']:.3f} against "
              f"{g['step_ms']:.3f} ms per step ({b['step_ms'] / g['step_ms']:.4f}x; host clock, "
              f"synchronised); host ms a step inside decode_step {b['decode_step_ms']:.3f} / "
              f"{g['decode_step_ms']:.3f}, the rest of a step (bookkeeping and the stop "
              f"test's read) {b['rest_ms']:.3f} / {g['rest_ms']:.3f}; busy share of a beam "
              f"batch {busy:.4f}", flush=True)
        if label != "large-v3":
            del model, beam, greedy
            torch.cuda.empty_cache()
            continue

        # Timestamps: greedy and beam 5, every row held to the grammar.
        ts_beam = setup_of(name, checkpoint, generation_num_beams=BEAMS,
                           return_timestamps=True).make_predictor(model)
        ts_greedy = setup_of(name, checkpoint, return_timestamps=True).make_predictor(model)
        tok = beam.tokenizer
        n_forced = len(tok.forced_decoder_ids_timestamps)
        for what, predictor in (("greedy", ts_greedy), (f"beam {BEAMS}", ts_beam)):
            ts_ids = predictor.generate(model, batch).cpu().numpy()
            bad = timestamp_grammar(ts_ids, n_forced, tok)
            n_ts = int((ts_ids[:, n_forced:] >= tok.timestamp_begin).sum())
            print(f"(v) {label} return_timestamps {what}: {len(ts_ids)} rows, {n_ts} timestamp "
                  f"tokens, the grammar holds on {len(ts_ids) - len(bad)} of {len(ts_ids)} rows",
                  flush=True)
            if bad:
                fail(f"(v) timestamps {what}: the grammar fails on {bad[:3]}")

        # Long-form: one clip in overlapping 30 s windows, one generate call.
        clip = (np.random.default_rng(9).standard_normal(int(LONGFORM_SECONDS * SR)) * 0.1
                ).astype(np.float32)
        start = time.perf_counter()
        text = transcribe_longform(clip, lambda b: beam.generate(model, b), tok)
        text_s = time.perf_counter() - start
        start = time.perf_counter()
        segments = transcribe_longform_timestamps(clip, lambda b: ts_beam.generate(model, b),
                                                  tok)
        seg_s = time.perf_counter() - start
        mids = [(a + z) / 2 for a, z, _ in segments]
        offsets = [s0 / SR for s0, _ in chunk_waveform(clip, T, 5 * SR)]
        inside = all(0.0 <= a and z <= offsets[-1] + 30.0 for a, z, _ in segments)
        beyond = sum(z > LONGFORM_SECONDS for _, z, _ in segments)
        print(f"(v) long-form {LONGFORM_SECONDS} s, {len(offsets)} windows of 30 s with a 5 s "
              f"stride (at {offsets} s), one generate call each, beam "
              f"{BEAMS}: {len(text)} characters in {text_s:.3f} s; timestamped: "
              f"{len(segments)} segments in {seg_s:.3f} s, from "
              f"{segments[0][0] if segments else 0:.2f} to "
              f"{segments[-1][1] if segments else 0:.2f} s, midpoints in order "
              f"{mids == sorted(mids)}, {beyond} ending past the clip's end (seeded weights "
              f"place timestamps past the audio)", flush=True)
        if not isinstance(text, str) or mids != sorted(mids) or not inside:
            fail("(v) long-form segments out of order or outside their windows")

        # run_validation with the beam predictor over (d)'s 12 clips.
        clips_rng = np.random.default_rng(3)
        words = np.random.default_rng(10)
        samples = [{"audio_array": (clips_rng.standard_normal(int(s * SR)) * 0.1)
                    .astype(np.float32),
                    "text": " ".join(words.choice(REFERENCE_WORDS, size=int(s)))}
                   for s in np.linspace(3.0, 30.0, 12)]
        start = time.perf_counter()
        rates = run_validation(beam, lambda: iter(samples), len(samples), 30.0, SR)
        print(f"(v) run_validation, beam {BEAMS}, 12 clips of 3-30 s in one batch against "
              f"seeded references: cer {rates['cer']:.6f}, wer {rates['wer']:.6f} in "
              f"{time.perf_counter() - start:.3f} s", flush=True)
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in rates.values()):
            fail(f"(v) run_validation rates {rates}")
        del model, beam, greedy, ts_beam, ts_greedy
        torch.cuda.empty_cache()
    for label, (b, g, busy) in figures.items():
        print(f"(v) summary {label} ({card}): beam {BEAMS} / greedy per batch "
              f"{b['batch_ms'] / g['batch_ms']:.4f}x, per step {b['step_ms'] / g['step_ms']:.4f}x;"
              f" beam {b['step_ms']:.3f} ms a step, {b['rest_ms']:.3f} of it outside "
              f"decode_step; busy share {busy:.4f}", flush=True)
    return dict(counts)


def sdpa_flash_yardsticks(qh, kh, vh, do_h, scale):
    """PyTorch's own flash attention forward with its log-sum-exp
    (``aten._scaled_dot_product_flash_attention``) and its backward fed that
    forward's outputs, as two timed calls on (B, H, T, d); either is None,
    with the reason printed, where the installed torch lacks it."""
    aten = torch.ops.aten
    try:
        out = aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, False, False,
                                                       scale=scale)
    except (AttributeError, RuntimeError, TypeError) as err:
        print(f"  library flash attention: none ({type(err).__name__}: {err})", flush=True)
        return None, None

    def fwd():
        return aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, False, False,
                                                        scale=scale)

    o, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = out
    try:
        aten._scaled_dot_product_flash_attention_backward(
            do_h, qh, kh, vh, o, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed, offset,
            scale=scale)
    except (AttributeError, RuntimeError, TypeError) as err:
        print(f"  library flash backward: none ({type(err).__name__}: {err})", flush=True)
        return fwd, None

    def bwd():
        return aten._scaled_dot_product_flash_attention_backward(
            do_h, qh, kh, vh, o, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed, offset,
            scale=scale)

    return fwd, bwd


def attention_bias(bias, shape) -> torch.Tensor:
    """The additive ``bias`` (broadcastable to ``shape`` = (B, H, Tq, Tk): a
    key or segment mask) as the bf16 ``attn_bias`` the memory-efficient
    kernels take, its rows on storage padded to 16 elements, as SDPA pads a
    mask for them."""
    B, H, Tq, Tk = shape
    full = torch.empty((B, H, Tq, -(-Tk // 16) * 16), dtype=torch.bfloat16, device=bias.device)
    full[..., :Tk] = bias
    return full[..., :Tk]


def sdpa_bwd_yardstick(qh, kh, vh, do_h, bias, scale):
    """PyTorch's memory-efficient attention backward
    (``aten._scaled_dot_product_efficient_attention_backward``: dq, dk and dv
    in one call) on (B, H, T, d) heads with the additive ``bias``
    (``attention_bias``), fed its own forward's o and lse: one timed call, or
    None, with the reason printed, where the installed torch lacks it. The
    backward rows' yardstick; the port never calls it."""
    aten = torch.ops.aten
    try:
        o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, bias, True, scale=scale)

        def bwd():
            return aten._scaled_dot_product_efficient_attention_backward(
                do_h, qh, kh, vh, bias, o, lse, seed, offset, 0.0, [True, True, True, False],
                scale=scale)

        bwd()
    except (AttributeError, RuntimeError, TypeError) as err:
        print(f"  library attention backward: none ({type(err).__name__}: {err})", flush=True)
        return None
    return bwd


def heads_of(t, H: int):
    """(B, T, H*d) rows -> (B, H, T, d) heads, a view."""
    B, T, HD = t.shape
    return t.view(B, T, H, HD // H).transpose(1, 2)


def layer_norm_bwd_yardstick(x, g, b, dy):
    """``aten.native_layer_norm_backward`` (dx, dgamma, dbeta in one call) on
    x's rows, with gamma, beta and dy in x's dtype (the kernel also takes an
    fp32 dy) and the mean and rstd of ``aten.native_layer_norm``: one timed
    call, the LayerNorm backward rows' yardstick."""
    C = x.shape[-1]
    gx, bx, dyx = g.to(x.dtype), b.to(x.dtype), dy.to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [C], gx, bx, 1e-5)
    return lambda: torch.ops.aten.native_layer_norm_backward(dyx, x, [C], mean, rstd, gx, bx,
                                                             [True, True, True])


def flash_bwd_rows(measure, key, args, ids, want, dkv_flops: float, dq_flops: float,
                   library) -> None:
    """Checks and times the flash backward's two kernels at one shape: dq
    (which also writes di), dkv (from that di) and the pair as one call
    (``flash_attention_bwd``, under the name ``flash_attention_bwd`` or its
    segment-id and head-dim form, no kernel row), each beside the plain
    backward and the library's. ``args`` = (q, k, v, o, l, m, do); ``want``
    the plain (dq, dk, dv); ``key`` names the rows from the launch names
    (None: the launch names themselves). The pair is also launched twice and
    must give the same bits."""
    from coral_tpu_torch.ops import flash_attention as fa

    q, k, v, o, l, m, do = args
    T = q.shape[1]
    name = key or (lambda n: fa._counter(n, ids, q.shape[-1]))
    want = dict(zip(("dq", "dk", "dv"), want))
    di = fa.flash_attention_bwd_dq(*args, ids)[1]

    def check(which):
        if which == "dkv":
            got = dict(zip(("dk", "dv"), fa.flash_attention_bwd_dkv(q, k, v, l, m, do, di, ids)))
        elif which == "dq":
            got = {"dq": fa.flash_attention_bwd_dq(*args, ids)[0]}
        else:
            first, again = fa.flash_attention_bwd(*args, ids), fa.flash_attention_bwd(*args, ids)
            same = all(bool(torch.equal(a, b)) for a, b in zip(first, again))
            print(f"  {name('flash_attention_bwd')} (T {T}): two launches give the same bits: "
                  f"{same}", flush=True)
            got = dict(zip(("dq", "dk", "dv"), first))
        label = name("flash_attention_bwd" + ("" if which == "bwd" else f"_{which}"))
        res = merge(*(compare_grad(f"{label} {n} (T {T})", g, want[n], GRAD_FRAC["flash_bwd"])
                      for n, g in got.items()))
        if which == "bwd":
            res["ok"] = res["ok"] and same
        return res

    # Inputs read once (q, k, v, o, do, l, m, the ids), the gradients and di
    # written once (di read once more by dkv).
    moved = nbytes(q, k, v, o, do, l, m) + (0 if ids is None else nbytes(ids))
    plain = (lambda: fa._padded_bwd_plain(*args, ids))
    measure(name("flash_attention_bwd_dq"), lambda: fa.flash_attention_bwd_dq(*args, ids), plain,
            functools.partial(check, "dq"),
            (dq_flops, BF16_FLOPS, moved + nbytes(q, di)), library)
    measure(name("flash_attention_bwd_dkv"),
            lambda: fa.flash_attention_bwd_dkv(q, k, v, l, m, do, di, ids), plain,
            functools.partial(check, "dkv"),
            (dkv_flops, BF16_FLOPS, moved - nbytes(o) + nbytes(di) + 2 * nbytes(q)), library)
    measure(name("flash_attention_bwd"), lambda: fa.flash_attention_bwd(*args, ids), plain,
            functools.partial(check, "bwd"),
            (dq_flops + dkv_flops, BF16_FLOPS, moved + 3 * nbytes(q)), library)


def whisper_train_kernel_checks(card: str) -> dict:
    """Whisper training's kernels against their plain versions at its shapes:
    whisper-large-v3 (d 1280, 20 heads x 64, FFN 5120), 8 x 30 s (T = 1500
    encoder rows; the decoder's 8 x 128 label positions)."""
    from coral_tpu_torch.ops import ffn, flash_attention, ln_gelu, philox

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    bf16 = torch.bfloat16
    results = {}
    measure = functools.partial(_measure, results, card)
    T, H, d, D, F, L = 1500, 20, 64, 1280, 5120, 128
    scale = d**-0.5

    # The encoder's flash attention, training forward: o and the row stats.
    q, k, v = (randn(BATCH, T, D, dtype=bf16).view(BATCH, T, H, d) for _ in range(3))
    do = randn(BATCH, T, H, d, dtype=bf16)
    heads = [t.transpose(1, 2) for t in (q, k, v, do)]
    lib_fwd, lib_bwd = sdpa_flash_yardsticks(*heads, scale)

    def train_check():
        o, l, m = flash_attention.flash_attention_fwd(q, k, v)
        want = flash_attention.flash_attention_fwd_plain(q, k, v)
        return merge(compare("flash_attention_train", o, want[0]),
                     compare("flash_attention_train stats", l, want[1]),
                     compare("flash_attention_train stats", m, want[2]))

    measure("flash_attention_train", lambda: flash_attention.flash_attention_fwd(q, k, v),
            lambda: flash_attention.flash_attention_fwd_plain(q, k, v), train_check,
            (4 * BATCH * H * T * T * d, BF16_FLOPS, 4 * nbytes(q) + 2 * BATCH * H * T * 4),
            lib_fwd)

    # Its backward: dq (query-major, launched first; it writes di) and dk, dv
    # (key-major, from di), from the forward's o, l and m; then the pair as
    # one call. The plain and library times are of the whole backward (dq, dk
    # and dv).
    o, l, m = flash_attention.flash_attention_fwd(q, k, v)
    args = (q, k, v, o, l, m, do)
    flash_bwd_rows(measure, None, args, None, flash_attention.flash_attention_bwd_plain(*args),
                   8 * BATCH * H * T * T * d, 6 * BATCH * H * T * T * d, lib_bwd)
    del q, k, v, do, heads, o, l, m, args, lib_fwd, lib_bwd
    torch.cuda.empty_cache()

    # The FFN block at D = 1280 with activation dropout 0.1: the encoder's
    # (8, 1500, 1280) rows, and the decoder's (8, 128, 1280).
    x = randn(BATCH, T, D, offset=0.2, dtype=bf16)
    w1 = randn(F, D, scale=D**-0.5, dtype=bf16)
    w2 = randn(D, F, scale=F**-0.5, dtype=bf16)
    b1, g, b = randn(F, scale=0.1), randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1)
    dy = randn(BATCH, T, D, dtype=bf16)
    seeds = torch.randint(-(2**31), 2**31, (BATCH,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    keep = philox.keep_mask(seeds, T, F, 0.1)
    M = BATCH * T

    def drop_check():
        got = ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=0.1, seeds=seeds)
        res = compare("ffn_ln_drop_1280", got,
                      ffn.ffn_ln_fc1_plain(x, w1, b1, g, b, rate=0.1, seeds=seeds))
        same = bool(torch.equal(got != 0, keep))
        frac = float(keep.float().mean())
        print(f"  ffn_ln_drop_1280: kernel mask == plain Philox mask: {same}; keep fraction "
              f"{frac:.6f} (rate 0.1)", flush=True)
        res["ok"] = res["ok"] and same and abs(frac - 0.9) < 1e-3
        return res

    measure("ffn_ln_drop_1280", lambda: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=0.1, seeds=seeds),
            lambda: ffn.ffn_ln_fc1_plain(x, w1, b1, g, b, rate=0.1, seeds=seeds), drop_check,
            (2 * M * D * F, BF16_FLOPS, nbytes(x, w1, b1, g, b, seeds) + M * F * 2))
    fc1_yardstick(card, "ffn_ln_drop_1280", x, w1)

    xd = randn(BATCH, L, D, offset=0.2, dtype=bf16)
    dyd = randn(BATCH, L, D, dtype=bf16)

    def bwd_ffn_check():
        out = []
        for label, xx, yy in (("encoder", x, dy), ("decoder", xd, dyd)):
            got = ffn.ffn_bwd(xx, w1, b1, g, b, yy, w2, rate=0.1, seeds=seeds)
            want_f = ffn.ffn_bwd_plain(xx, w1, b1, g, b, yy, w2, rate=0.1, seeds=seeds)
            same_g = bool(torch.equal(got[0], ffn.ffn_ln_fc1_fwd(xx, w1, b1, g, b, rate=0.1,
                                                             seeds=seeds)))
            mask = philox.keep_mask(seeds, xx.shape[1], F, 0.1)
            dropped_zero = not bool(got[1][~mask].any())
            print(f"  ffn_bwd_1280 {label} rows {tuple(xx.shape)}: g regenerated bit for bit: "
                  f"{same_g}; dh zero where dropped: {dropped_zero}", flush=True)
            res = [compare_grad(f"ffn_bwd_1280 {label} {n}", gg, ww, GRAD_FRAC["ffn_bwd"])
                   for n, gg, ww in (("dh", got[1], want_f[1]), ("dx", got[3], want_f[3]))]
            res.append(compare("ffn_ln_1280", got[2], want_f[2]))  # ln_out, a rounded LN
            res += [compare_grad(f"ffn_bwd_1280 {label} {n}", gg, ww, GRAD_FRAC["partials"])
                    for n, gg, ww in zip(("db1", "dgamma", "dbeta"), got[4:], want_f[4:])]
            merged = merge(*res)
            merged["ok"] = merged["ok"] and same_g and dropped_zero
            out.append(merged)
        return merge(*out)

    # Three products of 2 M D F (h again, dg, dl); outputs g, dh, ln_out, dx
    # and the vectors. Timed at the encoder's rows.
    measure("ffn_bwd_1280", lambda: ffn.ffn_bwd(x, w1, b1, g, b, dy, w2, rate=0.1, seeds=seeds),
            lambda: ffn.ffn_bwd_plain(x, w1, b1, g, b, dy, w2, rate=0.1, seeds=seeds),
            bwd_ffn_check,
            (3 * 2 * M * D * F, BF16_FLOPS,
             nbytes(x, w1, b1, g, b, dy, w2, seeds) + 2 * M * F * 2 + 2 * nbytes(x)
             + (F + 2 * D) * 4))
    fc1_yardstick(card, "ffn_bwd_1280", x, w1)
    del keep, w1, w2, xd, dyd

    # The LN step of the FFN backward: x bf16, dl fp32, (8, 1500, 1280).
    dl = randn(BATCH, T, D)

    def ln_check():
        got = ln_gelu.ln_bwd(x, g, b, dl, apply_gelu=False)
        want_l = ln_gelu.ln_bwd_plain(x, g, b, dl, apply_gelu=False)
        return merge(compare("ln_bwd_1280", got[0], want_l[0]),
                     *(compare_grad("ln_bwd_1280 partials", gg, ww, GRAD_FRAC["partials"])
                       for gg, ww in zip(got[1:], want_l[1:])))

    measure("ln_bwd_1280", lambda: ln_gelu.ln_bwd(x, g, b, dl, apply_gelu=False),
            lambda: ln_gelu.ln_bwd_plain(x, g, b, dl, apply_gelu=False), ln_check,
            (LN_BWD_OPS * x.numel(), FP32_FLOPS, 2 * nbytes(x) + nbytes(dl) + 4 * nbytes(g)),
            layer_norm_bwd_yardstick(x, g, b, dl))
    return results


def width_kernel_checks(card: str) -> dict:
    """The ported kernels at the other widths of the repository's configs, at
    their paths' shapes: the LN forward at wav2vec2-base's, XLS-R-1B's and
    -2B's serving rows (8 x 1499 x 768, 1280, 1920), and K1 (LayerNorm +
    GELU at 512) at the feature encoder's blocks 1-6 (``fused_fe_conv:
    false``; 8 x 30 s: 47,999 to 1,499 rows) and its backward there (8 x 10
    s: 15,999 to 499 rows), checked and timed under keys of their own (the kernels line's K1 row is block 0's); the attention at head_dim 80 and 120, 16 heads (8
    x 1499 serving, 8 x 499 training, padded rows and a fully masked one); the
    FFN block at XLS-R-2B's width (8 x 1499 serving rows, 8 x 499 training
    rows) and at Whisper tiny's, base's and small's (8 x 1500 encoder rows,
    and the decoder's 8 x 128 in the backward); the LN backward at 1920 (8 x
    499, bf16 and fp32 dy), at 384 and 768 (8 x 1500, the FFN backward's LN
    step with an fp32 dy) and at 1280 (8 x 499, XLS-R-1B's bf16 dy)."""
    from coral_tpu_torch.ops import attention, ln_gelu

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    bf16 = torch.bfloat16
    results = {}
    measure = functools.partial(_measure, results, card)

    # The encoder LN forward of wav2vec2-base, XLS-R-1B and -2B.
    for C in (768, 1280, 1920):
        x = randn(BATCH, 1499, C, dtype=bf16)
        g, b = randn(C, scale=0.1, offset=1.0), randn(C, scale=0.1)
        gb, bb = g.to(bf16), b.to(bf16)
        name = f"ln_fused_{C}"
        measure(name, lambda: ln_gelu.ln_fused(x, g, b),
                lambda: ln_gelu.ln_gelu_plain(x, g, b, apply_gelu=False),
                lambda: compare(name, ln_gelu.ln_fused(x, g, b),
                                ln_gelu.ln_gelu_plain(x, g, b, apply_gelu=False)),
                (LN_OPS * x.numel(), FP32_FLOPS, 2 * nbytes(x) + nbytes(g, b)),
                lambda: torch.nn.functional.layer_norm(x, (C,), gb, bb))
    del x

    # K1 at FE blocks 1-6's outputs, the conv apart (8 x 30 s).
    for i, T in enumerate(FE_ROWS[1:], 1):
        x = randn(BATCH, T, 512, scale=2.0, offset=0.3, dtype=bf16)
        g, b = randn(512, scale=0.1, offset=1.0), randn(512, scale=0.1)
        name = f"ln_gelu FE block {i}"
        measure(name, lambda: ln_gelu.ln_gelu(x, g, b), lambda: ln_gelu.ln_gelu_plain(x, g, b),
                lambda: compare(name, ln_gelu.ln_gelu(x, g, b), ln_gelu.ln_gelu_plain(x, g, b),
                                "ln_gelu"),
                ((LN_OPS + GELU_OPS) * x.numel(), FP32_FLOPS, 2 * nbytes(x) + nbytes(g, b)))
    del x

    # K1's backward (``ln_bwd`` with GELU at 512) at FE blocks 1-6's training
    # rows (8 x 10 s: 15,999 to 499), the route of ``fused_fe_conv: false``:
    # its column partials reduce over a last block the rows fill in part. It
    # recomputes the LN and GELU forward (GELU's derivative, 12 operations).
    for i, T in enumerate(FE_TRAIN_ROWS[1:], 1):
        x = randn(BATCH, T, 512, scale=2.0, offset=0.3, dtype=bf16)
        dy = randn(BATCH, T, 512, dtype=bf16)
        g, b = randn(512, scale=0.1, offset=1.0), randn(512, scale=0.1)
        name = f"ln_bwd FE block {i}"

        def ln_gelu_bwd_check():
            got = ln_gelu.ln_bwd(x, g, b, dy, apply_gelu=True)
            want = ln_gelu.ln_bwd_plain(x, g, b, dy, apply_gelu=True)
            return merge(compare(name, got[0], want[0], "ln_bwd"),
                         *(compare_grad(f"{name} partials", gg, ww, GRAD_FRAC["partials"])
                           for gg, ww in zip(got[1:], want[1:])))

        measure(name, lambda: ln_gelu.ln_bwd(x, g, b, dy, apply_gelu=True),
                lambda: ln_gelu.ln_bwd_plain(x, g, b, dy, apply_gelu=True), ln_gelu_bwd_check,
                ((LN_OPS + 12 + LN_BWD_OPS) * x.numel(), FP32_FLOPS,
                 2 * nbytes(x) + nbytes(dy) + 4 * nbytes(g)))
    del x, dy

    # The LN backward: 1920 (the encoder LN's gradient, bf16 dy, timed; the
    # FFN's LN step, fp32 dy), 384 and 768 (the FFN's LN step, timed; bf16 dy),
    # and 1280's bf16-dy route, XLS-R-1B's encoder LN gradient (another
    # instantiation than Whisper's fp32-dy route, which gives the kernels-line
    # row; this one is checked and timed under a key of its own).
    for C, T, timed_dtype in ((1920, 499, bf16), (384, 1500, torch.float32),
                              (768, 1500, torch.float32), (1280, 499, bf16)):
        x = randn(BATCH, T, C, offset=0.3, dtype=bf16)
        dys = {dt: randn(BATCH, T, C, dtype=dt) for dt in (bf16, torch.float32)}
        g, b = randn(C, scale=0.1, offset=1.0), randn(C, scale=0.1)
        name = f"ln_bwd_{C}"
        key = ROUTE_KEYS.get(name, name)

        def ln_check():
            out = []
            for dy in dys.values():
                got = ln_gelu.ln_bwd(x, g, b, dy, apply_gelu=False)
                want = ln_gelu.ln_bwd_plain(x, g, b, dy, apply_gelu=False)
                out.append(compare(name, got[0], want[0]))
                out += [compare_grad(f"{name} partials ({dy.dtype})", gg, ww, GRAD_FRAC["partials"])
                        for gg, ww in zip(got[1:], want[1:])]
            return merge(*out)

        dy = dys[timed_dtype]
        measure(key, lambda: ln_gelu.ln_bwd(x, g, b, dy, apply_gelu=False),
                lambda: ln_gelu.ln_bwd_plain(x, g, b, dy, apply_gelu=False), ln_check,
                (LN_BWD_OPS * x.numel(), FP32_FLOPS,
                 2 * nbytes(x) + nbytes(dy) + 4 * nbytes(g)),
                layer_norm_bwd_yardstick(x, g, b, dy))
    del x, dys, dy

    # The attention at XLS-R-1B's and -2B's head dims, 16 heads.
    H = 16
    for d in (80, 120):
        T = 1499
        q, k, v = (randn(BATCH, T, H * d, dtype=bf16) for _ in range(3))
        bias = tuple(randn(H * d, scale=0.1) for _ in range(3))
        lengths = torch.tensor([1499, 1200, 900, 600, 300, 1499, 50, -1], device=dev)
        mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
        name = f"attention_fwd_hd{d}"

        def attn_check():
            o, lse = attention.short_t_attention_flat(q, k, v, mask, d, bias)
            want_o, want_lse = attention.attention_plain(q, k, v, mask, d, bias)
            res = compare(name, o, want_o)
            lse_err = float((lse - want_lse).abs().max())
            clamped = bool((lse[-1] == -1e25).all())
            print(f"  {name} lse: max_abs_err {lse_err:.6g} (tolerance {LSE_ATOL}); masked row "
                  f"clamped: {clamped}", flush=True)
            res["ok"] = res["ok"] and lse_err <= LSE_ATOL and clamped
            return res

        heads = [(t + bb.to(bf16)).view(BATCH, T, H, d).transpose(1, 2)
                 for t, bb in zip((q, k, v), bias)]
        key_bias = torch.where(mask, 0.0, -1e30).to(bf16)[:, None, None, :]
        measure(name, lambda: attention.short_t_attention_flat(q, k, v, mask, d, bias),
                lambda: attention.attention_plain(q, k, v, mask, d, bias), attn_check,
                (4 * BATCH * H * T * T * d, BF16_FLOPS, 4 * nbytes(q) + nbytes(mask, *bias)),
                lambda: sdpa(*heads, attn_mask=key_bias))
        del q, k, v, heads

        # Its backward at the training rows.
        T = 499
        q, k, v, do = (randn(BATCH, T, H * d, dtype=bf16) for _ in range(4))
        bq, bk, bv = (randn(H * d, scale=0.1, dtype=bf16) for _ in range(3))
        lengths = torch.tensor([499, 400, 300, 250, 200, 499, 50, -1], device=dev)
        key_bias = torch.where(torch.arange(T, device=dev)[None, :] < lengths[:, None], 0.0,
                               -1e30).float()
        o, lse = attention._fwd(q, k, v, bq, bk, bv, key_bias, d, d**-0.5)
        args = (q, k, v, bq, bk, bv, key_bias, do, lse, o, d, d**-0.5)
        name = f"attention_bwd_hd{d}"

        def attn_bwd_check():
            got, want = attention.attention_bwd(*args), attention.attention_bwd_plain(*args)
            out = [compare_grad(f"{name} {n}", gg, ww, GRAD_FRAC["attention_bwd"])
                   for n, gg, ww in zip(("dq", "dk", "dv"), got[:3], want[:3])]
            out.append(compare_grad(f"{name} db", got[3], want[3], GRAD_FRAC["partials"]))
            masked_zero = all(not t[-1].any() for t in got[:3])
            print(f"  {name}: fully masked row gets no gradient: {masked_zero}", flush=True)
            res = merge(*out)
            res["ok"] = res["ok"] and masked_zero
            return res

        heads = [heads_of(t + bb, H) for t, bb in zip((q, k, v), (bq, bk, bv))]
        measure(name, lambda: attention.attention_bwd(*args),
                lambda: attention.attention_bwd_plain(*args), attn_bwd_check,
                (5 * 2 * BATCH * H * T * T * d, BF16_FLOPS,
                 nbytes(*args[:10]) + 3 * nbytes(q) + 3 * H * d * 4),
                sdpa_bwd_yardstick(*heads, heads_of(do, H),
                                   attention_bias(key_bias[:, None, None, :], (BATCH, H, T, T)),
                                   d**-0.5))
        del q, k, v, do, o, args, heads

    # The FFN block: XLS-R-2B (serving T' = 1499, training 499), Whisper tiny,
    # base and small (the encoder's 1500 rows; the decoder's 128 in the backward).
    for D, T_serve, T_train, T_dec in ((1920, 1499, 499, None), (384, 1500, 1500, 128),
                                       (512, 1500, 1500, 128), (768, 1500, 1500, 128)):
        ffn_width_checks(card, measure, randn, gen, D, 4 * D, T_serve, T_train, T_dec)
        torch.cuda.empty_cache()
    return results


def ffn_width_checks(card: str, measure, randn, gen, D: int, F: int, T_serve: int,
                     T_train: int, T_dec: int | None) -> None:
    """The FFN block's three kernels at width D against their plain versions:
    rate 0 at the serving rows, the dropout forward and the backward at the
    training rows (and the decoder's, when it has one), the masks exact;
    each row with cuBLAS's fc1 product alone beside it."""
    from coral_tpu_torch.ops import ffn, philox

    bf16 = torch.bfloat16
    names = {base: ffn._name(base, D) for base in ("ffn_ln", "ffn_ln_drop", "ffn_bwd")}
    w1 = randn(F, D, scale=D**-0.5, dtype=bf16)
    w2 = randn(D, F, scale=F**-0.5, dtype=bf16)
    b1, g, b = randn(F, scale=0.1), randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1)
    x = randn(BATCH, T_serve, D, dtype=bf16)
    name = names["ffn_ln"]
    M = BATCH * T_serve
    measure(name, lambda: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b),
            lambda: ffn.ffn_ln_fc1_plain(x, w1, b1, g, b),
            lambda: compare(name, ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b),
                            ffn.ffn_ln_fc1_plain(x, w1, b1, g, b)),
            (2 * M * D * F, BF16_FLOPS, nbytes(x, w1, b1, g, b) + M * F * 2))
    fc1_yardstick(card, name, x, w1)

    x = randn(BATCH, T_train, D, offset=0.2, dtype=bf16)
    dy = randn(BATCH, T_train, D, dtype=bf16)
    seeds = torch.randint(-(2**31), 2**31, (BATCH,), generator=gen, device=x.device,
                          dtype=torch.int64).to(torch.int32)
    keep = philox.keep_mask(seeds, T_train, F, 0.1)
    M = BATCH * T_train
    name = names["ffn_ln_drop"]

    def drop_check():
        got = ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=0.1, seeds=seeds)
        res = compare(name, got, ffn.ffn_ln_fc1_plain(x, w1, b1, g, b, rate=0.1, seeds=seeds))
        # Dropped is exactly 0; a kept value is 0 only where the polynomial
        # GELU is (h far below 0, more often at the narrow widths).
        dropped_zero = not bool(got[~keep].any())
        kept_live = float((got[keep] != 0).float().mean())
        frac = float(keep.float().mean())
        print(f"  {name}: zero where the plain Philox mask drops: {dropped_zero}; non-zero "
              f"where it keeps: {kept_live:.6f}; keep fraction {frac:.6f} (rate 0.1)", flush=True)
        res["ok"] = res["ok"] and dropped_zero and kept_live > 0.99 and abs(frac - 0.9) < 1e-3
        return res

    measure(name, lambda: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=0.1, seeds=seeds),
            lambda: ffn.ffn_ln_fc1_plain(x, w1, b1, g, b, rate=0.1, seeds=seeds), drop_check,
            (2 * M * D * F, BF16_FLOPS, nbytes(x, w1, b1, g, b, seeds) + M * F * 2))
    fc1_yardstick(card, name, x, w1)
    del keep
    rows = [("training", x, dy)]
    if T_dec is not None:
        rows.append(("decoder", randn(BATCH, T_dec, D, offset=0.2, dtype=bf16),
                     randn(BATCH, T_dec, D, dtype=bf16)))
    name = names["ffn_bwd"]

    def bwd_check():
        out = []
        for label, xx, yy in rows:
            got = ffn.ffn_bwd(xx, w1, b1, g, b, yy, w2, rate=0.1, seeds=seeds)
            want = ffn.ffn_bwd_plain(xx, w1, b1, g, b, yy, w2, rate=0.1, seeds=seeds)
            same_g = bool(torch.equal(got[0], ffn.ffn_ln_fc1_fwd(xx, w1, b1, g, b, rate=0.1,
                                                             seeds=seeds)))
            mask = philox.keep_mask(seeds, xx.shape[1], F, 0.1)
            dropped_zero = not bool(got[1][~mask].any())
            print(f"  {name} {label} rows {tuple(xx.shape)}: g regenerated bit for bit: "
                  f"{same_g}; dh zero where dropped: {dropped_zero}", flush=True)
            res = [compare_grad(f"{name} {label} {n}", gg, ww, GRAD_FRAC["ffn_bwd"])
                   for n, gg, ww in (("dh", got[1], want[1]), ("dx", got[3], want[3]))]
            res.append(compare(names["ffn_ln"], got[2], want[2]))  # ln_out, a rounded LN
            res += [compare_grad(f"{name} {label} {n}", gg, ww, GRAD_FRAC["partials"])
                    for n, gg, ww in zip(("db1", "dgamma", "dbeta"), got[4:], want[4:])]
            merged = merge(*res)
            merged["ok"] = merged["ok"] and same_g and dropped_zero
            out.append(merged)
        return merge(*out)

    # Three products of 2 M D F (h again, dg, dl); outputs g, dh, ln_out, dx
    # and the vectors. Timed at the training rows.
    measure(name, lambda: ffn.ffn_bwd(x, w1, b1, g, b, dy, w2, rate=0.1, seeds=seeds),
            lambda: ffn.ffn_bwd_plain(x, w1, b1, g, b, dy, w2, rate=0.1, seeds=seeds), bwd_check,
            (3 * 2 * M * D * F, BF16_FLOPS,
             nbytes(x, w1, b1, g, b, dy, w2, seeds) + 2 * M * F * 2 + 2 * nbytes(x)
             + (F + 2 * D) * 4))
    fc1_yardstick(card, name, x, w1)


def whisper_train_batch(seed: int, text_ids: int) -> tuple[dict, float]:
    """A fixed (ACCUM, 8, 480000) batch: clips of 6-10 s of seeded noise,
    padded to the 30 s window, with labels of 64-128 random text ids (below
    ``text_ids``) padded with -100 to ``MAX_LABEL``. Returns the batch and
    the seconds of (unpadded) audio in it."""
    rng = np.random.default_rng(seed)
    T = 30 * SR
    lengths = rng.integers(6 * SR, 10 * SR + 1, size=(ACCUM, BATCH)).astype(np.int32)
    audio = np.zeros((ACCUM, BATCH, T), np.float32)
    labels = np.full((ACCUM, BATCH, MAX_LABEL), -100, np.int32)
    n_labels = rng.integers(64, MAX_LABEL + 1, size=(ACCUM, BATCH))
    for a in range(ACCUM):
        for i in range(BATCH):
            audio[a, i, : lengths[a, i]] = rng.standard_normal(lengths[a, i]) * 0.1
            labels[a, i, : n_labels[a, i]] = rng.integers(0, text_ids, n_labels[a, i])
    batch = {"input_values": audio, "input_lengths": lengths, "labels": labels}
    return batch, float(lengths.sum()) / SR


def whisper_train_compare(card: str, setup, batch: dict, label: str = "(e)") -> dict:
    """Training (e) (or ``label``), kernel vs plain: the loss and the gradients of one
    microbatch on the same weights, batch and generator seed, through
    ``seq2seq_loss_and_grads`` under the setup's policy, dropout on (both
    paths draw the same Philox bits), SpecAugment on, augmentation off."""
    from coral_tpu_torch.models import whisper as W
    from coral_tpu_torch.training.optimizer import global_norm
    from coral_tpu_torch.training.train_state import _load_work_params, seq2seq_loss_and_grads

    model = setup.init_params(seed=0)
    with torch.device("meta"):
        plain = W.WhisperForConditionalGeneration(model.config, plain=True)
    plain = plain.to_empty(device="cuda")
    plain.load_state_dict(model.state_dict())
    masters = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    one = {k: torch.as_tensor(v[:1]).cuda() for k, v in batch.items()}
    tok = setup.tokenizer
    out = {}
    for name, m in (("kernel", model), ("plain", plain)):
        _load_work_params(m, masters, torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(7)
        out[name] = seq2seq_loss_and_grads(m, one, gen, tok.sot_token_id, tok.pad_token_id,
                                           setup.gradient_checkpointing)
        torch.cuda.synchronize()
    del model, plain, masters
    (loss_k, grads_k), (loss_p, grads_p) = out["kernel"], out["plain"]
    norm_k, norm_p = (float(global_norm(list(g.values()))) for g in (grads_k, grads_p))
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    norm_rel = abs(norm_k - norm_p) / norm_p
    ratios = []
    for n, gp in grads_p.items():
        scale = float(gp.abs().max())
        if scale == 0.0:
            if bool(grads_k[n].any()):
                fail(f"{n}: the kernel path has a gradient where the plain path has none")
            continue
        ratios.append((float((grads_k[n] - gp).abs().max()) / scale, n))
    ratios.sort(reverse=True)
    live = sum(bool(torch.isfinite(g).all()) and bool(g.any()) for g in grads_k.values())
    del out, grads_k, grads_p
    torch.cuda.empty_cache()
    print(f"training {label} kernel vs plain, one microbatch of {BATCH} x 30 s, "
          f"{setup.model_config.remat_policy}, dropout and SpecAugment on: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} (rel {loss_rel:.6g}, tolerance "
          f"{TRAIN_LOSS_RTOL}); grad norm {norm_k:.6f} vs {norm_p:.6f} (rel {norm_rel:.6g}, "
          f"tolerance {TRAIN_GRAD_NORM_RTOL}); gradient max|diff|/max|plain| over {len(ratios)} "
          f"parameters (tolerance {TRAIN_GRAD_TOL}), {live} with finite non-zero gradients, "
          f"worst: " + "; ".join(f"{r:.6g} {n}" for r, n in ratios[:5]) + f" ({card})",
          flush=True)
    if not (math.isfinite(float(loss_k)) and loss_rel <= TRAIN_LOSS_RTOL
            and norm_rel <= TRAIN_GRAD_NORM_RTOL and ratios[0][0] <= TRAIN_GRAD_TOL):
        fail("the Whisper training kernel path and plain path disagree")
    return {"loss_rel": loss_rel, "grad_norm_rel": norm_rel, "worst_grad": ratios[0][0]}


def whisper_train_run(card: str, label: str = "(e)", config: dict = WHISPER_TRAIN_CONFIG,
                      per_microbatch: dict = WHISPER_PER_MICROBATCH,
                      steps: int = WHISPER_TRAIN_STEPS, falling: bool = True,
                      route: str = "ffn_ln_block") -> dict:
    """Phase (e) (or ``label``: (k), (m), the FFN on ``route``), Whisper
    training through ``WhisperSetup.make_train_step``; returns the launch
    counts of the first step."""
    import tempfile

    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.training import TrainState, create_optimizer
    from coral_tpu_torch.training.model_setup import load_model_setup

    with tempfile.TemporaryDirectory() as tmp:
        bank = np.random.default_rng(1).standard_normal(
            (NOISE_CLIPS, NOISE_SECONDS * SR)).astype(np.float32) * 0.1
        np.save(Path(tmp) / "noise.npy", bank)
        config = {**config, "background_noise_path": str(Path(tmp) / "noise.npy")}
        setup = load_model_setup(config, device="cuda")
        tx, schedule = create_optimizer(
            learning_rate=setup.learning_rate, warmup_steps=WHISPER_WARMUP_STEPS,
            max_steps=1000, adam_beta1=config["adam_first_momentum"],
            adam_beta2=config["adam_second_momentum"], max_grad_norm=config["max_grad_norm"],
            mu_dtype=config["adam_mu_dtype"])
        step = setup.make_train_step(tx, schedule)  # loads the noise bank
    cfg = setup.model_config
    print(f"training {label}: whisper d_model {cfg.d_model}, {cfg.encoder_layers} + "
          f"{cfg.decoder_layers} layers, {cfg.encoder_attention_heads} heads, FFN {cfg.ffn_dim} "
          f"({cfg.ffn_route}), {cfg.num_mel_bins} mels, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat "
          f"{cfg.remat_policy}, activation dropout {cfg.activation_dropout}, SpecAugment time "
          f"{cfg.mask_time_prob}/{cfg.mask_time_length} feature {cfg.mask_feature_prob}/"
          f"{cfg.mask_feature_length}, learning rate {setup.learning_rate}, grad dtype "
          f"{setup.grad_dtype}, batch {ACCUM} x {BATCH} x {setup.chunk_length} samples", flush=True)
    if (cfg.d_model, cfg.encoder_layers, cfg.decoder_layers, cfg.ffn_dim, cfg.num_mel_bins,
            cfg.dtype, cfg.remat_policy, cfg.ffn_route) != (
                1280, 32, 32, 5120, 128, torch.bfloat16, "save_flash_ctx", route):
        fail("the setup did not build whisper-large-v3 in bf16 under save_flash_ctx with the "
             "configured FFN")
    batch, audio_seconds = whisper_train_batch(4, setup.tokenizer.sot_token_id)
    whisper_train_compare(card, setup, batch, label)

    state = TrainState.create(setup.init_params(seed=0), tx)
    gen = torch.Generator(device="cuda").manual_seed(0)

    # The main path, counted: the first optimizer step.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"training {label} main path: 1 step of {ACCUM} microbatches, launch counts "
          f"{counts}", flush=True)
    expected = {name: n * ACCUM for name, n in per_microbatch.items()}
    if counts != expected:
        fail(f"training {label}: launch counts {counts}, expected {expected}")
    losses = [float(metrics["loss"])]
    walls = []
    for _ in range(steps - 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))  # synchronises
        walls.append(time.perf_counter() - start)
    peak = torch.cuda.max_memory_allocated()
    print(f"training {label} losses over {steps} steps: {[round(v, 6) for v in losses]}"
          f"; last grad norm {float(metrics['grad_norm']):.6f}, learning rate "
          f"{float(metrics['learning_rate']):.6g}", flush=True)
    if not all(math.isfinite(v) for v in losses) or (falling and not losses[-1] < losses[0]):
        fail(f"training {label} loss not finite" + (" or not falling" if falling else ""))

    def one_step():
        nonlocal state, metrics
        state, metrics = step(state, batch, gen)

    profile_window(card, f"one training {label} step", one_step)
    wall = float(np.median(walls))
    print(f"training {label} ({card}): {audio_seconds / wall:.3f} audio-s/s ({audio_seconds:.3f} s "
          f"of audio per step of {ACCUM} x {BATCH} clips, padded to 30 s); {wall * 1e3:.3f} ms "
          f"per optimizer step (median of {len(walls)}); peak memory {peak / 2**30:.3f} GiB",
          flush=True)
    del state, step
    torch.cuda.empty_cache()
    return counts


def production_launches(cfg) -> dict:
    """Launches per microbatch of the production step (the feature encoder
    training, save_qk_ctx) at cfg's widths: LN1 forward and again in the
    replay, the attention forward once (q, k, o and lse are kept), the FFN
    block and both backwards once a layer; ln_bwd is LN1's backward and the
    FFN's LN step, and FE conv 0's (at 512) once."""
    from coral_tpu_torch.ops import attention, ffn, ln_gelu

    D, L = cfg.hidden_size, cfg.num_hidden_layers
    hd = D // cfg.num_attention_heads
    counts = collections.Counter({
        "ln_gelu": 1, "conv_ln_gelu_train": 6, "conv_ln_gelu_bwd": 6, "ctc_alpha": 1,
        "ctc_beta": 1, ln_gelu._name("ln_fused", D): 2 * L, attention._name("fwd", hd): L,
        attention._name("bwd", hd): L, ffn._name("ffn_ln_drop", D): L,
        ffn._name("ffn_bwd", D): L})
    counts[ln_gelu._name("ln_bwd", D)] += 2 * L
    counts["ln_bwd"] += 1
    return dict(counts)


def with_noise_bank(config: dict, tmp: str) -> dict:
    """``config`` with a seeded synthetic stand-in for the ESC-50 bank, saved
    under ``tmp``."""
    bank = np.random.default_rng(1).standard_normal(
        (NOISE_CLIPS, NOISE_SECONDS * SR)).astype(np.float32) * 0.1
    np.save(Path(tmp) / "noise.npy", bank)
    return {**config, "background_noise_path": str(Path(tmp) / "noise.npy")}


def xlsr_train_run(card: str, label: str, config: dict, arch_name: str, steps: int,
                   compare_layers: int | None, falling: bool,
                   warmup: int = WARMUP_STEPS) -> dict:
    """An XLS-R production fine-tune through ``Wav2Vec2Setup.make_train_step``
    (``arch_name`` the ``Wav2Vec2Config`` factory its checkpoint id selects):
    kernel vs plain on one microbatch (at ``compare_layers``, when given),
    then ``steps`` steps at full depth; returns the first step's launches."""
    import tempfile

    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    arch = getattr(Wav2Vec2Config, arch_name)()
    batch, audio_seconds = train_batch(0)
    if compare_layers is not None:
        training_compare(card, batch, config, label, layers=compare_layers)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        counts, _ = production_run(card, label, with_noise_bank(config, tmp),
                                   production_launches(arch), batch, audio_seconds,
                                   arch=(arch.hidden_size, arch.num_hidden_layers), steps=steps,
                                   plain_steps=0, falling=falling, warmup=warmup)
    torch.cuda.empty_cache()
    return counts


def whisper_size_run(card: str, label: str, name: str, checkpoint: str, lr: float,
                     extra: dict, arch: tuple, train_steps: int) -> dict:
    """One Whisper config through ``WhisperSetup`` on the card: greedy serving
    of one batch of 8 clips of 3-30 s with exact launch counts, the kernel
    path against the plain path on it (the encoder output, teacher-forced
    logits), then ``train_steps`` steps of its train step with exact launch
    counts over the first; returns the launch counts of both main paths."""
    import tempfile

    from coral_tpu_torch.audio.augment import peak_normalize
    from coral_tpu_torch.audio.mel import log_mel_spectrogram
    from coral_tpu_torch.ops import _build, ln_gelu
    from coral_tpu_torch.training import TrainState, create_optimizer
    from coral_tpu_torch.training.model_setup import load_model_setup

    config = {**WHISPER_TRAIN_CONFIG, "model": {
        **WHISPER_TRAIN_CONFIG["model"], "name": name, "pretrained_model_id": checkpoint,
        "learning_rate": lr, **extra}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = with_noise_bank(config, tmp)
        setup = load_model_setup(config, device="cuda")
        tx, schedule = create_optimizer(
            learning_rate=setup.learning_rate, warmup_steps=WHISPER_WARMUP_STEPS,
            max_steps=1000, adam_beta1=config["adam_first_momentum"],
            adam_beta2=config["adam_second_momentum"], max_grad_norm=config["max_grad_norm"],
            mu_dtype=config["adam_mu_dtype"])
        step = setup.make_train_step(tx, schedule) if train_steps else None
    cfg = setup.model_config
    model = setup.init_params(seed=0)
    predictor = setup.make_predictor(model)
    D, Le, Ld = cfg.d_model, cfg.encoder_layers, cfg.decoder_layers
    print(f"{label} {name} ({checkpoint}): d_model {D}, {Le} + {Ld} layers, "
          f"{cfg.encoder_attention_heads} heads, FFN {cfg.ffn_dim}, {cfg.dtype}, remat "
          f"{cfg.remat_policy}, lr {setup.learning_rate}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if (D, Le, Ld, cfg.encoder_attention_heads, cfg.ffn_dim, cfg.dtype) != (
            *arch, torch.bfloat16):
        fail(f"{label} {name}: the setup did not build {arch} in bf16")

    rng = np.random.default_rng(6)
    seconds = np.linspace(3.0, 30.0, BATCH)
    T = setup.chunk_length
    audio = np.zeros((BATCH, T), np.float32)
    for j, sec in enumerate(seconds):
        audio[j, : int(sec * SR)] = rng.standard_normal(int(sec * SR)) * 0.1
    batch = {"input_values": audio, "input_lengths": (seconds * SR).astype(np.int32)}

    # Serving, counted: one batch through the greedy generate step.
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    start = time.perf_counter()
    ids = predictor.generate(model, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    serve_counts = dict(_build.launch_counts)
    eos = predictor.tokenizer.eos_token_id
    steps = decode_steps(ids.cpu().numpy(), eos)
    texts = predictor.tokenizer.batch_decode(ids.cpu().numpy())
    serve_fwd, train_fwd, bwd = block_kernels(cfg, D)
    expected = {"flash_attention": Le, serve_fwd: Le,
                "decode_self_attention": Ld * steps, "decode_cross_attention": Ld * steps}
    print(f"{label} {name} serving main path: 1 batch of {BATCH} x 30 s, {steps} decode steps, "
          f"{wall * 1e3:.3f} ms, launch counts {serve_counts}", flush=True)
    if serve_counts != expected:
        fail(f"{label} {name} serving: launch counts {serve_counts}, expected {expected}")
    if len(texts) != BATCH or not all(isinstance(t, str) for t in texts):
        fail(f"{label} {name}: the predictor returned the wrong transcripts")
    feats = log_mel_spectrogram(peak_normalize(torch.from_numpy(audio).cuda()),
                                n_mels=cfg.num_mel_bins, dtype=cfg.dtype)
    n = min(steps, WHISPER_COMPARE_STEPS)
    enc_diff, worst, agree_k, parted = whisper_compare(
        model, feats, ids.long(), n, len(predictor.tokenizer.forced_decoder_ids), eos)
    print(f"{label} {name} kernel vs plain: encoder output max|diff|/max|plain| "
          f"{enc_diff:.6g} (tolerance {WHISPER_ENC_TOL}); teacher-forced logits over {n} "
          f"steps, worst {worst:.6g} (tolerance {WHISPER_LOGITS_TOL}); the kernel path's own "
          f"argmax gives its ids: {agree_k}; first step where the plain path's greedy token "
          f"parts: {parted if parted is not None else 'none'} ({card})", flush=True)
    if enc_diff > WHISPER_ENC_TOL or worst > WHISPER_LOGITS_TOL or not agree_k:
        fail(f"{label} {name}: kernel path and plain path disagree")
    del predictor, feats
    if not train_steps:
        del model
        torch.cuda.empty_cache()
        return serve_counts

    # Training, the first step counted.
    tbatch, audio_seconds = whisper_train_batch(5, setup.tokenizer.sot_token_id)
    state = TrainState.create(model, tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    state, metrics = step(state, tbatch, gen)
    torch.cuda.synchronize()
    train_counts = dict(_build.launch_counts)
    layers = Le + Ld
    expected = {"flash_attention_train": Le, "flash_attention_bwd_dkv": Le,
                "flash_attention_bwd_dq": Le, train_fwd: layers, bwd: layers,
                ln_gelu._name("ln_bwd", D): layers}
    expected = {k: v * ACCUM for k, v in expected.items()}
    print(f"{label} {name} training main path: 1 step of {ACCUM} microbatches, launch counts "
          f"{train_counts}", flush=True)
    if train_counts != expected:
        fail(f"{label} {name} training: launch counts {train_counts}, expected {expected}")
    losses, walls = [float(metrics["loss"])], []
    for _ in range(train_steps - 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, metrics = step(state, tbatch, gen)
        losses.append(float(metrics["loss"]))  # synchronises
        walls.append(time.perf_counter() - start)
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls))
    print(f"{label} {name} training ({card}): losses {[round(v, 6) for v in losses]}; "
          f"{wall * 1e3:.3f} ms per optimizer step (median of {len(walls)}), "
          f"{audio_seconds / wall:.3f} audio-s/s ({audio_seconds:.3f} s of audio a step, padded "
          f"to 30 s); peak memory {peak / 2**30:.3f} GiB", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label} {name}: training loss not finite")
    del state, step, model
    torch.cuda.empty_cache()
    return {k: serve_counts.get(k, 0) + train_counts.get(k, 0)
            for k in {*serve_counts, *train_counts}}


def segment_pairs(ids: torch.Tensor, T: int, keys: int) -> int:
    """Query-key pairs of one head that share a segment: queries below T,
    keys below ``keys`` (the forward's Tp, or T in the backward, where the
    grid's rows add nothing). The work of these inputs, as the bound counts it."""
    q, k = ids[:, :T], ids[:, :keys]
    return int(sum(int((q[b][:, None] == k[b][None, :]).sum()) for b in range(ids.shape[0])))


def unfused_kernel_checks(card: str) -> dict:
    """The unfused routes' kernels against their plain versions at their
    paths' shapes: the flash kernels with segment ids at XLS-R-300M's,
    -1B's and -2B's (8, T, 16, d), d = 64, 80 and 120, T = 1499 (padded to
    1536; the serving clips' second device batch, 4 filler rows of one
    sample) and T = 499 (padded to 512; the training batch's clips), beside
    SDPA (forwards) and the memory-efficient attention backward (dkv, dq),
    both with the segment mask; GELU + dropout at (8, 499, 4096) and Whisper
    large-v3's (8, 1500, 5120), rate 0.1. Each kernel's row comes from its
    path's shape; the other shape is checked and timed under a key of its
    own."""
    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from coral_tpu_torch.ops import flash_attention as fa
    from coral_tpu_torch.ops import gelu_dropout as gd
    from coral_tpu_torch.ops import philox

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {}
    measure = functools.partial(_measure, results, card)
    H = 16
    arch = Wav2Vec2Config()
    serve = np.ones(BATCH, np.int64)
    serve[:4] = [int(s * SR) for s in np.linspace(3.0, 30.0, 12)[BATCH:]]
    train = train_batch(0)[0]["input_lengths"][0]
    for d in fa.KERNEL_HEAD_DIMS:
        for T, samples in ((1499, serve), (499, train)):
            frames = torch.as_tensor(arch.feat_extract_output_lengths(samples), device=dev)
            pad_mask = torch.arange(T, device=dev)[None, :] < frames[:, None]
            ids = fa.segment_ids(pad_mask)
            Tp = ids.shape[1]
            print(f"  flash attention with segment ids: head_dim {d}, T {T} padded to {Tp}, "
                  f"frame lengths {frames.tolist()}", flush=True)
            q, k, v = (randn(BATCH, T, H * d).view(BATCH, T, H, d) for _ in range(3))
            do = randn(BATCH, T, H, d)
            # The library yardsticks: SDPA over the padded (B, H, Tp, d) heads
            # with the (B, 1, Tp, Tp) boolean segment mask (the padding made
            # outside), and the memory-efficient backward with that mask as
            # its bias.
            heads = [fa._pad_rows(t, Tp).transpose(1, 2) for t in (q, k, v)]
            same = (ids[:, None, :, None] == ids[:, None, None, :])
            pairs_fwd, pairs_bwd = segment_pairs(ids, T, Tp), segment_pairs(ids, T, T)
            io = 4 * nbytes(q) + nbytes(ids)
            stats = 2 * BATCH * H * T * 4

            def key(name):
                """The row's name at its path's T (serving's for the forward
                alone, training's for the others), else a key of its own;
                head dims other than 64 apart, as their launches are."""
                name = fa._counter(name, ids, d)
                path_T = 1499 if name.startswith("flash_attention_seg_hd") or \
                    name == "flash_attention_seg" else 499
                return name if T == path_T else f"{name} at T {T}"

            def fwd_check():
                return compare(key("flash_attention"), fa.flash_self_attention(q, k, v, ids),
                               fa.flash_self_attention_plain(q, k, v, ids),
                               key="flash_attention_seg")

            measure(key("flash_attention"), lambda: fa.flash_self_attention(q, k, v, ids),
                    lambda: fa.flash_self_attention_plain(q, k, v, ids), fwd_check,
                    (4 * H * d * pairs_fwd, BF16_FLOPS, io), lambda: sdpa(*heads, attn_mask=same))

            def train_check():
                o, l, m = fa.flash_attention_fwd(q, k, v, ids)
                want = fa.flash_attention_fwd_plain(*(fa._pad_rows(t, Tp) for t in (q, k, v)),
                                                    ids)
                name = key("flash_attention_train")
                return merge(compare(name, o, want[0][:, :T], key="flash_attention_seg_train"),
                             *(compare(f"{name} stats", got, w[..., :T],
                                       key="flash_attention_seg_train stats")
                               for got, w in ((l, want[1]), (m, want[2]))))

            measure(key("flash_attention_train"), lambda: fa.flash_attention_fwd(q, k, v, ids),
                    lambda: fa._padded_fwd_plain(q, k, v, ids), train_check,
                    (4 * H * d * pairs_fwd, BF16_FLOPS, io + stats),
                    lambda: sdpa(*heads, attn_mask=same))
            o, l, m = fa.flash_attention_fwd(q, k, v, ids)
            args = (q, k, v, o, l, m, do)
            library = sdpa_bwd_yardstick(
                *heads, fa._pad_rows(do, Tp).transpose(1, 2),
                attention_bias(torch.where(same, 0.0, float("-inf")), (BATCH, H, Tp, Tp)),
                d**-0.5)
            flash_bwd_rows(measure, key, args, ids, fa._padded_bwd_plain(*args, ids),
                           8 * H * d * pairs_bwd, 6 * H * d * pairs_bwd, library)
            del q, k, v, do, heads, same, o, l, m, args, library
            torch.cuda.empty_cache()

    # GELU + dropout, rate 0.1: the mask exact (the plain version's Philox bits).
    rate = 0.1
    seeds = torch.randint(-(2**31), 2**31, (BATCH,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    for T, F in ((499, 4096), (1500, 5120)):
        x = randn(BATCH, T, F, scale=2.0)
        dy = randn(BATCH, T, F)
        keep = philox.keep_mask(seeds, T, F, rate)

        def check(bwd):
            name = f"gelu_dropout{'_bwd' if bwd else ''}_{F}"
            got = gd.gelu_dropout_bwd(x, dy, rate, seeds) if bwd else gd.gelu_dropout_fwd(
                x, rate, seeds)
            want = (gd.gelu_dropout_bwd_plain(x, dy, rate, seeds) if bwd
                    else gd.gelu_dropout_plain(x, rate, seeds))
            res = compare(name, got, want)
            zero = not bool(got[~keep].any())
            print(f"  {name}: zero wherever the Philox mask drops: {zero}; keep fraction "
                  f"{float(keep.float().mean()):.6f} (rate {rate})", flush=True)
            res["ok"] = res["ok"] and zero
            return res

        n = x.numel()
        ops = (GELU_OPS + 2 + PHILOX_OPS) * n
        measure(f"gelu_dropout_{F}", lambda: gd.gelu_dropout_fwd(x, rate, seeds),
                lambda: gd.gelu_dropout_plain(x, rate, seeds), functools.partial(check, False),
                (ops, FP32_FLOPS, 2 * nbytes(x) + nbytes(seeds)))
        measure(f"gelu_dropout_bwd_{F}", lambda: gd.gelu_dropout_bwd(x, dy, rate, seeds),
                lambda: gd.gelu_dropout_bwd_plain(x, dy, rate, seeds),
                functools.partial(check, True),
                (ops + n, FP32_FLOPS, 3 * nbytes(x) + nbytes(seeds)))
        del x, dy, keep
        torch.cuda.empty_cache()
    return results


def probe_checks(card: str) -> dict:
    """The H100 probes' kernels against their plain versions, timed beside
    their bounds: the K3 backward's modes at (c)'s shapes (8 x 10 s, FE block
    1 for the rows, block 5 under keys of their own), ``full`` bit for bit
    the production backward's output, each mode's three launches timed by
    CUDA events; gelu_cost's and lane_reduce's cases checked at
    ``PROBE_CHECK_STEPS`` and timed at the probes' own steps."""
    from coral_tpu_torch.ops import conv_ln_gelu
    from coral_tpu_torch.tools import event_ms
    from coral_tpu_torch.tools import probe_fe_bwd as pf
    from coral_tpu_torch.tools import probe_gelu_cost as pg
    from coral_tpu_torch.tools import probe_lane_reduce as pl

    dev = torch.device("cuda")
    results = {}
    measure = functools.partial(_measure, results, card)
    C = pf.C
    for layer in (1, 5):
        B, T_in, T_out, k = pf.layer_shape(layer, 10.0, BATCH)
        inputs = pf.make_inputs(B, T_in, k, dev)
        prod = conv_ln_gelu.conv_ln_gelu_bwd(*inputs)
        floor = pf.floor_flops(B, T_out, k) / BF16_FLOPS * 1e3
        print(f"  probe fe_bwd: FE block {layer}, B {B}, T_in {T_in}, T_out {T_out}, k {k}; "
              f"floor {floor:.4f} ms (the JAX probe's 2k products at 989 TFLOP/s bf16)",
              flush=True)
        for mode in pf.MODES:
            name = f"probe_fe_bwd_{mode}" + ("" if layer == 1 else f" layer {layer}")

            def check(mode=mode, name=name):
                got = pf.bwd_variant(*inputs, mode)
                want = pf.bwd_variant_plain(*inputs, mode)
                out = [compare_grad(f"{name} {n}", g, w, GRAD_FRAC[frac]) for n, g, w, frac in
                       zip(("dx", "dW", "dvec"), got, want, ("conv_bwd", "conv_bwd", "partials"))]
                res = merge(*out)
                if mode == "full":
                    same = all(bool(torch.equal(g, p)) for g, p in zip(got, prod))
                    print(f"  {name}: conv_ln_gelu_bwd's dx, dW and dvec bit for bit: {same}",
                          flush=True)
                    res["ok"] = res["ok"] and same
                return res

            # The mode's products (dx's k and dW's k of T_out x C x C), its
            # inputs read once, dx, dW and dvec written.
            products = {"no_dw": k, "no_dx": k}.get(mode, 2 * k)
            moved = nbytes(*inputs) + nbytes(inputs[0]) + k * C * C * 4 + 3 * C * 4
            measure(name, lambda m=mode: pf.bwd_variant(*inputs, m),
                    lambda m=mode: pf.bwd_variant_plain(*inputs, m), check,
                    (2.0 * products * B * T_out * C * C, BF16_FLOPS, moved))
            ms, launches = event_ms(lambda ev, m=mode: pf.bwd_variant(*inputs, m, events=ev),
                                    REPS, n_events=4)
            print(f"  {name}: {ms:.4f} ms a call (CUDA events, median of {REPS}): row kernel "
                  f"{launches[0]:.4f}, dx {launches[1]:.4f}, dW {launches[2]:.4f} ms; "
                  f"{100 * floor / ms:.2f}% of the floor; {card}", flush=True)
        del inputs, prod
        torch.cuda.empty_cache()

    x, w = pg.make_inputs(pg.STEPS, dev)
    xc = x[:PROBE_CHECK_STEPS]
    for case, polys, prng in pg.CASES:
        name = pg.kernel_name(polys, prng)

        def check(polys=polys, prng=prng, name=name):
            got = pg.gelu_cost(xc, w, polys, prng, seed=3)
            want = pg.gelu_cost_plain(xc, w, polys, prng, seed=3)
            res = compare(f"{name} ({PROBE_CHECK_STEPS} steps)", got, want, key="probe_gelu_cost")
            if prng:
                same = bool(torch.equal(got == 0, want == 0))
                kept = float((want != 0).float().mean())
                print(f"  {name}: zero where the plain Philox mask drops, bit for bit: {same}; "
                      f"kept {kept:.6f} (15/16 = 0.9375, no rescale)", flush=True)
                res["ok"] = res["ok"] and same
            return res

        flops, moved = pg.case_work(pg.STEPS)
        library = None
        if not polys and not prng:
            library = functools.partial(torch.matmul, x.view(-1, pg.D), w.t())
        measure(name, lambda p=polys, r=prng: pg.gelu_cost(x, w, p, r, seed=3),
                lambda p=polys, r=prng: pg.gelu_cost_plain(x, w, p, r, seed=3), check,
                (flops, BF16_FLOPS, moved), library)
        print(f"  {name} ({case}): {pg.STEPS} steps of ({pg.TB}, {pg.D}) @ ({pg.D}, {pg.F}); "
              f"{card}", flush=True)
    del x, w, xc
    torch.cuda.empty_cache()

    x, w, ones = pl.make_inputs(pl.STEPS, dev)
    xc = x[:PROBE_CHECK_STEPS]
    for nred, mode in pl.CASES:
        name = pl.kernel_name(mode, nred)

        def check(mode=mode, nred=nred, name=name):
            return compare(f"{name} ({PROBE_CHECK_STEPS} steps)",
                           pl.lane_reduce(xc, w, ones, mode, nred),
                           pl.lane_reduce_plain(xc, w, ones, mode, nred), key="probe_lane_reduce")

        flops, moved = pl.case_work(pl.STEPS, mode, nred)
        measure(name, lambda m=mode, n=nred: pl.lane_reduce(x, w, ones, m, n),
                lambda m=mode, n=nred: pl.lane_reduce_plain(x, w, ones, m, n), check,
                (flops, BF16_FLOPS, moved))
    del x, w, ones, xc
    torch.cuda.empty_cache()
    return results


def fc1_case(kernel: str, D: int, T: int, rate: float, randn, seeds):
    """One of fc1's kernels without the block or the folded LayerNorm at (8,
    T, D) rows, F = 4 D: returns (check, launch, plain, work) for
    ``_measure``. ``kernel``: "ffn_fc1" (N1), "ffn_fc1_bwd" (N2),
    "ffn_block_bwd" (N3) or "ffn_ln_fc1_bwd" (N4); masks exact, dh zero where
    the forward dropped, N3's g the forward's bits."""
    from coral_tpu_torch.ops import ffn, philox

    bf16 = torch.bfloat16
    F, M = 4 * D, BATCH * T
    x = randn(BATCH, T, D, offset=0.2, dtype=bf16)
    w1 = randn(F, D, scale=D**-0.5, dtype=bf16)
    b1, g, b = randn(F, scale=0.1), randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1)
    s = seeds if rate else None
    keep = philox.keep_mask(seeds, T, F, rate) if rate else None
    tag = f"{kernel} D {D}, {BATCH} x {T} rows, rate {rate}"
    in_bytes = nbytes(x, w1, b1) + (nbytes(seeds) if rate else 0)
    if kernel == "ffn_fc1":
        def launch():
            return ffn.ffn_fc1_fwd(x, w1, b1, rate, s)

        def plain():
            return ffn.ffn_fc1_plain(x, w1, b1, rate, s)

        def check():
            got = launch()
            res = compare(tag, got, plain(), key="ffn_fc1")
            if rate:
                dropped_zero = not bool(got[~keep].any())
                frac = float(keep.float().mean())
                print(f"  {tag}: zero where the plain Philox mask drops: {dropped_zero}; keep "
                      f"fraction {frac:.6f}", flush=True)
                res["ok"] = res["ok"] and dropped_zero and abs(frac - (1 - rate)) < 1e-3
            return res

        return check, launch, plain, (2 * M * D * F, BF16_FLOPS, in_bytes + M * F * 2)

    dg = randn(BATCH, T, F, dtype=bf16)
    if kernel == "ffn_ln_fc1_bwd":
        def launch():
            return ffn.ffn_ln_fc1_bwd(x, w1, b1, g, b, dg, rate=rate, seeds=s)

        def plain():
            return ffn.ffn_ln_fc1_bwd_plain(x, w1, b1, g, b, dg, rate=rate, seeds=s)

        names = ("dh", "dx", "ln_out", "db1", "dgamma", "dbeta")
        fracs = (GRAD_FRAC["ffn_bwd"], GRAD_FRAC["ffn_bwd"], None) + (GRAD_FRAC["fc1_vectors"],) * 3
        # Two products (h again, dl = dh W1) and the LayerNorm's rows; dh,
        # dx, ln_out out, and the vectors.
        work = (4 * M * D * F + (LN_OPS + LN_BWD_OPS) * M * D, BF16_FLOPS,
                in_bytes + nbytes(g, b, dg) + M * F * 2 + 2 * M * D * 2 + (F + 2 * D) * 4)
    else:
        emit_g = kernel == "ffn_block_bwd"

        def launch():
            return ffn.ffn_fc1_bwd(x, w1, b1, dg, rate, s, emit_g=emit_g)

        def plain():
            return ffn.ffn_fc1_bwd_plain(x, w1, b1, dg, rate, s, emit_g=emit_g)

        names = ("dh", "g", "dx", "db1") if emit_g else ("dh", "dx", "db1")
        fracs = ((GRAD_FRAC["ffn_bwd"],) + ((None,) if emit_g else ())
                 + (GRAD_FRAC["fc1_dx"], GRAD_FRAC["fc1_vectors"]))
        # Two products (h again, dx = dh W1); dh (and g) and dx out.
        work = (4 * M * D * F, BF16_FLOPS,
                in_bytes + nbytes(dg) + M * F * 2 * (2 if emit_g else 1) + M * D * 2 + F * 4)

    def check():
        got, want = launch(), plain()
        out = []
        for name, frac, gg, ww in zip(names, fracs, got, want):
            if frac is None:  # g or ln_out: rounded outputs
                out.append(compare(f"{tag} {name}", gg, ww, key="ffn_fc1"))
            else:
                out.append(compare_grad(f"{tag} {name}", gg, ww, frac))
        res = merge(*out)
        if rate:
            dropped_zero = not bool(got[0][~keep].any())
            print(f"  {tag}: dh zero where the forward dropped: {dropped_zero}", flush=True)
            res["ok"] = res["ok"] and dropped_zero
        if kernel == "ffn_block_bwd":
            same_g = bool(torch.equal(got[1], ffn.ffn_fc1_fwd(x, w1, b1, rate, s)))
            print(f"  {tag}: g regenerated bit for bit: {same_g}", flush=True)
            res["ok"] = res["ok"] and same_g
        return res

    return check, launch, plain, work


# fc1's kernels at each path's shapes, rate 0 and 0.1: the rows of the
# kernels line (timed) and the other rate of each (checked only).
FC1_ROWS = (("ffn_fc1", "ffn_fc1", 1024, 1499, 0.0), ("ffn_fc1_drop", "ffn_fc1", 1024, 499, 0.1),
            ("ffn_fc1_bwd", "ffn_fc1_bwd", 1024, 499, 0.1),
            ("ffn_block_bwd", "ffn_block_bwd", 1024, 499, 0.1),
            ("ffn_ln_fc1_bwd_1280", "ffn_ln_fc1_bwd", 1280, 1500, 0.1))
FC1_CHECKS = (("ffn_fc1", 1024, 1499, 0.1), ("ffn_fc1", 1024, 499, 0.0),
              ("ffn_fc1", 1280, 1500, 0.0), ("ffn_fc1", 1280, 1500, 0.1),
              ("ffn_fc1_bwd", 1024, 499, 0.0), ("ffn_block_bwd", 1024, 499, 0.0),
              ("ffn_ln_fc1_bwd", 1280, 1500, 0.0), ("ffn_ln_fc1_bwd", 1280, 128, 0.1),
              *((k, D, T, r) for D, T in ((384, 1500), (1920, 499))
                for k in ("ffn_fc1", "ffn_fc1_bwd", "ffn_block_bwd", "ffn_ln_fc1_bwd")
                for r in (0.0, 0.1)))


def fc1_kernel_checks(card: str) -> dict:
    """fc1's kernels without the block or the folded LayerNorm (N1-N4)
    against their plain versions: the rows at their paths' shapes (XLS-R-300M
    serving 8 x 1499 and training 8 x 499 rows at D 1024, Whisper large-v3's
    encoder 8 x 1500 at 1280), timed with cuBLAS's fc1 product alone beside
    them; then the other rate of each, N1 at 1280, N4 at the decoder's 8 x
    128 rows, and all four at D 384 and 1920, checked."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    seeds = torch.randint(-(2**31), 2**31, (BATCH,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    results = {}
    measure = functools.partial(_measure, results, card)
    for name, kernel, D, T, rate in FC1_ROWS:
        check, launch, plain, work = fc1_case(kernel, D, T, rate, randn, seeds)
        measure(name, launch, plain, check, work)
        x = randn(BATCH * T, D, dtype=torch.bfloat16)
        w1 = randn(4 * D, D, scale=D**-0.5, dtype=torch.bfloat16)
        print(f"  {name}: cuBLAS's fc1 product alone ({BATCH * T} x {D} @ {D} x {4 * D}, bf16) "
              f"{median_ms(lambda: torch.matmul(x, w1.t())):.4f} ms (median of {REPS}; {card})",
              flush=True)
        del check, launch, plain, x, w1
        torch.cuda.empty_cache()
    for kernel, D, T, rate in FC1_CHECKS:
        check, *_ = fc1_case(kernel, D, T, rate, randn, seeds)
        results[f"{kernel} D {D} T {T} rate {rate}"] = check()
        del check
        torch.cuda.empty_cache()
    return results


def block_case(kernel: str, D: int, T: int, rate: float, randn, seeds):
    """One of the LayerNorm-folded block's variant kernels at (8, T, D) rows,
    F = 4 D: returns (check, launch, plain, work, yardstick) for ``_measure``
    and the note beside it. ``kernel``: "fc2" (N7), "g_bwd" (N5) or "dw_bwd"
    (N6); masks exact: N5's dh zero where the forward dropped and its g the
    forward's bits, N7's mask N5's (selection weights copy g's columns into
    y bit for bit)."""
    from coral_tpu_torch.ops import ffn, philox

    bf16 = torch.bfloat16
    F, M = 4 * D, BATCH * T
    x = randn(BATCH, T, D, offset=0.2, dtype=bf16)
    w1 = randn(F, D, scale=D**-0.5, dtype=bf16)
    w2 = randn(D, F, scale=F**-0.5, dtype=bf16)
    b1, b2 = randn(F, scale=0.1), randn(D, scale=0.1)
    g, b = randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1)
    s = seeds if rate else None
    keep = philox.keep_mask(seeds, T, F, rate) if rate else None
    tag = f"{kernel} D {D}, {BATCH} x {T} rows, rate {rate}"
    in_bytes = nbytes(x, w1, b1, g, b) + (nbytes(seeds) if rate else 0)
    dg = randn(BATCH, T, F, dtype=bf16)
    dy = randn(BATCH, T, D, dtype=bf16)
    lnf = LN_OPS * M * D
    if kernel == "fc2":
        def launch():
            return ffn.ffn_ln_fc2_fwd(x, w1, b1, g, b, w2, b2, rate=rate, seeds=s)

        def plain():
            return ffn.ffn_ln_fc2_fwd_plain(x, w1, b1, g, b, w2, b2, rate=rate, seeds=s)

        def check():
            y = launch()
            res = compare(tag, y, plain(), key="ffn_ln_fc2")
            twice = bool(torch.equal(y, launch()))
            print(f"  {tag}: the same bits on a second call: {twice}", flush=True)
            res["ok"] = res["ok"] and twice
            # The mask: y's columns under selection weights against N5's g.
            g5 = ffn.ffn_ln_g_bwd(x, w1, b1, g, b, torch.zeros_like(dg), rate=rate, seeds=s)[0]
            same = True
            for part in range(4):
                sel = torch.zeros(D, F, device=x.device, dtype=bf16)
                cols = torch.arange(D, device=x.device)
                sel[cols, part * D + cols] = 1.0
                y = ffn.ffn_ln_fc2_fwd(x, w1, b1, g, b, sel, torch.zeros_like(b2), rate=rate,
                                       seeds=s)
                same = same and bool(torch.equal(y, g5[..., part * D:(part + 1) * D]))
            print(f"  {tag}: g inside N7 equals N5's regenerated g bit for bit (mask and "
                  f"values): {same}", flush=True)
            res["ok"] = res["ok"] and same
            return res

        def yardstick():
            return torch.matmul(ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=rate, seeds=s), w2.t())

        note = "K5's forward + cuBLAS's fc2 product (two calls)"
        work = (4 * M * D * F + lnf, BF16_FLOPS, in_bytes + nbytes(w2, b2) + M * D * 2)
        return check, launch, plain, work, yardstick, note

    if kernel == "g_bwd":
        def launch():
            return ffn.ffn_ln_g_bwd(x, w1, b1, g, b, dg, rate=rate, seeds=s)

        def plain():
            return ffn.ffn_ln_g_bwd_plain(x, w1, b1, g, b, dg, rate=rate, seeds=s)

        names = ("g", "dh", "ln_out", "dx", "db1", "dgamma", "dbeta")
        fracs = (None, GRAD_FRAC["ffn_bwd"], None, GRAD_FRAC["ffn_bwd"]) + (
            GRAD_FRAC["fc1_vectors"],) * 3
        # Two products (h again, dl = dh W1) and the LayerNorm's rows; g, dh,
        # ln_out, dx and the vectors out.
        work = (4 * M * D * F + (LN_OPS + LN_BWD_OPS) * M * D, BF16_FLOPS,
                in_bytes + nbytes(dg) + 2 * M * F * 2 + 2 * M * D * 2 + (F + 2 * D) * 4)

        def yardstick():
            return torch.matmul(dg.view(M, F), w1)

        note = "cuBLAS's dl = dh W1 product alone"
    else:
        def launch():
            return ffn.ffn_ln_dw_bwd(x, w1, b1, g, b, dy, dg, rate=rate, seeds=s)

        def plain():
            return ffn.ffn_ln_dw_bwd_plain(x, w1, b1, g, b, dy, dg, rate=rate, seeds=s)

        names = ("dx", "dW1", "dW2", "db1", "dgamma", "dbeta")
        fracs = (GRAD_FRAC["ffn_bwd"], GRAD_FRAC["dw"], GRAD_FRAC["dw"]) + (
            GRAD_FRAC["fc1_vectors"],) * 3
        # Four products (h again, dl, dW1, dW2); dx, the fp32 dW1 and dW2 and
        # the vectors out (g, dh and ln_out never leave the TPU kernel).
        work = (8 * M * D * F + (LN_OPS + LN_BWD_OPS) * M * D, BF16_FLOPS,
                in_bytes + nbytes(dg, dy) + M * D * 2 + 2 * D * F * 4 + (F + 2 * D) * 4)
        dh, gg = dg.view(M, F), randn(M, F, dtype=bf16)

        def yardstick():
            return torch.matmul(dh.t(), x.view(M, D)), torch.matmul(dy.view(M, D).t(), gg)

        note = "cuBLAS's two dW products"

    def check():
        got, want = launch(), plain()
        out = []
        for name, frac, gg_, ww in zip(names, fracs, got, want):
            if frac is None:  # g or ln_out: rounded outputs
                out.append(compare(f"{tag} {name}", gg_, ww, key="ffn_fc1"))
            else:
                out.append(compare_grad(f"{tag} {name}", gg_, ww, frac))
        res = merge(*out)
        if kernel == "g_bwd":
            same_g = bool(torch.equal(got[0], ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=rate,
                                                                 seeds=s)))
            zero = not rate or not bool(got[1][~keep].any())
            print(f"  {tag}: g regenerated bit for bit: {same_g}; dh zero where the forward "
                  f"dropped: {zero}", flush=True)
            res["ok"] = res["ok"] and same_g and zero
        else:
            # The dW kernel against the plain products on N5's own operands.
            g5, dh5, ln5, *_ = ffn.ffn_ln_g_bwd(x, w1, b1, g, b, dg, rate=rate, seeds=s)
            res["ok"] = res["ok"] and all(
                compare_grad(f"{tag} {n} on N5's operands", k, p, GRAD_FRAC["dw_kernel"])["ok"]
                for n, k, p in zip(("dW1", "dW2"), got[1:3], ffn.ffn_dw_plain(dh5, ln5, dy, g5)))
            twice = all(bool(torch.equal(a, b_)) for a, b_ in zip(got, launch()))
            print(f"  {tag}: dW over {ffn.ffn_dw_ranges(M, D, F)} row range(s); the same bits "
                  f"on a second call (dx, dW1, dW2, db1, dgamma, dbeta): {twice}", flush=True)
            res["ok"] = res["ok"] and twice
        return res

    return check, launch, plain, work, yardstick, note


# The block variants' kernels at each path's shapes: the rows of the kernels
# line (timed; XLS-R-300M serving 8 x 1499 and training 8 x 499 rows at D
# 1024, Whisper large-v3's encoder 8 x 1500 at 1280), then the other rate of
# each, the decoder's 8 x 128 rows, and D 384 and 1920 (checked only).
BLOCK_ROWS = (("ffn_ln_fc2", "fc2", 1024, 1499, 0.0), ("ffn_ln_fc2_drop", "fc2", 1024, 499, 0.1),
              ("ffn_ln_g_bwd", "g_bwd", 1024, 499, 0.1),
              ("ffn_ln_dw_bwd", "dw_bwd", 1024, 499, 0.1),
              ("ffn_ln_fc2_1280", "fc2", 1280, 1500, 0.0),
              ("ffn_ln_fc2_drop_1280", "fc2", 1280, 1500, 0.1),
              ("ffn_ln_g_bwd_1280", "g_bwd", 1280, 1500, 0.1),
              ("ffn_ln_dw_bwd_1280", "dw_bwd", 1280, 1500, 0.1))
BLOCK_CHECKS = (("fc2", 1024, 1499, 0.1), ("fc2", 1024, 499, 0.0), ("g_bwd", 1024, 499, 0.0),
                ("dw_bwd", 1024, 499, 0.0), ("g_bwd", 1280, 1500, 0.0),
                ("dw_bwd", 1280, 1500, 0.0),
                *((k, 1280, 128, 0.1) for k in ("fc2", "g_bwd", "dw_bwd")),
                *((k, D, T, r) for D, T in ((384, 1500), (512, 1500), (768, 1500), (1920, 499))
                  for k in ("fc2", "g_bwd", "dw_bwd") for r in (0.0, 0.1)))


def block_variant_checks(card: str) -> dict:
    """The LayerNorm-folded block's variant kernels (N5-N7) against their
    plain versions: the rows at their paths' shapes, timed with their
    yardsticks beside them (two library calls each, so printed, not in the
    kernels line); then the other checks of ``BLOCK_CHECKS``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    seeds = torch.randint(-(2**31), 2**31, (BATCH,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    from coral_tpu_torch.ops import _build, ffn

    for D in ffn.KERNEL_D:
        c = ctypes.c_int(0)
        n = _build.library().coral_ffn_ln_fc2_clusters(D, ctypes.byref(c))
        print(f"  ffn_ln_fc2 D {D}: clusters of {c.value} blocks ({D // c.value} of y's columns "
              f"each), {n} clusters on the card at once (cudaOccupancyMaxActiveClusters; "
              f"{card}); N6's dW row ranges at {BATCH} x 499 / 1500 rows: "
              f"{ffn.ffn_dw_ranges(BATCH * 499, D, 4 * D)} / "
              f"{ffn.ffn_dw_ranges(BATCH * 1500, D, 4 * D)}", flush=True)
    results = {}
    measure = functools.partial(_measure, results, card)
    for name, kernel, D, T, rate in BLOCK_ROWS:
        check, launch, plain, work, yardstick, note = block_case(kernel, D, T, rate, randn, seeds)
        measure(name, launch, plain, check, work)
        lib_dev = device_ms(yardstick)
        print(f"  {name}: {note}: {median_ms(yardstick):.4f} ms (device "
              f"{'not measured' if lib_dev is None else f'{lib_dev:.4f} ms'}; median of {REPS}; "
              f"{card})", flush=True)
        del check, launch, plain, yardstick
        torch.cuda.empty_cache()
    for kernel, D, T, rate in BLOCK_CHECKS:
        check, *_ = block_case(kernel, D, T, rate, randn, seeds)
        results[f"{kernel} D {D} T {T} rate {rate}"] = check()
        del check
        torch.cuda.empty_cache()
    return results


def qkv_case(kernel: str, D: int, T: int, randn):
    """One of the packed QKV projection's or the bias-free attention's kernels
    at (8, T) rows of width D (F = 3 D, head_dim D / 16), on the layout of
    phase (p): q, k, v the lane thirds of one packed projection, the backward
    writing one packed gradient. Returns (check, launch, plain, work, library,
    yardsticks) for ``_measure``, yardsticks a list of (note, call) timed
    beside the kernel; ``kernel``: "fwd", "bwd" (``ln_dense``) or "attn_fwd",
    "attn_bwd"."""
    from coral_tpu_torch.ops import attention, ffn

    bf16 = torch.bfloat16
    F, M, H = 3 * D, BATCH * T, 16
    hd = D // H
    tag = f"{kernel} D {D}, {BATCH} x {T} rows"
    if kernel in ("fwd", "bwd"):
        x = randn(BATCH, T, D, offset=0.2, dtype=bf16)
        w = randn(F, D, scale=D**-0.5, dtype=bf16)
        b, g, bt = randn(F, scale=0.1), randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1)
        if kernel == "fwd":
            def launch():
                return ffn.ln_dense_fwd(x, w, b, g, bt)

            def plain():
                return ffn.ln_dense_plain(x, w, b, g, bt)

            def check():
                return compare(tag, launch(), plain(), key="ln_dense")

            def product():
                return torch.matmul(x.view(M, D), w.t())

            b16, g16, bt16 = b.to(bf16), g.to(bf16), bt.to(bf16)

            def two_calls():
                return torch.nn.functional.linear(
                    torch.nn.functional.layer_norm(x, (D,), g16, bt16), w, b16)

            work = (2 * M * D * F + LN_OPS * M * D, BF16_FLOPS,
                    nbytes(x, w, b, g, bt) + M * F * 2)
            return check, launch, plain, work, None, [
                ("cuBLAS's (3D, D) product alone", product),
                ("the two-call yardstick (F.layer_norm, then F.linear with the bias; bf16 "
                 "vectors)", two_calls)]
        dy = randn(BATCH, T, F, dtype=bf16)

        def launch():
            return ffn.ln_dense_bwd(x, w, g, bt, dy)

        def plain():
            return ffn.ln_dense_bwd_plain(x, w, g, bt, dy)

        def check():
            got, want = launch(), plain()
            out = [compare_grad(f"{tag} dx", got[0], want[0], GRAD_FRAC["ffn_bwd"]),
                   compare(f"{tag} ln_out", got[1], want[1], key="ln_dense")]
            out += [compare_grad(f"{tag} {n}", gg, ww, GRAD_FRAC["fc1_vectors"])
                    for n, gg, ww in zip(("db", "dgamma", "dbeta"), got[2:], want[2:])]
            return merge(*out)

        def product():
            return torch.matmul(dy.view(M, F), w)

        # One product (dl = dy W), the LayerNorm's rows both ways and db's
        # sums; dx, ln_out and the vectors out.
        work = (2 * M * D * F + (LN_OPS + LN_BWD_OPS) * M * D + M * F, BF16_FLOPS,
                nbytes(x, w, g, bt, dy) + 2 * M * D * 2 + (F + 2 * D) * 4)
        return check, launch, plain, work, None, [("cuBLAS's dl = dy W product alone", product)]

    dev = torch.device("cuda")
    qkv = randn(BATCH, T, F, dtype=bf16)
    q, k, v = qkv.chunk(3, dim=-1)
    lengths = torch.tensor([T, T * 4 // 5, T * 3 // 5, T * 2 // 5, T // 5, T, 50, -1],
                           device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    key_bias = attention._key_bias(mask)
    scale = hd**-0.5
    zero = torch.zeros(D, dtype=bf16, device=dev)
    if kernel == "attn_fwd":
        def launch():
            return attention.short_t_attention_packed(qkv, mask, hd)

        def plain():
            return attention.attention_plain(q, k, v, mask, hd)

        def check():
            (o, lse), (want_o, want_lse) = launch(), plain()
            res = compare(tag, o, want_o, key="attention_nb")
            lse_err = float((lse - want_lse).abs().max())
            o_b, lse_b = attention._fwd(q, k, v, zero, zero, zero, key_bias, hd, scale)
            same = bool(torch.equal(o, o_b) and torch.equal(lse, lse_b))
            clamped = bool((lse[-1] == -1e25).all())
            print(f"  {tag} lse: max_abs_err {lse_err:.6g} (tolerance {LSE_ATOL}); masked row "
                  f"clamped: {clamped}; o and lse the biased kernel's at zero biases bit for "
                  f"bit: {same}", flush=True)
            res["ok"] = res["ok"] and lse_err <= LSE_ATOL and clamped and same
            return res

        heads = [t.view(BATCH, T, H, hd).transpose(1, 2) for t in (q, k, v)]
        sdpa_bias = torch.where(mask, 0.0, -1e30).to(bf16)[:, None, None, :]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(*heads, attn_mask=sdpa_bias)

        work = (4 * BATCH * H * T * T * hd, BF16_FLOPS,
                nbytes(qkv, mask) + nbytes(q) + BATCH * H * T * 4)
        return check, launch, plain, work, library, []
    do = randn(BATCH, T, D, dtype=bf16)
    o, lse = attention._fwd(q, k, v, None, None, None, key_bias, hd, scale)
    args = (q, k, v, None, None, None, key_bias, do, lse, o, hd, scale)
    dqkv = torch.empty_like(qkv)

    def launch():
        return attention.attention_bwd(*args, out=dqkv)

    def plain():
        return attention.attention_bwd_plain(*args)

    def check():
        got, want = launch(), plain()
        out = [compare_grad(f"{tag} {n}", gg, ww, GRAD_FRAC["attention_bwd"])
               for n, gg, ww in zip(("dq", "dk", "dv"), got[:3], want[:3])]
        got_b = attention.attention_bwd(q, k, v, zero, zero, zero, *args[6:])
        same = all(bool(torch.equal(gg, gb)) for gg, gb in zip(got[:3], got_b[:3]))
        masked_zero = all(not t[-1].any() for t in got[:3])
        print(f"  {tag}: the biased kernels' dq, dk, dv at zero biases bit for bit: {same}; "
              f"fully masked row gets no gradient: {masked_zero}", flush=True)
        res = merge(*out)
        res["ok"] = res["ok"] and same and masked_zero
        return res

    # Five T x T x d products per head; the packed dq, dk, dv out.
    work = (5 * 2 * BATCH * H * T * T * hd, BF16_FLOPS,
            nbytes(qkv, key_bias, do, lse, o) + nbytes(qkv))
    library = sdpa_bwd_yardstick(*(heads_of(t, H) for t in (q, k, v, do)),
                                 attention_bias(key_bias[:, None, None, :], (BATCH, H, T, T)),
                                 scale)
    return check, launch, plain, work, library, []


# The packed projection's and the bias-free attention's kernels at their
# paths' shapes: the rows of the kernels line (timed; XLS-R-300M serving 8 x
# 1499 rows for the forwards, training 8 x 499 for the backwards), then the
# other shape of each and XLS-R-1B's and -2B's widths (checked only).
QKV_ROWS = (("ln_dense", "fwd", 1024, 1499), ("ln_dense_bwd", "bwd", 1024, 499),
            ("attention_nb", "attn_fwd", 1024, 1499), ("attention_nb_bwd", "attn_bwd", 1024, 499))
QKV_CHECKS = (("fwd", 1024, 499), ("attn_fwd", 1024, 499),
              *((k, D, T) for D in (1280, 1920)
                for k, T in (("fwd", 1499), ("bwd", 499), ("attn_fwd", 1499), ("attn_bwd", 499))))


def qkv_kernel_checks(card: str) -> dict:
    """The packed QKV projection's kernels and the attention without biases
    against their plain versions: the rows at their paths' shapes, timed, the
    projection's beside its yardsticks (cuBLAS's product alone; the forward's
    two-call composition); then ``QKV_CHECKS``, the forward timed at XLS-R-1B's
    and -2B's widths too."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    results = {}
    measure = functools.partial(_measure, results, card)
    for name, kernel, D, T in QKV_ROWS:
        check, launch, plain, work, library, yardsticks = qkv_case(kernel, D, T, randn)
        measure(name, launch, plain, check, work, library)
        for note, yardstick in yardsticks:
            lib_dev = device_ms(yardstick)
            print(f"  {name}: {note}: {median_ms(yardstick):.4f} ms (device "
                  f"{'not measured' if lib_dev is None else f'{lib_dev:.4f} ms'}; median of "
                  f"{REPS}; {card})", flush=True)
        del check, launch, plain, library, yardsticks
        torch.cuda.empty_cache()
    for kernel, D, T in QKV_CHECKS:
        check, launch, _, work, _, yardsticks = qkv_case(kernel, D, T, randn)
        results[f"{kernel} D {D} T {T}"] = check()
        if kernel == "fwd" and T == 1499:  # the projection at XLS-R-1B's and -2B's serving rows
            dev_ms, two = device_ms(launch), device_ms(yardsticks[1][1])
            print(f"  ln_dense D {D}, {BATCH} x {T} rows: {median_ms(launch):.4f} ms (device "
                  f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), bound "
                  f"{bound(*work)[0]:.4f} ms; the two-call yardstick device "
                  f"{'not measured' if two is None else f'{two:.4f} ms'} ({card})", flush=True)
        del check, launch, yardsticks
        torch.cuda.empty_cache()
    return results


def variant_case(route: str, direction: str, d: int, T: int, randn, packed: bool = False):
    """One kernel of the attention's other routes (K15) at (8, T, 16 x d), the
    serving clips' or the training batch's lengths with one fully masked row
    (length -1): ``route`` as ``ops.attention.ROUTES``, ``direction`` "fwd"
    or "bwd"; ``packed``: q, k, v the lane thirds of one (B, T, 3 H d)
    projection, the backward writing one packed gradient (the layout of
    ``fused_qkv_ln``). Returns (check, launch, plain, work, library) for
    ``_measure``. The forward without stats is checked bit for bit against
    the v2 forward's o; the backward's fully masked row gets no gradient on
    the stats routes and the uniform average's (every key's dv the mean of
    do) on the routes that recompute the softmax."""
    from coral_tpu_torch.ops import attention

    bf16, H, dev = torch.bfloat16, 16, torch.device("cuda")
    D = H * d
    name = attention._name(direction, d, False, route)
    tag = f"{name} ({BATCH}, {T}, {H} x {d}){' packed' if packed else ''}"
    qkv = randn(BATCH, T, 3 * D, dtype=bf16)
    q, k, v = qkv.chunk(3, dim=-1) if packed else (t.contiguous() for t in qkv.chunk(3, dim=-1))
    lengths = (torch.tensor([1499, 1200, 900, 600, 300, 1499, 50, -1], device=dev) if T == 1499
               else torch.tensor([499, 400, 300, 250, 200, 499, 50, -1], device=dev))
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    key_bias = attention._key_bias(mask)
    scale = d**-0.5
    if direction == "fwd":
        def launch():
            return attention._fwd(q, k, v, None, None, None, key_bias, d, scale, route)

        def plain():
            return attention.attention_plain(q, k, v, mask, d, route=route)

        def check():
            (o, lse), (want_o, want_lse) = launch(), plain()
            res = compare(tag, o, want_o, key="attention_v1" if route == "stats" else
                          "attention_ns")
            if route == "attention":
                o_v2, _ = attention._fwd(q, k, v, None, None, None, key_bias, d, scale,
                                         "stats_v2")
                same = bool(torch.equal(o, o_v2))
                print(f"  {tag}: o the v2 forward's (attention_nb) bit for bit: {same}",
                      flush=True)
                res["ok"] = res["ok"] and same and lse is None
                return res
            lse_err = float((lse - want_lse).abs().max())
            clamped = bool((lse[-1] == -1e25).all())
            print(f"  {tag} lse: max_abs_err {lse_err:.6g} (tolerance {LSE_ATOL}); masked row "
                  f"clamped: {clamped}", flush=True)
            res["ok"] = res["ok"] and lse_err <= LSE_ATOL and clamped
            if route == "stats":
                _, lse_v2 = attention._fwd(q, k, v, None, None, None, key_bias, d, scale,
                                           "stats_v2")
                same = bool(torch.equal(lse, lse_v2))
                print(f"  {tag}: lse the v2 forward's (attention_nb) bit for bit: {same}",
                      flush=True)
                res["ok"] = res["ok"] and same
                reciprocal_rounding(tag, q, k, v, key_bias, d, scale)
            return res

        heads = [t.reshape(BATCH, T, H, d).transpose(1, 2) for t in (q, k, v)]
        sdpa_bias = torch.where(mask, 0.0, -1e30).to(bf16)[:, None, None, :]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(*heads, attn_mask=sdpa_bias)

        # Two T x T x d products per head (v1's second score product counts
        # against the bound, not into it); q, k, v, the mask in, o (and lse)
        # out.
        work = (4 * BATCH * H * T * T * d, BF16_FLOPS,
                nbytes(q, k, v, mask) + nbytes(q) + (BATCH * H * T * 4 if route != "attention"
                                                     else 0))
        return check, launch, plain, work, library
    do = randn(BATCH, T, D, dtype=bf16)
    # The backward's residuals from its route's forward (v2's lse for v1's).
    fwd_route = "stats_v2" if route == "stats" else route
    o, lse = attention._fwd(q, k, v, None, None, None, key_bias, d, scale, fwd_route)
    args = (q, k, v, None, None, None, key_bias, do, lse, o, d, scale)
    out = torch.empty_like(qkv) if packed else None

    def launch():
        return attention.attention_bwd(*args, out=out, route=route)

    def plain():
        return attention.attention_bwd_plain(*args, route=route)

    def check():
        got, want = launch(), plain()
        res = merge(*[compare_grad(f"{tag} {n}", gg, ww, GRAD_FRAC["attention_bwd"])
                      for n, gg, ww in zip(("dq", "dk", "dv"), got[:3], want[:3])])
        masked = [t[-1] for t in got[:3]]
        if route in attention.LSE_ROUTES:
            ok = not any(bool(t.any()) for t in masked)
            what = "no gradient"
        else:
            mean_do = do[-1].float().mean(dim=0)
            err = float((masked[2].float() - mean_do).abs().max())
            bound_err = (GRAD_FRAC["attention_bwd"] + 2.0**-6) * float(mean_do.abs().max())
            ok = all(bool(t.any()) for t in masked) and err <= bound_err
            what = f"nonzero gradients, every key's dv the mean of do within {err:.3g}"
            if not packed:  # p = e (1 / l), as v1's forward forms it
                reciprocal_rounding(tag, q, k, v, key_bias, d, scale)
        print(f"  {tag}: fully masked row: {what}: {ok}", flush=True)
        if packed:
            same = all(bool(torch.equal(g, w)) for g, w in zip(
                got[:3], attention.attention_bwd(*args, route=route)[:3]))
            print(f"  {tag}: the packed gradient the separate one's bit for bit: {same}",
                  flush=True)
            ok = ok and same
        res["ok"] = res["ok"] and ok
        return res

    # Five T x T x d products per head (s, dp, dv, dq, dk), as the TPU kernel;
    # the first sweep's products count against the bound, not into it. Inputs
    # q, k, v, key_bias, do and lse or o where the route reads them; dq, dk,
    # dv out.
    reads = [t for t, used in ((lse, route in attention.LSE_ROUTES),
                               (o, route in attention.O_ROUTES)) if used]
    work = (5 * 2 * BATCH * H * T * T * d, BF16_FLOPS,
            nbytes(q, k, v, key_bias, do, *reads) + 3 * nbytes(do))
    library = sdpa_bwd_yardstick(*(heads_of(t, H) for t in (q, k, v, do)),
                                 attention_bias(key_bias[:, None, None, :], (BATCH, H, T, T)),
                                 scale)
    return check, launch, plain, work, library


def reciprocal_rounding(tag: str, q, k, v, key_bias, d: int, scale: float) -> None:
    """Prints how far p = e r, r = 1 / l in fp32, lies from e / l (v1's
    forward and the backwards that recompute the softmax form it so), on
    the card's fp32 arithmetic: the largest difference before rounding, in
    bf16 ulps of p, and the share of p (e > 0) whose bf16 rounding (as the
    kernel's pack) it changes, with the largest such change in ulps. e =
    exp2(s - m) in log2 units, as the kernel forms it but by torch's exp2,
    one batch row at a time."""
    from coral_tpu_torch.ops import attention

    H = q.shape[-1] // d
    worst_fp32 = worst_bf16 = 0.0
    changed = total = 0
    for b in range(q.shape[0]):
        qh, kh, _ = attention._biased(q[b:b + 1], k[b:b + 1], v[b:b + 1], None, None, None, d,
                                      scale)
        s = (qh @ kh.transpose(-1, -2)) * LOG2E + key_bias[b][None, None, None, :] * LOG2E
        e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        del s
        l = e.sum(dim=-1, keepdim=True)
        by_mul, by_div = e * (1.0 / l), e / l
        keep = by_div > 2.0**-126
        ulp = torch.ldexp(torch.ones_like(by_div), torch.frexp(by_div).exponent - 8)
        worst_fp32 = max(worst_fp32, float(((by_mul - by_div).abs() / ulp)[keep].max()))
        flips = (by_mul.to(torch.bfloat16).float() - by_div.to(torch.bfloat16).float()).abs()
        changed += int((flips[keep] > 0).sum())
        total += int(keep.sum())
        worst_bf16 = max(worst_bf16, float((flips / ulp)[keep].max()))
        del e, l, by_mul, by_div, keep, ulp, flips
    print(f"  {tag}: p = e (1 / l) against e / l (fp32 on the card, {H} heads): at most "
          f"{worst_fp32:.6g} bf16 ulp of p apart before rounding; the bf16 rounding changed "
          f"for {changed} of {total} p ({changed / total:.3g}), by at most {worst_bf16:g} ulp",
          flush=True)


# The K15 kernels at their paths' shapes (XLS-R-300M serving 8 x 1499 rows
# for the forwards, training 8 x 499 for the backwards): the rows of the
# kernels line, then the same at head_dim 80 and 120 (timed, launched on no
# main path), and one backward on packed lane thirds (checked). v1's forward
# runs at both shapes ((r') serves 8 x 1499 and trains at 8 x 499); its 8 x
# 499 rows are printed under their shape and give no row of the kernels line.
VARIANT_ROWS = (("attention", "fwd", 1499), ("stats", "fwd", 1499), ("stats", "fwd", 499),
                ("attention", "bwd", 499), ("ctx", "bwd", 499), ("stats", "bwd", 499))


def variant_kernel_checks(card: str) -> dict:
    """The attention's other routes' kernels against their plain versions:
    ``VARIANT_ROWS`` at head_dim 64, 80 and 120, timed, the forwards beside
    SDPA; then one packed backward."""
    from coral_tpu_torch.ops import attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    results = {}
    measure = functools.partial(_measure, results, card)
    for d in (64, 80, 120):
        for route, direction, T in VARIANT_ROWS:
            check, launch, plain, work, library = variant_case(route, direction, d, T, randn)
            name = attention._name(direction, d, False, route)
            if direction == "fwd" and T != 1499:
                name = f"{name} ({BATCH}, {T})"
            measure(name, launch, plain, check, work, library)
            del check, launch, plain, library
            torch.cuda.empty_cache()
    check, *_ = variant_case("attention", "bwd", 64, 499, randn, packed=True)
    results["attention_ns_bwd packed"] = check()
    return results


def block_kernels(cfg, D: int) -> tuple[str, str, str]:
    """The LayerNorm-folded block's kernels at width D on cfg's variant
    (``ffn_variant``): the serving forward, the training (dropout) forward
    and the backward, by their launch-count names."""
    from coral_tpu_torch.ops import ffn

    fwd = "ffn_ln_fc2" if cfg.ffn_variant == "fc2" else "ffn_ln"
    bwd = {"dg_in": "ffn_bwd", "dg_out": "ffn_ln_g_bwd", "fc2": "ffn_ln_g_bwd",
           "dw": "ffn_ln_dw_bwd"}[cfg.ffn_variant]
    return ffn._name(fwd, D), ffn._name(f"{fwd}_drop", D), ffn._name(bwd, D)


def route_launches(cfg, serving: bool, policy: str = "save_qk_ctx",
                   remat_fe: bool = False) -> dict:
    """Launches per forward (serving) or per microbatch (the production step:
    the feature encoder training, under ``policy``, save_qk_ctx by default,
    the feature encoder replayed under ``remat_fe``) of a wav2vec2 config off
    the production routes, at cfg's widths.

    The feature encoder: under layer norm K3 at each block
    ``Wav2Vec2Config.fe_fused`` names, else the conv + K1 (``ln_gelu``, its
    backward ``ln_bwd`` at 512); under ``remat_fe`` K3's training forward
    runs again in the replay (the fused blocks name no "conv_raw"), and so
    does K1 at every block but the last (the next conv's weight gradient
    reads its output); under group norm no kernel.

    The encoder, pre-LN: LN1 is ``ln_fused``, and so is LN2 where the FFN's
    kernels do not fold it in; in training each runs again in the replay
    (neither "attn_in" nor "ffn_in" is kept), and so do the flash forward
    with its stats (its o, l, m have no name), the GELU+dropout forward and
    the fc1 kernel of the fc1 routes (fc2's weight gradient reads their
    output, and save_qk_ctx keeps no "ffn_act"); the blocks' forward never.
    Post-LN both LayerNorms are ``ln_fused``; the replay runs the first again
    (the FFN packs its output) but not the final one, whose output it never
    reads, and runs the FFN block's forward again (the final LayerNorm packs
    the block's output). Under ``encoder_ln_impl: xla`` no encoder LayerNorm
    launches. ln_bwd counts the LayerNorms' backward (LN2's inside N4's and
    K5's wrappers, LN1's inside the packed projection's). Under
    ``fused_qkv_ln`` LN1 is in the packed projection (``ln_dense``), whose
    forward runs again in the replay (neither policy keeps all of q, k and
    v); the attention then runs without in-kernel biases, as with
    ``attention_fused_qkv_bias: false``. The pallas attention takes the
    kernels of its route (``attention_route``); its forward runs once a layer
    where the policy keeps o and, where the backward reads it, the lse
    (save_qk_ctx), else twice, as on v1, whose lse has no name, and under
    dots_saveable."""
    from coral_tpu_torch.models.wav2vec2 import remat_names
    from coral_tpu_torch.ops import attention, ffn, ln_gelu
    from coral_tpu_torch.ops.flash_attention import _counter as flash

    D, L, F = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size
    route = cfg.ffn_route
    hd = D // cfg.num_attention_heads
    ln = ln_gelu._name("ln_fused", D)
    pre_ln, pallas_ln = cfg.do_stable_layer_norm, cfg.encoder_ln_impl == "pallas"
    ln_apart = route in ("unfused", "ffn_block", "ffn_fc1")
    qkv_ln = cfg.qkv_ln
    # The encoder LayerNorms through ln_fused, a layer.
    lns = int(pallas_ln) * (int(ln_apart) + int(not qkv_ln) if pre_ln else 2)
    fused = [cfg.fe_fused(i) for i in range(len(cfg.conv_dim))]
    k1 = sum(not f for f in fused) if cfg.feat_extract_norm == "layer" else 0
    k3 = sum(fused)
    attn = {d: attention._name(d, hd, cfg.attention_fused_qkv_bias, cfg.attention_route)
            for d in ("fwd", "bwd")} if cfg.attention_impl == "pallas" else {}
    if serving:
        counts = collections.Counter({"ln_gelu": k1, "conv_ln_gelu": k3, ln: lns * L})
        if cfg.attention_impl == "flash":
            counts[flash("flash_attention", True, hd)] += L
        elif cfg.attention_impl == "pallas":
            counts[attn["fwd"]] += L
        if qkv_ln:
            counts[ffn._name("ln_dense", D)] += L
        fwd = {"ffn_ln_fc1": "ffn_ln", "ffn_block": "ffn_fc1", "ffn_fc1": "ffn_fc1"}.get(route)
        if route == "ffn_ln_block":
            counts[block_kernels(cfg, D)[0]] += L
        elif fwd is not None:
            counts[ffn._name(fwd, D)] += L
        return dict(+counts)
    k1_replays = k1 - int(k1 > 0 and not fused[-1]) if remat_fe else 0
    counts = collections.Counter({
        "ln_gelu": k1 + k1_replays, "conv_ln_gelu_train": k3 * (2 if remat_fe else 1),
        "conv_ln_gelu_bwd": k3, "ln_bwd": k1, "ctc_alpha": 1, "ctc_beta": 1,
        ln: (2 * lns if pre_ln else lns + int(pallas_ln)) * L})
    if qkv_ln:
        counts.update({ffn._name("ln_dense", D): 2 * L, ffn._name("ln_dense_bwd", D): L})
    ln_bwds = (int(pallas_ln or qkv_ln) + int(pallas_ln or not ln_apart) if pre_ln
               else 2 * int(pallas_ln))
    counts[ln_gelu._name("ln_bwd", D)] += ln_bwds * L
    names = remat_names(policy, cfg)
    kept = "attn_ctx" in names and ("attn_lse" in names
                                    or cfg.attention_route not in ("stats_v3", "stats_v2"))
    if cfg.attention_impl == "flash":
        counts.update({flash("flash_attention_train", True, hd): 2 * L,
                       flash("flash_attention_bwd_dkv", True, hd): L,
                       flash("flash_attention_bwd_dq", True, hd): L})
    elif cfg.attention_impl == "pallas":
        counts.update({attn["fwd"]: (1 if kept and cfg.attention_route != "stats" else 2) * L,
                       attn["bwd"]: L})
    fwd, fwd_runs, bwd = {
        "unfused": (f"gelu_dropout_{F}", 2, f"gelu_dropout_bwd_{F}"),
        "ffn_ln_block": (None, 1, None),
        "ffn_block": ("ffn_fc1_drop", 1 if pre_ln else 2, "ffn_block_bwd"),
        "ffn_ln_fc1": ("ffn_ln_drop", 2, "ffn_ln_fc1_bwd"),
        "ffn_fc1": ("ffn_fc1_drop", 2, "ffn_fc1_bwd"),
    }[route]
    if route == "ffn_ln_block":
        _, fwd, bwd = block_kernels(cfg, D)
    elif route != "unfused":
        fwd, bwd = ffn._name(fwd, D), ffn._name(bwd, D)
    counts.update({fwd: fwd_runs * L, bwd: L})
    return dict(+counts)


def route_serving(card: str, label: str, config: dict, batches: int, route: str,
                  arch: tuple = (1024, 24)) -> dict:
    """The serving clips of phase 4 (12 clips of 3-30 s in 30 s windows of
    batch 8, the second batch with 4 filler rows of one sample) through
    ``Wav2Vec2Setup.make_predictor`` on ``config``'s routes (the FFN on
    ``route``) at ``arch`` (hidden size, layers), the first ``batches`` device
    batches: exact launch counts, finite logits of the right shape, the
    kernel path against the plain path on the last batch, audio-s/s and
    latency. Returns the launch counts."""
    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.training.model_setup import GreedyCtcPredictor

    setup = phase_setup(config)
    model = setup.init_params(seed=0)
    cfg = setup.model_config
    predictor = setup.make_predictor(model)
    print(f"serving {label}: hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"attention {cfg.attention_impl} (route {cfg.attention_route}, q/k/v biases in the "
          f"kernel: "
          f"{cfg.attention_fused_qkv_bias}, LN1 folded into the packed QKV projection: "
          f"{cfg.fused_qkv_ln}), FFN {cfg.ffn_route}, {cfg.dtype}; encoder "
          f"{'pre' if cfg.do_stable_layer_norm else 'post'}-LN, LayerNorms "
          f"{cfg.encoder_ln_impl}; feature encoder {cfg.feat_extract_norm} norm, fused conv "
          f"blocks {sum(cfg.fe_fused(i) for i in range(len(cfg.conv_dim)))}", flush=True)
    if (cfg.hidden_size, cfg.num_hidden_layers, cfg.dtype, cfg.ffn_route,
            cfg.attention_impl) != (*arch, torch.bfloat16, route,
                                    config["model"].get("attention_impl", "pallas")):
        fail(f"serving {label}: the setup did not build the configured routes")
    rng = np.random.default_rng(0)
    seconds = np.linspace(3.0, 30.0, 12)
    clips = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]
    T = 30 * SR
    device_batches = []
    for i in range(0, len(clips), BATCH):
        audio = np.zeros((BATCH, T), np.float32)
        lengths = np.ones((BATCH,), np.int32)
        for j, clip in enumerate(clips[i:i + BATCH]):
            audio[j, : len(clip)] = clip
            lengths[j] = len(clip)
        device_batches.append({"input_values": audio, "input_lengths": lengths})
    device_batches = device_batches[-batches:]
    served = float(sum(b["input_lengths"][b["input_lengths"] > 1].sum()
                       for b in device_batches)) / SR

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    texts = [t for b in device_batches for t in predictor(b)]
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    expected = {n: c * batches for n, c in route_launches(cfg, serving=True).items()}
    print(f"serving {label} main path: {batches} forwards, launch counts {counts}", flush=True)
    if counts != expected:
        fail(f"serving {label}: launch counts {counts}, expected {expected}")
    if len(texts) != BATCH * batches or not all(isinstance(t, str) for t in texts):
        fail(f"serving {label} returned the wrong transcripts")

    batch = device_batches[-1]
    logits, frames = predictor.logits(batch)
    with torch.device("meta"):
        plain_model = Wav2Vec2ForCTC(cfg, plain=True)
    plain_model = plain_model.to_empty(device="cuda").eval()
    plain_model.load_state_dict(model.state_dict())
    plain = GreedyCtcPredictor(plain_model, predictor.tokenizer)
    plain_logits, _ = plain.logits(batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 1499, cfg.vocab_size):
        fail(f"serving {label}: logits not finite or of shape {tuple(logits.shape)}")
    diff = float((logits.float() - plain_logits.float()).abs().max()
                 / plain_logits.float().abs().max())
    valid = torch.arange(1499, device="cuda")[None, :] < frames[:, None]
    agree = float((logits.argmax(-1) == plain_logits.argmax(-1))[valid].float().mean())
    print(f"serving {label} logits kernel vs plain (every frame, filler rows included): "
          f"max|diff|/max|plain| {diff:.6g} (tolerance {LOGITS_TOL}); argmax agreement over "
          f"{int(valid.sum())} valid frames {agree:.6f}", flush=True)
    if diff > LOGITS_TOL:
        fail(f"serving {label}: kernel path and plain path disagree")
    del plain, plain_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    latency = timed(lambda: predictor(batch), 3)
    wall = timed(lambda: [predictor(b) for b in device_batches], 3)
    peak = torch.cuda.max_memory_allocated()
    print(f"serving {label} ({card}): {served / wall:.3f} audio-s/s over {served:.1f} s of "
          f"audio in {batches} batches (median of 3); latency {latency * 1e3:.3f} ms per batch "
          f"of {BATCH} x 30 s (median of 3); peak memory {peak / 2**30:.3f} GiB", flush=True)
    del model, predictor
    torch.cuda.empty_cache()
    return counts


def route_run(card: str, label: str, config: dict, route: str, steps: int,
              serve_batches: int, compare: bool, arch: tuple = (1024, 24),
              compare_layers: int | None = None) -> dict:
    """Phases (j)-(s') and (y)-(z' no remat): serving through the setup's predictor
    (``serve_batches`` device batches, none for 0), then ``steps`` of (c)'s
    production step on ``config``'s routes (the FFN on ``route``) at
    ``arch`` (hidden size, layers; the kernel path against the plain path on
    one microbatch first, when ``compare``, at ``compare_layers`` of the
    layers where given; no plain step is timed); returns the launch counts
    of the counted runs."""
    import tempfile

    counts = collections.Counter(route_serving(card, label, config, serve_batches, route, arch)
                                 if serve_batches else {})
    batch, audio_seconds = train_batch(0)
    if compare:
        training_compare(card, batch, config, label, layers=compare_layers,
                         activation_dropout=0.1)
        torch.cuda.empty_cache()
    setup = phase_setup(config)
    expected = route_launches(setup.model_config, serving=False, policy=setup.remat_policy,
                              remat_fe=setup.remat_feature_encoder)
    with tempfile.TemporaryDirectory() as tmp:
        train_counts, _ = production_run(card, label, with_noise_bank(config, tmp),
                                         expected, batch,
                                         audio_seconds, arch=arch, steps=steps,
                                         plain_steps=0, falling=steps >= TRAIN_STEPS)
    counts.update(train_counts)
    torch.cuda.empty_cache()
    return dict(counts)


# Phases (w) and (w'): fine-tuning through the port's loop. `compose` gives
# asr_finetuning.yaml with these overrides (the synthetic source offline, A =
# 2 as (c) runs, a checkpoint and an eval every 2 steps); (w) runs
# wav2vec2-small.yaml with `model.use_decoder=false` (its n-gram decoder is
# ROADMAP Queue 1 item 7(e)), (w') whisper-small.yaml with max_length 32 (cut
# from 225) and 8 eval clips.
FINETUNE_OVERRIDES = [
    "datasets=[synthetic]", "enable_experiment_tracking=false", "per_device_batch_size=8",
    "total_batch_size=16", "warmup_steps=2", "logging_steps=1", "eval_steps=2",
    "save_steps=2", "save_total_limit=1"]
FINETUNE_VAL_CLIPS = 16
WHISPER_FINETUNE_VAL_CLIPS = 8
WHISPER_FINETUNE_MAX_LENGTH = 32
# B resumes A (2 steps) to 4; C runs 4 straight. B's losses at steps 3-4
# within this of C's (cuDNN's positional-conv backward need not be
# deterministic on the card, so the masters are printed, not held).
RESUME_LOSS_RTOL = 1e-2
BARE_STEPS = 5


class LoopSpy:
    """For the ``finetune`` runs inside ``with``: wraps what the loop builds.
    The setup's train step keeps the last state and each step's batch (and
    the masters, flattened on the device, after step ``keep_step``); the
    infeed's ``put_fn`` hashes each host batch, in the order the loop takes
    them (the batches skipped on a resume are never put); the tracker keeps
    each logged step's metrics and the host time of its log (the loss read
    synchronises it)."""

    def __init__(self, keep_step: int | None = None) -> None:
        self.keep_step, self.kept = keep_step, None
        self.hashes, self.logs, self.times, self.batches = [], {}, {}, {}
        self.setup = self.step_fn = self.state = None

    def __enter__(self):
        import hashlib
        import importlib

        from coral_tpu_torch.tracking import TrackingSetup

        ft = self.ft = importlib.import_module("coral_tpu_torch.training.finetune")
        self._orig = (ft.load_model_setup, ft.device_put_fn, ft.load_tracking_setup)
        spy = self

        def load_model_setup(config, is_main=True, device="cuda"):
            setup = spy._orig[0](config, is_main=is_main, device=device)
            make = setup.make_train_step

            def make_train_step(tx, schedule):
                step = spy.step_fn = make(tx, schedule)

                def wrapped(state, batch, generator):
                    spy.state, spy.batches[state.step + 1] = state, batch
                    out = step(state, batch, generator)
                    if state.step == spy.keep_step:
                        spy.kept = torch.cat([p.reshape(-1) for p in state.params.values()])
                    return out

                return wrapped

            setup.make_train_step = make_train_step
            spy.setup = setup
            return setup

        def device_put_fn(device):
            put = spy._orig[1](device)

            def hashed(batch):
                digest = hashlib.blake2b(digest_size=8)
                for key in sorted(batch):
                    digest.update(np.ascontiguousarray(batch[key]).tobytes())
                spy.hashes.append(digest.hexdigest())
                return put(batch)

            return hashed

        class Tracker(TrackingSetup):
            def run_initialization(self):
                pass

            def log_metrics(self, metrics, step):
                if "loss" in metrics:
                    spy.times[step] = time.perf_counter()
                else:
                    spy.times[f"val {step}"] = time.perf_counter()
                spy.logs.setdefault(step, {}).update(metrics)

            def run_finalization(self):
                pass

        ft.load_model_setup, ft.device_put_fn = load_model_setup, device_put_fn
        ft.load_tracking_setup = Tracker
        return self

    def __exit__(self, *exc) -> None:
        self.ft.load_model_setup, self.ft.device_put_fn, self.ft.load_tracking_setup = self._orig

    def step_ms(self, step: int) -> float:
        """Host ms from step - 1's loss read to step's (an eval pass and a
        save at step - 1 fall inside)."""
        return (self.times[step] - self.times[step - 1]) * 1e3

    def eval_ms(self, step: int) -> float:
        """Host ms from step's loss read to its eval pass's log."""
        return (self.times[f"val {step}"] - self.times[step]) * 1e3

    def release(self) -> None:
        self.setup = self.step_fn = self.state = None
        self.batches.clear()


def trace_busy_share(path: Path) -> tuple[float, float, int]:
    """(device busy ms, window ms, kernels) of a Chrome trace that
    ``finetune``'s ``profile_step`` wrote: the union of the kernels' intervals
    over the span of every event."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                     if e.get("cat") == "kernel")
    window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
              - min(float(e["ts"]) for e in events)) / 1e3
    busy, end = 0.0, -math.inf
    for a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, window, len(kernels)


def bare_step_ms(spy: LoopSpy, reps: int, step: int) -> float:
    """The median host ms of ``reps`` bare train steps on the loop's state
    and the batch of its step ``step``, each synchronised by its loss read."""
    from coral_tpu_torch.training.finetune import step_generator

    walls = []
    for rep in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        spy.state, metrics = spy.step_fn(spy.state, spy.batches[step],
                                         step_generator(0, rep, torch.device("cuda")))
        float(metrics["loss"])
        walls.append(time.perf_counter() - start)
    return float(np.median(walls)) * 1e3


def saved_model_strings(card: str, label: str, spy: LoopSpy, model_dir: Path, clips: list
                        ) -> int:
    """``load_saved_predictor`` on the loop's saved directory against a
    predictor on the loop's final in-memory state (the model pointed at its
    fp32 masters): the same strings on ``clips`` in batches of 8, or fail.
    Returns the clips served."""
    from coral_tpu_torch.evaluation.eval_loop import batch_for_eval
    from coral_tpu_torch.evaluation.evaluate import load_saved_predictor
    from coral_tpu_torch.training.train_state import _load_work_params

    start = time.perf_counter()
    saved, geometry = load_saved_predictor({"model_id": str(model_dir), "sampling_rate": SR},
                                           device="cuda")
    load_s = time.perf_counter() - start
    _load_work_params(spy.state.model, spy.state.params, None)
    spy.state.model.eval()
    live = spy.setup.make_predictor(spy.state.model)
    samples = [{"audio_array": c, "text": ""} for c in clips]
    got, want, same = [], [], []
    for batch, texts in batch_for_eval(samples, BATCH, **geometry):
        got += saved(batch)[: len(texts)]
        want += live(batch)[: len(texts)]
        # Under the strings: Whisper's generated ids, wav2vec2's logits.
        if hasattr(saved, "generate"):
            same.append(torch.equal(saved.generate(saved.model, batch),
                                    live.generate(live.model, batch)))
        else:
            same.append(torch.equal(saved.logits(batch)[0], live.logits(batch)[0]))
    print(f"{label} served from the saved directory (load_saved_predictor, {load_s:.2f} s to "
          f"load): {len(got)} clips, the in-memory predictor's strings: {got == want}, "
          f"{'ids' if hasattr(saved, 'generate') else 'logits'} bit for bit: {all(same)}; "
          f"first {got[0][:40]!r} ({card})", flush=True)
    if got != want or not all(same) or len(got) != len(clips):
        fail(f"{label}: the saved model's strings differ from the loop's in-memory predictor's")
    del saved, live
    return len(got)


def keep_saved_model(run_dir: Path, saved_to: Path | None) -> None:
    """Move a loop's saved model directory (its checkpoints dropped) to
    ``saved_to`` for phase (x), if asked."""
    import shutil

    if saved_to is not None:
        shutil.rmtree(run_dir / "checkpoints", ignore_errors=True)
        shutil.move(str(run_dir), str(saved_to))


def finetune_run(card: str, saved_to: Path | None = None) -> dict:
    """Phase (w): three runs of ``finetune`` on wav2vec2-small.yaml, composed
    by the port's ``compose``: A to step 2, B resuming A to step 4 (steps 3-4
    profiled through ``profile_step``), C straight to step 4. Exact launch
    counts (the train step's (c) counts a step, the serving forward's a
    batch of each eval pass), the resume (B's batches at steps 3-4 are C's,
    its losses within RESUME_LOSS_RTOL, the masters' max|diff|), the
    retention by orbax's rule after each run, the saved directory served with
    the in-memory predictor's strings, and the timings; C's saved directory
    is moved to ``saved_to`` where given; returns the launch counts of the three
    runs."""
    import shutil
    import tempfile

    from coral_tpu_torch.config import compose
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.training.checkpoint import Checkpointer
    from coral_tpu_torch.training.finetune import finetune

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_w_"))
    val = f"synthetic://{FINETUNE_VAL_CLIPS}"
    overrides = ["model=wav2vec2-small", "model.use_decoder=false", *FINETUNE_OVERRIDES,
                 f"evaluation_datasets=[{{id: {val}, val_name: val}}]"]
    metric = f"val_{FINETUNE_VAL_CLIPS}_cer"
    eval_batches = -(-FINETUNE_VAL_CLIPS // BATCH)
    total: collections.Counter = collections.Counter()
    spies = {}
    try:
        # (label, directory, overrides, the steps it trains, eval passes)
        for label, run_dir, extra, trained, evals in (
                ("A", "ab", ["max_steps=2"], [1, 2], 1),
                ("B", "ab", ["max_steps=4", "resume_from_checkpoint=true", "profile_step=2",
                             "profile_num_steps=2"], [3, 4], 1),
                ("C", "c", ["max_steps=4"], [1, 2, 3, 4], 2)):
            steps = len(trained)
            config = compose("asr_finetuning",
                             overrides=overrides + [f"model_dir={tmp / run_dir}", *extra])
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            with LoopSpy(keep_step=4) as spy:
                start = time.perf_counter()
                history = finetune(config, device="cuda")
                wall = time.perf_counter() - start
            torch.cuda.synchronize()
            counts = dict(_build.launch_counts)
            cfg = spy.setup.model_config
            if (cfg.hidden_size, cfg.num_hidden_layers, cfg.dtype) != (1024, 24, torch.bfloat16):
                fail(f"(w) {label}: the loop did not build XLS-R-300M in bf16")
            serve = w2v2_forward_launches(cfg)
            expected = {k: PRODUCTION_PER_MICROBATCH.get(k, 0) * ACCUM * steps
                        + serve.get(k, 0) * eval_batches * evals
                        for k in {*PRODUCTION_PER_MICROBATCH, *serve}}
            losses = {s: round(m["loss"], 4) for s, m in sorted(spy.logs.items()) if "loss" in m}
            cers = {s: m[metric] for s, m in sorted(spy.logs.items()) if metric in m}
            print(f"(w) run {label} ({config.model.name}, hidden {cfg.hidden_size}, "
                  f"{cfg.num_hidden_layers} layers, A {ACCUM} x {BATCH}): {wall:.2f} s, losses "
                  f"{losses}, eval CER {cers}, launch counts {counts}", flush=True)
            if counts != expected:
                fail(f"(w) run {label}: launch counts {counts}, expected {expected} ({steps} "
                     f"steps, {evals} eval passes of {eval_batches} batches)")
            if sorted(losses) != trained or not all(map(math.isfinite, losses.values())):
                fail(f"(w) run {label}: logged steps {sorted(losses)} or a loss not finite")
            total.update(counts)
            # Retention: one kept (save_total_limit 1), every save with
            # metrics: the least CER, the later of equals, is kept, best and
            # latest.
            ckpt = Checkpointer(tmp / run_dir / "checkpoints", 1, metric)
            every = {**(spies["A"].cers if label == "B" else {}), **cers}
            keep = min(every, key=lambda s: (every[s], -s))
            got = (ckpt.all_steps(), ckpt.best_step(), ckpt.latest_step())
            print(f"(w) run {label} checkpoints: steps {got[0]}, best {got[1]}, latest {got[2]} "
                  f"(orbax's rule, max_to_keep 1, min of {metric}: {[keep], keep, keep}); "
                  f"history {({k: float(f'{v:.6g}') for k, v in history.items()})}", flush=True)
            if got != ([keep], keep, keep):
                fail(f"(w) run {label}: checkpoints {got}, orbax's rule gives {keep}")
            spy.cers, spy.wall = cers, wall
            spies[label] = spy
            if label != "C":
                spy.release()
        a, b, c = spies["A"], spies["B"], spies["C"]
        # Resume: B's steps 3-4 took C's batches 3-4, and their losses.
        same_batches = b.hashes[:2] == c.hashes[2:4]
        rel = [abs(b.logs[s]["loss"] - c.logs[s]["loss"]) / abs(c.logs[s]["loss"])
               for s in (3, 4)]
        diff = float((b.kept - c.kept).abs().max())
        print(f"(w) resume ({card}): B's batches at steps 3-4 are C's: {same_batches} (blake2b "
              f"{b.hashes[:2]} / {c.hashes[2:4]}); A's at 1-2 C's: {a.hashes[:2] == c.hashes[:2]}; "
              f"losses at 3-4 B {[b.logs[s]['loss'] for s in (3, 4)]} C "
              f"{[c.logs[s]['loss'] for s in (3, 4)]} (rel {[f'{r:.3g}' for r in rel]}, "
              f"tolerance {RESUME_LOSS_RTOL}); masters after step 4 max|B - C| {diff:.6g} "
              f"(max|C| {float(c.kept.abs().max()):.6g})", flush=True)
        if not (same_batches and a.hashes[:2] == c.hashes[:2]
                and max(rel) <= RESUME_LOSS_RTOL and math.isfinite(diff)):
            fail("(w): the resumed run did not take the straight run's batches and losses")
        b.kept = c.kept = None
        busy, window, kernels = trace_busy_share(next((tmp / "ab" / "profile").glob("*.json")))
        clips = serving_clips(30 * SR)[0]
        saved_model_strings(card, "(w)", c, tmp / "c", clips)
        c.state.model.train()
        loop_ms = [c.step_ms(s) for s in (2, 3, 4)]
        loop = float(np.median(loop_ms))
        bare, bare2 = bare_step_ms(c, BARE_STEPS, 4), bare_step_ms(c, BARE_STEPS, 2)
        logs = [c.logs[s] for s in (2, 3, 4)]
        print(f"(w) loop vs bare step ({card}): the loop's step {loop:.3f} ms (median of C's "
              f"steps 2-4: {', '.join(f'{v:.3f}' for v in loop_ms)}; step 3 holds step 2's "
              f"eval pass and save, step 4 runs while step 2's checkpoint is written), the bare "
              f"train step on C's last batch {bare:.3f} ms (median of {BARE_STEPS}): ratio "
              f"{loop / bare:.4f}; step by step on the same batch: step 2 (no eval, save or "
              f"write in its window) {loop_ms[0] / bare2:.4f}x its bare {bare2:.3f} ms, step 4 "
              f"{loop_ms[2] / bare:.4f}x; device busy "
              f"{busy:.3f} ms of a {window:.3f} ms window of B's steps 3-4 ({kernels} kernels, "
              f"profile_step 2, profiler on): busy share {busy / window:.4f}; "
              f"audio_seconds_per_second {[round(m['audio_seconds_per_second'], 3) for m in logs]}"
              f", infeed_mb_per_step {[round(m['infeed_mb_per_step'], 4) for m in logs]}; eval "
              f"pass ({FINETUNE_VAL_CLIPS} clips, {eval_batches} batches) "
              f"{c.eval_ms(2):.3f} / {c.eval_ms(4):.3f} ms at steps 2 / 4", flush=True)
        ckpt = Checkpointer(tmp / "timing", 1)
        ckpt.save(1, c.state)
        ckpt.wait()
        torch.cuda.synchronize()
        start = time.perf_counter()
        ckpt.restore(c.state, 1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - start
        print(f"(w) checkpoint of the train state ({card}): {ckpt.saved_bytes / 1e9:.3f} GB "
              f"(fp32 masters, fp32 second moment, bf16 first moment), host snapshot "
              f"{ckpt.snapshot_seconds * 1e3:.3f} ms, write {ckpt.write_seconds * 1e3:.3f} ms "
              f"(background thread, torch.save then rename), restore "
              f"{restore_s * 1e3:.3f} ms (read warm from the page cache, copied in place)",
              flush=True)
        ckpt.close()
        keep_saved_model(tmp / "c", saved_to)
    finally:
        spies.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"(w) done in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(total)


def whisper_finetune_run(card: str, saved_to: Path | None = None) -> dict:
    """Phase (w'): ``finetune`` on whisper-small.yaml (12 + 12 layers, d 768)
    to step 2 with one eval pass over WHISPER_FINETUNE_VAL_CLIPS clips:
    exact launch counts (the train step's a step, the encoder's and each
    decode step's in the eval's generation), the saved directory served with
    the in-memory predictor's strings, the loop's step ms against the bare
    step's; the saved directory is moved to ``saved_to`` where given; returns
    the launch counts."""
    import shutil
    import tempfile

    from coral_tpu_torch.config import compose
    from coral_tpu_torch.ops import _build, ln_gelu
    from coral_tpu_torch.training.finetune import finetune

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_w2_"))
    val = f"synthetic://{WHISPER_FINETUNE_VAL_CLIPS}"
    overrides = ["model=whisper-small", f"model.max_length={WHISPER_FINETUNE_MAX_LENGTH}",
                 *FINETUNE_OVERRIDES, f"evaluation_datasets=[{{id: {val}, val_name: val}}]",
                 "max_steps=2", f"model_dir={tmp / 'run'}"]
    try:
        config = compose("asr_finetuning", overrides=overrides)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with LoopSpy() as spy, DecodeSpy() as decode:
            start = time.perf_counter()
            finetune(config, device="cuda")
            wall = time.perf_counter() - start
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        cfg = spy.setup.model_config
        D, Le, Ld = cfg.d_model, cfg.encoder_layers, cfg.decoder_layers
        if (D, Le, Ld, cfg.dtype) != (768, 12, 12, torch.bfloat16):
            fail("(w'): the loop did not build whisper-small in bf16")
        serve_fwd, train_fwd, bwd = block_kernels(cfg, D)
        per_step = {"flash_attention_train": Le, "flash_attention_bwd_dkv": Le,
                    "flash_attention_bwd_dq": Le, train_fwd: Le + Ld, bwd: Le + Ld,
                    ln_gelu._name("ln_bwd", D): Le + Ld}
        batches = -(-WHISPER_FINETUNE_VAL_CLIPS // BATCH)
        evals = {"flash_attention": Le * batches, serve_fwd: Le * batches,
                 "decode_self_attention": Ld * decode.steps,
                 "decode_cross_attention": Ld * decode.steps}
        expected = {k: per_step.get(k, 0) * ACCUM * 2 + evals.get(k, 0)
                    for k in {*per_step, *evals}}
        losses = {s: round(m["loss"], 4) for s, m in sorted(spy.logs.items()) if "loss" in m}
        print(f"(w') {config.model.name} (d {D}, {Le} + {Ld} layers, max_length "
              f"{WHISPER_FINETUNE_MAX_LENGTH}, A {ACCUM} x {BATCH} x 30 s): {wall:.2f} s, losses "
              f"{losses}, eval {spy.logs.get(2, {}).get(f'val_{WHISPER_FINETUNE_VAL_CLIPS}_cer')} "
              f"CER over {decode.steps} decode steps, launch counts {counts}", flush=True)
        if counts != expected:
            fail(f"(w'): launch counts {counts}, expected {expected}")
        if sorted(losses) != [1, 2] or not all(map(math.isfinite, losses.values())):
            fail("(w'): a loss not finite, or steps missing")
        clips = serving_clips(30 * SR)[0][-BATCH:]
        saved_model_strings(card, "(w')", spy, tmp / "run", clips)
        spy.state.model.train()
        loop = spy.step_ms(2)
        bare = bare_step_ms(spy, 3, 2)
        print(f"(w') loop vs bare step ({card}): the loop's step 2 {loop:.3f} ms, the bare "
              f"train step on its last batch {bare:.3f} ms (median of 3): ratio "
              f"{loop / bare:.4f}; eval pass ({WHISPER_FINETUNE_VAL_CLIPS} clips, "
              f"{decode.steps} decode steps) {spy.eval_ms(2):.3f} ms", flush=True)
        spy.release()
        keep_saved_model(tmp / "run", saved_to)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"(w') done in {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# Phase (x): the evaluation set, the LM and the dataset QA on (w)'s run-C
# directory, the demo, and Whisper's evaluation on (w')'s directory.
EVAL_DATASET = "synthetic://16"
WHISPER_EVAL_DATASET = "synthetic://8"
LM_DECODER_DATASET = "synthetic://256"
DEMO_SECONDS = (4.0, 25.0)
CLI_TIMEOUT_S = 300


class PredictorSpy:
    """Wraps ``load_saved_predictor`` of ``evaluation.evaluate`` for the
    runs inside ``with``: keeps the predictors it built and the raw strings
    each returned, a list a predictor."""

    def __enter__(self):
        from coral_tpu_torch.evaluation import evaluate as E

        self._orig = E.load_saved_predictor
        self.predictors, self.strings = [], []

        def load(*args, **kwargs):
            predict, geometry = self._orig(*args, **kwargs)
            self.predictors.append(predict)
            strings = []
            self.strings.append(strings)

            def recorded(batch):
                out = predict(batch)
                strings.extend(out)
                return out
            return recorded, geometry

        E.load_saved_predictor = load
        return self

    def __exit__(self, *exc) -> None:
        from coral_tpu_torch.evaluation import evaluate as E

        E.load_saved_predictor = self._orig


class Command:
    """``python -m coral_tpu_torch <args>`` started from ``cwd`` (the
    repository on its path; the card, as by default), its standard input
    read from ``stdin`` and its streams written to files; ``wait`` gives its
    wall seconds and standard output, or fails with its errors' tail."""

    def __init__(self, label: str, cwd: Path, args: list[str], stdin: str = "") -> None:
        import os

        self.label, self.name = label, args[0]
        self.out, self.err = (cwd / f"{label.strip('()x ').replace(' ', '_')}.{part}"
                              for part in ("stdout", "stderr"))
        source = cwd / f"{self.out.stem}.stdin"
        source.write_text(stdin, encoding="utf-8")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
        with source.open() as i, self.out.open("w") as o, self.err.open("w") as e:
            self.start = time.perf_counter()
            self.proc = subprocess.Popen([sys.executable, "-m", "coral_tpu_torch", *args],
                                         cwd=cwd, env=env, stdin=i, stdout=o, stderr=e)
        # A thread notes when the process ends, whatever the caller does then.
        self.end = None
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self) -> None:
        self.proc.wait()
        self.end = time.perf_counter()

    def wait(self) -> tuple[float, str]:
        self.watcher.join(timeout=max(0.0, self.start + CLI_TIMEOUT_S - time.perf_counter()))
        if self.end is None:
            self.proc.kill()
            self.proc.wait()
            fail(f"{self.label}: python -m coral_tpu_torch {self.name} ran over "
                 f"{CLI_TIMEOUT_S} s")
        wall, code = self.end - self.start, self.proc.returncode
        if code != 0:
            fail(f"{self.label}: python -m coral_tpu_torch {self.name} exited {code}: "
                 f"{self.err.read_text()[-1500:]}")
        return wall, self.out.read_text(encoding="utf-8")


def counted_evaluate(config) -> tuple[object, dict, float, PredictorSpy]:
    """``evaluate(config, device="cuda")`` with the launch counts set to 0
    before and read after: its grid, the counts, its wall seconds and the
    predictor it built."""
    from coral_tpu_torch.evaluation.evaluate import evaluate
    from coral_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with PredictorSpy() as spy:
        start = time.perf_counter()
        grid = evaluate(config, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return grid, dict(_build.launch_counts), wall, spy


def overall_row(grid) -> dict:
    row = grid[grid[["age_group", "gender", "dialect"]].isna().all(axis=1)]
    if len(row) != 1:
        fail(f"(x): the grid has {len(row)} overall rows")
    return row.iloc[0].to_dict()


def write_wav(path: Path, audio: np.ndarray, rate: int) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


def evaluation_run(card: str, root: Path) -> dict:
    """Phase (x) on ``root``'s ``wav2vec2-small`` ((w)'s run C) and
    ``whisper-small`` ((w')) saved directories, through the port's entry
    points: the LM trained by the ``train-ngram`` command into the former
    (loaded from ARPA and binary at order 3); ``evaluate`` in-process with
    ``no_lm`` (exact launches: the serving forward's a batch; its overall
    CER/WER those of a fresh ``load_saved_predictor``'s strings on the same
    stream, re-normalised), and that stream's forward against the LM's host
    decode; then four commands at once: ``evaluate`` with the LM and 200
    bootstrap samples and with ``no_lm`` (its overall row the in-process
    one), ``validate`` at max_cer 1e9 (its predictions the in-process
    ``add_validations`` strings, lower-cased) and ``demo``'s stdin loop on a
    4 s and a 25 s WAV (its lines ``make_transcriber``'s); beside them
    ``add_validations`` in-process at max_cer 0.6 (kept plus dropped the
    filtered rows), ``make_transcriber`` on the WAVs and ``evaluate`` on
    Whisper with ``generation_max_length`` 32 (exact launches a batch and
    decode step). Validation runs greedy (``+no_lm=true``): the LM's host
    decode is timed on the evaluation set. Returns the launch counts of the
    two in-process ``evaluate`` runs."""
    import importlib.util
    import logging

    import pandas as pd

    from coral_tpu_torch.cli import make_transcriber, read_wav, results_filename
    from coral_tpu_torch.config import compose
    from coral_tpu_torch.data.loading import load_dataset_for_evaluation, make_raw_source
    from coral_tpu_torch.data.processing import filter_example, process_example
    from coral_tpu_torch.data.validation import add_validations
    from coral_tpu_torch.decoding import NGramModel
    from coral_tpu_torch.evaluation.eval_loop import batch_for_eval
    from coral_tpu_torch.evaluation.evaluate import load_saved_predictor
    from coral_tpu_torch.evaluation.metrics import cer, wer

    t0 = time.perf_counter()
    root = root.resolve()  # the commands run from it, and read paths under it
    w2v2, whisper = root / "wav2vec2-small", root / "whisper-small"
    cache = root / "cache"
    walls = {}
    for saved in (w2v2, whisper):
        if not (saved / "config.yaml").exists():
            fail(f"(x): no saved model in {saved}; {root} holds "
                 f"{sorted(str(p.relative_to(root)) for p in root.rglob('*'))[:20]}")

    # The LM, by the train-ngram command.
    walls["train-ngram"], _ = Command("(x) train-ngram", root, [
        "train-ngram", "model=wav2vec2-small", "decoder_datasets=[]",
        f"+decoder_datasets.synthetic={{id: {LM_DECODER_DATASET}}}",
        f"+decoder_excision_dataset={EVAL_DATASET}", f"cache_dir={cache}",
        f"model_dir={w2v2}"]).wait()
    arpa = w2v2 / "3gram.arpa"
    if not (arpa.exists() and arpa.with_suffix(".bin").exists()):
        fail("(x) train-ngram: no 3gram.arpa and 3gram.bin beside the model")
    orders = [NGramModel(path).order for path in (arpa, arpa.with_suffix(".bin"))]
    corpus = next(cache.glob("ngram-sentences-*.txt")).read_text(encoding="utf-8").split("\n")
    header = [line for line in arpa.read_text(encoding="utf-8").splitlines()
              if line.startswith("ngram ")]
    print(f"(x) LM by `python -m coral_tpu_torch train-ngram` ({card}): "
          f"{walls['train-ngram']:.2f} s wall; {LM_DECODER_DATASET} less every sentence of "
          f"{EVAL_DATASET}: {len(corpus)} corpus lines, {sum(map(bool, corpus))} not empty; "
          f"{arpa.name} {arpa.stat().st_size} B ({', '.join(header)}), .bin "
          f"{arpa.with_suffix('.bin').stat().st_size} B; orders {orders}", flush=True)
    if orders != [3, 3]:
        fail(f"(x): the trained LM loads at orders {orders}, not 3")

    # evaluate in-process, greedy (no_lm).
    overrides = [f"model_id={w2v2}", f"dataset={EVAL_DATASET}", f"batch_size={BATCH}",
                 f"cache_dir={cache}"]
    config = compose("evaluation", overrides=overrides + ["no_lm=true"])
    grid, counts, eval_s, spy = counted_evaluate(config)
    cfg = spy.predictors[0].model.config
    batches = -(-len(spy.strings[0]) // BATCH)
    expected = {k: v * batches for k, v in w2v2_forward_launches(cfg).items()}
    overall = overall_row(grid)
    print(f"(x) evaluate in-process, no_lm ({card}): {eval_s:.2f} s for {len(spy.strings[0])} "
          f"clips in {batches} batches (hidden {cfg.hidden_size}, {cfg.num_hidden_layers} "
          f"layers); grid {len(grid)} rows, overall CER {overall['cer']:.6f} WER "
          f"{overall['wer']:.6f}; launch counts {counts}", flush=True)
    if counts != expected:
        fail(f"(x) evaluate: launch counts {counts}, expected {expected}")
    total = collections.Counter(counts)

    # The same stream through a fresh predictor, re-normalised and scored;
    # with the LM beside it, the forward against the host's beam search.
    texts, raw, times = [], [], {"greedy": [], "lm forward": [], "lm decode": []}
    greedy, geometry = load_saved_predictor(config, device="cuda")
    beam, _ = load_saved_predictor(dict(config, no_lm=False), device="cuda")
    lm_start = time.perf_counter()
    for batch, chunk in batch_for_eval(load_dataset_for_evaluation(config)(), BATCH,
                                       **geometry):
        start = time.perf_counter()
        raw += greedy(batch)[: len(chunk)]
        times["greedy"].append(time.perf_counter() - start)
        start = time.perf_counter()
        log_probs, frames = beam.log_probs(batch)
        times["lm forward"].append(time.perf_counter() - start)
        start = time.perf_counter()
        beam.decode(log_probs, frames)
        times["lm decode"].append(time.perf_counter() - start)
        texts += chunk
    stream_s = time.perf_counter() - lm_start
    normed = [process_example({"text": r}, characters_to_keep=config.characters_to_keep,
                              text_column="text", audio_column=None, lower_case=True,
                              convert_numerals=True)["text"] for r in raw]
    scores = (cer(predictions=normed, labels=texts), wer(predictions=normed, labels=texts))
    ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    print(f"(x) the stream through a fresh load_saved_predictor ({card}): the evaluate run's "
          f"strings {raw == spy.strings[0]}; CER/WER {scores[0]:.6f} / {scores[1]:.6f} "
          f"(the grid's overall {overall['cer']:.6f} / {overall['wer']:.6f}); per batch of "
          f"{BATCH} (median of {batches}): greedy {ms['greedy']:.3f} ms, with the LM forward "
          f"{ms['lm forward']:.3f} ms against host decode {ms['lm decode']:.3f} ms "
          f"({ms['lm decode'] / ms['lm forward']:.3f}x); both over the set {stream_s:.2f} s",
          flush=True)
    if raw != spy.strings[0] or scores != (overall["cer"], overall["wer"]):
        fail("(x) evaluate: the grid's overall CER/WER are not its predictor's strings' scores")
    del greedy, beam, spy

    # Four commands at once.
    rng = np.random.default_rng(0)
    wavs = []
    for seconds in DEMO_SECONDS:
        path = root / f"demo_{seconds:g}s.wav"
        write_wav(path, rng.standard_normal(int(seconds * SR)) * 0.1, SR)
        wavs.append(path)
    val_overrides = [f"dataset={EVAL_DATASET}", f"model_id={w2v2}", "+no_lm=true"]
    gradio = importlib.util.find_spec("gradio") is not None
    commands = {
        "evaluate lm": Command("(x) evaluate lm", root,
                               ["evaluate", *overrides, "bootstrap_samples=200"]),
        "evaluate no-lm": Command("(x) evaluate no-lm", root,
                                  ["evaluate", *overrides, "no_lm=true"]),
        "validate": Command("(x) validate", root, [
            "validate", *val_overrides, "max_cer=1e9", f"output_path={root / 'validated'}"]),
    }
    if not gradio:
        commands["demo"] = Command("(x) demo", root, ["demo", f"model_id={w2v2}"],
                                   stdin="".join(f"{path}\n" for path in wavs))

    # Beside them: add_validations at 0.6, the demo's transcriber, Whisper.
    val_config = compose("dataset_validation", overrides=val_overrides)
    raw_source = make_raw_source(EVAL_DATASET, None, split="train")
    filtered = sum(filter_example(ex, "audio", "text", 0.25, 3600) for ex in raw_source())
    predict, _ = load_saved_predictor(val_config, device="cuda")
    strings, lines = [], []

    def recorded(batch):
        out = predict(batch)
        strings.extend(out)
        return out

    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    data_logger = logging.getLogger("coral_tpu_torch.data")
    data_logger.addHandler(handler)
    data_logger.setLevel(logging.INFO)
    start = time.perf_counter()
    try:
        kept_rows = list(add_validations(
            raw_source(), predictor=recorded, model_id=str(w2v2),
            characters_to_keep=val_config.characters_to_keep,
            batch_size=int(val_config.batch_size), max_cer=float(val_config.max_cer),
            max_pad_seconds=float(val_config.max_seconds_per_example)))
    finally:
        data_logger.removeHandler(handler)
    validate_s = time.perf_counter() - start
    found = [m for m in (re.match(r"Validation kept ([\d,]+) samples, dropped ([\d,]+)", line)
                         for line in lines) if m]
    kept, dropped = ((int(g.replace(",", "")) for g in found[-1].groups()) if found
                     else (-1, -1))
    del predict, recorded

    start = time.perf_counter()
    transcribe = make_transcriber(compose("demo", overrides=[f"model_id={w2v2}"]), "cuda")
    demo_lines = [transcribe(read_wav(str(path))) for path in wavs]
    demo_s = time.perf_counter() - start
    del transcribe

    w_config = compose("evaluation", overrides=[
        f"model_id={whisper}", f"dataset={WHISPER_EVAL_DATASET}", f"batch_size={BATCH}",
        f"cache_dir={cache}", f"generation_max_length={WHISPER_FINETUNE_MAX_LENGTH}"])
    with DecodeSpy() as decode:
        w_grid, w_counts, w_s, w_spy = counted_evaluate(w_config)
    wcfg = w_spy.predictors[0].model.config
    D, Le, Ld = wcfg.d_model, wcfg.encoder_layers, wcfg.decoder_layers
    w_batches = -(-len(w_spy.strings[0]) // BATCH)
    w_expected = {"flash_attention": Le * w_batches, block_kernels(wcfg, D)[0]: Le * w_batches,
                  "decode_self_attention": Ld * decode.steps,
                  "decode_cross_attention": Ld * decode.steps}
    w_overall = overall_row(w_grid)
    del w_spy

    outputs = {}
    for name, command in commands.items():
        walls[name], outputs[name] = command.wait()

    # The commands' results against the in-process ones.
    print(f"(x) add_validations in-process at max_cer {val_config.max_cer}, greedy ({card}): "
          f"{validate_s:.2f} s, kept {kept} + dropped {dropped} of {filtered} filtered rows "
          f"({len(kept_rows)} yielded)", flush=True)
    if kept + dropped != filtered or kept != len(kept_rows) or len(strings) != filtered:
        fail(f"(x) add_validations: kept {kept} + dropped {dropped} != {filtered} filtered rows")
    rows = [json.loads(line) for line in
            (root / "validated" / "validated.jsonl").read_text(encoding="utf-8").splitlines()]
    same = [r["asr_prediction"] for r in rows] == [t.lower().strip() for t in strings]
    print(f"(x) `python -m coral_tpu_torch validate` at max_cer 1e9 ({card}): {len(rows)} rows, "
          f"their asr_prediction the in-process strings lower-cased: {same}", flush=True)
    if not same:
        fail("(x) validate: the command's predictions are not the in-process strings")

    csvs = {}
    for name, extra in (("evaluate lm", ["bootstrap_samples=200"]),
                        ("evaluate no-lm", ["no_lm=true"])):
        path = root / results_filename(compose("evaluation", overrides=overrides + extra))
        if not path.exists():
            fail(f"(x) {name}: {path.name} was not written")
        csvs[name] = overall_row(pd.read_csv(path, float_precision="round_trip"))
    lm_row, no_lm_row = csvs["evaluate lm"], csvs["evaluate no-lm"]
    print(f"(x) `python -m coral_tpu_torch evaluate` ({card}): with the LM, overall CER "
          f"{lm_row['cer']:.6f} [{lm_row['cer_ci_low']:.6f}, {lm_row['cer_ci_high']:.6f}] WER "
          f"{lm_row['wer']:.6f}; no_lm {no_lm_row['cer']:.6f} / {no_lm_row['wer']:.6f} "
          f"(in-process {overall['cer']:.6f} / {overall['wer']:.6f})", flush=True)
    if (no_lm_row["cer"], no_lm_row["wer"]) != (overall["cer"], overall["wer"]):
        fail("(x) evaluate: the no_lm command's overall row is not the in-process one")
    if not lm_row["cer_ci_low"] <= lm_row["cer"] <= lm_row["cer_ci_high"]:
        fail("(x) evaluate: the LM's overall CER lies outside its bootstrap interval")

    if gradio:
        print(f"(x) demo ({card}): gradio imports here, so the command would serve a page; "
              f"make_transcriber called directly instead: {demo_s:.2f} s for {DEMO_SECONDS} s "
              f"WAVs, {[len(t) for t in demo_lines]} characters", flush=True)
    else:
        got = outputs["demo"].splitlines()
        print(f"(x) `python -m coral_tpu_torch demo`, stdin loop ({card}): its lines "
              f"make_transcriber's ({demo_s:.2f} s in-process for {DEMO_SECONDS} s WAVs, with "
              f"the LM): {got == demo_lines} ({[len(t) for t in got]} characters)", flush=True)
        if got != demo_lines:
            fail("(x) demo: the command's lines are not make_transcriber's")

    print(f"(x) evaluate in-process, whisper-small (d {D}, {Le} + {Ld} layers, "
          f"generation_max_length {WHISPER_FINETUNE_MAX_LENGTH}) ({card}): {w_s:.2f} s for "
          f"{WHISPER_EVAL_DATASET}, {decode.steps} decode steps; overall CER "
          f"{w_overall['cer']:.6f} WER {w_overall['wer']:.6f}; launch counts {w_counts}",
          flush=True)
    if w_counts != w_expected:
        fail(f"(x) Whisper evaluate: launch counts {w_counts}, expected {w_expected}")
    total.update(w_counts)
    print(f"(x) command walls ({card}; train-ngram alone, the rest started together): " +
          ", ".join(f"{name} {secs:.2f} s" for name, secs in walls.items()), flush=True)
    print(f"(x) done in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(total)


def main() -> int:
    t0 = time.perf_counter()

    def mark(phase: str) -> None:
        print(f"[{time.perf_counter() - t0:.1f} s] {phase} done", flush=True)

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, allow_tf32 matmul/cudnn False/False", flush=True)

    from concurrent.futures import ThreadPoolExecutor

    from coral_tpu_torch import decoding
    from coral_tpu_torch.ops import _build

    print(run([_build._nvcc(), "--version"]).splitlines()[-1], flush=True)
    start = time.perf_counter()
    # The native decoder (phase (t)) builds with g++ beside the kernels.
    with ThreadPoolExecutor(1) as pool:
        decoder = pool.submit(lambda: (decoding.build_native_library(),
                                       time.perf_counter() - start))
        _build.library()
        print(f"kernels built and loaded in {time.perf_counter() - start:.2f} s "
              f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'}"
              f" s)", flush=True)
        decoder_lib, decoder_s = decoder.result()
    print(f"native decoder {decoder_lib.name} ready {decoder_s:.2f} s after the start "
          f"(g++ started beside nvcc)", flush=True)
    if _build.source_seconds:
        print("  nvcc seconds by source (all started together): " + ", ".join(
            f"{name} {secs:.1f}" for name, secs in sorted(_build.source_seconds.items(),
                                                         key=lambda kv: -kv[1])), flush=True)
    for path in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        lines = path.read_text().splitlines()
        used = [line.split(":", 1)[1].strip() for line in lines if "Used" in line]
        spills, function = [], ""
        for line in lines:
            if "Function properties for" in line:
                function = line.split("Function properties for", 1)[1].strip()
            elif "spill" in line and " 0 bytes spill" not in line:
                spills.append(f"{function[:80]}: {line.strip()}")
        print(f"  ptxas, {len(used)} kernels: {'; '.join(used)}; spills: {spills or 'none'}",
              flush=True)
        for line in mainloop_registers(lines):
            print(f"  {line}", flush=True)
    ln_host_split(card)

    print(f"kernel checks at serving shapes (bf16, batch {BATCH}):", flush=True)
    checks = kernel_checks(card)
    print(f"kernel checks at training shapes (bf16, batch {BATCH} x 10 s):", flush=True)
    checks.update(train_kernel_checks(card))
    print(f"kernel checks at Whisper serving shapes (bf16, batch {BATCH} x 30 s, "
          f"whisper-large-v3):", flush=True)
    checks.update(whisper_kernel_checks(card))
    print(f"kernel checks at Whisper training shapes (bf16, batch {BATCH} x 30 s, "
          f"whisper-large-v3):", flush=True)
    checks.update(whisper_train_kernel_checks(card))
    print(f"kernel checks at the other configs' widths (bf16, batch {BATCH}: XLS-R-1B, -2B, "
          f"Whisper tiny, base, small):", flush=True)
    checks.update(width_kernel_checks(card))
    print(f"kernel checks of the unfused routes (bf16, batch {BATCH}: the flash attention with "
          f"segment ids at XLS-R-300M's, -1B's and -2B's head_dim 64, 80 and 120, GELU + "
          f"dropout at F 4096 and 5120):", flush=True)
    checks.update(unfused_kernel_checks(card))
    print(f"kernel checks of fc1 without the block or the folded LayerNorm (bf16, batch "
          f"{BATCH}: N1-N4 at XLS-R-300M's and Whisper large-v3's shapes, at D 384 and 1920):",
          flush=True)
    checks.update(fc1_kernel_checks(card))
    print(f"kernel checks of the LayerNorm-folded block's variants (bf16, batch {BATCH}: N5-N7 "
          f"at XLS-R-300M's and Whisper large-v3's shapes, at D 384, 512, 768 and 1920):",
          flush=True)
    checks.update(block_variant_checks(card))
    print(f"kernel checks of the packed QKV projection and the attention without biases "
          f"(bf16, batch {BATCH}: XLS-R-300M's shapes, D 1280 and 1920):", flush=True)
    checks.update(qkv_kernel_checks(card))
    print(f"kernel checks of the attention's other routes (bf16, batch {BATCH}: the forwards "
          f"at 1499 rows, the backwards at 499, head_dim 64, 80 and 120):", flush=True)
    checks.update(variant_kernel_checks(card))
    map_encode_us(card)
    mark("kernel checks")
    print(f"the H100 probes (bf16: the K3 backward's modes at batch {BATCH} x 10 s, FE blocks 1 "
          f"and 5; gelu_cost and lane_reduce checked at {PROBE_CHECK_STEPS} steps, timed at "
          f"the probes' own):", flush=True)
    checks.update(probe_checks(card))
    mark("probes")
    bad = [name for name, res in checks.items() if not res["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    torch.cuda.empty_cache()

    serve_counts, _ = serving_run(card)
    torch.cuda.empty_cache()
    mark("serving")
    lm_counts = checkpoint_lm_run(card)
    mark("(t) XLS-R-300M from a checkpoint with an n-gram LM")
    train_counts = training_run(card)
    torch.cuda.empty_cache()
    mark("training (a)-(c)")
    whisper_counts = whisper_run(card)
    torch.cuda.empty_cache()
    mark("Whisper serving (d)")
    whisper_ckpt_counts = whisper_checkpoint_run(card)
    mark("(u) Whisper large-v3 from a checkpoint")
    whisper_beam_counts = whisper_beam_run(card)
    mark("(v) Whisper beam search, timestamps, long-form, run_validation")
    whisper_train_counts = whisper_train_run(card)
    torch.cuda.empty_cache()
    mark("Whisper training (e)")
    main_counts = [serve_counts, train_counts, whisper_counts, whisper_train_counts,
                   lm_counts, whisper_ckpt_counts, whisper_beam_counts]
    # (f) XLS-R-2B's production fine-tune, (f') its serving.
    main_counts.append(xlsr_train_run(card, "(f)", W2V2_LARGE_CONFIG, "xls_r_2b", TRAIN_STEPS,
                                      XLSR_2B_COMPARE_LAYERS, falling=True,
                                      warmup=FINETUNE_WARMUP_STEPS))
    mark("XLS-R-2B training (f)")
    main_counts.append(serving_run(card, XLSR_2B_ID, (1920, 48, 16), "serving (f')",
                                   long_clip=False, reps=(3, 1, 2))[0])
    torch.cuda.empty_cache()
    mark("XLS-R-2B serving (f')")
    # (g) XLS-R-1B (wav2vec2-medium.yaml): serving, then a few train steps.
    main_counts.append(serving_run(card, XLSR_1B_ID, (1280, 48, 16), "serving (g)",
                                   long_clip=False, reps=(3, 1, 2))[0])
    torch.cuda.empty_cache()
    main_counts.append(xlsr_train_run(card, "(g)", W2V2_MEDIUM_CONFIG, "xls_r_1b", FEW_STEPS,
                                      None, falling=False))
    mark("XLS-R-1B (g)")
    # (h), (i): whisper-small, -xsmall, -xxsmall and test-whisper.
    for size in WHISPER_SIZES:
        main_counts.append(whisper_size_run(card, *size))
        mark(f"{size[0]} {size[1]}")
    # (j), (j'), (k): the unfused routes.
    main_counts.append(route_run(card, "(j)", UNFUSED_FLASH_CONFIG, "unfused", TRAIN_STEPS, 2,
                                 True))
    mark("(j) flash attention, unfused FFN")
    main_counts.append(route_run(card, "(j')", UNFUSED_XLA_CONFIG, "unfused", ROUTE_STEPS, 1,
                                 False))
    mark("(j') xla attention, unfused FFN")
    main_counts.append(whisper_train_run(card, "(k)", WHISPER_UNFUSED_CONFIG,
                                         WHISPER_UNFUSED_PER_MICROBATCH, ROUTE_STEPS,
                                         falling=False, route="unfused"))
    torch.cuda.empty_cache()
    mark("(k) Whisper large-v3, unfused FFN")
    # (l), (l'), (m): the FFN without the folded LayerNorm or the block.
    main_counts.append(route_run(card, "(l)", LN_APART_CONFIG, "ffn_block", ROUTE_STEPS, 1,
                                 True))
    mark("(l) fused_ffn_ln: false, the LayerNorm-less block")
    main_counts.append(route_run(card, "(l')", FC1_CONFIG, "ffn_fc1", ROUTE_STEPS, 1, False))
    mark("(l') fused_ffn_ln and fused_ffn_block false, fc1 alone")
    main_counts.append(whisper_train_run(card, "(m)", WHISPER_FC1_CONFIG,
                                         WHISPER_FC1_PER_MICROBATCH, ROUTE_STEPS, falling=False,
                                         route="ffn_ln_fc1"))
    torch.cuda.empty_cache()
    mark("(m) Whisper large-v3, fused_ffn_block: false")
    # (n)-(o'): the LayerNorm-folded block's variants.
    main_counts.append(route_run(card, "(n)", FC2_CONFIG, "ffn_ln_block", ROUTE_STEPS, 1,
                                 True))
    mark("(n) fused_ffn_block_fc2: true")
    main_counts.append(route_run(card, "(n')", DW_CONFIG, "ffn_ln_block", ROUTE_STEPS, 0,
                                 True))
    mark("(n') fused_ffn_block_dw: true")
    main_counts.append(route_run(card, "(n'')", DG_OUT_CONFIG, "ffn_ln_block", ROUTE_STEPS, 0,
                                 False))
    mark("(n'') fused_ffn_block_dg: false")
    main_counts.append(whisper_train_run(card, "(o)", WHISPER_DW_CONFIG,
                                         WHISPER_DW_PER_MICROBATCH, ROUTE_STEPS, falling=False))
    torch.cuda.empty_cache()
    mark("(o) Whisper large-v3, fused_ffn_block_dw: true")
    main_counts.append(whisper_size_run(card, "(o')", "whisper-large", WHISPER_ID, 1e-6,
                                        {"fused_ffn_block_fc2": True}, (1280, 32, 32, 20, 5120),
                                        2))
    mark("(o') Whisper large-v3, fused_ffn_block_fc2: true")
    # (p), (p'): the packed QKV projection, the attention without biases.
    main_counts.append(route_run(card, "(p)", QKV_LN_CONFIG, "ffn_ln_block", ROUTE_STEPS, 1,
                                 True))
    mark("(p) fused_qkv_ln: true")
    main_counts.append(route_run(card, "(p')", QKV_BIAS_OFF_CONFIG, "ffn_ln_block", ROUTE_STEPS,
                                 1, True))
    mark("(p') attention_fused_qkv_bias: false")
    # (q)-(r'): the attention's other routes.
    for label, config, serve in VARIANT_PHASES:
        main_counts.append(route_run(card, label, config, "ffn_ln_block", ROUTE_STEPS, serve,
                                     True))
        mark(f"{label} attention_save_stats: {config['model']['attention_save_stats']}, "
             f"attention_o_residual: {config['model'].get('attention_o_residual', False)}")
    # (s), (s'): the flash route at XLS-R-1B's and -2B's head dims.
    main_counts.append(route_run(card, "(s)", FLASH_1B_CONFIG, "ffn_ln_block", ROUTE_STEPS, 1, True,
                                 arch=(1280, 48), compare_layers=XLSR_2B_COMPARE_LAYERS))
    mark("(s) XLS-R-1B, attention_impl: flash")
    main_counts.append(route_run(card, "(s')", FLASH_2B_CONFIG, "ffn_ln_block", ROUTE_STEPS, 1, True,
                                 arch=(1920, 48), compare_layers=XLSR_2B_COMPARE_LAYERS))
    mark("(s') XLS-R-2B, attention_impl: flash")
    # (y)-(z''): wav2vec2-base, post-LN, the feature encoder's conv apart
    # with its replay, the plain encoder LayerNorms under dots_saveable.
    main_counts.append(route_run(card, "(y)", BASE_CONFIG, "ffn_block", BASE_STEPS, 1, True,
                                 arch=(768, 12)))
    mark("(y) wav2vec2-base: group norm, post-LN, hidden 768")
    main_counts.append(route_run(card, "(z)", POST_LN_CONFIG, "ffn_block", ROUTE_STEPS, 1,
                                 True))
    mark("(z) do_stable_layer_norm: false")
    main_counts.append(route_run(card, "(z')", FE_APART_CONFIG, "ffn_ln_block", ROUTE_STEPS, 1,
                                 True))
    mark("(z') fused_fe_conv: false, remat_feature_encoder: true")
    main_counts.append(route_run(card, "(z'')", LN_XLA_DOTS_CONFIG, "ffn_ln_block",
                                 ROUTE_STEPS, 1, True))
    mark("(z'') encoder_ln_impl: xla, remat_policy: dots_saveable")
    main_counts.append(route_run(card, "(c remat)", REMAT_FE_CONFIG, "ffn_ln_block",
                                 ROUTE_STEPS, 0, True))
    mark("(c remat) remat_feature_encoder: true")
    main_counts.append(route_run(card, "(z' no remat)", FE_APART_KEPT_CONFIG, "ffn_ln_block",
                                 ROUTE_STEPS, 0, False))
    mark("(z' no remat) fused_fe_conv: false")
    # (w), (w'): fine-tuning through the port's loop (finetune), composed by
    # its config composer.
    # (x) takes over their saved directories.
    import shutil
    import tempfile

    saved = Path(tempfile.mkdtemp(prefix="chip_smoke_x_"))
    try:
        main_counts.append(finetune_run(card, saved_to=saved / "wav2vec2-small"))
        mark("(w) finetune: wav2vec2-small, resume, saved model served")
        main_counts.append(whisper_finetune_run(card, saved_to=saved / "whisper-small"))
        mark("(w') finetune: whisper-small, saved model served")
        # (x): evaluation, the LM, validation and the demo through the
        # port's entry points.
        main_counts.append(evaluation_run(card, saved))
        mark("(x) evaluate, train-ngram, validate, demo")
    finally:
        shutil.rmtree(saved, ignore_errors=True)
    for label, base in (("(p)", "(c)"), ("(p')", "(c)"),
                        *((phase[0], "(c)") for phase in VARIANT_PHASES),
                        ("(s)", "(g)"), ("(s')", "(f)"), ("(z)", "(c)"), ("(z')", "(c)"),
                        ("(z'')", "(c)"), ("(c remat)", "(c)"), ("(z' no remat)", "(c)")):
        print(f"training {label} ({card}): {STEP_MS[label]:.3f} ms per optimizer step against "
              f"{base}'s {STEP_MS[base]:.3f} ms in this run ({STEP_MS[label] / STEP_MS[base]:.4f}"
              f"x)", flush=True)
    for label, base in (("(z)", "(c)"), ("(z')", "(c)"), ("(z'')", "(c)"),
                        ("(c remat)", "(c)"), ("(z' no remat)", "(c)"),
                        ("(z')", "(z' no remat)")):
        print(f"training {label} ({card}): forward and backward peak "
              f"{FWD_BWD_PEAK_GIB[label]:.3f} GiB above the step's start against {base}'s "
              f"{FWD_BWD_PEAK_GIB[base]:.3f} GiB in this run "
              f"({FWD_BWD_PEAK_GIB[label] / FWD_BWD_PEAK_GIB[base]:.4f}x)",
              flush=True)
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "coral_tpu", "safetensors", "transformers"))
    if imported:
        fail(f"the port imported jax, the JAX package, safetensors or transformers: "
             f"{imported[:5]}")
    rows = {name: res for name, res in checks.items() if name in SOURCES}
    counts = {name: sum(c.get(name, 0) for c in main_counts) for name in rows}
    # The probes run on no main path; every other kernel must have.
    idle = [name for name, n in counts.items() if n == 0 and not name.startswith("probe_")]
    if idle:
        fail(f"kernels never launched on a main path: {idle}")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name],
         "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
         "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
         "library_ms": res["library_ms"], "device_ms": res["device_ms"],
         "library_device_ms": res["library_device_ms"]}
        for name, res in rows.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
