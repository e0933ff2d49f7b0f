#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``emo_disentanger_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``emo_disentanger_tpu_torch/csrc`` and
holds each against its plain PyTorch version at the main paths' shapes, then
drives nine paths at full width with random weights from a seed.  Three run
the flagship stage-2 Performer (12 layers, 8 heads, d_model 512, d_ff 2048,
128 FAVOR+ features):

* serving: the forward at B=2, L=1024, an f32 decode that must reproduce
  the forward's logits, and ``Stage2BatchGenerator.serve`` over 24 jobs in
  16 slots with bf16 weights;
* training: full-model gradients through the kernels against the plain
  path, ``train_stage2.run`` on a synthetic corpus with the values of
  ``configs/stage2/pop1k7_pretrain.yaml`` (f32, B=4, L=3072), bf16 steps at
  B=16, L=3072, and a fixed batch whose loss must fall;
* heads_last_training: the same model in the heads-last attention layout
  (``EMODIS_HL_ATTN=1``), whose FAVOR+ kernels read q, k, v [B, L, D] in
  place: its gradients against the head-major model's on the same weights,
  ``train_stage2.run`` at the same config, bf16 steps beside the head-major
  ones, and a fixed batch whose loss must fall.

Two run the stage-2 GPT-2 of ``configs/stage2/pop1k7_pretrain_gpt2.yaml``
(12 layers, 8 heads, d_model 512, d_ff 2048):

* gpt2_training: ``train_stage2.run`` at the config's values (f32, B=4,
  L=2048, two micro-batches an update), whose validation forwards launch
  the flash-attention kernel and whose train steps (attention dropout) do
  not, then a fixed batch whose loss must fall;
* gpt2_serving: with bf16 weights, ``serve`` over 24 jobs in 16 slots whose
  songs outgrow the 4096-position cache and re-anchor over a 2048-token
  window, the lockstep ``generate`` through the (1024, 2048) cache ladder,
  one host-driven ``Stage2Generator`` song that re-anchors, and the
  reference-exact replay past its 2048-token window.  Before it, the f32
  forward with the flash-attention kernel is held against the einsum path
  and the KV-cache decode against the forward.

The sixth, composed_attention, runs the composed FAVOR+ attention of the
port's public ops, ``causal_linear_attention(favor_features(q),
favor_features(k), v)``, forward and backward at the training shape (B=16,
H=8, L=3072, Dh=64, M=128, f32) through kernels #5-#7 of
``csrc/linear_attn.cu``, and holds its output and gradients against the
fused ``favor_causal_attention``.

Two run the stage-1 Transformer-XL of ``configs/stage1/emopia_finetune.yaml``
(12 layers, 8 heads, d_model 512, d_ff 2048) over a synthetic functional
lead-sheet vocabulary.  No TPU kernel lies on them: their attention is
einsums in the JAX package too, and so in the port.

* stage1_serving: the f32 forward at B=4, L=512, the f32 decode of the same
  tokens through the chunked and the whole-cache attention against it, the
  per-element-clock decode against the whole-cache one; then, with bf16
  weights in ``infer/run_stage1.py``'s lead_sheet mode, the lockstep
  ``Stage1BatchGenerator.generate`` at B=16 through the 768 -> 1536 cache
  ladder, ``serve`` of 24 jobs in 16 slots and one ``Stage1Generator``
  song, every song held to the key-mode and beat rules;
* stage1_training: full-model f32 gradients, ``train_stage1.run`` at the
  config's values (f32, B=4, L=512) for 3 steps, a fixed batch whose loss
  must fall, and a segmented step with 512 memories over two segments.

The ninth, two_stage_generation, runs the user's commands end to end over
YAML copies of both stages' ``emopia_finetune.yaml``: ``infer-stage1``
writes 16 lead sheets (``.mid``, ``.txt``, ``_roman.txt``), ``infer-stage2
-m performer`` renders each into two quadrants (32 ``_full.mid``, cut to 8
bars a job) through the decode-layer kernel, and ``evaluate`` scores them;
every file is checked, and a second ``infer-stage1`` must render nothing.

It checks that every kernel of each path was launched on it, times each
kernel, its plain version and its bound (and, for flash attention, PyTorch's
``scaled_dot_product_attention`` as a yardstick the port never calls, with
its error; for the decode layer, the profiler's device time beside the CUDA
events, which at its speed also time the wrapper's host work),
profiles where a serving step's and a training step's time goes (a
training step in both attention layouts, a stage-1 serving step), and prints
one JSON line of kernel records, the card's name and power limit, and a last
line ``{"ok": true, "device": {...}}``.
Any failed check raises and the exit code is non-zero; without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""

import collections
import contextlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and arithmetic
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12

# flagship stage-2 Performer (__graft_entry__.py) and its serving batch (bench.py)
N_LAYER, N_HEAD, D_MODEL, D_FF, FAVOR = 12, 8, 512, 2048, 128
D_HEAD = D_MODEL // N_HEAD
ENTRY_B, ENTRY_L = 2, 1024
WINDOW_B, WINDOW_L = 16, 2048
SERVE_B = 16
# training: configs/stage2/pop1k7_pretrain.yaml (f32) and the bench.py:42
# train-step shape (bf16); the synthetic corpus's pieces run past TRAIN_L
TRAIN_B, TRAIN_L, TRAIN_BATCHES = 4, 3072, 3
BF16_B, BF16_STEPS = 16, 3
CORPUS_PIECES, CORPUS_BARS = 20, 32
# GPT-2 training: configs/stage2/pop1k7_pretrain_gpt2.yaml (f32, B=4,
# L=2048, accum_steps 2) over the same corpus
GPT2_TRAIN_L, GPT2_ACCUM, GPT2_TRAIN_BATCHES = 2048, 2, 4

# flagship stage-2 GPT-2 (configs/stage2/pop1k7_pretrain_gpt2.yaml) with
# max_len 4096, the MusicGPT2 default that train_stage2.py:57 uses; serving
# re-anchors the 4096-position cache over a 2048-token window (the generator
# defaults), so every re-anchor forward runs at L = GPT2_WINDOW
GPT2_MAX_LEN = 4096
GPT2_CACHE, GPT2_WINDOW, GPT2_MARGIN, GPT2_BAR_TOKENS = 4096, 2048, 256, 256
GPT2_EVENTS = 4160                  # songs pass the cache end: all re-anchor
GPT2_JOB_BARS = (32, 48)            # lead-sheet bars a job, so songs run long
GPT2_TIERS, GPT2_TIER_EVENTS = (1024, 2048), 1200
# the host generator's least legal cache, to keep its one song short
GPT2_HOST_CACHE = GPT2_WINDOW + GPT2_BAR_TOKENS + 2
GPT2_HOST_EVENTS = 2400
GPT2_DECODE_STEPS = 64
# stage 1: configs/stage1/emopia_finetune.yaml (tgt_len 512, batch_size 4)
# and infer/run_stage1.py's lead_sheet mode (temp 1.2, top_p 0.97,
# max_events 512; reject_slack 1024 and fast_slack 256, the generator
# defaults: the ladder 768 -> 1536; MAX_BARS 128), served at B=16
S1_B, S1_L = 4, 512
S1_TEMP, S1_TOP_P, S1_EVENTS, S1_MAX_BARS = 1.2, 0.97, 512, 128
S1_REJECT_SLACK, S1_FAST_SLACK = 1024, 256
S1_SERVE_B, S1_JOBS = 16, 24
# random weights give near-uniform logits, under which songs end at an EOS
# after ~150 events and a song needs ~1.07 iterations a token, so none
# outgrows the 768-row tier.  For serving, the head's EOS logit is lowered
# by S1_EOS_BIAS (songs run to max_events) and its Beat logits raised by
# S1_BEAT_BIAS (about half of the draws are beats, most of them rejected by
# the beat rule), so songs spill into the 1536-row tier
S1_BEAT_BIAS, S1_EOS_BIAS = 2.5, -30.0
# the serving profile: short songs (max_events 64) in a 1536-row cache,
# profiled over S1_PROFILE_STEPS steps after S1_PROFILE_SKIP
S1_PROFILE_EVENTS, S1_PROFILE_SKIP, S1_PROFILE_STEPS = 64, 16, 32
# two-stage generation: configs/stage1/emopia_finetune.yaml and
# configs/stage2/emopia_finetune.yaml at their values (f32), infer-stage1 in
# the lead_sheet mode for 8 groups (16 songs) and infer-stage2 -m performer
# over their 16 lead sheets (32 jobs), both --batch 16 --serve; stage 2 cut
# to 8 bars a job
TWO_STAGE_GROUPS, TWO_STAGE_BATCH, TWO_STAGE_BARS = 8, 16, 8
# the stage-1 head moved as in phase 5s, and its Bar_None logit raised so a
# lead sheet has bars of ~20 events (stage 2 injects at most 255 a bar); its
# Emotion_Positive / Emotion_Negative logits lowered, as a trained head never
# draws them after the first token and the stage-2 vocabulary lacks them
TWO_STAGE_BAR_BIAS, TWO_STAGE_EMOTION_BIAS = 3.0, -30.0
# a random Performer's head is nearly uniform over 327 events, and its
# hidden state follows the position more than the token (the embeddings are
# N(0, 0.01) under sinusoids of norm 16): a full-track note, Octave, Degree,
# Duration and Velocity in a row, would come up about once in 60 jobs, so no
# rendered performance would hold a note.  The path's Performer keeps its
# random layers; its token embeddings are rescaled to S2_EMB_OVER_PE times
# the sinusoids' norm and its head reads the current token through
# S2_GRAMMAR (the next events each event allows), at a logit of about
# S2_GRAMMAR_LOGIT for an allowed event and about 0 for the others
S2_EMB_OVER_PE, S2_GRAMMAR_LOGIT = 8.0, 10.0
S2_GRAMMAR = {
    'Track_Full': ['Beat_0'],
    **{f'Beat_{b}': ['Note_Octave_5'] for b in (0, 4, 8, 12)},
    'Note_Octave_5': [f'Note_Degree_{d}' for d in ('I', 'II', 'III', 'IV', 'V', 'VI', 'VII')],
    **{f'Note_Degree_{d}': ['Note_Duration_480']
       for d in ('I', 'II', 'III', 'IV', 'V', 'VI', 'VII')},
    'Note_Duration_480': ['Note_Velocity_64'],
    'Note_Velocity_64': ['Note_Octave_5', 'Beat_4', 'Beat_8', 'Beat_12',
                         'Track_LeadSheet'],
}
# the training corpus: 32-bar lead sheets of ~675 events (a sample fills L)
S1_CORPUS_PIECES, S1_CORPUS_BARS = 16, 32
# flash attention: the re-anchor shape and the smallest the dispatch sends
# (H = N_HEAD, Dh = D_HEAD), inputs at std FLASH_STD so softmax rows peak
FLASH_CASES = ((WINDOW_B, WINDOW_L), (2, 512))
FLASH_STD = 2.0

# pass A (#3, #10) while all its products ran as 4x4 f32 register tiles,
# read by this script on an NVIDIA H100 80GB HBM3 at 700.00 W: ms at B=16
# L=3072 bf16 (phases 6, 6h), ms a bf16 train step (7b, 7h), the step's wall
# (8b, 8h-b) and the largest bf16 error against the plain pass (2c); printed
# beside today's readings
SCALAR_PASS_A = {'favor_bwd_a': 6.0553, 'favor_bwd_a_hl': 6.2727,
                 'step head-major': 72.48, 'step heads-last': 74.90,
                 'wall head-major': 257.0, 'wall heads-last': 254.5,
                 'bf16 err': 8.3e-3}
# pass B (#4, #11) while all its products ran as 4x4 f32 register tiles,
# read by this script on the same card and limit (after pass A's redesign):
# the same readings, printed beside today's
SCALAR_PASS_B = {'favor_bwd_b': 5.7647, 'favor_bwd_b_hl': 5.5428,
                 'step head-major': 68.81, 'step heads-last': 66.03,
                 'wall head-major': 212.4, 'wall heads-last': 208.4,
                 'bf16 err': 8.3e-3}
# the forward (#2, #9) while all its products ran as 4x4 f32 register
# tiles, read by this script on the same card and limit (after pass B's
# redesign): ms at B=2 L=1024 and B=16 L=2048 (phase 6), at B=16 L=3072
# bf16 (6h), ms a bf16 train step (7b, 7h), the step's wall (8b, 8h-b) and
# the largest bf16 error against the plain forward (2); printed beside
# today's readings
SCALAR_FWD = {'favor_fwd B=2 L=1024': 1.0261, 'favor_fwd B=16 L=2048': 2.3874,
              'favor_fwd B=16 L=3072': 3.6011, 'favor_fwd_hl B=16 L=3072': 3.9511,
              'step head-major': 42.20, 'step heads-last': 46.81,
              'wall head-major': 172.4, 'wall heads-last': 168.4,
              'bf16 err': 5.04e-3}
# the key max (#1, #8) while its bf16 product ran as 4x4 f32 register tiles,
# one chunk a block, read by this script on the same card and limit (after
# the forward's redesign): ms at B=2 L=1024 and B=16 L=2048 (phase 6), at
# B=16 L=3072 bf16 in both layouts (6h), ms a bf16 train step (7b, of 10 of
# its 12 launches that the profiler kept; 7h) and the step's wall (8b,
# 8h-b); printed beside today's readings
SCALAR_KMAX = {'favor_kmax B=2 L=1024': 0.0406, 'favor_kmax B=16 L=2048': 0.2497,
               'favor_kmax B=16 L=3072': 0.3807, 'favor_kmax_hl B=16 L=3072': 0.3940,
               'step head-major': 3.96, 'step heads-last': 4.69,
               'wall head-major': 147.0, 'wall heads-last': 138.5}
# the composed op's backward passes (#6, #7) while all their products ran as
# 4x4 f32 register tiles, read by this script on the same card and limit
# (after the key max's redesign): ms at BH=128 L=3072 M=128 Dv=64 f32 (phase
# 6l) and the composed forward+backward (6l, two readings); printed beside
# today's readings
SCALAR_CLA = {'cla_bwd_a': 4.5395, 'cla_bwd_b': 4.2132, 'fwd+bwd composed': (16.5067, 16.5187)}
# the composed op's forward (#5) while its products ran as 4x4 f32 register
# tiles on scalar loads, read by this script on the same card and limit
# (after the passes' redesign): ms at BH=128 L=3072 M=128 Dv=64 f32 and the
# composed forward, no autograd (phase 6l, two readings); printed beside
# today's readings
SCALAR_CLA_FWD = {'cla_fwd': 2.9512, 'fwd composed': (5.2739, 5.2920)}

# tolerances, as the largest |kernel - plain| over the largest |plain|:
# f32 differs only in summation order; under bf16 the kernels round their
# product operands (and the output) to bf16, ~2^-8 relative each, while the
# plain versions compute in f32 (FAVOR) or round at other places (decode)
TOL_F32 = 1e-4
TOL_BF16 = 3e-2
# the key max (#1, #8) is f32 arithmetic on the same values in both dtypes
# (bf16 k widens exactly; its product in 3xTF32, ~1e-6), so it is held to
# TOL_F32 in both: one TF32 pass (~1e-3) would fail it
# the FAVOR kernels are held against their plain versions at the serving
# entry shape, a ragged L, and the training path's two shapes:
# train_stage2.run's f32 batch and the bf16 train step's
KERNEL_CASES = ((ENTRY_B, ENTRY_L, torch.float32), (ENTRY_B, ENTRY_L, torch.bfloat16),
                (ENTRY_B, 1000, torch.float32), (ENTRY_B, 1000, torch.bfloat16),
                (TRAIN_B, TRAIN_L, torch.float32), (BF16_B, TRAIN_L, torch.bfloat16))
# the heads-last kernels: the training path's two shapes and a ragged L
HL_CASES = ((TRAIN_B, TRAIN_L, torch.float32), (BF16_B, TRAIN_L, torch.bfloat16),
            (ENTRY_B, 1000, torch.float32), (ENTRY_B, 1000, torch.bfloat16))
# (Dh, M) beside the model's (64, 128) for the bf16 key max alone: omega in
# registers with idle warps and a 16-wide K tail, and from shared memory
# (Dh > 64, M > 128), at the ragged L
KMAX_WIDTHS = ((32, 64), (48, 112), (80, 144), (64, 144))
HEAD_MAJOR = ('favor_kmax', 'favor_fwd', 'favor_bwd_a', 'favor_bwd_b')
HEADS_LAST = ('favor_kmax_hl', 'favor_fwd_hl', 'favor_bwd_a_hl', 'favor_bwd_b_hl')
# causal_linear_attention's kernels #5-#7, held against their plain versions
# at the composed path's shape (B=16, L=3072: BH=128), a ragged L, and the
# forward on bf16 features and v and on f32 features (favor_features' type)
# with bf16 v; each compares f32 results (bf16 inputs widen exactly), so
# TOL_F32 holds for all.  A case is (B, L, features' dtype, v's dtype)
COMPOSED = ('cla_fwd', 'cla_bwd_a', 'cla_bwd_b')
CLA_CASES = ((BF16_B, TRAIN_L, torch.float32, torch.float32),
             (ENTRY_B, 1000, torch.float32, torch.float32),
             (ENTRY_B, 1000, torch.bfloat16, torch.bfloat16),
             (ENTRY_B, 1000, torch.float32, torch.bfloat16))
# (M, Dv) beside the composed path's (128, 64) for all three kernels at the
# ragged L (the passes f32, the forward in each of CLA_FWD_MIXES): widths
# off 16, which the kernels pad to 16 in shared memory, and widths past
# 128 / 64
CLA_WIDTHS = ((36, 20), (144, 80))
# the forward's (features' dtype, v's dtype) at CLA_WIDTHS
CLA_FWD_MIXES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.bfloat16))
# the composed FAVOR+ path's gradients against the fused op's: the same
# function up to summation order, through the feature map's chain rule
TOL_COMPOSED_GRAD = 1e-3
# f32 decode (key stabilizer 0) against the forward (row max stabilizer)
# after 12 layers: the stabilizers cancel up to the 1e-6 eps and float order
TOL_DECODE_VS_FORWARD = 1e-3
# bf16 forward against the f32 forward: bf16 rounding through 12 layers
TOL_BF16_MODEL = 5e-2
# the GPT-2 f32 forward through flash_attention_fwd against the einsum path:
# summation order through 12 layers
TOL_GPT2_KERNEL_PATH = 1e-3
# f32 parameter gradients through the kernels against the plain path, per
# parameter as ||kernel - plain|| / ||plain||.  The kernels differ from the
# plain passes by summation order, ~1e-6 (phase 2c), and a ReLU unit whose
# pre-activation sits within that noise of 0 takes another branch on each
# path, which moves its weight-gradient row by one token's term.  So the
# gradients are compared twice: with the plain path replaying the kernel
# path's ReLU masks, where every parameter must agree to TOL_GRAD_SHARED,
# and with each path's own masks, where the q/k/v/out projections must agree
# to TOL_GRAD_ATTN and every parameter to TOL_GRAD (a wrong backward kernel
# gives errors of order 1).  The key-projection bias reads highest on shared
# masks: its gradient nearly cancels (a shift of every key changes softmax
# attention not at all, and FAVOR+ approximates it), so summation noise is
# large against it
TOL_GRAD_SHARED = 1e-3
TOL_GRAD_ATTN = 1e-3
TOL_GRAD = 1e-2
# f32 gradients of the heads-last model against the head-major model on the
# same weights, per parameter by norm: the same kernel bodies run on the
# same rows, so they are expected equal bit for bit
TOL_GRAD_LAYOUT = 1e-6


def rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def max_abs(got, ref):
    return float((got.float() - ref.float()).abs().max())


def expect(ok, what):
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def time_ms(fn, iters=20, warmup=3):
    """Mean time of one call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes, op_seconds):
    """Least time (ms) for ``nbytes`` of traffic and the operations' time at
    peak, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, op_seconds) * 1e3,
            'bytes' if t_bytes >= op_seconds else 'operations')


# ---------------------------------------------------------------------------
# work counts for the bounds (each input read once, each output written once)
# ---------------------------------------------------------------------------

def kmax_bound(BH, L, Dh, M, in_bytes, chunk, rate=F32_FLOP_PER_S, passes=1):
    """The key max: k read, one partial max a chunk written; h and ||x||^2
    in f32, ``passes`` times over at ``rate`` (``TF32_FLOP_PER_S, 3``:
    3xTF32, as the bf16 instantiation runs them; the default f32 on the
    CUDA cores)."""
    nbytes = BH * L * Dh * in_bytes + Dh * M * 4 + BH * -(-L // chunk) * 4
    ops = 2 * BH * L * Dh * (M + 1)                         # h, ||x||^2: f32
    return bound(nbytes, passes * ops / rate)


def fwd_products(BH, L, M, Dv):
    """Flop of the causal products a forward needs, counted as the
    per-position recurrence does them (a chunked kernel's triangles are its
    own overhead): S += phi_k v^T and phi_q.S, 2 M Dv each; z += phi_k and
    phi_q.z, 3 M; the division by the denominator, Dv."""
    return BH * L * (4 * M * Dv + 3 * M + Dv)


def bwd_products(BH, L, M, Dv, pass_a):
    """Flop a backward pass needs, per position as the recurrence does it:
    three [M, Dv] state products, 6 M Dv (pass A replays S += phi_k v^T and
    num = phi_q.S and forms S u; pass B forms R += phi_q u^T, R^T phi_k and
    R v), and the vectors: pass A's z update, phi_q.z and w z (5 M) and
    u = g/den and g.num (3 Dv), pass B's r += w phi_q and its add (3 M)."""
    vec = 5 * M + 3 * Dv if pass_a else 3 * M
    return BH * L * (6 * M * Dv + vec)


def fwd_bound(BH, L, Dh, Dv, M, in_bytes, chunk, feat_rate=F32_FLOP_PER_S,
              feat_passes=1):
    """The forward: q, k, v and the key maxima read, out written.  Both
    feature maps' f32 products count at ``feat_rate``, ``feat_passes`` times
    over, as in :func:`bwd_bound` (``TF32_FLOP_PER_S, 3``: 3xTF32, as the
    bf16 instantiation runs them); the causal products at the inputs'
    rate."""
    nbytes = (BH * L * (2 * Dh + 2 * Dv) * in_bytes + Dh * M * 4
              + BH * -(-L // chunk) * 4)
    feat = 2 * 2 * BH * L * Dh * (M + 1)                    # phi_q, phi_k: f32
    rate = BF16_FLOP_PER_S if in_bytes == 2 else F32_FLOP_PER_S
    return bound(nbytes, feat_passes * feat / feat_rate
                 + fwd_products(BH, L, M, Dv) / rate)


def bwd_bound(BH, L, Dh, Dv, M, in_bytes, n_partial, pass_a,
              feat_rate=F32_FLOP_PER_S, feat_passes=1):
    """A backward pass: A reads q, k, v, g and writes dq, u, w; B reads
    q, k, v, u, w and writes dk, dv -- 3 Dh + 3 Dv + 1 values a position
    both ways.  Each recomputes both feature maps and the chain rule through
    one of them (f32, omega exact), and runs the causal products.  The
    feature maps' and chain rule's f32 products count at ``feat_rate``,
    ``feat_passes`` times over: ``TF32_FLOP_PER_S, 3`` as both passes' bf16
    instantiations run them (3xTF32 on the tensor cores), the default as
    f32 on the CUDA cores."""
    nbytes = (BH * L * (3 * Dh + 3 * Dv + 1) * in_bytes + Dh * M * 4
              + BH * n_partial * 4)
    feat = 2 * 2 * BH * L * Dh * (M + 1) + 2 * BH * L * M * Dh
    rate = BF16_FLOP_PER_S if in_bytes == 2 else F32_FLOP_PER_S
    return bound(nbytes, feat_passes * feat / feat_rate
                 + bwd_products(BH, L, M, Dv, pass_a) / rate)


def cla_fwd_bound(BH, L, M, Dv, in_bytes, rate=F32_FLOP_PER_S, passes=1):
    """Kernel #5: phi_q, phi_k and v read once in their type, the f32 output
    written once; the forward's causal products, f32 arithmetic whatever
    the inputs' type (the kernel widens bf16 inputs), at ``rate``,
    ``passes`` times over (``TF32_FLOP_PER_S, 3``: 3xTF32, as the kernel
    runs them; the default f32 on the CUDA cores)."""
    nbytes = BH * L * (2 * M + Dv) * in_bytes + BH * L * Dv * 4
    return bound(nbytes, passes * fwd_products(BH, L, M, Dv) / rate)


def cla_bwd_bound(BH, L, M, Dv, pass_a, rate=F32_FLOP_PER_S, passes=1):
    """Kernel #6 or #7, f32: pass A reads phi_q, phi_k, v, g and writes
    dphi_q, u, w; pass B reads phi_q, phi_k, v, u, w and writes dphi_k, dv
    -- 3 M + 3 Dv + 1 values a position both ways; no feature map.  The
    products count at ``rate``, ``passes`` times over (``TF32_FLOP_PER_S,
    3``: 3xTF32, as both passes run them; the default f32 on the CUDA
    cores)."""
    nbytes = BH * L * (3 * M + 3 * Dv + 1) * 4
    return bound(nbytes, passes * bwd_products(BH, L, M, Dv, pass_a) / rate)


def decode_bound(B, D, H, M, F, w_bytes, x_bytes):
    Dh = D // H
    n_params = 4 * D * D + 2 * D * F + 4 * D + F + D + 4 * D
    nbytes = (n_params * w_bytes + 2 * B * H * (Dh * M + M) * 4
              + 2 * B * D * x_bytes + Dh * M * 4 + B * 4)
    proj = 2 * B * (4 * D * D + 2 * D * F)
    favor = B * H * (2 * 2 * Dh * M + 4 * Dh * M)
    rate = BF16_FLOP_PER_S if w_bytes == 2 else F32_FLOP_PER_S
    return bound(nbytes, proj / rate + favor / F32_FLOP_PER_S)


def flash_bound(B, H, L, Dh, rate=TF32_FLOP_PER_S, passes=3):
    """Causal attention forward, f32: q, k, v read and o written once; the
    products q k^T and p v over the causal triangle, 4 Dh L(L+1)/2 flop a
    (batch, head) row, each f32 product as 3 TF32 products (hi*hi + hi*lo +
    lo*hi) at the TF32 tensor-core rate.  ``rate=F32_FLOP_PER_S, passes=1``
    gives the same products on the CUDA cores in f32."""
    nbytes = 4 * B * H * L * Dh * 4
    ops = passes * B * H * 4 * Dh * L * (L + 1) / 2
    return bound(nbytes, ops / rate)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def qkv(gen, B, H, L, dtype, dev):
    """Random q/k/v at the magnitude of the model's projections."""
    return [(0.5 * torch.randn(B, H, L, D_HEAD, generator=gen)).to(dev, dtype)
            for _ in range(3)]


def layer_params(gen, dtype, dev):
    from emo_disentanger_tpu_torch.ops.performer_decode import PARAM_KEYS
    D, F = D_MODEL, D_FF
    shapes = {'wq': (D, D), 'wk': (D, D), 'wv': (D, D), 'wo': (D, D),
              'w1': (F, D), 'w2': (D, F), 'b1': (F,)}
    p = {}
    for key in PARAM_KEYS:
        shape = shapes.get(key, (D,))
        t = torch.randn(shape, generator=gen)
        t = 1.0 + 0.1 * t if key in ('g1', 'g2') else 0.04 * t
        p[key] = t.to(dev, dtype).contiguous()
    return p


def synthetic_dictionary():
    """(event2word, word2event) of the port's functional vocabulary with
    velocities (327 events and PAD)."""
    from emo_disentanger_tpu_torch.core.vocab import (
        MAJOR_KEY, MINOR_KEY, events_to_dictionary)
    corpus = (['Bar_None', 'EOS_None', 'Track_LeadSheet', 'Track_Full']
              + [f'Beat_{b}' for b in range(16)]
              + [f'Key_{k}' for k in list(MAJOR_KEY) + list(MINOR_KEY)])
    return events_to_dictionary([corpus], add_velocity=True, relative=True)


def synthetic_vocab():
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    return Vocab(*synthetic_dictionary())


def synthetic_jobs(vocab, n_jobs, rng, bars=(4, 9)):
    """Primers (emotion, key, tempo) and lead-sheet bars, between bars[0]
    and bars[1] - 1 a job."""
    e = vocab.event2idx
    degrees = ['I', 'II', 'III', 'IV', 'V', 'VI', 'VII']
    primers, sheets = [], []
    for j in range(n_jobs):
        primers.append([e[f'Emotion_Q{1 + j % 4}'],
                        e['Key_C' if j % 2 == 0 else 'Key_a'], e['Tempo_110']])
        sheet = []
        for _ in range(rng.randint(*bars)):
            bar = [e['Bar_None']]
            for beat in sorted(rng.choice(16, size=rng.randint(2, 5),
                                          replace=False)):
                bar += [e[f'Beat_{beat}'],
                        e[f'Chord_{degrees[rng.randint(7)]}_M'],
                        e[f'Note_Octave_{rng.randint(4, 7)}'],
                        e[f'Note_Degree_{degrees[rng.randint(7)]}'],
                        e[f'Note_Duration_{120 * rng.randint(1, 9)}']]
            sheet.append(bar)
        sheets.append(sheet)
    return primers, sheets


def write_corpus(root, rng):
    """A synthetic stage-2 corpus in the pipeline's pickle format under
    ``root`` (``events/<piece>.pkl`` = (lead_pos, full_pos, events),
    ``dictionary.pkl``, train/valid splits), each piece CORPUS_BARS bars of
    an interleaved lead sheet and full track (~104 events a bar), and a
    training config with the values of ``configs/stage2/pop1k7_pretrain.yaml``
    (log and checkpoint every epoch)."""
    e2w, w2e = synthetic_dictionary()
    vels = [ev for ev in e2w if ev.startswith('Note_Velocity_')]
    deg = lambda: ['I', 'II', 'III', 'IV', 'V', 'VI', 'VII'][rng.randint(7)]
    events_dir = os.path.join(root, 'events')
    os.makedirs(events_dir)
    names = []
    for p in range(CORPUS_PIECES):
        evs = [f'Emotion_Q{1 + p % 4}', 'Key_C' if p % 2 == 0 else 'Key_a',
               'Tempo_110']
        lead_pos, full_pos = [], []
        for bar in range(CORPUS_BARS):
            lead = ['Track_LeadSheet', 'Bar_None']
            for beat in range(0, 16, 4):
                lead += [f'Beat_{beat}', f'Chord_{deg()}_M',
                         f'Note_Octave_{rng.randint(4, 6)}',
                         f'Note_Degree_{deg()}', 'Note_Duration_480']
            if bar == CORPUS_BARS - 1:
                lead.append('EOS_None')
            full = ['Track_Full', 'Bar_None']
            for beat in range(0, 16, 2):
                full += [f'Beat_{beat}', f'Chord_{deg()}_M']
                for _ in range(2):
                    full += [f'Note_Octave_{rng.randint(3, 6)}',
                             f'Note_Degree_{deg()}',
                             f'Note_Duration_{120 * rng.randint(1, 9)}',
                             vels[rng.randint(len(vels))]]
            lead_pos.append((len(evs), len(evs) + len(lead)))
            evs += lead
            full_pos.append((len(evs), len(evs) + len(full)))
            evs += full
        names.append(f'Q{1 + p % 4}_piece{p}.pkl')
        with open(os.path.join(events_dir, names[-1]), 'wb') as f:
            pickle.dump((lead_pos, full_pos, evs), f)
    paths = {k: os.path.join(root, f'{k}.pkl')
             for k in ('dictionary', 'train', 'valid')}
    for key, obj in (('dictionary', (e2w, w2e)), ('train', names[:-4]),
                     ('valid', names[-4:])):
        with open(paths[key], 'wb') as f:
            pickle.dump(obj, f)
    return {
        'data_loader': {'batch_size': TRAIN_B, 'data_path': events_dir,
                        'train_split': paths['train'],
                        'val_split': paths['valid'],
                        'vocab_path': paths['dictionary']},
        'model': {'d_embed': D_MODEL, 'd_ff': D_FF, 'd_model': D_MODEL,
                  'feature_map': {'n_dims': FAVOR}, 'max_len': TRAIN_L,
                  'n_head': N_HEAD, 'n_layer': N_LAYER, 'use_segemb': True,
                  'n_segment_types': 2},
        'training': {'ckpt_dir': os.path.join(root, 'ckpt_{}'),
                     'ckpt_interval': 1, 'log_interval': 1,
                     'feat_redraw_prob': 0.05, 'lr': 1e-4,
                     'lr_scheduler': {'T_max': 500000, 'eta_min': 1e-5},
                     'num_epochs': 1, 'warmup_steps': 200,
                     'trained_params': None, 'trained_optim': None},
    }


def kernel_ms(prof, steps, needle):
    """Device ms per step of the kernels whose name holds ``needle``."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and needle in e.key) / 1e3 / steps


def kernel_breakdown(prof, steps, n_top=8):
    """(device busy ms per step, the top kernels by device ms per step) from
    a torch.profiler run over ``steps`` steps; device events only, so
    nothing is counted twice, and no user annotation (the optimizer's
    ``Optimizer.step#...`` range also shows as a device event and would
    count its kernels again).  Busy is 0 when the profiler saw no device
    events."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    notes = {e.key for e in events if getattr(e, 'is_user_annotation', False)}
    kern = [e for e in events
            if e.device_type == DeviceType.CUDA and e.key not in notes]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    top = '; '.join(f'{e.key[:48]} x{e.count // steps} '
                    f'{e.self_device_time_total / 1e3 / steps:.4f}'
                    for e in kern[:n_top])
    return busy, top


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    from emo_disentanger_tpu_torch.ops import _build
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.time()
    _build.build()
    secs = time.time() - t0
    smi = smi[0] if smi else 'nvidia-smi gave no output'
    print(f'phase 1 device: {torch.cuda.get_device_name(0)} x '
          f'{torch.cuda.device_count()} [{smi}]; torch {torch.__version__} '
          f'CUDA {torch.version.cuda}; kernels built in {secs:.1f} s')
    return smi


def phase_kernel_a(dev, rec):
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    gen = torch.Generator().manual_seed(11)
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    for B, L, dtype in KERNEL_CASES:
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        q, k, v = qkv(gen, B, N_HEAD, L, dtype, dev)
        k2 = k.reshape(-1, L, D_HEAD)
        part = la._favor_kmax_cuda(k2, omega)
        got_m = part.amax(1)
        ref_m = la._key_max_plain(k2, omega)
        got = la.favor_causal_attention(q, k, v, omega)
        ref = la._favor_compose(q, k, v, omega)
        torch.cuda.synchronize()
        e_m, e_o = rel_err(got_m, ref_m), rel_err(got, ref)
        name = str(dtype).replace('torch.', '')
        was = ('' if dtype == torch.float32 else
               f'; on 4x4 f32 tiles out <= {SCALAR_FWD["bf16 err"]:.2e}')
        print(f'phase 2 kernel A {name} B={B} H={N_HEAD} L={L}: '
              f'kmax rel err {e_m:.2e} (tol {TOL_F32}), out rel err {e_o:.2e} '
              f'(tol {tol}{was})')
        expect(got.dtype == dtype and got.shape == ref.shape,
               'favor_fwd output dtype/shape')
        expect(part.dtype == torch.float32
               and part.shape == (B * N_HEAD, -(-L // la.KERNEL_CHUNK)),
               'favor_kmax partial: one f32 max a 64-row chunk')
        expect(e_m <= TOL_F32 and e_o <= tol, f'kernel A {name} B={B} L={L}')
        if (B, L, dtype) == (ENTRY_B, ENTRY_L, torch.bfloat16):
            rec['favor_kmax']['max_abs_err'] = max_abs(got_m, ref_m)
            rec['favor_fwd']['max_abs_err'] = max_abs(got, ref)
    errs = {}
    for Dh, M in KMAX_WIDTHS:
        om = la.draw_orthogonal_features(Dh, M, gen).to(dev)
        k2 = (0.5 * torch.randn(ENTRY_B * N_HEAD, 1000, Dh, generator=gen)).to(
            dev, torch.bfloat16)
        errs[Dh, M] = rel_err(la._favor_kmax_cuda(k2, om).amax(1),
                              la._key_max_plain(k2, om))
    print(f'phase 2 kernel #1 bfloat16 B={ENTRY_B} H={N_HEAD} L=1000 at (Dh, M) '
          + ', '.join(f'{w}: kmax rel err {e:.2e}' for w, e in errs.items())
          + f' (tol {TOL_F32})')
    expect(max(errs.values()) <= TOL_F32, 'favor_kmax bf16 at other widths')


def phase_kernel_c(dev, rec):
    """Kernels #3 and #4: pass A against the plain pass A, pass B against
    the plain pass B fed the kernel's own (u, w), both at the kernels'
    dot dtype and chunk; in f32 also dq/dk/dv against autograd through the
    plain forward.  The bf16 train step's shape gives the recorded error."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    gen = torch.Generator().manual_seed(15)
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    C = la.KERNEL_CHUNK
    for B, L, dtype in KERNEL_CASES:
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        q, k, v, g = (t.reshape(-1, L, D_HEAD) for t in
                      qkv(gen, B, N_HEAD, L, dtype, dev)
                      + qkv(gen, B, N_HEAD, L, dtype, dev)[:1])
        part = la._favor_kmax_cuda(k, omega)
        dq, u, w = la._favor_bwd_a_cuda(q, k, v, g, omega, part)
        dk, dv = la._favor_bwd_b_cuda(q, k, v, u, w, omega, part)
        kmax, dt = part.amax(1), la._dot_dtype_for(q)
        rdq, ru, rw = la._favor_bwd_a_plain(q, k, v, g, omega, kmax, C,
                                            dot_dtype=dt)
        rdk, rdv = la._favor_bwd_b_plain(q, k, v, u, w, omega, kmax, C,
                                         dot_dtype=dt)
        torch.cuda.synchronize()
        pairs = {'dq': (dq, rdq), 'u': (u, ru), 'w': (w, rw),
                 'dk': (dk, rdk), 'dv': (dv, rdv)}
        for name, (a, b) in pairs.items():
            expect(a.dtype == dtype and a.shape == b.shape,
                   f'favor_bwd {name} dtype/shape')
        errs = {name: rel_err(a, b) for name, (a, b) in pairs.items()}
        if dtype == torch.float32:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            la._favor_compose(*leaves, omega).backward(g)
            for name, a, b in zip(('dq', 'dk', 'dv'), (dq, dk, dv), leaves):
                errs[f'{name} vs autograd'] = rel_err(a, b.grad)
        line = ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
        name = str(dtype).replace('torch.', '')
        was = ('' if dtype == torch.float32 else
               f'; on 4x4 f32 tiles: pass A <= {SCALAR_PASS_A["bf16 err"]:.1e}, '
               f'pass B <= {SCALAR_PASS_B["bf16 err"]:.1e}')
        print(f'phase 2c kernels #3/#4 {name} B={B} H={N_HEAD} L={L}: '
              f'rel err {line} (tol {tol}{was})')
        expect(max(errs.values()) <= tol, f'favor_bwd {name} B={B} L={L}')
        if (B, L, dtype) == (BF16_B, TRAIN_L, torch.bfloat16):
            rec['favor_bwd_a']['max_abs_err'] = max(
                max_abs(dq, rdq), max_abs(u, ru), max_abs(w, rw))
            rec['favor_bwd_b']['max_abs_err'] = max(max_abs(dk, rdk),
                                                    max_abs(dv, rdv))

def phase_kernel_hl(dev, rec):
    """Kernels #8-#11 on heads-last [B, L, D] inputs: each against its plain
    version (the key max and the f32 composed forward on the split heads;
    the plain passes at the kernels' dot dtype and chunk, pass B fed the
    kernel's own (u, w)), and against the head-major kernels #1-#4 on the
    head-split inputs, which must agree bit for bit.  The bf16 train step's
    shape gives the recorded error."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    gen = torch.Generator().manual_seed(19)
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    C, H = la.KERNEL_CHUNK, N_HEAD
    for B, L, dtype in HL_CASES:
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        q, k, v, g = [(0.5 * torch.randn(B, L, D_MODEL, generator=gen)).to(dev, dtype)
                      for _ in range(4)]
        part = la._favor_kmax_hl_cuda(k, omega, H)
        out = la._favor_fwd_hl_cuda(q, k, v, omega, part, H)
        dq, u, w = la._favor_bwd_a_hl_cuda(q, k, v, g, omega, part, H)
        dk, dv = la._favor_bwd_b_hl_cuda(q, k, v, u, w, omega, part, H)
        sp = lambda t: la._split_heads(t, H)
        merge = lambda t: la._merge_heads(t, B)
        q2, k2, v2, g2 = sp(q), sp(k), sp(v), sp(g)
        kmax, dt = part.amax(1), la._dot_dtype_for(q)
        ref_m = la._key_max_plain(k2, omega)
        ref_o = la._hl_compose(q, k, v, omega, H)
        rdq, ru, rw = la._favor_bwd_a_plain(q2, k2, v2, g2, omega, kmax, C,
                                            dot_dtype=dt)
        rdk, rdv = la._favor_bwd_b_plain(q2, k2, v2, sp(u), w, omega, kmax, C,
                                         dot_dtype=dt)
        pairs = {'kmax': (kmax, ref_m), 'out': (out, ref_o),
                 'dq': (dq, merge(rdq)), 'u': (u, merge(ru)), 'w': (w, rw),
                 'dk': (dk, merge(rdk)), 'dv': (dv, merge(rdv))}
        # the head-major kernels on the split heads
        hpart = la._favor_kmax_cuda(k2, omega)
        hout = la._favor_fwd_cuda(q2, k2, v2, omega, hpart)
        hdq, hu, hw = la._favor_bwd_a_cuda(q2, k2, v2, g2, omega, hpart)
        hdk, hdv = la._favor_bwd_b_cuda(q2, k2, v2, hu, hw, omega, hpart)
        torch.cuda.synchronize()
        for name, (a, b) in pairs.items():
            expect(a.shape == b.shape and (name == 'kmax' or a.dtype == dtype),
                   f'heads-last {name} dtype/shape')
        errs = {name: rel_err(a, b) for name, (a, b) in pairs.items()}
        same = {'kmax': (part, hpart), 'out': (out, merge(hout)),
                'dq': (dq, merge(hdq)), 'u': (u, merge(hu)), 'w': (w, hw),
                'dk': (dk, merge(hdk)), 'dv': (dv, merge(hdv))}
        unequal = [name for name, (a, b) in same.items() if not torch.equal(a, b)]
        line = ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
        name = str(dtype).replace('torch.', '')
        print(f'phase 2h kernels #8-#11 {name} B={B} H={H} L={L}: rel err '
              f'{line} (tol {tol}, kmax {TOL_F32}); against #1-#4 on the split heads: '
              f'{"all bitwise equal" if not unequal else "differ: " + str(unequal)}')
        expect(part.shape == (B * H, -(-L // C)), 'favor_kmax_hl partial shape')
        expect(errs['kmax'] <= TOL_F32 and max(errs.values()) <= tol,
               f'heads-last kernels {name} B={B} L={L}')
        expect(not unequal, f'heads-last kernels equal the head-major ones '
               f'{name} B={B} L={L}')
        if (B, L, dtype) == (BF16_B, TRAIN_L, torch.bfloat16):
            rec['favor_kmax_hl']['max_abs_err'] = max_abs(kmax, ref_m)
            rec['favor_fwd_hl']['max_abs_err'] = max_abs(out, ref_o)
            rec['favor_bwd_a_hl']['max_abs_err'] = max(
                max_abs(*pairs[n]) for n in ('dq', 'u', 'w'))
            rec['favor_bwd_b_hl']['max_abs_err'] = max(
                max_abs(*pairs[n]) for n in ('dk', 'dv'))


def cla_inputs(gen, B, L, dev, M=FAVOR, Dv=D_HEAD):
    """Kernels #5-#7's inputs as the composed path makes them: the FAVOR+
    features of qkv()'s q and k (D_HEAD = 64, M features, f32) as
    [B*H, L, M], v and a cotangent g as [B*H, L, Dv]."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    omega = la.draw_orthogonal_features(D_HEAD, M, gen).to(dev)
    q, k = qkv(gen, B, N_HEAD, L, torch.float32, dev)[:2]
    v, g = ((0.5 * torch.randn(B * N_HEAD, L, Dv, generator=gen)).to(dev)
            for _ in range(2))
    flat = lambda t: t.reshape(B * N_HEAD, L, t.shape[-1])
    return (flat(la.favor_features(q, omega, is_query=True)),
            flat(la.favor_features(k, omega, is_query=False)), v, g)


def cla_bwd_pairs(la, q, k, v, g, C):
    """Passes A and B on the card beside their plain versions, pass B fed
    the kernel's own (u, w): {name: (kernel, plain)}."""
    dq, u, w = la._cla_bwd_a_cuda(q, k, v, g)
    dk, dv = la._cla_bwd_b_cuda(q, k, v, u, w)
    rdq, ru, rw = la._cla_bwd_a_plain(q, k, v, g, C)
    rdk, rdv = la._cla_bwd_b_plain(q, k, v, u, w, C)
    return dict(dphi_q=(dq, rdq), u=(u, ru), w=(w, rw), dphi_k=(dk, rdk), dv=(dv, rdv))


def dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def misaligned(t, elements=1):
    """A contiguous copy of ``t`` on its device starting ``elements``
    values past the allocator's boundary."""
    out = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = out[elements:].view(t.shape)
    out.copy_(t)
    return out


def phase_kernel_cla(dev, rec):
    """Kernels #5-#7 against their plain versions at the kernels' chunk:
    the forward, pass A, and pass B fed the kernel's own (u, w), at the
    composed path's shape and a ragged L in f32; the forward also on bf16
    features and v, and on f32 features with bf16 v (f32 out); then the
    three at the ragged L at the widths of CLA_WIDTHS (the forward in each
    of CLA_FWD_MIXES), and the op's forward on misaligned views.  The
    composed path's shape gives the recorded errors."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    gen = torch.Generator().manual_seed(21)
    C = la.KERNEL_CHUNK
    for B, L, dtype, v_dtype in CLA_CASES:
        q, k, v, g = cla_inputs(gen, B, L, dev)
        q, k, v = q.to(dtype), k.to(dtype), v.to(v_dtype)
        pairs = {'out': (la._cla_fwd_cuda(q, k, v), la._cla_fwd_plain(q, k, v, C))}
        if dtype == v_dtype == torch.float32:
            pairs.update(cla_bwd_pairs(la, q, k, v, g, C))
        torch.cuda.synchronize()
        for name, (a, b) in pairs.items():
            expect(a.dtype == torch.float32 and a.shape == b.shape
                   and bool(torch.isfinite(a).all()),
                   f'causal_linear_attention {name} dtype/shape/finite')
        errs = {name: rel_err(a, b) for name, (a, b) in pairs.items()}
        line = ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
        name = f'{dtype_name(dtype)} features, {dtype_name(v_dtype)} v'
        print(f'phase 2l kernels #5-#7 {name} B={B} H={N_HEAD} L={L} '
              f'M={FAVOR} Dv={D_HEAD}: rel err {line} (tol {TOL_F32})')
        expect(max(errs.values()) <= TOL_F32,
               f'causal_linear_attention kernels {name} B={B} L={L}')
        if (B, L, dtype, v_dtype) == CLA_CASES[0]:
            rec['cla_fwd']['max_abs_err'] = max_abs(*pairs['out'])
            rec['cla_bwd_a']['max_abs_err'] = max(
                max_abs(*pairs[n]) for n in ('dphi_q', 'u', 'w'))
            rec['cla_bwd_b']['max_abs_err'] = max(
                max_abs(*pairs[n]) for n in ('dphi_k', 'dv'))
    B, L = ENTRY_B, 1000
    for M, Dv in CLA_WIDTHS:
        q, k, v, g = cla_inputs(gen, B, L, dev, M, Dv)
        pairs = cla_bwd_pairs(la, q, k, v, g, C)
        for dtype, v_dtype in CLA_FWD_MIXES:
            ins = q.to(dtype), k.to(dtype), v.to(v_dtype)
            pairs[f'out {dtype_name(dtype)}/{dtype_name(v_dtype)}'] = (
                la._cla_fwd_cuda(*ins), la._cla_fwd_plain(*ins, C))
        torch.cuda.synchronize()
        for name, (a, b) in pairs.items():
            expect(a.dtype == torch.float32 and a.shape == b.shape
                   and bool(torch.isfinite(a).all()),
                   f'causal_linear_attention {name} M={M} Dv={Dv} dtype/shape/finite')
        errs = {name: rel_err(a, b) for name, (a, b) in pairs.items()}
        print(f'phase 2l kernels #5-#7 B={B} H={N_HEAD} L={L} M={M} Dv={Dv} (the passes '
              f'f32, out features/v): rel err '
              f'{", ".join(f"{n} {e:.2e}" for n, e in errs.items())} (tol {TOL_F32})')
        expect(max(errs.values()) <= TOL_F32,
               f'causal_linear_attention kernels M={M} Dv={Dv}')

    # the op's forward on views one value off the allocator's boundary (f32
    # phi_q, bf16 v), which it copies again, in their own dtype, for #5
    from emo_disentanger_tpu_torch.ops import causal_linear_attention
    q, k, v, _ = cla_inputs(gen, B, L, dev)
    views = misaligned(q), k, misaligned(v.to(torch.bfloat16))
    expect(views[0].data_ptr() % 16 and views[2].data_ptr() % 8,
           'the views are off the boundaries #5 loads on')
    got = causal_linear_attention(*(t.reshape(B, N_HEAD, L, -1) for t in views))
    err = rel_err(got.reshape(v.shape), la._cla_fwd_plain(*views, C))
    print(f'phase 2l causal_linear_attention forward on misaligned views (f32 phi_q, '
          f'bf16 v) B={B} H={N_HEAD} L={L}: rel err {err:.2e} (tol {TOL_F32})')
    expect(err <= TOL_F32, 'causal_linear_attention on misaligned views')


def phase_kernel_b(dev, rec):
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    from emo_disentanger_tpu_torch.ops import performer_decode as pd
    gen = torch.Generator().manual_seed(12)
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    B = SERVE_B
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        p = layer_params(gen, dtype, dev)
        S = [torch.zeros(B, N_HEAD, D_HEAD, FAVOR, device=dev) for _ in range(2)]
        z = [torch.zeros(B, N_HEAD, FAVOR, device=dev) for _ in range(2)]
        worst = {'out': 0.0, 'S': 0.0, 'z': 0.0}
        abs_out = 0.0
        for _ in range(8):
            x = torch.randn(B, D_MODEL, generator=gen).to(dev, dtype)
            mask = (torch.rand(B, generator=gen) > 0.3).to(dev)
            got = pd._decode_layer_cuda(x, S[0], z[0], p, omega, mask, N_HEAD)
            ref = pd._decode_layer_plain(x, S[1], z[1], p, omega, mask, N_HEAD)
            torch.cuda.synchronize()
            expect(got.dtype == dtype and got.shape == ref.shape,
                   'performer_decode_layer output dtype/shape')
            for key, a, b in (('out', got, ref), ('S', S[0], S[1]),
                              ('z', z[0], z[1])):
                worst[key] = max(worst[key], rel_err(a, b))
            abs_out = max(abs_out, max_abs(got, ref))
        name = str(dtype).replace('torch.', '')
        print(f'phase 3 kernel B {name} weights B={B} D={D_MODEL} H={N_HEAD} '
              f'M={FAVOR} F={D_FF}, 8 masked steps: rel err out '
              f'{worst["out"]:.2e} S {worst["S"]:.2e} z {worst["z"]:.2e} '
              f'(tol {tol})')
        expect(max(worst.values()) <= tol, f'kernel B {name}')
        if dtype == torch.bfloat16:
            rec['performer_decode_layer']['max_abs_err'] = abs_out


def build_model(vocab, dev, heads_last=False):
    from emo_disentanger_tpu_torch.models import MusicPerformer
    model = MusicPerformer(n_token=vocab.size, n_layer=N_LAYER, n_head=N_HEAD,
                           d_model=D_MODEL, d_ff=D_FF, d_embed=D_MODEL,
                           favor_dims=FAVOR, heads_last=heads_last, device=dev,
                           generator=torch.Generator().manual_seed(0))
    omegas = model.draw_omegas(torch.Generator().manual_seed(1))
    return model.eval(), omegas


@torch.no_grad()
def phase_model(vocab, dev):
    from emo_disentanger_tpu_torch.utils.precision import cast_params
    model, omegas = build_model(vocab, dev)
    gen = torch.Generator().manual_seed(13)
    tokens = torch.randint(0, vocab.size - 1, (ENTRY_B, ENTRY_L), generator=gen).to(dev)
    seg = torch.randint(0, 2, (ENTRY_B, ENTRY_L), generator=gen).to(dev)
    ref = model(tokens, omegas, seg)                        # f32 forward
    state = model.init_decode_state(ENTRY_B)
    steps = min(256, ENTRY_L)
    dec = torch.stack([model.decode_step(tokens[:, t], seg[:, t], t, omegas,
                                         state)[0] for t in range(steps)], 1)
    e_dec = rel_err(dec, ref[:, :steps])
    cast_params(model)
    out = model(tokens, omegas, seg)                        # bf16 forward
    torch.cuda.synchronize()
    t0 = time.time()
    model(tokens, omegas, seg)                              # timed warm
    torch.cuda.synchronize()
    secs = time.time() - t0
    e_bf = rel_err(out, ref)
    print(f'phase 4 model {N_LAYER}L/{N_HEAD}H/{D_MODEL}d/{D_FF}ff V={vocab.size}: '
          f'f32 decode of {steps} tokens vs forward rel err {e_dec:.2e} '
          f'(tol {TOL_DECODE_VS_FORWARD}); bf16 forward B={ENTRY_B} L={ENTRY_L}: '
          f'logits {out.dtype} {tuple(out.shape)} in {secs * 1e3:.1f} ms, rel err vs '
          f'f32 {e_bf:.2e} (tol {TOL_BF16_MODEL})')
    expect(tuple(out.shape) == (ENTRY_B, ENTRY_L, vocab.size)
           and bool(torch.isfinite(out).all()), 'bf16 forward finite, shape')
    expect(e_dec <= TOL_DECODE_VS_FORWARD, 'f32 decode matches the forward')
    expect(e_bf <= TOL_BF16_MODEL, 'bf16 forward agrees with f32')
    return model, omegas


def phase_serve(model, omegas, vocab, dev):
    from emo_disentanger_tpu_torch.infer.stage2_batch import (
        STATUS_IDLE, STATUS_RUNNING, Stage2BatchGenerator)
    primers, sheets = synthetic_jobs(vocab, 24, np.random.RandomState(5))
    gen = Stage2BatchGenerator(model, vocab, batch=SERVE_B, temp=1.1,
                               top_p=0.99, max_events=1500, omegas=omegas,
                               device=dev)
    streams, stats = gen.serve(primers, sheets, seed=7)
    done = sum(s is not None for s in streams)
    tokens = sum(stats['events'])
    pad = vocab.pad_id
    print(f'phase 5 serve: {done}/{len(primers)} jobs in {SERVE_B} slots, '
          f'{tokens} events in {stats["wall_seconds"]:.2f} s = '
          f'{tokens / stats["wall_seconds"]:.1f} tokens/s, {stats["steps"]} '
          f'steps ({stats["wall_seconds"] * 1e3 / stats["steps"]:.3f} ms each), '
          f'{stats["chunks"]} chunks, statuses {sorted(set(stats["status"]))}')
    expect(done == len(primers), 'every job finished')
    expect(all(st not in (STATUS_RUNNING, STATUS_IDLE) for st in stats['status']),
           'every job has a final status')
    lead = vocab.event2idx['Track_LeadSheet']
    for j, s in enumerate(streams):
        # primer, Track_LeadSheet, then bar 0 injected verbatim; no PAD
        bar0 = sheets[j][0]
        expect(s[:4] == primers[j] + [lead] and s[4:4 + len(bar0)] == bar0
               and pad not in s, f'job {j} stream')


class ReluMasks:
    """Stands in for ``torch.nn.functional`` inside ``models/performer.py``:
    records the mask of each ReLU of a forward, or, given ``replay``, applies
    those masks in the same order instead, so that two paths take one branch
    at every ReLU unit."""

    def __init__(self, replay=None):
        self.masks = []
        self.replay = None if replay is None else list(replay)

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def relu(self, x):
        if self.replay is not None:
            return x * self.replay.pop(0)
        self.masks.append(x > 0)
        return torch.nn.functional.relu(x)


def phase_grad(vocab, dev):
    """Full-width f32 loss and every parameter's gradient at B=2, L=1024,
    dropout off, through the kernels and through the plain path (autograd
    through the plain forward on the card), each path with its own ReLU
    masks and the plain path again with the kernel path's masks.  Every
    parameter must get a finite gradient that is not None and not all zero
    -- the q/k/v projections get theirs only through favor_bwd_a/favor_bwd_b."""
    from emo_disentanger_tpu_torch.models import performer as pm
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    model, omegas = build_model(vocab, dev)                # eval: no dropout
    gen = torch.Generator().manual_seed(16)
    tokens = torch.randint(0, vocab.size - 1, (ENTRY_B, ENTRY_L), generator=gen).to(dev)
    seg = torch.randint(0, 2, (ENTRY_B, ENTRY_L), generator=gen).to(dev)
    targets = torch.randint(0, vocab.size, (ENTRY_B, ENTRY_L), generator=gen).to(dev)
    kernel_path = pm.favor_causal_attention
    plain = lambda q, k, v, om: la._favor_compose(q, k, v, om).to(q.dtype)

    def loss_and_grads(attention, relu):
        pm.favor_causal_attention, pm.F = attention, relu
        try:
            model.zero_grad(set_to_none=True)
            loss = model.compute_loss(model(tokens, omegas, seg), targets)
            loss.backward()
        finally:
            pm.favor_causal_attention, pm.F = kernel_path, torch.nn.functional
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}

    n_bwd = _build.LAUNCHES['favor_bwd_a']
    own_k, own_p = ReluMasks(), ReluMasks()
    loss_k, got = loss_and_grads(kernel_path, own_k)
    expect(_build.LAUNCHES['favor_bwd_a'] - n_bwd == N_LAYER,
           'the kernel backward ran once a layer')
    loss_p, ref = loss_and_grads(plain, own_p)
    loss_s, ref_s = loss_and_grads(plain, ReluMasks(replay=own_k.masks))
    for name, g in got.items():
        expect(g is not None and bool(torch.isfinite(g).all())
               and float(g.abs().max()) > 0, f'gradient of {name}')
    flips = sum(int((a != b).sum()) for a, b in zip(own_k.masks, own_p.masks))
    units = sum(m.numel() for m in own_k.masks)
    norm_err = lambda a, b: float((a - b).norm() / b.norm())
    errs = {name: norm_err(got[name], ref[name]) for name in got}
    errs_s = {name: norm_err(got[name], ref_s[name]) for name in got}
    worst = max(errs, key=errs.get)
    worst_s = max(errs_s, key=errs_s.get)
    attn = max(e for n, e in errs.items() if 'attention.' in n)
    elem = max(rel_err(got[n], ref[n]) for n in got)
    elem_s = max(rel_err(got[n], ref_s[n]) for n in got)
    print(f'phase 4b gradients {N_LAYER}L f32 B={ENTRY_B} L={ENTRY_L}: loss '
          f'{loss_k:.7f} kernels vs {loss_p:.7f} plain, {loss_s:.7f} plain '
          f'on the kernel masks; {len(got)} parameters all finite and '
          f'non-zero; ReLU units on another branch: {flips} of {units}. '
          f'Own masks: worst norm rel err {errs[worst]:.2e} ({worst}; tol '
          f'{TOL_GRAD}), attention projections {attn:.2e} (tol '
          f'{TOL_GRAD_ATTN}), worst largest-element rel err {elem:.2e}. '
          f'Kernel masks shared: worst norm rel err {errs_s[worst_s]:.2e} '
          f'({worst_s}; tol {TOL_GRAD_SHARED}), {errs_s[worst]:.2e} on '
          f'{worst}, worst largest-element rel err '
          f'{elem_s:.2e}')
    expect(abs(loss_k - loss_p) <= TOL_F32 * abs(loss_p), 'loss matches')
    expect(errs_s[worst_s] <= TOL_GRAD_SHARED,
           'gradients match the plain path on shared ReLU masks')
    expect(attn <= TOL_GRAD_ATTN, 'attention gradients match the plain path')
    expect(errs[worst] <= TOL_GRAD, 'gradients match the plain path')


def phase_grad_hl(vocab, dev):
    """Full-width f32 loss and every parameter's gradient at B=2, L=1024,
    dropout off, of the heads-last model (kernels #8-#11) against the
    head-major model (#1-#4) on the same weights.  The same kernel bodies
    run on the same rows, so the gradients are expected equal bit for bit;
    each parameter is held to TOL_GRAD_LAYOUT by norm."""
    from emo_disentanger_tpu_torch.ops import _build
    gen = torch.Generator().manual_seed(20)
    tokens = torch.randint(0, vocab.size - 1, (ENTRY_B, ENTRY_L), generator=gen).to(dev)
    seg = torch.randint(0, 2, (ENTRY_B, ENTRY_L), generator=gen).to(dev)
    targets = torch.randint(0, vocab.size, (ENTRY_B, ENTRY_L), generator=gen).to(dev)
    runs = {}
    for heads_last in (False, True):
        model, omegas = build_model(vocab, dev, heads_last=heads_last)
        before = collections.Counter(_build.LAUNCHES)
        loss = model.compute_loss(model(tokens, omegas, seg), targets)
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: _build.LAUNCHES[k] - before[k] for k in HEAD_MAJOR + HEADS_LAST}
        runs[heads_last] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                            launched)
        del model
    (loss_m, ref, n_m), (loss_h, got, n_h) = runs[False], runs[True]
    for name, g in got.items():
        expect(g is not None and bool(torch.isfinite(g).all())
               and float(g.abs().max()) > 0, f'heads-last gradient of {name}')
    errs = {n: float((got[n] - ref[n]).norm() / ref[n].norm()) for n in got}
    worst = max(errs, key=errs.get)
    equal = sum(torch.equal(got[n], ref[n]) for n in got)
    print(f'phase 4h gradients {N_LAYER}L f32 B={ENTRY_B} L={ENTRY_L}, heads-last vs '
          f'head-major on the same weights: loss {float(loss_h):.7f} vs '
          f'{float(loss_m):.7f} (bitwise {bool(torch.equal(loss_h, loss_m))}); '
          f'{equal} of {len(got)} parameters bitwise equal, worst norm rel err '
          f'{errs[worst]:.2e} ({worst}; tol {TOL_GRAD_LAYOUT}); launches '
          f'head-major {n_m}, heads-last {n_h}')
    expect(errs[worst] <= TOL_GRAD_LAYOUT, 'heads-last gradients match head-major')
    expect(all(n_h[k] == N_LAYER for k in HEADS_LAST)
           and not any(n_h[k] for k in HEAD_MAJOR),
           'the heads-last model ran #8-#11 once a layer and none of #1-#4')



@contextlib.contextmanager
def heads_last_env(heads_last):
    """``EMODIS_HL_ATTN`` set to '1' (heads-last) or '0' (head-major) inside
    the block, whatever the caller's environment held; restored after."""
    saved = os.environ.get('EMODIS_HL_ATTN')
    os.environ['EMODIS_HL_ATTN'] = '1' if heads_last else '0'
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop('EMODIS_HL_ATTN', None)
        else:
            os.environ['EMODIS_HL_ATTN'] = saved


def step_ms(step, batch, extras, n=BF16_STEPS):
    """Host-clock ms a train step over ``n`` steps ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        step(batch, extras)
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / n


def phase_train(dev, smi, heads_last=False):
    """The training path: ``train_stage2.run`` (f32, B=4, L=3072, dropout
    0.1, redraw 0.05, warmup 200, a checkpoint and the logs), then bf16
    steps at B=16, L=3072 with launches per step, then a fixed batch whose
    loss must fall.  The run and the models are built under
    ``EMODIS_HL_ATTN`` = '1' with ``heads_last`` (phases 8h-a to 8h-c), '0'
    without (8a to 8c), so the variable chooses the layout as a user's
    environment would.  Returns what phase 7b profiles."""
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    from emo_disentanger_tpu_torch.data.datasets import Stage2Dataset
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.train import train_stage2
    from emo_disentanger_tpu_torch.train.trainer import (
        OptimizerConfig, batch_to_device, make_optimizer, make_train_step,
        stage2_performer_loss_fn)
    from emo_disentanger_tpu_torch.utils.io import pickle_load
    gib = lambda: torch.cuda.max_memory_allocated() / 2 ** 30
    tag = 'phase 8h-' if heads_last else 'phase 8'
    layout = 'heads-last' if heads_last else 'head-major'
    with heads_last_env(heads_last), tempfile.TemporaryDirectory() as root:
        config = write_corpus(root, np.random.RandomState(9))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = train_stage2.run(config, 'functional', max_epoch_override=1,
                               max_batches_per_epoch=TRAIN_BATCHES, device=dev)
        wall = time.time() - t0
        secs = out['step_seconds']
        ckpt = out['ckpt_dir']
        files = sorted(os.listdir(os.path.join(ckpt, 'params')))
        logs = {n: open(os.path.join(ckpt, n)).read().splitlines()
                for n in ('log.txt', 'valloss.txt')}
        print(f'{tag}a train_stage2.run {layout} f32 {N_LAYER}L/{N_HEAD}H/{D_MODEL}d/'
              f'{D_FF}ff M={FAVOR} B={TRAIN_B} L={TRAIN_L} [{smi}]: '
              f'{out["steps"]} steps, losses '
              f'{[round(x, 5) for x in out["step_losses"]]}, step seconds '
              f'{[round(x, 3) for x in secs]} ({TRAIN_B * TRAIN_L / min(secs):.0f} '
              f'tokens/s at the fastest step), run {wall:.1f} s, peak '
              f'{gib():.2f} GiB; wrote {files}, log.txt {len(logs["log.txt"])} '
              f'lines, valloss.txt: {logs["valloss.txt"]}')
        expect(out['steps'] == TRAIN_BATCHES
               and all(np.isfinite(out['step_losses'])), 'f32 losses finite')
        expect(any(f.startswith('ep001_loss') and f.endswith('_params.pt')
                   for f in files)
               and any(f.endswith('_optim.pt') for f in files),
               'a checkpoint was written')
        expect(len(logs['log.txt']) == 2 + TRAIN_BATCHES
               and len(logs['valloss.txt']) == 1, 'the logs were written')

        dconf = config['data_loader']
        vocab = Vocab.load(dconf['vocab_path'])
        dset = Stage2Dataset(dconf['data_path'], vocab,
                             pieces=pickle_load(dconf['train_split']),
                             model_dec_seqlen=TRAIN_L)
        batch = batch_to_device(next(dset.batches(BF16_B, shuffle=False)), dev)
        model, omegas = train_stage2.build_model_and_params(
            config, vocab, device=dev, compute_dtype=torch.bfloat16)
    expect(all(layer.heads_last == heads_last for layer in model.layers),
           f'EMODIS_HL_ATTN chose the {layout} layout')
    extras = {'omegas': omegas}
    loss_fn = stage2_performer_loss_fn(model, vocab.pad_id)
    step = make_train_step(loss_fn, model, make_optimizer(
        model.parameters(), OptimizerConfig()))
    losses = [float(step(batch, extras)[0])]               # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = collections.Counter(_build.LAUNCHES)
    t0 = time.time()
    for _ in range(BF16_STEPS):
        losses.append(float(step(batch, extras)[0]))
    torch.cuda.synchronize()
    secs = time.time() - t0
    per_step = {k: (_build.LAUNCHES[k] - before[k]) / BF16_STEPS
                for k in HEAD_MAJOR + HEADS_LAST}
    print(f'{tag}b bf16 train steps {layout} B={BF16_B} L={TRAIN_L} [{smi}]: '
          f'{BF16_B * TRAIN_L * BF16_STEPS / secs:.0f} tokens/s '
          f'({secs * 1e3 / BF16_STEPS:.1f} ms a step, host clock, synchronized), '
          f'peak {gib():.2f} GiB, losses {[round(x, 5) for x in losses]}, '
          f'launches per step {per_step}; with pass A on 4x4 f32 tiles '
          f'{SCALAR_PASS_A["wall " + layout]:.1f} ms a step, with pass B on them '
          f'{SCALAR_PASS_B["wall " + layout]:.1f}, with the forward on them '
          f'{SCALAR_FWD["wall " + layout]:.1f}, with the key max on them '
          f'{SCALAR_KMAX["wall " + layout]:.1f}')
    expect(all(np.isfinite(losses)), 'bf16 losses finite')
    expect(all(p.dtype == torch.float32 for p in model.parameters()),
           'master weights stay f32')
    ran, idle = (HEADS_LAST, HEAD_MAJOR) if heads_last else (HEAD_MAJOR, HEADS_LAST)
    expect(all(per_step[k] == N_LAYER for k in ran)
           and not any(per_step[k] for k in idle),
           f'each {layout} FAVOR kernel launched once a layer per step, the '
           f'other layout\'s none')

    fixed = make_train_step(loss_fn, model, make_optimizer(
        model.parameters(), OptimizerConfig(max_lr=1e-3, min_lr=1e-4,
                                            warmup_steps=2, lr_decay_steps=100)))
    falls = [float(fixed(batch, extras)[0]) for _ in range(8)]
    print(f'{tag}c one bf16 batch {layout}, 8 steps, warmup 2, lr 1e-3: losses '
          f'{[round(x, 4) for x in falls]}')
    expect(np.mean(falls[-2:]) < np.mean(falls[:2]), 'the loss falls')
    return step, batch, extras, secs / BF16_STEPS


def phase_train_gpt2(dev, smi):
    """The gpt2_training path: ``train_stage2.run`` for GPT-2 at
    ``configs/stage2/pop1k7_pretrain_gpt2.yaml``'s values (f32, B=4,
    L=2048, two micro-batches an update, warmup 200) for GPT2_TRAIN_BATCHES
    micro-batches and the validation batches, then a fixed batch whose loss
    must fall over 8 steps.  Returns the number of validation forwards: each
    runs in eval() mode at L=2048 and launches flash_attention_fwd once a
    layer, while the train steps take the einsum path."""
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    from emo_disentanger_tpu_torch.data.datasets import Stage2Dataset
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.train import train_stage2
    from emo_disentanger_tpu_torch.train.trainer import (
        OptimizerConfig, batch_to_device, make_optimizer, make_train_step,
        stage2_gpt2_loss_fn)
    from emo_disentanger_tpu_torch.utils.io import pickle_load
    with tempfile.TemporaryDirectory() as root:
        config = write_corpus(root, np.random.RandomState(9))
        config['model']['max_len'] = GPT2_TRAIN_L
        config['training'].pop('feat_redraw_prob')
        config['training'].update(accum_steps=GPT2_ACCUM,
                                  ckpt_dir=os.path.join(root, 'ckpt_gpt2_{}'))
        dconf = config['data_loader']
        vocab = Vocab.load(dconf['vocab_path'])
        data = lambda split: Stage2Dataset(dconf['data_path'], vocab,
                                           pieces=pickle_load(dconf[split]),
                                           model_dec_seqlen=GPT2_TRAIN_L)
        n_val = sum(1 for _ in data('val_split').batches(TRAIN_B, shuffle=False))
        torch.cuda.reset_peak_memory_stats()
        n0 = _build.LAUNCHES['flash_attention_fwd']
        t0 = time.time()
        out = train_stage2.run(config, 'functional', 'gpt2', max_epoch_override=1,
                               max_batches_per_epoch=GPT2_TRAIN_BATCHES, device=dev)
        wall = time.time() - t0
        n_flash = _build.LAUNCHES['flash_attention_fwd'] - n0
        ckpt = out['ckpt_dir']
        files = sorted(os.listdir(os.path.join(ckpt, 'params')))
        val = open(os.path.join(ckpt, 'valloss.txt')).read().splitlines()
        secs = out['step_seconds']
        print(f'phase 8g train_stage2.run GPT-2 f32 {N_LAYER}L/{N_HEAD}H/{D_MODEL}d/'
              f'{D_FF}ff B={TRAIN_B} L={GPT2_TRAIN_L} accum {GPT2_ACCUM} [{smi}]: '
              f'{out["steps"]} micro-batches, losses '
              f'{[round(x, 5) for x in out["step_losses"]]}, step seconds '
              f'{[round(x, 3) for x in secs]} ({TRAIN_B * GPT2_TRAIN_L / min(secs):.0f} '
              f'tokens/s at the fastest), run {wall:.1f} s, peak '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; wrote '
              f'{files}; valloss.txt: {val}; flash_attention_fwd launches '
              f'{n_flash} for {n_val} validation forwards')
        expect(out['steps'] == GPT2_TRAIN_BATCHES
               and all(np.isfinite(out['step_losses'])), 'GPT-2 losses finite')
        expect(any(f.startswith('ep001_loss') and f.endswith('_params.pt')
                   for f in files), 'a GPT-2 checkpoint was written')
        expect(len(val) == 1, 'the GPT-2 valloss line was written')
        expect(n_flash == N_LAYER * n_val, 'flash_attention_fwd launched once a '
               'layer per validation forward and never in a train step')
        batch = batch_to_device(next(data('train_split').batches(
            TRAIN_B, shuffle=False)), dev)
        model, _ = train_stage2.build_model_and_params(config, vocab, 'gpt2',
                                                       device=dev)
    # the config's peak lr (1e-4): at the Performer check's 1e-3 this f32
    # GPT-2 diverges within three steps, though the port's steps follow
    # JAX's there (tests/test_torch_gpt2_lr.py, reduced width, on the CPU)
    fixed = make_train_step(stage2_gpt2_loss_fn(model, vocab.pad_id), model,
                            make_optimizer(model.parameters(), OptimizerConfig(
                                max_lr=1e-4, min_lr=1e-5, warmup_steps=2,
                                lr_decay_steps=100)))
    falls = [float(fixed(batch, {})[0]) for _ in range(8)]
    print(f'phase 8g-c one GPT-2 f32 batch, 8 steps, warmup 2, lr 1e-4: losses '
          f'{[round(x, 4) for x in falls]}')
    expect(np.mean(falls[-2:]) < np.mean(falls[:2]), 'the GPT-2 loss falls')
    return n_val


def composed_attention(omega):
    """The composed FAVOR+ attention as a user writes it with the port's
    public ops: feature maps, then causal_linear_attention."""
    from emo_disentanger_tpu_torch.ops import causal_linear_attention, favor_features
    return lambda q, k, v: causal_linear_attention(
        favor_features(q, omega, is_query=True),
        favor_features(k, omega, is_query=False), v)


def phase_composed(dev):
    """The composed_attention path: the composed FAVOR+ attention forward
    and backward through autograd to dq, dk and dv at B=16, H=8, L=3072,
    Dh=64, M=128, f32, against favor_causal_attention (#1-#4) on the same
    q, k, v and omega: the output within TOL_F32, each gradient within
    TOL_COMPOSED_GRAD.  The launch counts are set to 0 just before the
    composed call and read just after it; returns them."""
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    gen = torch.Generator().manual_seed(22)
    B, L = BF16_B, TRAIN_L
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    q, k, v, g = (qkv(gen, B, N_HEAD, L, torch.float32, dev)
                  + qkv(gen, B, N_HEAD, L, torch.float32, dev)[:1])

    def run(attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attention(*leaves)
        out.backward(g)
        return out.detach(), [t.grad for t in leaves]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.LAUNCHES.clear()                  # the composed_attention path starts here
    out, grads = run(composed_attention(omega))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ref, ref_grads = run(lambda q_, k_, v_: la.favor_causal_attention(q_, k_, v_, omega))
    torch.cuda.synchronize()
    e_out = rel_err(out, ref)
    errs = {n: rel_err(a, b) for n, a, b in zip(('dq', 'dk', 'dv'), grads, ref_grads)}
    print(f'phase 9 composed_attention f32 B={B} H={N_HEAD} L={L} Dh={D_HEAD} '
          f'M={FAVOR}: causal_linear_attention(favor_features(q), '
          f'favor_features(k), v) vs favor_causal_attention: out rel err '
          f'{e_out:.2e} (tol {TOL_F32}), gradients rel err '
          f'{", ".join(f"{n} {e:.2e}" for n, e in errs.items())} (tol '
          f'{TOL_COMPOSED_GRAD}); peak {peak:.2f} GiB above the memory held '
          f'before; launches {launches}')
    expect(out.dtype == torch.float32 and out.shape == ref.shape
           and bool(torch.isfinite(out).all())
           and all(bool(torch.isfinite(t).all()) for t in grads),
           'composed output f32, shape, finite')
    expect(e_out <= TOL_F32, 'the composed output matches the fused op')
    expect(max(errs.values()) <= TOL_COMPOSED_GRAD,
           'the composed gradients match the fused op')
    expect(launches == {name: 1 for name in COMPOSED},
           'the composed call launched #5, #6 and #7 once each and no FAVOR '
           'kernel')
    return launches


def fwd_beside(name, t, b, BH, L):
    """The forward's 3xTF32 bound share, its f32 bound and the 4x4 design's
    reading at this shape, for phases 6 and 6h."""
    from emo_disentanger_tpu_torch.ops.linear_attention import KERNEL_CHUNK
    b_f32 = fwd_bound(BH, L, D_HEAD, D_HEAD, FAVOR, 2, KERNEL_CHUNK)[0]
    return (f' in 3xTF32 ({b / t:.3f} of it), {b_f32:.4f} with the omega products '
            f'in f32 on the CUDA cores; on 4x4 f32 tiles {SCALAR_FWD[name]:.4f}')


def kmax_beside(name, t, b, BH, L):
    """The key max's 3xTF32 bound share, its f32 bound and the 4x4 design's
    reading at this shape, for phases 6 and 6h."""
    from emo_disentanger_tpu_torch.ops.linear_attention import KERNEL_CHUNK
    b_f32 = kmax_bound(BH, L, D_HEAD, FAVOR, 2, KERNEL_CHUNK)[0]
    return (f' in 3xTF32 ({b / t:.3f} of it), {b_f32:.4f} in f32 on the CUDA cores; '
            f'on 4x4 f32 tiles {SCALAR_KMAX[name]:.4f}')


def phase_timing(dev, rec, smi):
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    from emo_disentanger_tpu_torch.ops import performer_decode as pd
    gen = torch.Generator().manual_seed(14)
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    bf = torch.bfloat16
    for B, L in ((ENTRY_B, ENTRY_L), (WINDOW_B, WINDOW_L)):
        q, k, v = qkv(gen, B, N_HEAD, L, bf, dev)
        BH = B * N_HEAD
        q2, k2, v2 = (t.reshape(BH, L, D_HEAD) for t in (q, k, v))
        part = la._favor_kmax_cuda(k2, omega)
        t_k = time_ms(lambda: la._favor_kmax_cuda(k2, omega))
        t_f = time_ms(lambda: la._favor_fwd_cuda(q2, k2, v2, omega, part))
        p_k = time_ms(lambda: la._key_max_plain(k2, omega))
        p_f = time_ms(lambda: la._favor_compose(q, k, v, omega), iters=5)
        # the key max's and the forward's bounds count their omega products
        # in 3xTF32, as they run them; the f32 figures (CUDA cores) are
        # printed beside them
        b_k, by_k = kmax_bound(BH, L, D_HEAD, FAVOR, 2, la.KERNEL_CHUNK,
                               TF32_FLOP_PER_S, 3)
        b_f, by_f = fwd_bound(BH, L, D_HEAD, D_HEAD, FAVOR, 2, la.KERNEL_CHUNK,
                              TF32_FLOP_PER_S, 3)
        print(f'phase 6 kernel A bf16 B={B} L={L} [{smi}]: favor_kmax '
              f'{t_k:.4f} ms (plain {p_k:.4f}, bound {b_k:.4f} {by_k}'
              f'{kmax_beside(f"favor_kmax B={B} L={L}", t_k, b_k, BH, L)}); '
              f'favor_fwd {t_f:.4f} ms (plain {p_f:.4f}, bound {b_f:.4f} {by_f}'
              f'{fwd_beside(f"favor_fwd B={B} L={L}", t_f, b_f, BH, L)})')
        if B == ENTRY_B:
            rec['favor_kmax'].update(ms=t_k, plain_ms=p_k, bound_ms=b_k, bound_by=by_k)
            rec['favor_fwd'].update(ms=t_f, plain_ms=p_f, bound_ms=b_f, bound_by=by_f)

    # one decode step: 12 layers' weights and state, so L2 holds none of
    # them from the previous call of the same layer
    B = SERVE_B
    layers = [layer_params(gen, bf, dev) for _ in range(N_LAYER)]
    S = torch.zeros(N_LAYER, B, N_HEAD, D_HEAD, FAVOR, device=dev)
    z = torch.zeros(N_LAYER, B, N_HEAD, FAVOR, device=dev)
    x = torch.randn(B, D_MODEL, generator=gen).to(dev, bf)
    mask = torch.ones(B, device=dev)

    def step(fn):
        def run():
            for i, p in enumerate(layers):
                fn(x, S[i], z[i], p, omega, mask, N_HEAD)
        return run
    t_d = time_ms(step(pd._decode_layer_cuda), iters=10) / N_LAYER
    p_d = time_ms(step(pd._decode_layer_plain), iters=10) / N_LAYER
    b_d, by_d = decode_bound(B, D_MODEL, N_HEAD, FAVOR, D_FF, 2, 2)
    # the device's own time: at tens of microseconds a layer the CUDA events
    # above time the wrapper's host work too
    dev_d, n_kern, top = decode_device_ms(step(pd._decode_layer_cuda))
    dev_txt = ('not measured (the profiler saw no device events)' if dev_d is None
               else f'{dev_d:.5f} ms in {n_kern:g} kernels a layer '
                    f'({b_d / dev_d:.3f} of the bound)')
    print(f'phase 6 kernel B bf16 B={B} per layer [{smi}]: '
          f'performer_decode_layer device time {dev_txt}; CUDA events around '
          f'{N_LAYER} wrapped calls {t_d:.4f} ms (plain {p_d:.4f}, bound '
          f'{b_d:.4f} {by_d}); device ms a layer by kernel: {top}')
    rec['performer_decode_layer'].update(ms=t_d if dev_d is None else dev_d,
                                         plain_ms=p_d, bound_ms=b_d, bound_by=by_d)

    # the backward passes at the bf16 train-step shape (held against their
    # plain versions at this shape in phase 2c)
    B, L = BF16_B, TRAIN_L
    BH = B * N_HEAD
    q2, k2, v2, g2 = (t.reshape(BH, L, D_HEAD) for t in
                      qkv(gen, B, N_HEAD, L, bf, dev)
                      + qkv(gen, B, N_HEAD, L, bf, dev)[:1])
    part = la._favor_kmax_cuda(k2, omega)
    kmax = part.amax(1)
    dq, u, w = la._favor_bwd_a_cuda(q2, k2, v2, g2, omega, part)
    C = la.KERNEL_CHUNK
    times = {
        'favor_bwd_a': (
            time_ms(lambda: la._favor_bwd_a_cuda(q2, k2, v2, g2, omega, part),
                    iters=5, warmup=1),
            time_ms(lambda: la._favor_bwd_a_plain(q2, k2, v2, g2, omega, kmax,
                                                  C, dot_dtype=bf),
                    iters=2, warmup=1)),
        'favor_bwd_b': (
            time_ms(lambda: la._favor_bwd_b_cuda(q2, k2, v2, u, w, omega, part),
                    iters=5, warmup=1),
            time_ms(lambda: la._favor_bwd_b_plain(q2, k2, v2, u, w, omega, kmax,
                                                  C, dot_dtype=bf),
                    iters=2, warmup=1)),
    }
    # the passes' bounds count their omega products in 3xTF32, as they run
    # them; the f32 figures (CUDA cores) are printed beside them
    b_a, b_b = (bwd_bound(BH, L, D_HEAD, D_HEAD, FAVOR, 2, part.shape[1], pass_a,
                          TF32_FLOP_PER_S, 3) for pass_a in (True, False))
    b_f32 = {p: bwd_bound(BH, L, D_HEAD, D_HEAD, FAVOR, 2, part.shape[1], p == 'a')[0]
             for p in 'ab'}

    def beside(name, t, b):
        p = name[len('favor_bwd_')]
        scalar = SCALAR_PASS_A if p == 'a' else SCALAR_PASS_B
        if name not in scalar:
            return ''
        return (f' in 3xTF32 ({b / t:.3f} of it), {b_f32[p]:.4f} with the omega '
                f'products in f32 on the CUDA cores; on 4x4 f32 tiles '
                f'{scalar[name]:.4f}')
    for name, (t, p), (b, by) in zip(times, times.values(), (b_a, b_b)):
        print(f'phase 6 kernel {name} bf16 B={B} L={L} [{smi}]: {t:.4f} ms '
              f'(plain {p:.4f}, bound {b:.4f} {by}{beside(name, t, b)})')
        rec[name].update(ms=t, plain_ms=p, bound_ms=b, bound_by=by)

    # the heads-last kernels #8-#11 at the same shape, on [B, L, D] tensors
    # holding the same values, beside the head-major #1/#2 there; the plain
    # versions split the heads first, as the CPU path does
    H = N_HEAD
    merge = lambda t: la._merge_heads(t, B)
    q, k, v, g = merge(q2), merge(k2), merge(v2), merge(g2)
    hpart = la._favor_kmax_hl_cuda(k, omega, H)
    hdq, hu, hw = la._favor_bwd_a_hl_cuda(q, k, v, g, omega, hpart, H)
    sp = lambda t: la._split_heads(t, H)
    kmax = hpart.amax(1)
    t_hm_k = time_ms(lambda: la._favor_kmax_cuda(k2, omega), iters=10)
    t_hm_f = time_ms(lambda: la._favor_fwd_cuda(q2, k2, v2, omega, part), iters=5)
    hl = {
        'favor_kmax_hl': (
            time_ms(lambda: la._favor_kmax_hl_cuda(k, omega, H), iters=10),
            time_ms(lambda: la._key_max_plain(sp(k), omega), iters=5),
            kmax_bound(BH, L, D_HEAD, FAVOR, 2, C, TF32_FLOP_PER_S, 3)),
        'favor_fwd_hl': (
            time_ms(lambda: la._favor_fwd_hl_cuda(q, k, v, omega, hpart, H), iters=5),
            time_ms(lambda: la._hl_compose(q, k, v, omega, H), iters=2, warmup=1),
            fwd_bound(BH, L, D_HEAD, D_HEAD, FAVOR, 2, C, TF32_FLOP_PER_S, 3)),
        'favor_bwd_a_hl': (
            time_ms(lambda: la._favor_bwd_a_hl_cuda(q, k, v, g, omega, hpart, H),
                    iters=5, warmup=1),
            time_ms(lambda: la._favor_bwd_a_plain(sp(q), sp(k), sp(v), sp(g), omega,
                                                  kmax, C, dot_dtype=bf),
                    iters=2, warmup=1),
            b_a),
        'favor_bwd_b_hl': (
            time_ms(lambda: la._favor_bwd_b_hl_cuda(q, k, v, hu, hw, omega, hpart, H),
                    iters=5, warmup=1),
            time_ms(lambda: la._favor_bwd_b_plain(sp(q), sp(k), sp(v), sp(hu), hw,
                                                  omega, kmax, C, dot_dtype=bf),
                    iters=2, warmup=1),
            b_b),
    }
    for name, (t, p, (b, by)) in hl.items():
        beside_hl = {'favor_kmax_hl': kmax_beside, 'favor_fwd_hl': fwd_beside}
        more = (beside_hl[name](f'{name} B={B} L={L}', t, b, BH, L) if name in beside_hl
                else beside(name, t, b))
        print(f'phase 6h kernel {name} bf16 B={B} L={L} [{smi}]: {t:.4f} ms '
              f'(plain {p:.4f}, bound {b:.4f} {by}{more})')
        rec[name].update(ms=t, plain_ms=p, bound_ms=b, bound_by=by)
    print(f'phase 6h head-major at the same shape [{smi}]: favor_kmax '
          f'{t_hm_k:.4f} ms (on 4x4 f32 tiles {SCALAR_KMAX[f"favor_kmax B={B} L={L}"]:.4f}), '
          f'favor_fwd {t_hm_f:.4f} ms (on 4x4 f32 tiles '
          f'{SCALAR_FWD[f"favor_fwd B={B} L={L}"]:.4f}), favor_bwd_a '
          f'{times["favor_bwd_a"][0]:.4f} ms, favor_bwd_b {times["favor_bwd_b"][0]:.4f} ms')


def phase_timing_cla(dev, rec, smi):
    """Kernels #5-#7 at the composed path's shape (f32, B=16, L=3072:
    BH=128) beside their plain versions and bounds; no single PyTorch call
    computes these functions.  Then the composed FAVOR+ attention beside
    favor_causal_attention at the same shape, f32 forward (no autograd) and
    forward+backward, in turns: composed, fused, fused, composed."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    gen = torch.Generator().manual_seed(23)
    B, L = BF16_B, TRAIN_L
    BH, C = B * N_HEAD, la.KERNEL_CHUNK
    q, k, v, g = cla_inputs(gen, B, L, dev)
    _, u, w = la._cla_bwd_a_cuda(q, k, v, g)
    times = {
        'cla_fwd': (time_ms(lambda: la._cla_fwd_cuda(q, k, v), iters=10),
                    time_ms(lambda: la._cla_fwd_plain(q, k, v, C), iters=3, warmup=1),
                    cla_fwd_bound(BH, L, FAVOR, D_HEAD, 4, TF32_FLOP_PER_S, 3)),
        'cla_bwd_a': (time_ms(lambda: la._cla_bwd_a_cuda(q, k, v, g), iters=10, warmup=2),
                      time_ms(lambda: la._cla_bwd_a_plain(q, k, v, g, C),
                              iters=2, warmup=1),
                      cla_bwd_bound(BH, L, FAVOR, D_HEAD, True, TF32_FLOP_PER_S, 3)),
        'cla_bwd_b': (time_ms(lambda: la._cla_bwd_b_cuda(q, k, v, u, w), iters=10,
                              warmup=2),
                      time_ms(lambda: la._cla_bwd_b_plain(q, k, v, u, w, C),
                              iters=2, warmup=1),
                      cla_bwd_bound(BH, L, FAVOR, D_HEAD, False, TF32_FLOP_PER_S, 3)),
    }
    f32_bound = {'cla_fwd': cla_fwd_bound(BH, L, FAVOR, D_HEAD, 4)[0],
                 'cla_bwd_a': cla_bwd_bound(BH, L, FAVOR, D_HEAD, True)[0],
                 'cla_bwd_b': cla_bwd_bound(BH, L, FAVOR, D_HEAD, False)[0]}
    for name, (t, p, (b, by)) in times.items():
        # the bounds count the products in 3xTF32, as the kernels run them;
        # the f32 figure (CUDA cores) and the 4x4 design's time beside
        before = {**SCALAR_CLA, **SCALAR_CLA_FWD}[name]
        print(f'phase 6l kernel {name} f32 B={B} H={N_HEAD} L={L} M={FAVOR} '
              f'Dv={D_HEAD} [{smi}]: {t:.4f} ms (plain {p:.4f}, bound {b:.4f} {by} '
              f'in 3xTF32 ({b / t:.3f} of it), {f32_bound[name]:.4f} in f32 on the CUDA '
              f'cores; on 4x4 f32 tiles {before:.4f})')
        rec[name].update(ms=t, plain_ms=p, bound_ms=b, bound_by=by)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    t = time_ms(lambda: la._cla_fwd_cuda(qb, kb, vb), iters=10)
    b, by = cla_fwd_bound(BH, L, FAVOR, D_HEAD, 2, TF32_FLOP_PER_S, 3)
    print(f'phase 6l kernel cla_fwd bf16 phi_q, phi_k, v B={B} H={N_HEAD} L={L} M={FAVOR} '
          f'Dv={D_HEAD} [{smi}]: {t:.4f} ms (bound {b:.4f} {by} in 3xTF32, {b / t:.3f} of it)')
    del q, k, v, g, u, w, qb, kb, vb

    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    x = qkv(gen, B, N_HEAD, L, torch.float32, dev)
    g = qkv(gen, B, N_HEAD, L, torch.float32, dev)[0]
    leaves = [t.clone().requires_grad_() for t in x]
    fns = {'composed': composed_attention(omega),
           'fused': lambda q_, k_, v_: la.favor_causal_attention(q_, k_, v_, omega)}

    def forward(fn):
        def run():
            with torch.no_grad():
                fn(*x)
        return run

    def forward_backward(fn):
        def run():
            for t in leaves:
                t.grad = None
            fn(*leaves).backward(g)
        return run
    res = {(kind, name): [] for kind in ('fwd', 'fwd+bwd') for name in fns}
    for name in ('composed', 'fused', 'fused', 'composed'):
        res['fwd', name].append(time_ms(forward(fns[name]), iters=5, warmup=1))
        res['fwd+bwd', name].append(time_ms(forward_backward(fns[name]), iters=3,
                                            warmup=1))
    fmt = lambda ts: ' / '.join(f'{t:.4f}' for t in ts)
    print(f'phase 6l composed vs fused FAVOR+ attention f32 B={B} H={N_HEAD} '
          f'L={L} Dh={D_HEAD} M={FAVOR} [{smi}], two readings each (CUDA events): '
          f'forward {fmt(res["fwd", "composed"])} ms composed (on 4x4 f32 tiles '
          f'{fmt(SCALAR_CLA_FWD["fwd composed"])}), {fmt(res["fwd", "fused"])} ms fused; '
          f'forward+backward '
          f'{fmt(res["fwd+bwd", "composed"])} ms composed (on 4x4 f32 tiles '
          f'{fmt(SCALAR_CLA["fwd+bwd composed"])}), {fmt(res["fwd+bwd", "fused"])} ms fused')


def phase_profile(model, omegas, vocab, dev, smi):
    """Where a serving step's time goes: a short serve() run timed on the
    host clock, then the same run under torch.profiler for device time by
    kernel (device events only, so nothing is counted twice)."""
    from torch.profiler import ProfilerActivity, profile
    from emo_disentanger_tpu_torch.infer.stage2_batch import Stage2BatchGenerator
    primers, sheets = synthetic_jobs(vocab, SERVE_B, np.random.RandomState(6))
    gen = Stage2BatchGenerator(model, vocab, batch=SERVE_B, temp=1.1,
                               top_p=0.99, max_events=64, omegas=omegas,
                               device=dev)
    _, stats = gen.serve(primers, sheets, seed=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, pstats = gen.serve(primers, sheets, seed=8)
        torch.cuda.synchronize()
    expect(pstats['steps'] == stats['steps'], 'profiled run repeats the run')
    steps = stats['steps']
    wall = stats['wall_seconds'] * 1e3 / steps
    busy, top = kernel_breakdown(prof, steps)
    if busy == 0:
        print('phase 7 profile: device time not measured (the profiler saw '
              'no device events)')
        return
    print(f'phase 7 profile serve B={SERVE_B}, {steps} steps [{smi}]: wall '
          f'{wall:.3f} ms/step, device busy {busy:.3f} ms/step (idle share '
          f'{1 - busy / wall:.3f}); device ms/step by kernel: {top}')


def decode_device_ms(run, reps=20):
    """(device ms a layer, device kernels a layer, the kernels by device ms
    a layer) of ``run`` -- one decode step of N_LAYER wrapped layer calls --
    from torch.profiler over ``reps`` steps; (None, 0, '') when the
    profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    layers = reps * N_LAYER
    busy, top = kernel_breakdown(prof, layers, n_top=6)
    if busy == 0:
        return None, 0, ''
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False))
    return busy, n / layers, top


def copy_ms(prof, steps):
    """Device ms a step of PyTorch's copy kernels (layout copies such as the
    head split's and dtype casts) in a torch.profiler run."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and 'copy' in e.key.lower()
               ) / 1e3 / steps


def phase_profile_train(step, batch, extras, wall_ms, smi, label='phase 7b',
                        layout='head-major'):
    """Where a bf16 train step's device time goes: two steps under
    torch.profiler, against the step's host-clock time from phase 8b (8h-b
    for the heads-last layout); the copy kernels' share is read apart."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(batch, extras)
        torch.cuda.synchronize()
    busy, top = kernel_breakdown(prof, 2, n_top=12)
    if busy == 0:
        print(f'{label} profile: device time not measured (the profiler saw '
              f'no device events)')
        return
    print(f'{label} profile bf16 train step {layout} B={BF16_B} L={TRAIN_L} [{smi}]: '
          f'wall {wall_ms:.1f} ms/step, device busy {busy:.1f} ms/step (idle '
          f'share {1 - busy / wall_ms:.3f}); copy kernels {copy_ms(prof, 2):.2f} '
          f'ms/step; device ms/step by kernel: {top}')
    hl = '' if layout == 'head-major' else '_hl'
    print(f'{label} favor_kmax{hl} {kernel_ms(prof, 2, "favor_kmax_kernel"):.2f} ms/step, '
          f'wall {wall_ms:.1f} ms/step; with the key max on 4x4 f32 tiles '
          f'{SCALAR_KMAX["step " + layout]:.2f} and {SCALAR_KMAX["wall " + layout]:.1f}')
    print(f'{label} favor_fwd{hl} {kernel_ms(prof, 2, "favor_fwd_kernel"):.2f} ms/step, '
          f'wall {wall_ms:.1f} ms/step; with the forward on 4x4 f32 tiles '
          f'{SCALAR_FWD["step " + layout]:.2f} and {SCALAR_FWD["wall " + layout]:.1f}')
    for p, scalar in (('a', SCALAR_PASS_A), ('b', SCALAR_PASS_B)):
        print(f'{label} favor_bwd_{p}{hl} {kernel_ms(prof, 2, f"favor_bwd_{p}_kernel"):.2f} '
              f'ms/step, wall {wall_ms:.1f} ms/step; with pass {p.upper()} on 4x4 f32 '
              f'tiles {scalar["step " + layout]:.2f} and {scalar["wall " + layout]:.1f}')


def phase_kernel_flash(dev, rec, smi):
    """Kernel #13: flash_attention_fwd against its plain version at the
    re-anchor shape and the smallest shape the dispatch sends, f32, beside
    scaled_dot_product_attention's error against the same plain version
    (TF32 off, as main() sets it; the port never calls it); then at the
    re-anchor shape the kernel's time, the plain version's, SDPA's, the
    kernel's again, and the bounds: 3xTF32 on the tensor cores, and f32 on
    the CUDA cores for comparison.  The kernel must beat SDPA."""
    from emo_disentanger_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator().manual_seed(17)
    scale = 1.0 / D_HEAD ** 0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, L in FLASH_CASES:
        q, k, v = [(FLASH_STD * torch.randn(B, N_HEAD, L, D_HEAD, generator=gen)
                    ).to(dev) for _ in range(3)]
        got = fa._flash_attention_cuda(q, k, v, scale)
        ref = fa._flash_attention_plain(q, k, v, scale)
        lib = sdpa(q, k, v, is_causal=True, scale=scale)
        torch.cuda.synchronize()
        err, e_lib = rel_err(got, ref), rel_err(lib, ref)
        print(f'phase 2f kernel #13 f32 B={B} H={N_HEAD} L={L} Dh={D_HEAD}: '
              f'flash_attention_fwd rel err {err:.2e} (tol {TOL_F32}); '
              f'scaled_dot_product_attention rel err {e_lib:.2e}')
        expect(got.dtype == torch.float32 and got.shape == ref.shape
               and bool(torch.isfinite(got).all()),
               'flash_attention_fwd output dtype/shape/finite')
        expect(err <= TOL_F32, f'flash_attention_fwd B={B} L={L}')
        if (B, L) != FLASH_CASES[0]:
            continue
        rec['flash_attention_fwd']['max_abs_err'] = max_abs(got, ref)
        del ref, lib
        kernel = lambda: fa._flash_attention_cuda(q, k, v, scale)
        t_k = time_ms(kernel, iters=10)
        t_p = time_ms(lambda: fa._flash_attention_plain(q, k, v, scale),
                      iters=3, warmup=1)
        t_l = time_ms(lambda: sdpa(q, k, v, is_causal=True, scale=scale), iters=10)
        t_k2 = time_ms(kernel, iters=10)
        b_k, by_k = flash_bound(B, N_HEAD, L, D_HEAD)
        b_f, by_f = flash_bound(B, N_HEAD, L, D_HEAD, F32_FLOP_PER_S, passes=1)
        print(f'phase 6f kernel #13 f32 B={B} H={N_HEAD} L={L} [{smi}]: '
              f'flash_attention_fwd {t_k:.4f} / {t_k2:.4f} ms (plain {t_p:.4f}, '
              f'scaled_dot_product_attention {t_l:.4f}, bound {b_k:.4f} {by_k} '
              f'in 3xTF32 ({b_k / t_k:.2f} of it), {b_f:.4f} {by_f} in f32 on '
              f'the CUDA cores)')
        rec['flash_attention_fwd'].update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                          bound_ms=b_k, bound_by=by_k)
        expect(max(t_k, t_k2) < t_l, 'flash_attention_fwd is faster than '
               'scaled_dot_product_attention')


def build_gpt2(vocab, dev):
    from emo_disentanger_tpu_torch.models import MusicGPT2
    return MusicGPT2(n_token=vocab.size, n_layer=N_LAYER, n_head=N_HEAD,
                     d_model=D_MODEL, d_ff=D_FF, d_embed=D_MODEL,
                     max_len=GPT2_MAX_LEN, device=dev,
                     generator=torch.Generator().manual_seed(2)).eval()


@torch.no_grad()
def phase_gpt2_model(vocab, dev):
    """The f32 forward at B=2, L=GPT2_WINDOW through flash_attention_fwd
    against the same model's einsum path; a 'khd' cache prefilled from that
    forward's k/v (the re-anchor route) whose f32 decode of the next tokens
    must reproduce the forward over the extended sequence (einsum path, L
    not a multiple of 128); the bf16 forward against the f32 one.  Returns
    the bf16 model."""
    from emo_disentanger_tpu_torch.models import gpt2
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.utils.precision import cast_params
    model = build_gpt2(vocab, dev)
    gen = torch.Generator().manual_seed(18)
    B, P, S = ENTRY_B, GPT2_WINDOW, GPT2_DECODE_STEPS
    tokens = torch.randint(0, vocab.size - 1, (B, P + S), generator=gen).to(dev)
    seg = torch.randint(0, 2, (B, P + S), generator=gen).to(dev)
    n0 = _build.LAUNCHES['flash_attention_fwd']
    ref, k, v = model(tokens[:, :P], seg[:, :P], return_kv=True)
    expect(_build.LAUNCHES['flash_attention_fwd'] - n0 == N_LAYER,
           'the prefill forward ran flash_attention_fwd once a layer')
    real = gpt2._flash_applies
    gpt2._flash_applies = lambda training, q: False
    try:
        ein = model(tokens[:, :P], seg[:, :P])
    finally:
        gpt2._flash_applies = real
    e_path = rel_err(ref, ein)
    full = model(tokens, seg)                   # L = P + S: the einsum path
    cache = model.init_decode_cache(B, GPT2_CACHE)
    cache['k'][:, :, :P] = k
    cache['v'][:, :, :P] = v
    t = torch.full((B,), P, dtype=torch.long, device=dev)
    dec = torch.stack([model.decode_step_batchpos(tokens[:, P + i], seg[:, P + i],
                                                  t + i, cache)[0]
                       for i in range(S)], 1)
    e_dec = rel_err(dec, full[:, P:])
    cast_params(model)
    out = model(tokens[:, :P], seg[:, :P])
    torch.cuda.synchronize()
    t0 = time.time()
    model(tokens[:, :P], seg[:, :P])
    torch.cuda.synchronize()
    secs = time.time() - t0
    e_bf = rel_err(out, ref)
    print(f'phase 4g GPT-2 {N_LAYER}L/{N_HEAD}H/{D_MODEL}d/{D_FF}ff V={vocab.size} '
          f'f32 B={B} L={P}: forward through flash_attention_fwd vs the einsum '
          f'path rel err {e_path:.2e} (tol {TOL_GPT2_KERNEL_PATH}); decode of '
          f'{S} tokens from the prefilled cache vs the forward rel err '
          f'{e_dec:.2e} (tol {TOL_DECODE_VS_FORWARD}); bf16 forward in '
          f'{secs * 1e3:.1f} ms, rel err vs f32 {e_bf:.2e} (tol {TOL_BF16_MODEL})')
    expect(bool(torch.isfinite(out).all()) and tuple(out.shape) == (B, P, vocab.size),
           'GPT-2 bf16 forward finite, shape')
    expect(e_path <= TOL_GPT2_KERNEL_PATH, 'GPT-2 kernel path matches einsum')
    expect(e_dec <= TOL_DECODE_VS_FORWARD, 'GPT-2 f32 decode matches the forward')
    expect(e_bf <= TOL_BF16_MODEL, 'GPT-2 bf16 forward agrees with f32')
    return model


def check_streams(streams, primers, sheets, vocab, what):
    """Each stream opens with its primer, Track_LeadSheet and bar 0 as
    injected, and holds no PAD."""
    lead = vocab.event2idx['Track_LeadSheet']
    for j, s in enumerate(streams):
        bar0 = sheets[j][0]
        expect(s[:len(primers[j]) + 1] == primers[j] + [lead]
               and s[len(primers[j]) + 1:len(primers[j]) + 1 + len(bar0)] == bar0
               and vocab.pad_id not in s
               and all(0 <= x < vocab.size for x in s), f'{what} stream {j}')


def phase_gpt2_serve(model, vocab, dev, smi):
    """The gpt2_serving path with bf16 weights.  Returns the number of
    forwards at L = GPT2_WINDOW it ran (each should launch
    flash_attention_fwd once a layer)."""
    from emo_disentanger_tpu_torch.infer.reference_exact import (
        generate_stage2_reference_exact)
    from emo_disentanger_tpu_torch.infer.stage2 import Stage2Generator
    from emo_disentanger_tpu_torch.infer.stage2_batch import (
        STATUS_IDLE, STATUS_RUNNING, Stage2BatchGenerator)
    windows = []
    hook = model.register_forward_pre_hook(
        lambda mod, args: windows.append(args[0].shape[1]))
    kw = dict(temp=1.1, top_p=0.99, gpt2_cache_len=GPT2_CACHE,
              gpt2_window=GPT2_WINDOW, reanchor_margin=GPT2_MARGIN,
              max_bar_tokens=GPT2_BAR_TOKENS, device=dev)
    try:
        primers, sheets = synthetic_jobs(vocab, 24, np.random.RandomState(7),
                                         bars=GPT2_JOB_BARS)
        gen = Stage2BatchGenerator(model, vocab, batch=SERVE_B,
                                   max_events=GPT2_EVENTS, **kw)
        streams, stats = gen.serve(primers, sheets, seed=9)
        done = sum(s is not None for s in streams)
        events = sum(stats['events'])
        print(f'phase 5g GPT-2 serve bf16 [{smi}]: {done}/{len(primers)} jobs in '
              f'{SERVE_B} slots, {events} events in {stats["wall_seconds"]:.2f} s '
              f'= {events / stats["wall_seconds"]:.1f} events/s, {stats["steps"]} '
              f'steps ({stats["wall_seconds"] * 1e3 / stats["steps"]:.3f} ms '
              f'each), {stats["chunks"]} chunks, re-anchors '
              f'{sum(stats["reanchors"])} (per job {sorted(set(stats["reanchors"]))}), '
              f'statuses {sorted(set(stats["status"]))}')
        expect(done == len(primers), 'every GPT-2 job finished')
        expect(all(st not in (STATUS_RUNNING, STATUS_IDLE)
                   for st in stats['status']), 'every GPT-2 job has a final status')
        expect(sum(stats['reanchors']) > 0, 'serve() re-anchored')
        check_streams(streams, primers, sheets, vocab, 'serve')

        lad = Stage2BatchGenerator(model, vocab, batch=SERVE_B,
                                   max_events=GPT2_TIER_EVENTS,
                                   gpt2_tiers=GPT2_TIERS, **kw)
        t0 = time.time()
        lstreams, lstats = lad.generate(primers[:SERVE_B], sheets[:SERVE_B], seed=10)
        secs = time.time() - t0
        levents = sum(lstats['events'])
        print(f'phase 5h GPT-2 generate B={SERVE_B} tiers {GPT2_TIERS}: '
              f'{levents} events in {secs:.2f} s = {levents / secs:.1f} events/s, '
              f'{lstats["steps"]} steps ({secs * 1e3 / lstats["steps"]:.3f} ms '
              f'each), tier resumes {lstats["tier_resumes"]}, statuses '
              f'{sorted(set(lstats["status"]))}')
        expect(lstats['tier_resumes'] >= 1, 'the cache ladder resumed')
        check_streams(lstreams, primers, sheets, vocab, 'ladder')

        host = Stage2Generator(model, vocab, temp=1.1, top_p=0.99,
                               max_events=GPT2_HOST_EVENTS,
                               gpt2_cache_len=GPT2_HOST_CACHE,
                               gpt2_window=GPT2_WINDOW,
                               reanchor_margin=GPT2_MARGIN, device=dev)
        hstream, hstats = host.generate(primers[0], sheets[0], seed=11)
        print(f'phase 5i GPT-2 Stage2Generator, cache {GPT2_HOST_CACHE}: '
              f'{hstats["n_events"]} events in {hstats["seconds"]:.2f} s, '
              f'{hstats["reanchors"]} re-anchors, status {hstats["status"]}')
        expect(hstats['reanchors'] >= 1, 'Stage2Generator re-anchored')
        check_streams([hstream], primers[:1], sheets[:1], vocab, 'host')

        np.random.seed(12)
        t0 = time.time()
        rstream, rsteps = generate_stage2_reference_exact(
            model, vocab, lead_sheet_events=sheets[1], primer=primers[1],
            max_events=GPT2_WINDOW + 16, temp=1.2, top_p=0.9,
            window=GPT2_WINDOW)
        print(f'phase 5j GPT-2 reference-exact replay, window {GPT2_WINDOW}: '
              f'{len(rstream)} tokens, {rsteps} accepted samples in '
              f'{time.time() - t0:.2f} s')
        expect(len(rstream) >= GPT2_WINDOW, 'the replay passed its window')
        check_streams([rstream], primers[1:2], sheets[1:2], vocab, 'replay')
    finally:
        hook.remove()
    n = sum(w == GPT2_WINDOW for w in windows)
    print(f'gpt2_serving forwards: {len(windows)}, {n} at L={GPT2_WINDOW}')
    expect(n > 0 and n == len(windows), 'every GPT-2 path forward ran at the window')
    return n


def phase_profile_gpt2(model, vocab, dev, smi):
    """Where a GPT-2 serving step's time goes: a short serve() (no re-anchor)
    on the host clock, then under torch.profiler.  The decode attention's
    two products run as aten::einsum; their device time (layout copies
    included) is read from the profiler's operator events."""
    from torch.profiler import ProfilerActivity, profile
    from emo_disentanger_tpu_torch.infer.stage2_batch import Stage2BatchGenerator
    primers, sheets = synthetic_jobs(vocab, SERVE_B, np.random.RandomState(8))
    gen = Stage2BatchGenerator(model, vocab, batch=SERVE_B, temp=1.1,
                               top_p=0.99, max_events=64,
                               gpt2_cache_len=GPT2_CACHE,
                               gpt2_window=GPT2_WINDOW, device=dev)
    _, stats = gen.serve(primers, sheets, seed=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, pstats = gen.serve(primers, sheets, seed=8)
        torch.cuda.synchronize()
    expect(pstats['steps'] == stats['steps'], 'profiled run repeats the run')
    steps = stats['steps']
    wall = stats['wall_seconds'] * 1e3 / steps
    busy, top = kernel_breakdown(prof, steps)
    if busy == 0:
        print('phase 7g profile: device time not measured (the profiler saw '
              'no device events)')
        return
    einsum = sum(e.device_time_total for e in prof.key_averages()
                 if e.key == 'aten::einsum') / 1e3 / steps
    print(f'phase 7g profile GPT-2 serve B={SERVE_B} cache {GPT2_CACHE}, {steps} '
          f'steps [{smi}]: wall {wall:.3f} ms/step, device busy {busy:.3f} '
          f'ms/step (idle share {1 - busy / wall:.3f}); decode attention '
          f'products (aten::einsum) {einsum:.3f} ms/step ({einsum / busy:.3f} '
          f'of busy); device ms/step by kernel: {top}')


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------

S1_DEGREES = ['I', 'II', 'III', 'IV', 'V', 'VI', 'VII']


def s1_dictionary():
    """(event2word, word2event) of a functional stage-1 lead-sheet
    vocabulary, as ``tests/helpers.py`` builds one (two emotions, no
    velocity, no tempo): 215 events and PAD."""
    from emo_disentanger_tpu_torch.core.vocab import (
        MAJOR_KEY, MINOR_KEY, events_to_dictionary)
    corpus = (['Bar_None', 'EOS_None'] + [f'Beat_{b}' for b in range(16)]
              + [f'Key_{k}' for k in list(MAJOR_KEY) + list(MINOR_KEY)])
    return events_to_dictionary([corpus], add_velocity=False, add_tempo=False,
                                num_emotion=2, relative=True)


def build_txl(vocab, dev, **kw):
    from emo_disentanger_tpu_torch.models import PlainTransformer
    return PlainTransformer(vocab.size, d_embed=D_MODEL, n_layer=N_LAYER,
                            n_head=N_HEAD, d_model=D_MODEL, d_ff=D_FF,
                            pad_id=vocab.pad_id, device=dev,
                            generator=torch.Generator().manual_seed(3), **kw)


@torch.no_grad()
def phase_s1_model(vocab, dev, smi):
    """The f32 forward at B=4, L=512; the f32 decode of the same tokens
    through the chunked (two chunks of 256) and the whole-cache attention
    against it; the per-element-clock decode at a uniform clock against the
    whole-cache decode; the bf16 forward against the f32 one.  Returns the
    model with bf16 weights."""
    from emo_disentanger_tpu_torch.utils.precision import cast_params
    model = build_txl(vocab, dev).eval()
    gen = torch.Generator().manual_seed(19)
    tokens = torch.randint(0, vocab.size - 1, (S1_B, S1_L), generator=gen).to(dev)
    ref, _ = model(tokens)
    torch.cuda.synchronize()
    t0 = time.time()
    model(tokens)
    torch.cuda.synchronize()
    fwd_ms = (time.time() - t0) * 1e3
    dec, ms = {}, {}
    for path in ('flash', 'full', 'pe'):
        cache = model.init_decode_cache(S1_B, S1_L)
        steps = []
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(S1_L):
            if path == 'pe':
                t = torch.full((S1_B,), i, dtype=torch.long, device=dev)
                steps.append(model.decode_step_pe(tokens[:, i], t, cache)[0])
            else:
                steps.append(model.decode_step(tokens[:, i], i, cache,
                                               full_attention=path == 'full')[0])
        torch.cuda.synchronize()
        ms[path] = (time.time() - t0) * 1e3 / S1_L
        dec[path] = torch.stack(steps, 1)
    e_flash, e_full = rel_err(dec['flash'], ref), rel_err(dec['full'], ref)
    same = bool((dec['pe'].argmax(-1) == dec['full'].argmax(-1)).all())
    d_pe = max_abs(dec['pe'], dec['full'])
    cast_params(model)
    out, _ = model(tokens)
    e_bf = rel_err(out, ref)
    print(f'phase 4s stage-1 TXL {N_LAYER}L/{N_HEAD}H/{D_MODEL}d/{D_FF}ff V={vocab.size} '
          f'[{smi}]: f32 forward B={S1_B} L={S1_L} {fwd_ms:.1f} ms; f32 decode of '
          f'{S1_L} tokens vs the forward: chunked rel err {e_flash:.2e} '
          f'({ms["flash"]:.2f} ms a step), whole-cache {e_full:.2e} '
          f'({ms["full"]:.2f} ms a step) (tol {TOL_DECODE_VS_FORWARD}); '
          f'per-element clock vs whole-cache max abs {d_pe:.2e}, argmax stream '
          f'{"equal" if same else "DIFFERS"} ({ms["pe"]:.2f} ms a step); bf16 '
          f'forward rel err vs f32 {e_bf:.2e} (tol {TOL_BF16_MODEL})')
    expect(bool(torch.isfinite(ref).all()) and tuple(ref.shape) == (S1_B, S1_L, vocab.size),
           'stage-1 forward finite, shape')
    expect(e_flash <= TOL_DECODE_VS_FORWARD and e_full <= TOL_DECODE_VS_FORWARD,
           'stage-1 f32 decode matches the forward through both attentions')
    expect(same, 'the per-element-clock decode gives the whole-cache stream')
    expect(bool(torch.isfinite(out).all()) and e_bf <= TOL_BF16_MODEL,
           'stage-1 bf16 forward agrees with f32')
    return model


def s1_check_songs(songs, emotions, vocab, what):
    """Each song that is not stuck (None) opens with its Emotion token and a
    Key of its valence's mode, holds no PAD, and its beats never decrease
    within a bar.  Returns the number of stuck songs."""
    from emo_disentanger_tpu_torch.core.vocab import MAJOR_KEY
    from emo_disentanger_tpu_torch.infer.rules import emotion_wants_major
    stuck = 0
    for j, (song, emotion) in enumerate(zip(songs, emotions)):
        if song is None:
            stuck += 1
            continue
        key = song[1] if len(song) > 1 else ''
        expect(song[0] == f'Emotion_{emotion}' and key.startswith('Key_')
               and (key.split('_')[1] in MAJOR_KEY) == emotion_wants_major(emotion),
               f'{what} song {j} opens with its emotion and a key of its mode')
        expect('PAD_None' not in song, f'{what} song {j} holds no PAD')
        cur = 0
        for ev in song[2:]:
            if ev == 'Bar_None':
                cur = 0
            elif ev.startswith('Beat_'):
                expect(int(ev.split('_')[1]) >= cur,
                       f'{what} song {j}: beats never decrease within a bar')
                cur = int(ev.split('_')[1])
    return stuck


def s1_line(stats, secs, steps, emotions):
    events = sum(stats['events'])
    rejects = sum(stats['rejects'])
    sampled = events - len(emotions)
    return (f'{events} events in {secs:.2f} s = {events / secs:.1f} events/s, '
            f'{steps} steps ({secs * 1e3 / steps:.3f} ms each), rejects per '
            f'sampled token {rejects / max(sampled, 1):.3f}, statuses '
            f'{sorted(collections.Counter(stats["status"]).items())}')


def phase_s1_serve(model, vocab, dev, smi):
    """The stage-1 serving path with bf16 weights in the lead_sheet mode:
    the lockstep generate at B=16 through the 768 -> 1536 ladder, serve of
    24 jobs in 16 slots, one Stage1Generator song; every song held to the
    rules.  The head's Beat and EOS logits are moved first (S1_BEAT_BIAS,
    S1_EOS_BIAS)."""
    from emo_disentanger_tpu_torch.infer.stage1 import (
        STATUS_RUNNING, Stage1Generator)
    from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
    beats = [vocab.event2idx[f'Beat_{b}'] for b in range(16)]
    with torch.no_grad():
        model.dec_out_proj.bias[beats] += S1_BEAT_BIAS
        model.dec_out_proj.bias[vocab.eos_id] += S1_EOS_BIAS
    kw = dict(temp=S1_TEMP, top_p=S1_TOP_P, max_events=S1_EVENTS,
              max_bars=S1_MAX_BARS, reject_slack=S1_REJECT_SLACK, device=dev)
    gen = Stage1BatchGenerator(model, vocab, batch=S1_SERVE_B,
                               fast_slack=S1_FAST_SLACK, **kw)
    emotions = ['Positive', 'Negative'] * (S1_SERVE_B // 2)
    songs, st = gen.generate(emotions, seed=21)
    stuck = s1_check_songs(songs, emotions, vocab, 'generate')
    print(f'phase 5s stage-1 generate bf16 B={S1_SERVE_B} ladder {gen.klens} '
          f'[{smi}]: {s1_line(st, st["seconds"], st["iters"], emotions)}, '
          f'{st["resumed"]} songs resumed in the {gen.klens[-1]}-row tier, '
          f'{stuck} stuck, bars {sorted(set(st["bars"]))}')
    if st['resumed'] == 0:
        print(f'phase 5s: no ladder resume: the loop ended after {st["iters"]} '
              f'steps, before the clock reached row {gen.klens[0] - 1}')
    jobs = ['Positive', 'Negative'] * (S1_JOBS // 2)
    ssongs, sst = gen.serve(jobs, seed=22)
    sstuck = s1_check_songs(ssongs, jobs, vocab, 'serve')
    print(f'phase 5t stage-1 serve bf16 {len(jobs)} jobs in {S1_SERVE_B} slots, '
          f'cache {gen.full_klen} [{smi}]: '
          f'{s1_line(sst, sst["seconds"], sst["steps"], jobs)}, {sst["chunks"]} '
          f'chunks, {sstuck} stuck')
    expect(all(st != STATUS_RUNNING or b >= S1_MAX_BARS
               for st, b in zip(sst['status'], sst['bars'])),
           'every stage-1 job has a final status')
    single = Stage1Generator(model, vocab, **kw)
    song, hst = single.generate('Negative', 23)
    s1_check_songs([song], ['Negative'], vocab, 'Stage1Generator')
    print(f'phase 5u stage-1 Stage1Generator (chunked attention, cache '
          f'{single.max_klen}): {hst["n_events"]} events in {hst["seconds"]:.2f} s, '
          f'status {hst["status"]}, bars {hst["bars"]}')
    return gen


def phase_profile_s1(model, vocab, dev, smi):
    """Where a stage-1 serving step's time goes: serve() of 16 short jobs
    (max_events S1_PROFILE_EVENTS, the serving phase's head) in a cache of
    the lead_sheet mode's full 1536 rows on the host clock (the second of
    two runs), then the same run with torch.profiler recording
    S1_PROFILE_STEPS of its steps, all slots busy.  The decode attention's products run as aten::einsum;
    their device time (layout copies included) is read from the profiler's
    operator events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
    klen = S1_EVENTS + S1_REJECT_SLACK
    gen = Stage1BatchGenerator(model, vocab, batch=S1_SERVE_B, temp=S1_TEMP,
                               top_p=S1_TOP_P, max_events=S1_PROFILE_EVENTS,
                               reject_slack=klen - S1_PROFILE_EVENTS, device=dev)
    jobs = ['Positive', 'Negative'] * (S1_SERVE_B // 2)
    gen.serve(jobs, seed=24)                                # warm
    _, stats = gen.serve(jobs, seed=24)
    torch.cuda.synchronize()
    real_step = gen._step

    def step(*args, **kw):
        real_step(*args, **kw)
        prof.step()
    gen._step = step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=S1_PROFILE_SKIP - 2, warmup=2,
                                   active=S1_PROFILE_STEPS, repeat=1)) as prof:
        _, pstats = gen.serve(jobs, seed=24)
        torch.cuda.synchronize()
    expect(pstats['steps'] == stats['steps']
           and stats['steps'] >= S1_PROFILE_SKIP + S1_PROFILE_STEPS,
           'the profiled run repeats the run, past the profiled steps')
    wall = stats['seconds'] * 1e3 / stats['steps']
    busy, top = kernel_breakdown(prof, S1_PROFILE_STEPS)
    if busy == 0:
        print('phase 7s profile: device time not measured (the profiler saw '
              'no device events)')
        return
    from torch.autograd import DeviceType
    events = prof.key_averages()
    einsum = sum(e.device_time_total for e in events
                 if e.key == 'aten::einsum') / 1e3 / S1_PROFILE_STEPS
    kernels = sum(e.count for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, 'is_user_annotation', False))
    print(f'phase 7s profile stage-1 serve B={S1_SERVE_B} cache {klen}, steps '
          f'{S1_PROFILE_SKIP}-{S1_PROFILE_SKIP + S1_PROFILE_STEPS} of '
          f'{stats["steps"]} [{smi}]: wall {wall:.3f} ms/step (the whole '
          f'warm run), device busy {busy:.3f} ms/step (idle share '
          f'{1 - busy / wall:.3f}), {kernels / S1_PROFILE_STEPS:.0f} device '
          f'kernels a step; decode attention products (aten::einsum) '
          f'{einsum:.3f} ms/step ({einsum / busy:.3f} of busy); device ms/step '
          f'by kernel: {top}')


def s1_write_corpus(root, rng):
    """A synthetic stage-1 corpus in the pipeline's pickle format under
    ``root`` (``events/<piece>.pkl`` = (bar_pos, events), the dictionary,
    train/valid splits): S1_CORPUS_BARS-bar lead sheets, four beats a bar
    of chord and melody; and a training config with the values of
    ``configs/stage1/emopia_finetune.yaml`` (checkpoint and log every
    epoch)."""
    e2w, w2e = s1_dictionary()
    deg = lambda: S1_DEGREES[rng.randint(7)]  # noqa: E731
    events_dir = os.path.join(root, 'events')
    os.makedirs(events_dir)
    names = []
    for p in range(S1_CORPUS_PIECES):
        evs = ['Emotion_Positive' if p % 2 == 0 else 'Emotion_Negative',
               'Key_C' if p % 2 == 0 else 'Key_a']
        bar_pos = []
        for _ in range(S1_CORPUS_BARS):
            bar_pos.append(len(evs))
            evs.append('Bar_None')
            for beat in range(0, 16, 4):
                evs += [f'Beat_{beat}', f'Chord_{deg()}_M',
                        f'Note_Octave_{rng.randint(4, 6)}',
                        f'Note_Degree_{deg()}', 'Note_Duration_480']
        evs.append('EOS_None')
        names.append(f'piece{p}.pkl')
        with open(os.path.join(events_dir, names[-1]), 'wb') as f:
            pickle.dump((bar_pos, evs), f)
    paths = {k: os.path.join(root, f'{k}.pkl')
             for k in ('dictionary', 'train', 'valid')}
    for key, obj in (('dictionary', (e2w, w2e)), ('train', names[:-4]),
                     ('valid', names[-4:])):
        with open(paths[key], 'wb') as f:
            pickle.dump(obj, f)
    return {
        'pretrained_param_path': None, 'pretrained_optim_path': None,
        'model': {'d_word_embed': D_MODEL, 'pre_lnorm': True,
                  'decoder': {'n_layer': N_LAYER, 'n_head': N_HEAD,
                              'd_model': D_MODEL, 'd_ff': D_FF,
                              'dropout': 0.1, 'mem_len': 0, 'tgt_len': S1_L}},
        'data': {'data_dir': events_dir, 'train_split': paths['train'],
                 'val_split': paths['valid'], 'vocab_path': paths['dictionary'],
                 'batch_size': S1_B, 'max_n_seg': 1},
        'training': {'trained_steps': 0, 'trained_epochs': 0,
                     'warmup_steps': 200, 'lr_decay_steps': 500000,
                     'max_lr': 1e-5, 'min_lr': 1e-6, 'max_epoch': 1,
                     'val_interval': 1, 'log_interval': 1},
        'output': {'ckpt_dir': os.path.join(root, 'ckpt_s1_{}'),
                   'ckpt_interval': 1},
    }


def phase_s1_train(dev, smi):
    """The stage-1 training path: full-model f32 gradients (dropout off),
    ``train_stage1.run`` at emopia_finetune.yaml's values (f32, B=4, L=512)
    for 3 steps and the validation, a fixed batch whose loss must fall over
    8 steps, and one segmented step per segment over two segments with 512
    memories."""
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    from emo_disentanger_tpu_torch.data.datasets import Stage1Dataset
    from emo_disentanger_tpu_torch.train import train_stage1
    from emo_disentanger_tpu_torch.train.trainer import (
        OptimizerConfig, batch_to_device, make_optimizer,
        make_segmented_train_step, make_train_step, stage1_loss_fn)
    from emo_disentanger_tpu_torch.utils.io import pickle_load
    gib = lambda: torch.cuda.max_memory_allocated() / 2 ** 30  # noqa: E731
    with tempfile.TemporaryDirectory() as root:
        config = s1_write_corpus(root, np.random.RandomState(25))
        dconf = config['data']
        vocab = Vocab.load(dconf['vocab_path'])
        data = lambda split, **kw: Stage1Dataset(  # noqa: E731
            dconf['data_dir'], vocab, pieces=pickle_load(dconf[split]),
            model_dec_seqlen=S1_L, **kw)
        batch = batch_to_device(next(data('train_split').batches(
            S1_B, shuffle=False)), dev)
        segs = next(data('train_split', max_n_seg=2).segment_batches(
            S1_B, shuffle=False))

        model = build_txl(vocab, dev, dropout=0.0).eval()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = stage1_loss_fn(model, vocab.pad_id)(batch, {})
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads])))
        print(f'phase 8s-g stage-1 f32 full-model gradients B={S1_B} L={S1_L} '
              f'(dropout off): loss {loss.item():.5f}, global grad norm '
              f'{norm:.4f}, {sum(bool((g != 0).any()) for g in grads)}/'
              f'{len(grads)} parameters with a nonzero gradient, peak {gib():.2f} GiB')
        expect(all(bool(torch.isfinite(g).all()) for g in grads)
               and all(bool((g != 0).any()) for g in grads),
               'every stage-1 gradient finite and nonzero')
        del model, grads

        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = train_stage1.run(config, 'functional', device=dev)
        wall = time.time() - t0
        ckpt = out['ckpt_dir']
        files = sorted(os.listdir(os.path.join(ckpt, 'params')))
        val = open(os.path.join(ckpt, 'valloss.txt')).read().splitlines()
        secs = out['step_seconds']
        print(f'phase 8s train_stage1.run f32 {N_LAYER}L/{N_HEAD}H/{D_MODEL}d/'
              f'{D_FF}ff B={S1_B} L={S1_L} [{smi}]: {out["steps"]} steps, losses '
              f'{[round(x, 5) for x in out["step_losses"]]}, step seconds '
              f'{[round(x, 4) for x in secs]} ({S1_B * S1_L / min(secs):.0f} '
              f'tokens/s at the fastest step), run {wall:.1f} s, peak '
              f'{gib():.2f} GiB; wrote {files}; valloss.txt: {val}')
        expect(out['steps'] == -(-(S1_CORPUS_PIECES - 4) // S1_B)
               and all(np.isfinite(out['step_losses'])), 'stage-1 losses finite')
        expect(any(f.endswith('_params.pt') for f in files) and len(val) == 1,
               'a stage-1 checkpoint and the valloss line were written')

        model = train_stage1.build_model_and_params(config, vocab, device=dev)
        loss_fn = stage1_loss_fn(model, vocab.pad_id)
        fixed = make_train_step(loss_fn, model, make_optimizer(
            model.parameters(), OptimizerConfig(max_lr=1e-4, min_lr=1e-5,
                                                warmup_steps=2,
                                                lr_decay_steps=100)))
        falls = [float(fixed(batch, {})[0]) for _ in range(8)]
        print(f'phase 8s-c one stage-1 f32 batch, 8 steps, warmup 2, lr 1e-4: '
              f'losses {[round(x, 4) for x in falls]}')
        expect(np.mean(falls[-2:]) < np.mean(falls[:2]), 'the stage-1 loss falls')

        config['model']['decoder']['mem_len'] = S1_L
        model = train_stage1.build_model_and_params(config, vocab, device=dev)
        step = make_segmented_train_step(model, vocab.pad_id, make_optimizer(
            model.parameters(), OptimizerConfig()))
        mems = torch.zeros(N_LAYER + 1, S1_B, S1_L, D_MODEL, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seg_ms, seg_losses = [], []
        for si in range(2):
            seg = batch_to_device({k: v[:, si] for k, v in segs.items()}, dev)
            t0 = time.time()
            mems, loss, _ = step(seg, mems)
            seg_losses.append(float(loss))
            seg_ms.append((time.time() - t0) * 1e3)
        print(f'phase 8s-m segmented step, mem_len {S1_L}, two segments of '
              f'{S1_L} (lengths {segs["seg_len"].tolist()}): losses '
              f'{[round(x, 5) for x in seg_losses]}, ms '
              f'{[round(x, 1) for x in seg_ms]} (host clock, the loss read '
              f'waits), peak {gib():.2f} GiB')
        expect(all(np.isfinite(seg_losses)) and bool(torch.isfinite(mems).all())
               and bool((mems[:, :, -1] != 0).any()),
               'the segmented steps ran and carried memories')


# ---------------------------------------------------------------------------
# two-stage generation
# ---------------------------------------------------------------------------

def two_stage_configs(root):
    """The stage-1 (215 events and PAD) and stage-2 (327 events) dictionaries
    as ``dictionary.pkl`` files, and YAML copies of both stages'
    ``emopia_finetune.yaml`` with only ``vocab_path`` repointed; returns the
    two config paths."""
    import yaml
    from emo_disentanger_tpu_torch.utils.io import load_yaml
    conf_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'emo_disentanger_tpu', 'configs')
    paths = {}
    for stage, section, dictionary in (('stage1', 'data', s1_dictionary()),
                                       ('stage2', 'data_loader',
                                        synthetic_dictionary())):
        os.makedirs(os.path.join(root, f'{stage}_functional'))
        with open(os.path.join(root, f'{stage}_functional', 'dictionary.pkl'),
                  'wb') as f:
            pickle.dump(dictionary, f)
        config = load_yaml(os.path.join(conf_dir, stage, 'emopia_finetune.yaml'))
        config[section]['vocab_path'] = os.path.join(root, stage + '_{}',
                                                     'dictionary.pkl')
        paths[stage] = os.path.join(root, f'{stage}.yaml')
        with open(paths[stage], 'w') as f:
            yaml.safe_dump(config, f)
    return paths


@torch.no_grad()
def note_grammar(model, vocab):
    """Give a stage-2 Performer the S2_GRAMMAR head: token embeddings
    rescaled to S2_EMB_OVER_PE times the sinusoids' norm, the head's row of
    each event the sum of the unit (mean-free) embeddings of the events that
    allow it, scaled so an allowed event's logit is ~S2_GRAMMAR_LOGIT."""
    e = vocab.event2idx
    w = model.token_emb.emb_lookup.weight
    target = S2_EMB_OVER_PE * (model.d_model / 2) ** 0.5
    w.mul_(target / (w.norm(dim=1, keepdim=True) * model.token_emb.emb_scale))
    unit = w.float() - w.float().mean(1, keepdim=True)
    unit = unit / unit.norm(dim=1, keepdim=True)
    head = torch.zeros_like(model.dec_out_proj.weight)
    gain = S2_GRAMMAR_LOGIT / model.d_model ** 0.5
    for src, allowed in S2_GRAMMAR.items():
        for ev in allowed:
            head[e[ev]] += gain * unit[e[src]].to(head.dtype)
    model.dec_out_proj.weight.copy_(head)
    model.dec_out_proj.bias.zero_()


def midi_notes(path):
    """(notes, tracks in the header) of a MIDI file parsed by the port."""
    from emo_disentanger_tpu_torch.data.midi_io import MidiFile
    with open(path, 'rb') as f:
        data = f.read()
    midi = MidiFile.parse_bytes(data)
    return sum(len(i.notes) for i in midi.instruments), int.from_bytes(data[10:12], 'big')


def phase_two_stage(dev, smi):
    """The two-stage generation path through the user's commands: stage-1
    and stage-2 checkpoints written from seeds, ``infer-stage1`` (lead_sheet,
    --batch 16 --serve) through its CLI's ``main``, ``run_stage2.run``
    (Performer, --batch 16 --serve; the CLI has no bar cut) over the 16
    ``_roman.txt`` files, ``evaluate`` through its CLI, then a second
    ``infer-stage1`` over the same directory, which must render nothing.
    Returns the kernel launches of stage 1 and of stage 2."""
    import io
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    from emo_disentanger_tpu_torch.train import train_stage1, train_stage2
    from emo_disentanger_tpu_torch.train.checkpoint import save_checkpoint
    from emo_disentanger_tpu_torch.utils.io import load_yaml
    root = tempfile.mkdtemp(prefix='two_stage_')
    paths = two_stage_configs(root)
    v1 = Vocab(*s1_dictionary())
    v2 = Vocab(*synthetic_dictionary())
    s1 = train_stage1.build_model_and_params(load_yaml(paths['stage1']), v1, 5,
                                             device=dev)
    with torch.no_grad():
        s1.dec_out_proj.bias[[v1.event2idx[f'Beat_{b}'] for b in range(16)]] += S1_BEAT_BIAS
        s1.dec_out_proj.bias[v1.eos_id] += S1_EOS_BIAS
        s1.dec_out_proj.bias[v1.bar_id] += TWO_STAGE_BAR_BIAS
        s1.dec_out_proj.bias[[v1.event2idx['Emotion_Positive'],
                              v1.event2idx['Emotion_Negative']]] += TWO_STAGE_EMOTION_BIAS
    s2, _ = train_stage2.build_model_and_params(load_yaml(paths['stage2']), v2,
                                                'performer', 6, device=dev)
    note_grammar(s2, v2)
    ck1 = save_checkpoint(os.path.join(root, 'w1'), 1, 0.0, s1)
    ck2 = save_checkpoint(os.path.join(root, 'w2'), 1, 0.0, s2)
    del s1, s2
    out = os.path.join(root, 'generation')
    stage1 = ['-c', paths['stage1'], '-r', 'functional', '-m', 'lead_sheet',
              '-i', ck1, '-o', out, '-n', str(TWO_STAGE_GROUPS),
              '--batch', str(TWO_STAGE_BATCH), '--serve', '--device', str(dev)]
    log = io.StringIO()
    quiet = contextlib.redirect_stdout(log)
    try:
        return _two_stage_run(dev, smi, paths, ck1, ck2, out, stage1, quiet)
    except Exception:
        print(log.getvalue()[-4000:])          # the drivers' own messages
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _two_stage_run(dev, smi, paths, ck1, ck2, out, stage1, quiet):
    """Phase 10's runs and checks, the drivers' messages sent to
    ``quiet``."""
    from emo_disentanger_tpu_torch.cli import evaluate, inference_stage1
    from emo_disentanger_tpu_torch.infer import run_stage2
    from emo_disentanger_tpu_torch.ops import _build
    _build.LAUNCHES.clear()                  # stage 1 starts here
    torch.cuda.synchronize()
    t0 = time.time()
    with quiet:
        sum1 = inference_stage1.main(stage1)
    torch.cuda.synchronize()
    s1_secs = time.time() - t0
    launches1 = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()                  # stage 2 starts here
    t0 = time.time()
    with quiet:
        sum2 = run_stage2.run(paths['stage2'], 'functional', 'performer',
                              inference_params=ck2, output_dir=out,
                              batch_size=TWO_STAGE_BATCH, serve=True,
                              max_bars_override=TWO_STAGE_BARS, device=dev)
    torch.cuda.synchronize()
    s2_secs = time.time() - t0
    launches2 = dict(_build.LAUNCHES)
    with quiet:
        report = evaluate.main(['-o', out])
    n_songs = 2 * TWO_STAGE_GROUPS
    names = sorted(os.listdir(out))
    songs = [f'samp_{g:02d}_{v}' for g in range(TWO_STAGE_GROUPS)
             for v in ('Positive', 'Negative')]
    want = ([s + x for s in songs for x in ('.mid', '.txt', '_roman.txt')]
            + [s[:7] + f'_{q}_full.mid' for s in songs
               for q in (('Q1', 'Q4') if 'Positive' in s else ('Q2', 'Q3'))])
    expect(sum1['pieces'] == n_songs and set(want) <= set(names),
           f'infer-stage1 wrote {n_songs} .mid/.txt/_roman.txt sets and '
           f'infer-stage2 {2 * n_songs} _full.mid files')
    expect(sum2['pieces'] == 2 * n_songs, 'stage 2 rendered every job')
    notes = {}
    for name in want:
        if name.endswith('.mid'):
            notes[name], tracks = midi_notes(os.path.join(out, name))
            expect(notes[name] > 0, f'{name} parses back and holds notes')
            if not name.endswith('_full.mid'):
                expect(tracks == 3, f'{name} has its chord track')
    bars = []
    for s in songs:
        with open(os.path.join(out, s + '_roman.txt')) as f:
            bars.append(sum(ev == 'Bar_None' for ev in f.read().split()))
    expect({k: v['n_pieces'] for k, v in report.items()}
           == {'Positive': TWO_STAGE_GROUPS, 'Negative': TWO_STAGE_GROUPS},
           'evaluate reports Positive and Negative groups of 8 pieces')
    with quiet:
        again = inference_stage1.main(stage1)
    expect(again['pieces'] == 0 and sorted(os.listdir(out)) == names,
           'a second infer-stage1 over the directory renders nothing')
    expect(not launches1, 'stage 1 launched no kernel')
    expect(launches2.get('performer_decode_layer', 0) > 0,
           'performer_decode_layer launched in stage 2')
    full = [n for n in want if n.endswith('_full.mid')]
    print(f'phase 10 two-stage generation [{smi}]: infer-stage1 lead_sheet '
          f'{n_songs} songs --batch {TWO_STAGE_BATCH} --serve in {s1_secs:.1f} s '
          f'(bars a lead sheet {min(bars)}-{max(bars)}); infer-stage2 performer '
          f'{2 * n_songs} jobs --batch {TWO_STAGE_BATCH} --serve, cut to '
          f'{TWO_STAGE_BARS} bars a job (max_bars_override), in {s2_secs:.1f} s; '
          f'{n_songs / (s1_secs + s2_secs) * 60:.1f} songs a minute through both '
          f'stages; notes a lead sheet {min(notes[s + ".mid"] for s in songs)}-'
          f'{max(notes[s + ".mid"] for s in songs)}, a performance '
          f'{min(notes[n] for n in full)}-{max(notes[n] for n in full)}; '
          f'evaluate: ' + ', '.join(
              f'{k} {v["n_pieces"]} pieces, {v["note_density"]:.2f} notes a bar'
              for k, v in report.items()))
    print('phase 10: readings of random heads (stage 1 with EOS lowered, Beat '
          'and Bar raised; stage 2 with its note grammar), not a lead-sheet '
          'throughput; stage-2 launches ' + str(launches2))
    return launches1, launches2


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    try:
        from emo_disentanger_tpu_torch.ops import _build
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here ({e})',
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    src = 'emo_disentanger_tpu_torch/csrc/'
    rec = {
        'favor_kmax': dict(route='cuda', source=src + 'favor_fwd.cu',
                           replaces='emo_disentanger_tpu/ops/linear_attention.py:487'),
        'favor_fwd': dict(route='cuda', source=src + 'favor_fwd.cu',
                          replaces='emo_disentanger_tpu/ops/linear_attention.py:533'),
        'performer_decode_layer': dict(
            route='cuda', source=src + 'performer_decode.cu',
            replaces='emo_disentanger_tpu/ops/performer_decode.py:59'),
        'favor_bwd_a': dict(route='cuda', source=src + 'favor_bwd.cu',
                            replaces='emo_disentanger_tpu/ops/linear_attention.py:578'),
        'favor_bwd_b': dict(route='cuda', source=src + 'favor_bwd.cu',
                            replaces='emo_disentanger_tpu/ops/linear_attention.py:644'),
        # JAX's library kernel (jax/experimental/pallas/ops/tpu/flash_attention.py)
        'flash_attention_fwd': dict(route='cuda', source=src + 'flash_attn_fwd.cu',
                                    replaces='emo_disentanger_tpu/models/gpt2.py:68-79'),
        'favor_kmax_hl': dict(route='cuda', source=src + 'favor_fwd.cu',
                              replaces='emo_disentanger_tpu/ops/linear_attention.py:955'),
        'favor_fwd_hl': dict(route='cuda', source=src + 'favor_fwd.cu',
                             replaces='emo_disentanger_tpu/ops/linear_attention.py:977'),
        'favor_bwd_a_hl': dict(route='cuda', source=src + 'favor_bwd.cu',
                               replaces='emo_disentanger_tpu/ops/linear_attention.py:1027'),
        'favor_bwd_b_hl': dict(route='cuda', source=src + 'favor_bwd.cu',
                               replaces='emo_disentanger_tpu/ops/linear_attention.py:1099'),
        # the composed op's three kernels: 3xTF32 mma.sync on tiles padded to
        # 16, rows by vector loads (the forward's in each input's own type)
        'cla_fwd': dict(route='cuda', source=src + 'linear_attn.cu',
                        replaces='emo_disentanger_tpu/ops/linear_attention.py:152'),
        'cla_bwd_a': dict(route='cuda', source=src + 'linear_attn.cu',
                          replaces='emo_disentanger_tpu/ops/linear_attention.py:245'),
        'cla_bwd_b': dict(route='cuda', source=src + 'linear_attn.cu',
                          replaces='emo_disentanger_tpu/ops/linear_attention.py:295'),
    }
    # each kernel's launches are read on the path it was ported for
    paths = {'serving': ('favor_kmax', 'favor_fwd', 'performer_decode_layer'),
             'training': HEAD_MAJOR,
             'heads_last_training': HEADS_LAST,
             'gpt2_serving': ('flash_attention_fwd',),
             'gpt2_training': ('flash_attention_fwd',),
             'composed_attention': COMPOSED,
             # stage 1 runs none of the kernels: its attention is einsums
             'stage1_serving': (),
             'stage1_training': (),
             # stage 1 runs no kernel; stage 2's Performer serving runs #12
             'two_stage_generation': ('performer_decode_layer',)}
    owner = {'favor_bwd_a': 'training', 'favor_bwd_b': 'training',
             'flash_attention_fwd': 'gpt2_serving',
             **{name: 'heads_last_training' for name in HEADS_LAST},
             **{name: 'composed_attention' for name in COMPOSED}}
    t_start = time.time()
    smi = phase_device()
    phase_kernel_a(dev, rec)
    phase_kernel_c(dev, rec)
    phase_kernel_hl(dev, rec)
    phase_kernel_cla(dev, rec)
    phase_kernel_b(dev, rec)
    phase_kernel_flash(dev, rec, smi)

    vocab = synthetic_vocab()
    launches = {}
    _build.LAUNCHES.clear()                  # the serving path starts here
    model, omegas = phase_model(vocab, dev)
    phase_serve(model, omegas, vocab, dev)
    torch.cuda.synchronize()
    launches['serving'] = dict(_build.LAUNCHES)

    phase_grad(vocab, dev)
    _build.LAUNCHES.clear()                  # the training path starts here
    step, batch, extras, step_s = phase_train(dev, smi)
    torch.cuda.synchronize()
    launches['training'] = dict(_build.LAUNCHES)

    phase_grad_hl(vocab, dev)
    _build.LAUNCHES.clear()                  # the heads-last training path starts here
    hl_step, hl_batch, hl_extras, hl_step_s = phase_train(dev, smi, heads_last=True)
    torch.cuda.synchronize()
    launches['heads_last_training'] = dict(_build.LAUNCHES)
    expect(not any(launches['heads_last_training'].get(k) for k in HEAD_MAJOR),
           'no head-major FAVOR kernel launched on the heads-last path')
    # the two layouts' bf16 steps in turns on one card: head-major (8b),
    # heads-last (8h-b), then four more pairs, the order alternating
    hm, hl = [step_s * 1e3], [hl_step_s * 1e3]
    pair = ((hl, (hl_step, hl_batch, hl_extras)), (hm, (step, batch, extras)))
    for i in range(4):
        for times, args in (pair if i % 2 == 0 else pair[::-1]):
            times.append(step_ms(*args))
    fmt = lambda ts: ', '.join(f'{t:.1f}' for t in ts)
    print(f'phase 8h-d bf16 train step B={BF16_B} L={TRAIN_L} in turns [{smi}]: '
          f'head-major median {np.median(hm):.1f} ms ({fmt(hm)}), heads-last '
          f'median {np.median(hl):.1f} ms ({fmt(hl)}); host clock, synchronized, '
          f'{BF16_STEPS} steps a reading')

    gpt2_model = phase_gpt2_model(vocab, dev)
    _build.LAUNCHES.clear()                  # the GPT-2 serving path starts here
    n_windows = phase_gpt2_serve(gpt2_model, vocab, dev, smi)
    torch.cuda.synchronize()
    launches['gpt2_serving'] = dict(_build.LAUNCHES)
    expect(launches['gpt2_serving'].get('flash_attention_fwd', 0)
           == N_LAYER * n_windows,
           'flash_attention_fwd launched once a layer per L=2048 forward')

    _build.LAUNCHES.clear()                  # the GPT-2 training path starts here
    n_val = phase_train_gpt2(dev, smi)
    torch.cuda.synchronize()
    launches['gpt2_training'] = dict(_build.LAUNCHES)
    expect(launches['gpt2_training'] == {'flash_attention_fwd': N_LAYER * n_val},
           'GPT-2 training launched flash_attention_fwd in validation only')
    launches['composed_attention'] = phase_composed(dev)

    from emo_disentanger_tpu_torch.core.vocab import Vocab
    s1_vocab = Vocab(*s1_dictionary())
    t_s1 = time.time()
    _build.LAUNCHES.clear()                  # the stage-1 serving path starts here
    s1_model = phase_s1_model(s1_vocab, dev, smi)
    phase_s1_serve(s1_model, s1_vocab, dev, smi)
    torch.cuda.synchronize()
    launches['stage1_serving'] = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()                  # the stage-1 training path starts here
    phase_s1_train(dev, smi)
    torch.cuda.synchronize()
    launches['stage1_training'] = dict(_build.LAUNCHES)
    print(f'stage-1 paths took {time.time() - t_s1:.0f} s')
    expect(not launches['stage1_serving'] and not launches['stage1_training'],
           'the stage-1 paths launched no kernel')
    t_two = time.time()
    _, launches['two_stage_generation'] = phase_two_stage(dev, smi)
    print(f'two-stage path took {time.time() - t_two:.0f} s')
    for path, names in paths.items():
        print(f'{path} path launches: {launches[path]}')
        for name in names:
            expect(launches[path].get(name, 0) > 0,
                   f'{name} launched on the {path} path')
    for name, r in rec.items():
        r['launches'] = launches[owner.get(name, 'serving')][name]

    phase_timing(dev, rec, smi)
    phase_timing_cla(dev, rec, smi)
    phase_profile(model, omegas, vocab, dev, smi)
    phase_profile_train(step, batch, extras, step_s * 1e3, smi)
    phase_profile_train(hl_step, hl_batch, hl_extras, hl_step_s * 1e3, smi,
                        label='phase 7h', layout='heads-last')
    phase_profile_gpt2(gpt2_model, vocab, dev, smi)
    phase_profile_s1(s1_model, s1_vocab, dev, smi)
    print(f'chip_smoke: all phases passed in {time.time() - t_start:.0f} s')
    kernels = [dict(name=name, **{'library_ms': None, **r})
               for name, r in rec.items()]
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
