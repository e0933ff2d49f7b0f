#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``emo_disentanger_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``emo_disentanger_tpu_torch/csrc`` and
holds each against its plain PyTorch version at the main paths' shapes, then
drives six paths at full width with random weights from a seed.  Three run
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

It checks that every kernel of each path was launched on it, times each
kernel, its plain version and its bound (and, for flash attention, PyTorch's
``scaled_dot_product_attention`` as a yardstick the port never calls, with
its error; for the decode layer, the profiler's device time beside the CUDA
events, which at its speed also time the wrapper's host work),
profiles where a serving step's and a training step's time goes (a
training step in both attention layouts), and prints
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
# flash attention: the re-anchor shape and the smallest the dispatch sends
# (H = N_HEAD, Dh = D_HEAD), inputs at std FLASH_STD so softmax rows peak
FLASH_CASES = ((WINDOW_B, WINDOW_L), (2, 512))
FLASH_STD = 2.0

# tolerances, as the largest |kernel - plain| over the largest |plain|:
# f32 differs only in summation order; under bf16 the kernels round their
# product operands (and the output) to bf16, ~2^-8 relative each, while the
# plain versions compute in f32 (FAVOR) or round at other places (decode)
TOL_F32 = 1e-4
TOL_BF16 = 3e-2
# the FAVOR kernels are held against their plain versions at the serving
# entry shape, a ragged L, and the training path's two shapes:
# train_stage2.run's f32 batch and the bf16 train step's
KERNEL_CASES = ((ENTRY_B, ENTRY_L, torch.float32), (ENTRY_B, ENTRY_L, torch.bfloat16),
                (ENTRY_B, 1000, torch.float32), (ENTRY_B, 1000, torch.bfloat16),
                (TRAIN_B, TRAIN_L, torch.float32), (BF16_B, TRAIN_L, torch.bfloat16))
# the heads-last kernels: the training path's two shapes and a ragged L
HL_CASES = ((TRAIN_B, TRAIN_L, torch.float32), (BF16_B, TRAIN_L, torch.bfloat16),
            (ENTRY_B, 1000, torch.float32), (ENTRY_B, 1000, torch.bfloat16))
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

def kmax_bound(BH, L, Dh, M, in_bytes, chunk):
    nbytes = BH * L * Dh * in_bytes + Dh * M * 4 + BH * -(-L // chunk) * 4
    ops = 2 * BH * L * Dh * (M + 1)                         # h, ||x||^2: f32
    return bound(nbytes, ops / F32_FLOP_PER_S)


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


def fwd_bound(BH, L, Dh, Dv, M, in_bytes, chunk):
    nbytes = (BH * L * (2 * Dh + 2 * Dv) * in_bytes + Dh * M * 4
              + BH * -(-L // chunk) * 4)
    feat = 2 * 2 * BH * L * Dh * (M + 1)                    # phi_q, phi_k: f32
    rate = BF16_FLOP_PER_S if in_bytes == 2 else F32_FLOP_PER_S
    return bound(nbytes, feat / F32_FLOP_PER_S + fwd_products(BH, L, M, Dv) / rate)


def bwd_bound(BH, L, Dh, Dv, M, in_bytes, n_partial, pass_a):
    """A backward pass: A reads q, k, v, g and writes dq, u, w; B reads
    q, k, v, u, w and writes dk, dv -- 3 Dh + 3 Dv + 1 values a position
    both ways.  Each recomputes both feature maps and the chain rule through
    one of them (f32, omega exact), and runs the causal products."""
    nbytes = (BH * L * (3 * Dh + 3 * Dv + 1) * in_bytes + Dh * M * 4
              + BH * n_partial * 4)
    feat = 2 * 2 * BH * L * Dh * (M + 1) + 2 * BH * L * M * Dh
    rate = BF16_FLOP_PER_S if in_bytes == 2 else F32_FLOP_PER_S
    return bound(nbytes, feat / F32_FLOP_PER_S
                 + bwd_products(BH, L, M, Dv, pass_a) / rate)


def cla_fwd_bound(BH, L, M, Dv, in_bytes):
    """Kernel #5: phi_q, phi_k and v read once in their type, the f32 output
    written once; the forward's causal products at the f32 rate (the kernel
    widens bf16 inputs)."""
    nbytes = BH * L * (2 * M + Dv) * in_bytes + BH * L * Dv * 4
    return bound(nbytes, fwd_products(BH, L, M, Dv) / F32_FLOP_PER_S)


def cla_bwd_bound(BH, L, M, Dv, pass_a):
    """Kernel #6 or #7, f32: pass A reads phi_q, phi_k, v, g and writes
    dphi_q, u, w; pass B reads phi_q, phi_k, v, u, w and writes dphi_k, dv
    -- 3 M + 3 Dv + 1 values a position both ways; no feature map."""
    nbytes = BH * L * (3 * M + 3 * Dv + 1) * 4
    return bound(nbytes, bwd_products(BH, L, M, Dv, pass_a) / F32_FLOP_PER_S)


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
        got_m = la._favor_kmax_cuda(k2, omega).amax(1)
        ref_m = la._key_max_plain(k2, omega)
        got = la.favor_causal_attention(q, k, v, omega)
        ref = la._favor_compose(q, k, v, omega)
        torch.cuda.synchronize()
        e_m, e_o = rel_err(got_m, ref_m), rel_err(got, ref)
        name = str(dtype).replace('torch.', '')
        print(f'phase 2 kernel A {name} B={B} H={N_HEAD} L={L}: '
              f'kmax rel err {e_m:.2e}, out rel err {e_o:.2e} (tol {tol})')
        expect(got.dtype == dtype and got.shape == ref.shape,
               'favor_fwd output dtype/shape')
        expect(e_m <= tol and e_o <= tol, f'kernel A {name} B={B} L={L}')
        if (B, L, dtype) == (ENTRY_B, ENTRY_L, torch.bfloat16):
            rec['favor_kmax']['max_abs_err'] = max_abs(got_m, ref_m)
            rec['favor_fwd']['max_abs_err'] = max_abs(got, ref)


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
        print(f'phase 2c kernels #3/#4 {name} B={B} H={N_HEAD} L={L}: '
              f'rel err {line} (tol {tol})')
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
              f'{line} (tol {tol}); against #1-#4 on the split heads: '
              f'{"all bitwise equal" if not unequal else "differ: " + str(unequal)}')
        expect(max(errs.values()) <= tol, f'heads-last kernels {name} B={B} L={L}')
        expect(not unequal, f'heads-last kernels equal the head-major ones '
               f'{name} B={B} L={L}')
        if (B, L, dtype) == (BF16_B, TRAIN_L, torch.bfloat16):
            rec['favor_kmax_hl']['max_abs_err'] = max_abs(kmax, ref_m)
            rec['favor_fwd_hl']['max_abs_err'] = max_abs(out, ref_o)
            rec['favor_bwd_a_hl']['max_abs_err'] = max(
                max_abs(*pairs[n]) for n in ('dq', 'u', 'w'))
            rec['favor_bwd_b_hl']['max_abs_err'] = max(
                max_abs(*pairs[n]) for n in ('dk', 'dv'))


def cla_inputs(gen, B, L, dev):
    """Kernels #5-#7's inputs as the composed path makes them: the FAVOR+
    features of qkv()'s q and k (D_HEAD = 64, FAVOR = 128, f32) as
    [B*H, L, FAVOR], v and a cotangent g as [B*H, L, D_HEAD]."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    q, k, v, g = (qkv(gen, B, N_HEAD, L, torch.float32, dev)
                  + qkv(gen, B, N_HEAD, L, torch.float32, dev)[:1])
    flat = lambda t: t.reshape(B * N_HEAD, L, t.shape[-1])
    return (flat(la.favor_features(q, omega, is_query=True)),
            flat(la.favor_features(k, omega, is_query=False)), flat(v), flat(g))


def phase_kernel_cla(dev, rec):
    """Kernels #5-#7 against their plain versions at the kernels' chunk:
    the forward, pass A, and pass B fed the kernel's own (u, w), at the
    composed path's shape and a ragged L in f32; the forward also on bf16
    features and v, and on f32 features with bf16 v (f32 out).  The
    composed path's shape gives the recorded errors."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    gen = torch.Generator().manual_seed(21)
    C = la.KERNEL_CHUNK
    for B, L, dtype, v_dtype in CLA_CASES:
        q, k, v, g = cla_inputs(gen, B, L, dev)
        q, k, v = q.to(dtype), k.to(dtype), v.to(v_dtype)
        pairs = {'out': (la._cla_fwd_cuda(q, k, v), la._cla_fwd_plain(q, k, v, C))}
        if dtype == v_dtype == torch.float32:
            dq, u, w = la._cla_bwd_a_cuda(q, k, v, g)
            dk, dv = la._cla_bwd_b_cuda(q, k, v, u, w)
            rdq, ru, rw = la._cla_bwd_a_plain(q, k, v, g, C)
            rdk, rdv = la._cla_bwd_b_plain(q, k, v, u, w, C)
            pairs.update(dphi_q=(dq, rdq), u=(u, ru), w=(w, rw),
                         dphi_k=(dk, rdk), dv=(dv, rdv))
        torch.cuda.synchronize()
        for name, (a, b) in pairs.items():
            expect(a.dtype == torch.float32 and a.shape == b.shape
                   and bool(torch.isfinite(a).all()),
                   f'causal_linear_attention {name} dtype/shape/finite')
        errs = {name: rel_err(a, b) for name, (a, b) in pairs.items()}
        line = ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
        name = (f"{str(dtype).replace('torch.', '')} features, "
                f"{str(v_dtype).replace('torch.', '')} v")
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
          f'launches per step {per_step}')
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
        b_k, by_k = kmax_bound(BH, L, D_HEAD, FAVOR, 2, la.KERNEL_CHUNK)
        b_f, by_f = fwd_bound(BH, L, D_HEAD, D_HEAD, FAVOR, 2, la.KERNEL_CHUNK)
        print(f'phase 6 kernel A bf16 B={B} L={L} [{smi}]: favor_kmax '
              f'{t_k:.4f} ms (plain {p_k:.4f}, bound {b_k:.4f} {by_k}); '
              f'favor_fwd {t_f:.4f} ms (plain {p_f:.4f}, bound {b_f:.4f} {by_f})')
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
    b_a, b_b = (bwd_bound(BH, L, D_HEAD, D_HEAD, FAVOR, 2, part.shape[1], pass_a)
                for pass_a in (True, False))
    for name, (t, p), (b, by) in zip(times, times.values(), (b_a, b_b)):
        print(f'phase 6 kernel {name} bf16 B={B} L={L} [{smi}]: {t:.4f} ms '
              f'(plain {p:.4f}, bound {b:.4f} {by})')
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
            kmax_bound(BH, L, D_HEAD, FAVOR, 2, C)),
        'favor_fwd_hl': (
            time_ms(lambda: la._favor_fwd_hl_cuda(q, k, v, omega, hpart, H), iters=5),
            time_ms(lambda: la._hl_compose(q, k, v, omega, H), iters=2, warmup=1),
            fwd_bound(BH, L, D_HEAD, D_HEAD, FAVOR, 2, C)),
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
        print(f'phase 6h kernel {name} bf16 B={B} L={L} [{smi}]: {t:.4f} ms '
              f'(plain {p:.4f}, bound {b:.4f} {by})')
        rec[name].update(ms=t, plain_ms=p, bound_ms=b, bound_by=by)
    print(f'phase 6h head-major at the same shape [{smi}]: favor_kmax '
          f'{t_hm_k:.4f} ms, favor_fwd {t_hm_f:.4f} ms, favor_bwd_a '
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
                    cla_fwd_bound(BH, L, FAVOR, D_HEAD, 4)),
        'cla_bwd_a': (time_ms(lambda: la._cla_bwd_a_cuda(q, k, v, g), iters=5, warmup=1),
                      time_ms(lambda: la._cla_bwd_a_plain(q, k, v, g, C),
                              iters=2, warmup=1),
                      cla_bwd_bound(BH, L, FAVOR, D_HEAD, True)),
        'cla_bwd_b': (time_ms(lambda: la._cla_bwd_b_cuda(q, k, v, u, w), iters=5,
                              warmup=1),
                      time_ms(lambda: la._cla_bwd_b_plain(q, k, v, u, w, C),
                              iters=2, warmup=1),
                      cla_bwd_bound(BH, L, FAVOR, D_HEAD, False)),
    }
    for name, (t, p, (b, by)) in times.items():
        print(f'phase 6l kernel {name} f32 B={B} H={N_HEAD} L={L} M={FAVOR} '
              f'Dv={D_HEAD} [{smi}]: {t:.4f} ms (plain {p:.4f}, bound {b:.4f} {by})')
        rec[name].update(ms=t, plain_ms=p, bound_ms=b, bound_by=by)
    del q, k, v, g, u, w

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
          f'forward {fmt(res["fwd", "composed"])} ms composed, '
          f'{fmt(res["fwd", "fused"])} ms fused; forward+backward '
          f'{fmt(res["fwd+bwd", "composed"])} ms composed, '
          f'{fmt(res["fwd+bwd", "fused"])} ms fused')


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
             'composed_attention': COMPOSED}
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
