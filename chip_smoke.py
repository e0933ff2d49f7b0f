#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``emo_disentanger_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``emo_disentanger_tpu_torch/csrc`` and
holds each against its plain PyTorch version at the main path's shapes, then
drives the main path at the full width of the flagship stage-2 Performer
(12 layers, 8 heads, d_model 512, d_ff 2048, 128 FAVOR+ features; random
weights from a seed): the forward at B=2, L=1024, an f32 decode that must
reproduce the forward's logits, and ``Stage2BatchGenerator.serve`` over 24
jobs in 16 slots with bf16 weights.  It checks that every kernel of the path
was launched, times each kernel, its plain version and its bound, profiles
where a serving step's time goes, and prints one JSON line of kernel
records, the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``.  Any failed check raises and
the exit code is non-zero; without CUDA, or without the package beside it,
it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and arithmetic
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# flagship stage-2 Performer (__graft_entry__.py) and its serving batch (bench.py)
N_LAYER, N_HEAD, D_MODEL, D_FF, FAVOR = 12, 8, 512, 2048, 128
D_HEAD = D_MODEL // N_HEAD
ENTRY_B, ENTRY_L = 2, 1024
WINDOW_B, WINDOW_L = 16, 2048
SERVE_B = 16

# tolerances, as the largest |kernel - plain| over the largest |plain|:
# f32 differs only in summation order; under bf16 the kernels round their
# product operands (and the output) to bf16, ~2^-8 relative each, while the
# plain versions compute in f32 (FAVOR) or round at other places (decode)
TOL_F32 = 1e-4
TOL_BF16 = 3e-2
# f32 decode (key stabilizer 0) against the forward (row max stabilizer)
# after 12 layers: the stabilizers cancel up to the 1e-6 eps and float order
TOL_DECODE_VS_FORWARD = 1e-3
# bf16 forward against the f32 forward: bf16 rounding through 12 layers
TOL_BF16_MODEL = 5e-2


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


def fwd_bound(BH, L, Dh, Dv, M, in_bytes, chunk):
    nbytes = (BH * L * (2 * Dh + 2 * Dv) * in_bytes + Dh * M * 4
              + BH * -(-L // chunk) * 4)
    feat = 2 * 2 * BH * L * Dh * (M + 1)                    # phi_q, phi_k: f32
    # chunked causal products: the lower triangle of each chunk's scores and
    # their product with v, then phi_q.S and the S update
    prod = BH * (L * (chunk + 1) * (M + Dv) + 4 * L * M * Dv)
    rate = BF16_FLOP_PER_S if in_bytes == 2 else F32_FLOP_PER_S
    return bound(nbytes, feat / F32_FLOP_PER_S + prod / rate)


def decode_bound(B, D, H, M, F, w_bytes, x_bytes):
    Dh = D // H
    n_params = 4 * D * D + 2 * D * F + 4 * D + F + D + 4 * D
    nbytes = (n_params * w_bytes + 2 * B * H * (Dh * M + M) * 4
              + 2 * B * D * x_bytes + Dh * M * 4 + B * 4)
    proj = 2 * B * (4 * D * D + 2 * D * F)
    favor = B * H * (2 * 2 * Dh * M + 4 * Dh * M)
    rate = BF16_FLOP_PER_S if w_bytes == 2 else F32_FLOP_PER_S
    return bound(nbytes, proj / rate + favor / F32_FLOP_PER_S)


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


def synthetic_vocab():
    from emo_disentanger_tpu_torch.core.vocab import (
        MAJOR_KEY, MINOR_KEY, Vocab, events_to_dictionary)
    corpus = (['Bar_None', 'EOS_None', 'Track_LeadSheet', 'Track_Full']
              + [f'Beat_{b}' for b in range(16)]
              + [f'Key_{k}' for k in list(MAJOR_KEY) + list(MINOR_KEY)])
    return Vocab(*events_to_dictionary([corpus], add_velocity=True,
                                       relative=True))


def synthetic_jobs(vocab, n_jobs, rng):
    """Primers (emotion, key, tempo) and 4-8 lead-sheet bars each."""
    e = vocab.event2idx
    degrees = ['I', 'II', 'III', 'IV', 'V', 'VI', 'VII']
    primers, sheets = [], []
    for j in range(n_jobs):
        primers.append([e[f'Emotion_Q{1 + j % 4}'],
                        e['Key_C' if j % 2 == 0 else 'Key_a'], e['Tempo_110']])
        bars = []
        for _ in range(rng.randint(4, 9)):
            bar = [e['Bar_None']]
            for beat in sorted(rng.choice(16, size=rng.randint(2, 5),
                                          replace=False)):
                bar += [e[f'Beat_{beat}'],
                        e[f'Chord_{degrees[rng.randint(7)]}_M'],
                        e[f'Note_Octave_{rng.randint(4, 7)}'],
                        e[f'Note_Degree_{degrees[rng.randint(7)]}'],
                        e[f'Note_Duration_{120 * rng.randint(1, 9)}']]
            bars.append(bar)
        sheets.append(bars)
    return primers, sheets


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
    for L in (ENTRY_L, 1000):
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            q, k, v = qkv(gen, ENTRY_B, N_HEAD, L, dtype, dev)
            k2 = k.reshape(-1, L, D_HEAD)
            got_m = la._favor_kmax_cuda(k2, omega).amax(1)
            ref_m = la._key_max_plain(k2, omega)
            got = la.favor_causal_attention(q, k, v, omega)
            ref = la._favor_compose(q, k, v, omega)
            torch.cuda.synchronize()
            e_m, e_o = rel_err(got_m, ref_m), rel_err(got, ref)
            name = str(dtype).replace('torch.', '')
            print(f'phase 2 kernel A {name} B={ENTRY_B} H={N_HEAD} L={L}: '
                  f'kmax rel err {e_m:.2e}, out rel err {e_o:.2e} (tol {tol})')
            expect(got.dtype == dtype and got.shape == ref.shape,
                   'favor_fwd output dtype/shape')
            expect(e_m <= tol and e_o <= tol, f'kernel A {name} L={L}')
            if L == ENTRY_L and dtype == torch.bfloat16:
                rec['favor_kmax']['max_abs_err'] = max_abs(got_m, ref_m)
                rec['favor_fwd']['max_abs_err'] = max_abs(got, ref)


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


def build_model(vocab, dev):
    from emo_disentanger_tpu_torch.models import MusicPerformer
    model = MusicPerformer(n_token=vocab.size, n_layer=N_LAYER, n_head=N_HEAD,
                           d_model=D_MODEL, d_ff=D_FF, d_embed=D_MODEL,
                           favor_dims=FAVOR, device=dev,
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
    print(f'phase 6 kernel B bf16 B={B} per layer [{smi}]: '
          f'performer_decode_layer {t_d:.4f} ms (plain {p_d:.4f}, bound '
          f'{b_d:.4f} {by_d})')
    rec['performer_decode_layer'].update(ms=t_d, plain_ms=p_d, bound_ms=b_d,
                                         bound_by=by_d)


def phase_profile(model, omegas, vocab, dev, smi):
    """Where a serving step's time goes: a short serve() run timed on the
    host clock, then the same run under torch.profiler for device time by
    kernel (device events only, so nothing is counted twice)."""
    from torch.autograd import DeviceType
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
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    if busy == 0:
        print('phase 7 profile: device time not measured (the profiler saw '
              'no device events)')
        return
    top = '; '.join(f'{e.key[:48]} x{e.count // steps} '
                    f'{e.self_device_time_total / 1e3 / steps:.4f}'
                    for e in kern[:8])
    print(f'phase 7 profile serve B={SERVE_B}, {steps} steps [{smi}]: wall '
          f'{wall:.3f} ms/step, device busy {busy:.3f} ms/step (idle share '
          f'{1 - busy / wall:.3f}); device ms/step by kernel: {top}')


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
    }
    smi = phase_device()
    phase_kernel_a(dev, rec)
    phase_kernel_b(dev, rec)

    vocab = synthetic_vocab()
    _build.LAUNCHES.clear()                  # the main path starts here
    model, omegas = phase_model(vocab, dev)
    phase_serve(model, omegas, vocab, dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f'main path launches: {launches}')
    for name, r in rec.items():
        r['launches'] = launches.get(name, 0)
        expect(r['launches'] > 0, f'{name} launched on the main path')

    phase_timing(dev, rec, smi)
    phase_profile(model, omegas, vocab, dev, smi)
    kernels = [dict(name=name, library_ms=None, **r) for name, r in rec.items()]
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
