"""The stage-1 Transformer-XL of the PyTorch port against the benchmark's
plain float32 reference (``portbench/reference/txl.py``, which shares no
code with the port): the forward over whole streams, and the logits of
every running slot's every step of ``Stage1BatchGenerator.serve`` (the
per-element-clock decode through the cache, slots refilled at staggered
clocks) against the reference's forward over the tokens that slot fed,
in float32 and in bfloat16."""

import numpy as np
import pytest
import torch

from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
from emo_disentanger_tpu_torch.models.txl import PlainTransformer
from emo_disentanger_tpu_torch.utils.precision import cast_params
from portbench import inputs_txl
from portbench.reference import models as ref_models
from portbench.reference import txl as ref_txl
from torch_port_helpers import one_torch_thread  # noqa: F401

CFG = dict(n_layer=2, n_head=4, d_model=64, d_ff=128, d_embed=64)
EVENTS = sorted(['Emotion_Positive', 'Emotion_Negative', 'Key_C', 'Key_a',
                 'Bar_None', 'EOS_None', 'Chord_I_M', 'Chord_V_7',
                 'Note_Octave_5', 'Note_Degree_I', 'Note_Degree_V',
                 'Note_Duration_480'] + [f'Beat_{b}' for b in range(16)])
# both sides compute in float32 from the same weights; they differ only in
# the order of their sums (einsum and matmul splits), which at logits of
# O(1) over two layers of 64 moves the last few bits: 1e-5
F32_TOL = 1e-5
# the serve decode in float32: the cache's sums over up to 48 rows in
# another order than the reference's whole-stream products (read 1.9e-6)
DECODE_TOL = 1e-5
# bfloat16 weights and cache against the float32 reference on the same
# (rounded) weights: the program's error is the rounding of each layer's
# activations and cache rows to bfloat16 (~2^-8 relative, logits of O(1);
# read 0.023), while the reference with float8 operands errs by ~0.3, which
# the test checks fails
BF16_TOL = 0.05


def _vocab():
    return Vocab({e: i for i, e in enumerate(EVENTS)},
                 {i: e for i, e in enumerate(EVENTS)})


def _weights(vocab, seed=5):
    """Seeded reference weights, the matrices at ten times the reference's
    scale so that attention and the relative term move the logits; PAD and
    EOS never win a draw, and Bar_None often does, so that songs end by
    their bars at different steps."""
    P = inputs_txl.make_weights(CFG, vocab.size, seed, 'cpu')
    P = {k: v if k.endswith('layer_norm.weight') else 10 * v
         for k, v in P.items()}
    bias = P['dec_out_proj.bias']
    bias[[vocab.pad_id, vocab.event2idx['EOS_None']]] = -30.0
    bias[vocab.event2idx['Bar_None']] = 2.0
    return P


def _model(vocab, P, dtype=None):
    m = PlainTransformer(vocab.size, dropout=0.0, pad_id=vocab.pad_id,
                         device='cpu', **CFG)
    m.load_state_dict(P)
    if dtype is not None:
        cast_params(m, dtype)
    return m.eval()


def test_forward_matches_the_plain_reference():
    vocab = _vocab()
    P = _weights(vocab)
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, vocab.size - 1, (3, 37)))
    with torch.no_grad():
        got, _ = _model(vocab, P)(tok)
    want = ref_txl.forward(P, CFG, tok)
    assert want.abs().max() > 1.0
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)


def test_rel_shift_gives_each_entry_its_distance():
    L = 6
    x = torch.arange(L, dtype=torch.float32).expand(1, 1, L, L)   # x[.., m] = m
    shifted = ref_txl.rel_shift(x)[0, 0]
    i, j = np.tril_indices(L)
    # position row m holds distance L - 1 - m
    assert (L - 1 - shifted[i, j]).tolist() == (i - j).tolist()


def _served(model, vocab, record):
    """Serve 7 songs through 3 slots (primers of 2-4 tokens, 2-12 bars,
    a 48-row cache), recording each step's fed tokens, clocks, running
    slots and logits.  Long songs run on while short ones are refilled, so
    slots run at different clocks."""
    gen = Stage1BatchGenerator(model, vocab, batch=3, temp=1.2, top_p=0.0,
                               max_events=40, reject_slack=8, device='cpu')
    real_step, real_decode = gen._step, model.decode_step_pe

    def step(s, *a, **kw):
        record.append({'run': gen._running(s).clone()})
        real_step(s, *a, **kw)

    def decode(token, t, *a, **kw):
        logits, cache = real_decode(token, t, *a, **kw)
        record[-1].update(tok=token.clone(), t=t.clone(), logits=logits.clone())
        return logits, cache
    gen._step, model.decode_step_pe = step, decode
    primers = [['Emotion_Positive', 'Key_C'],
               ['Emotion_Negative', 'Key_a', 'Bar_None', 'Beat_4'],
               ['Emotion_Positive', 'Key_C', 'Bar_None']] * 2 + [
               ['Emotion_Negative', 'Key_a']]
    emotions = [p[0].split('_')[1] for p in primers]
    return gen.serve(emotions, seed=3, target_bars=[2, 12, 5, 2, 12, 3, 12],
                     primers=primers, chunk_steps=16)


def _step_logits_against_reference(dtype):
    """(largest gap of any running slot-step's logits to the reference's
    forward over that slot's fed tokens, of the same with the reference
    in float8, the most distinct clocks of running slots in one step)."""
    vocab = _vocab()
    P = _weights(vocab)
    if dtype is not None:
        P = {k: v.to(dtype).float() for k, v in P.items()}
    record = []
    _, stats = _served(_model(vocab, P, dtype), vocab, record)
    assert stats['chunks'] >= 3
    segments, fed = [], [None] * 3
    stagger = 0
    for r in record:
        live = [b for b in range(3) if r['run'][b]]
        stagger = max(stagger, len({int(r['t'][b]) for b in live}))
        for b in range(3):
            if int(r['t'][b]) == 0:
                fed[b] = {'tok': [], 'at': []}
                segments.append(fed[b])
            if fed[b] is None:
                continue
            fed[b]['tok'].append(int(r['tok'][b]))
            assert len(fed[b]['tok']) == int(r['t'][b]) + 1 or not r['run'][b]
            if r['run'][b]:
                fed[b]['at'].append((int(r['t'][b]), r['logits'][b]))
    worst = worst_fp8 = 0.0
    for seg in segments:
        if not seg['at']:
            continue
        tok = torch.tensor([seg['tok'][:max(t for t, _ in seg['at']) + 1]])
        want = ref_txl.forward(P, CFG, tok)[0]
        low = ref_txl.forward(P, CFG, tok, quant=ref_models.fp8)[0]
        for t, logits in seg['at']:
            worst = max(worst, float((logits - want[t]).abs().max()))
            worst_fp8 = max(worst_fp8, float((low[t] - want[t]).abs().max()))
    assert sum(len(s['at']) for s in segments) == sum(
        n - 1 + r for n, r in zip(stats['events'], stats['rejects']))
    return worst, worst_fp8, stagger


def test_serve_decode_at_staggered_clocks_matches_the_reference_f32():
    worst, _, stagger = _step_logits_against_reference(None)
    assert stagger >= 2
    assert worst <= DECODE_TOL


@pytest.mark.parametrize('control', ['bf16', 'fp8'])
def test_serve_decode_in_bf16_within_a_tolerance_float8_fails(control):
    worst, worst_fp8, _ = _step_logits_against_reference(torch.bfloat16)
    if control == 'bf16':
        assert worst <= BF16_TOL
    else:
        assert worst_fp8 > BF16_TOL
