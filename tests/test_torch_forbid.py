"""The inadmissible-token mask ``forbid``: the port against the JAX package.

JAX's ``Stage2Generator`` takes a bool [V] mask (``infer/stage2.py:61``)
and its sampler writes ``NEG_INF`` where the mask is True before the
temperature softmax (``ops/sampling.py:42-43``); the pipeline builds the
mask with ``construct_inadmissible_set`` (tempo tokens more than 20 bpm
from the song's tempo).  The vocabulary here adds tempo tokens far from
110 bpm, and the head is biased toward one of them, so the unmasked greedy
stream samples it (three times over six bars).  Under the mask the two
generators' greedy (``top_p=0``) streams must agree token for token, and
hold no forbidden id."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from emo_disentanger_tpu.core.vocab import Vocab as JaxVocab
from emo_disentanger_tpu.infer.pipeline import construct_inadmissible_set
from emo_disentanger_tpu.infer.stage2 import Stage2Generator as JaxGenerator
from emo_disentanger_tpu.ops.sampling import nucleus_sample as jax_nucleus
from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.infer.stage2 import Stage2Generator
from emo_disentanger_tpu_torch.ops.sampling import nucleus_sample
from torch_port_helpers import model_pair, one_torch_thread  # noqa: F401

FAR_TEMPOS = ('Tempo_60', 'Tempo_150', 'Tempo_200')


def _vocab():
    events = ['Emotion_Q1', 'Emotion_Q2', 'Key_C', 'Key_c', 'Bar_None',
              'EOS_None', 'Track_LeadSheet', 'Track_Full', 'Tempo_110',
              'Tempo_120', 'Chord_I_M', 'Chord_V_7', 'Chord_None_None',
              'Note_Octave_5', 'Note_Degree_I', 'Note_Degree_V',
              'Note_Duration_480', 'Note_Velocity_64', *FAR_TEMPOS]
    events = sorted(set(events + [f'Beat_{b}' for b in range(16)]))
    jv = JaxVocab({e: i for i, e in enumerate(events)},
                  {i: e for i, e in enumerate(events)})
    ev = {e: i for e, i in jv.event2idx.items() if e != 'PAD_None'}
    return jv, Vocab(ev, {i: e for e, i in ev.items()})


def _song(vocab, rng, n_bars=6):
    e = vocab.event2idx
    sheet = []
    for _ in range(n_bars):
        beats = sorted(rng.choice(16, size=2, replace=False))
        sheet.append([e['Bar_None'], e[f'Beat_{beats[0]}'], e['Chord_I_M'],
                      e['Note_Octave_5'], e['Note_Degree_I'],
                      e[f'Beat_{beats[1]}'], e['Chord_V_7'],
                      e['Note_Degree_V'], e['Note_Duration_480']])
    return [e['Emotion_Q1'], e['Key_C'], e['Tempo_110']], sheet


def test_nucleus_forbid_matches_jax():
    """At top_p=0 both samplers take the argmax over the allowed ids."""
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 40).astype(np.float32)
    forbid = np.zeros(40, dtype=bool)
    forbid[logits.argmax(-1)] = True
    got = nucleus_sample(torch.from_numpy(logits), 1.1, 0.0,
                         torch.Generator().manual_seed(0),
                         torch.from_numpy(forbid))
    want = [int(jax_nucleus(key, jnp.asarray(row), 1.1, 0.0,
                            forbid=jnp.asarray(forbid)))
            for key, row in zip(jax.random.split(jax.random.PRNGKey(0), 6),
                                logits)]
    assert got.tolist() == want
    assert not forbid[got.numpy()].any()


def test_stage2_generator_forbid_matches_jax_greedy():
    jv, pv = _vocab()
    far = jv.event2idx['Tempo_200']

    def bias(b):
        # PAD and EOS never win; beats and Track_LeadSheet offset so that
        # the greedy song finishes its bars
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[[jv.event2idx[f'Beat_{i}'] for i in range(16)]] -= 0.5
        b[jv.event2idx['Track_LeadSheet']] += 1.0
        b[far] += 0.2
    jm, params, jom, tm, tom = model_pair(jv.size, seed=9, std=0.1,
                                          bias_fn=bias)
    primer, sheet = _song(jv, np.random.RandomState(3))
    kw = dict(temp=1.0, top_p=0.0, max_events=200)
    n_inject = len(primer) + 1 + len(sheet[0]) + 1

    free, _ = Stage2Generator(tm, pv, omegas=tom, device='cpu', **kw).generate(
        primer, sheet, seed=1)
    forbid = construct_inadmissible_set(110, jv.event2idx, jv.size)
    assert forbid[[jv.event2idx[t] for t in FAR_TEMPOS]].all()
    assert not forbid[jv.event2idx['Tempo_110']]
    assert not forbid[jv.event2idx['Tempo_120']]
    if not forbid[free[n_inject:]].any():
        # the mask would not bite: forbid the first full-track token instead
        forbid = np.zeros(jv.size, dtype=bool)
        forbid[free[n_inject]] = True
    assert forbid[free[n_inject:]].any(), 'the unmasked stream samples a forbidden id'

    got, gstats = Stage2Generator(tm, pv, omegas=tom, forbid=forbid,
                                  device='cpu', **kw).generate(primer, sheet, seed=1)
    want, wstats = JaxGenerator(jm, params, jv, omegas=jom, forbid=forbid,
                                **kw).generate(primer, sheet, seed=4)
    assert got == want
    for key in ('status', 'bars', 'n_events'):
        assert gstats[key] == wstats[key], key
    assert got != free
    assert not forbid[got].any()
    assert gstats['bars'] == len(sheet) and len(got) > n_inject + 40
