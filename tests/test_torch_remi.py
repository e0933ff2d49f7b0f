"""REMI generation in the port against the JAX package, greedy.

REMI has no key token, so ``functional=False`` turns the stage-1 key step
off: the second token samples at the mode's own temperature and top-p and
meets no key rule.  At ``top_p=0`` every step keeps only its most probable
token, so emotion-only primers are deterministic in both frameworks (the
functional tests need keyed primers, since the key step samples at top-p
0.97 whatever ``top_p`` is).  The stage-1 generators (``generate`` through
the cache ladder, ``serve``, ``Stage1Generator``) must give JAX's streams,
statuses, bars, events and rejects; the numpy-sampled reference-exact
replay JAX's tokens under one ``np.random`` seed; and the drivers
(``run_stage1`` lead_sheet and full_song, ``run_stage2`` Performer over the
REMI ``.txt`` lead sheets) JAX's files byte for byte, with no
``_roman.txt``.  full_song runs only batched (whole-cache attention), since
JAX's chunked decode attention misaligns its last chunk when 256 does not
divide Kmax (``ROADMAP.md`` §3).  Every sampling row's top-2 logit gap on
the port's side must exceed ten times LOGIT_TOL."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from emo_disentanger_tpu.core.vocab import Vocab as JaxVocab
from emo_disentanger_tpu.infer import run_stage1 as jax_run1
from emo_disentanger_tpu.infer import run_stage2 as jax_run2
from emo_disentanger_tpu.infer.reference_exact import (
    generate_stage1_reference_exact as jax_replay)
from emo_disentanger_tpu.infer.stage1 import Stage1Generator as JaxSingle
from emo_disentanger_tpu.infer.stage1_batch import Stage1BatchGenerator as JaxBatch
from emo_disentanger_tpu.train import train_stage1 as jax_train1
from emo_disentanger_tpu.train import train_stage2 as jax_train2
from emo_disentanger_tpu_torch import convert
from emo_disentanger_tpu_torch.__main__ import main as port_main
from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.data.midi_io import MidiFile
from emo_disentanger_tpu_torch.infer import run_stage1, run_stage2
from emo_disentanger_tpu_torch.infer import stage1 as port_stage1
from emo_disentanger_tpu_torch.infer import stage2_batch as port_stage2
from emo_disentanger_tpu_torch.infer import stage2 as port_stage2_host
from emo_disentanger_tpu_torch.infer.reference_exact import (
    generate_stage1_reference_exact)
from emo_disentanger_tpu_torch.infer.stage1 import (
    STATUS_DONE, Stage1Generator)
from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
from emo_disentanger_tpu_torch.models.performer import MusicPerformer
from emo_disentanger_tpu_torch.train import train_stage1 as port_train1
from emo_disentanger_tpu_torch.train.checkpoint import save_checkpoint
from helpers import write_fullsong_corpus, write_stage1_corpus, write_stage2_corpus
from test_torch_run_drivers import (
    LOGIT_TOL, N_LAYER, _Gaps, _same_outputs, _sampling_rows, _weights)
from test_torch_stage1_serve import _Recorder, _port_vocab, _same
from test_torch_txl import txl_pair
from torch_port_helpers import one_torch_thread  # noqa: F401

# a REMI vocabulary: absolute pitches and pitch-class chord roots, no Key_*
REMI_EVENTS = sorted(
    ['Emotion_Q1', 'Emotion_Q2', 'Bar_None', 'EOS_None', 'Tempo_110',
     'Chord_0_M', 'Chord_7_7', 'Chord_9_m', 'Chord_None_None',
     'Note_Pitch_60', 'Note_Pitch_64', 'Note_Pitch_67', 'Note_Duration_240',
     'Note_Duration_480', 'Note_Velocity_64'] + [f'Beat_{b}' for b in range(16)])
PRIMERS = [['Emotion_Q1'], ['Emotion_Q2'],
           ['Emotion_Q2', 'Bar_None', 'Beat_4', 'Chord_9_m', 'Note_Pitch_64',
            'Note_Duration_240'],
           ['Emotion_Q1', 'Bar_None']]
EMOTIONS = ['Q1', 'Q2', 'Q2', 'Q1']
TARGETS = [3, 4, 8, 8]
KW = dict(temp=1.2, max_events=40, max_bars=8, reject_slack=64)


def _remi_vocab():
    return JaxVocab({e: i for i, e in enumerate(REMI_EVENTS)},
                    {i: e for i, e in enumerate(REMI_EVENTS)})


def _models(jv, seed=3, beat=0.0, bar=1.0):
    def bias(b):
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[[jv.event2idx[f'Beat_{k}'] for k in range(16)]] += beat
        b[jv.event2idx['Bar_None']] += bar
    return txl_pair(jv.size, seed=seed, std=0.1, bias_fn=bias)


def _remi_songs(songs):
    """Every song runs past its emotion token and holds no key."""
    for song in songs:
        assert song is not None and len(song) > 3
        assert not any(ev.startswith('Key_') for ev in song)


@pytest.mark.parametrize('mode', ['generate', 'serve'])
def test_batch_generator_remi_matches_jax_greedy(mode, monkeypatch):
    jv = _remi_vocab()
    jm, params, tm = _models(jv)
    kw = dict(KW, batch=4, top_p=0.0, functional=False)
    jgen = JaxBatch(jm, params, jv, **kw)
    tgen = Stage1BatchGenerator(tm, _port_vocab(jv), device='cpu',
                                **(dict(kw, fast_slack=16) if mode == 'generate' else kw))
    if mode == 'generate':
        jgen = JaxBatch(jm, params, jv, fast_slack=16, **kw)
    rec = _Recorder(monkeypatch, tgen)
    emotions, primers, targets = EMOTIONS, PRIMERS, TARGETS
    if mode == 'serve':
        emotions, primers = EMOTIONS + EMOTIONS[:2], PRIMERS + PRIMERS[:2]
        targets = TARGETS + [5, 2]
    call = 'generate' if mode == 'generate' else 'serve'
    extra = {} if mode == 'generate' else dict(chunk_steps=16)
    tres = getattr(tgen, call)(emotions, seed=11, primers=primers,
                               target_bars=targets, **extra)
    jres = getattr(jgen, call)(emotions, seed=3, primers=primers,
                               target_bars=targets, **extra)
    _same(jres, tres)
    _remi_songs(tres[0])
    assert STATUS_DONE in tres[1]['status']
    assert rec.min_gap() > 10 * LOGIT_TOL


def test_single_generator_remi_matches_jax_greedy(monkeypatch):
    jv = _remi_vocab()
    jm, params, tm = _models(jv)
    jgen = JaxSingle(jm, params, jv, top_p=0.0, functional=False, **KW)
    tgen = Stage1Generator(tm, _port_vocab(jv), top_p=0.0, functional=False,
                           device='cpu', **KW)
    rec = _Recorder(monkeypatch, tgen)
    songs = []
    for primer, emotion, target in zip(PRIMERS, EMOTIONS, TARGETS):
        tev, tst = tgen.generate(emotion, 1, primer_events=primer, target_bars=target)
        jev, jst = jgen.generate(emotion, 0, primer_events=primer, target_bars=target)
        assert tev == jev
        assert {k: tst[k] for k in ('status', 'bars', 'n_events')} == \
            {k: jst[k] for k in ('status', 'bars', 'n_events')}
        songs.append(tev)
    _remi_songs(songs)
    assert rec.min_gap() > 10 * LOGIT_TOL


def test_functional_key_step_rejects_a_remi_vocabulary():
    """The switch is what lets REMI run: with the key step on, no token of a
    REMI vocabulary is a key, so every second-token draw is rejected and the
    emotion-only song never grows."""
    jv = _remi_vocab()
    _, _, tm = _models(jv)
    gen = Stage1BatchGenerator(tm, _port_vocab(jv), batch=2, top_p=0.0,
                               fast_slack=None, device='cpu', **KW)
    songs, stats = gen.generate(['Q1', 'Q2'], seed=0)
    assert stats['events'] == [1, 1] and min(stats['rejects']) > 0
    remi = Stage1BatchGenerator(tm, _port_vocab(jv), batch=2, top_p=0.0,
                                fast_slack=None, functional=False, device='cpu', **KW)
    assert min(remi.generate(['Q1', 'Q2'], seed=0)[1]['events']) > 3


@pytest.mark.parametrize('rep,key_determine', [('remi', 'rule'),
                                               ('functional', 'none')])
def test_reference_exact_replay_matches_jax(rep, key_determine):
    """The numpy-sampled replay (1.2 / 0.97) from an emotion-only primer:
    REMI samples its second token as any other; the functional
    representation with ``key_determine`` other than 'rule' samples it at
    1.1 / 0.97 and keeps it whatever it is."""
    jv = _remi_vocab()
    jm, params, tm = _models(jv, seed=7, beat=0.0, bar=0.5)
    kw = dict(primer_events=['Emotion_Q2'], max_bars=6, max_events=30,
              max_klen=128, representation=rep, key_determine=key_determine)
    np.random.seed(21)
    want, wsteps = jax_replay(jm, params, jv, **kw)
    np.random.seed(21)
    got, gsteps = generate_stage1_reference_exact(tm, _port_vocab(jv), **kw)
    assert got == want and gsteps == wsteps
    assert len(got) > 20 and not jv.idx2event[got[1]].startswith('Key_')


# ------------------------------------------------------------------ drivers

S1_CASES = {
    # mode, batch, serve, corpus writer, prompts, weight seed, Beat / Bar offsets
    'lead-serve': ('lead_sheet', 3, True, write_stage1_corpus, False, 4, 0.5, 1.0),
    'lead-lockstep-prompts': ('lead_sheet', 3, False, write_stage1_corpus, True, 2,
                              0.5, 1.0),
    'lead-single': ('lead_sheet', 0, False, write_stage1_corpus, False, 0, 0.0, 0.5),
    'full-lockstep': ('full_song', 4, False, write_fullsong_corpus, False, 0, 0.0, 1.0),
    'full-serve-prompts': ('full_song', 3, True, write_fullsong_corpus, True, 6,
                           0.0, 0.5),
}


def _stage1_config(tmp, writer):
    root = os.path.join(tmp, 'corpus_remi')
    events_dir, vocab_path, names = writer(root, n_pieces=4, functional=False)
    cfg = {
        'model': {'d_word_embed': 32, 'pre_lnorm': True,
                  'decoder': {'n_layer': N_LAYER, 'n_head': 2, 'd_model': 32,
                              'd_ff': 64, 'dropout': 0.0, 'mem_len': 0,
                              'tgt_len': 64}},
        'data': {'data_dir': events_dir.replace('corpus_remi', 'corpus_{}'),
                 'vocab_path': vocab_path.replace('corpus_remi', 'corpus_{}')},
    }
    path = os.path.join(tmp, 's1.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path, cfg, JaxVocab.load(vocab_path), events_dir, names


@pytest.mark.parametrize('name', sorted(S1_CASES))
def test_run_stage1_remi_matches_jax_greedy(name, tmp_path, monkeypatch):
    mode, batch, serve, writer, with_prompts, seed, beat, bar = S1_CASES[name]
    tmp = str(tmp_path)
    cfg_path, cfg, jv, events_dir, names = _stage1_config(tmp, writer)

    def bias(b):
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[[i for e, i in jv.event2idx.items() if e.startswith('Beat_')]] += beat
        b[jv.event2idx['Bar_None']] += bar
    _, params = jax_train1.build_model_and_params(cfg, jv)
    jckpt, tckpt = _weights(tmp, params, seed, bias, convert.flax_txl_to_torch)
    prompts = None
    if with_prompts:
        prompts = [run_stage1.get_leadsheet_prompt(events_dir, n, 1) for n in names[:2]]
        assert prompts == [jax_run1.get_leadsheet_prompt(events_dir, n, 1)
                           for n in names[:2]]
    for mod in (jax_run1, run_stage1):
        monkeypatch.setitem(mod.MODE_PARAMS, mode,
                            dict(mod.MODE_PARAMS[mode], top_p=0.0))
    gaps = _Gaps(monkeypatch, port_stage1, port_stage1.SongLoop,
                 lambda g, s: g._running(s) & (s['fed'] >= s['primer_len']))
    kw = dict(n_groups=2, seed=0, max_events_override=64, max_bars_override=8,
              prompts=prompts, batch_size=batch, serve=serve)
    jdir, tdir = os.path.join(tmp, 'jax_out'), os.path.join(tmp, 'port_out')
    got = run_stage1.run(cfg_path, 'remi', mode, inference_params=tckpt,
                         output_dir=tdir, device='cpu', **kw)
    want = jax_run1.run(cfg_path, 'remi', mode, inference_params=jckpt,
                        output_dir=jdir, **kw)
    n_jobs = 2 * len(run_stage1.MODE_PARAMS[mode]['emotions'])
    assert got['pieces'] == want['pieces'] == n_jobs
    names = _same_outputs(jdir, tdir)
    assert sum(n.endswith('.txt') for n in names) == n_jobs
    assert not any(n.endswith('_roman.txt') for n in names)
    for n in names:
        if n.endswith('.txt'):
            with open(os.path.join(tdir, n)) as f:
                evs = f.read().split()
            assert evs and not any(e.startswith(('Key_', 'Emotion_')) for e in evs[:1])
    assert gaps.min_gap() > 10 * LOGIT_TOL


LEAD_SHEETS = {
    'samp_00_Positive': ['Bar_None', 'Beat_0', 'Chord_0_M', 'Note_Pitch_60',
                         'Note_Duration_480', 'Bar_None', 'Beat_0', 'Chord_7_7',
                         'Note_Pitch_67', 'Note_Duration_480'],
    'samp_01_Negative': ['Bar_None', 'Beat_4', 'Chord_9_m', 'Note_Pitch_57',
                         'Note_Duration_240', 'Bar_None', 'Beat_0', 'Chord_2_m',
                         'Bar_None', 'Beat_8', 'Note_Pitch_69', 'Note_Duration_960'],
}
S2_CASES = {
    # batch, serve, weight seed
    'performer-serve': (4, True, 12),
    'performer-lockstep': (4, False, 13),
    'performer-single': (0, False, 14),
}


@pytest.mark.parametrize('name', sorted(S2_CASES))
def test_run_stage2_remi_matches_jax_greedy(name, tmp_path, monkeypatch):
    """``run_stage2``'s REMI branch: the ``.txt`` lead sheets (no
    ``_roman.txt``), a primer of emotion and tempo (no key), and absolute
    pitches rendered as they come (``relative_melody=False``)."""
    batch, serve, seed = S2_CASES[name]
    tmp = str(tmp_path)
    root = os.path.join(tmp, 'corpus_remi')
    events_dir, vocab_path, _ = write_stage2_corpus(root, n_pieces=4, functional=False)
    cfg = {'data_loader': {'data_path': events_dir.replace('corpus_remi', 'corpus_{}'),
                           'vocab_path': vocab_path.replace('corpus_remi', 'corpus_{}')},
           'model': {'d_embed': 32, 'd_ff': 64, 'd_model': 32,
                     'feature_map': {'n_dims': 16}, 'max_len': 256, 'n_head': 2,
                     'n_layer': N_LAYER, 'use_segemb': True, 'n_segment_types': 2}}
    cfg_path = os.path.join(tmp, 's2.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg, f)
    jv = JaxVocab.load(vocab_path)

    def bias(b):
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[jv.event2idx['Track_LeadSheet']] += 1.0
    jm, params, _ = jax_train2.build_model_and_params(cfg, jv, 'performer')
    jckpt, tckpt = _weights(tmp, params, seed, bias, convert.flax_performer_to_torch)
    jom = np.array(jm.draw_omegas(jax.random.PRNGKey(17)))
    monkeypatch.setattr(MusicPerformer, 'draw_omegas',
                        lambda self, gen: torch.from_numpy(jom).to(self.device))
    for mod in (jax_run2, run_stage2):
        monkeypatch.setitem(mod.SAMPLING, 'performer',
                            dict(mod.SAMPLING['performer'], top_p=0.0))
    gaps = (_Gaps(monkeypatch, port_stage2, port_stage2.Stage2BatchGenerator,
                  _sampling_rows) if batch else _Gaps(monkeypatch, port_stage2_host))
    kw = dict(seed=0, max_events=160, max_bars_override=3, batch_size=batch,
              serve=serve)
    jdir, tdir = os.path.join(tmp, 'jax_out'), os.path.join(tmp, 'port_out')
    for out in (jdir, tdir):
        os.makedirs(out)
        for sheet, events in LEAD_SHEETS.items():
            with open(os.path.join(out, sheet + '.txt'), 'w') as f:
                f.write('\n'.join(events) + '\n')
    got = run_stage2.run(cfg_path, 'remi', 'performer', inference_params=tckpt,
                         output_dir=tdir, device='cpu', **kw)
    want = jax_run2.run(cfg_path, 'remi', 'performer', inference_params=jckpt,
                        output_dir=jdir, **kw)
    assert got['pieces'] == want['pieces'] == 4
    names = _same_outputs(jdir, tdir)
    assert sorted(n for n in names if n.endswith('_full.mid')) == [
        'samp_00_Q1_full.mid', 'samp_00_Q4_full.mid', 'samp_01_Q2_full.mid',
        'samp_01_Q3_full.mid']
    assert gaps.min_gap() > 10 * LOGIT_TOL


def test_cli_remi_lead_sheets(tmp_path):
    """``infer-stage1 -r remi`` through ``__main__`` (serve, sampling as the
    reference does): every ``.mid`` and ``.txt`` written, no
    ``_roman.txt``, each MIDI parses back with notes and a lead sheet's
    chord track."""
    tmp = str(tmp_path)
    cfg_path, cfg, jv, _, _ = _stage1_config(tmp, write_stage1_corpus)
    vocab = Vocab.load(cfg['data']['vocab_path'].format('remi'))
    model = port_train1.build_model_and_params(cfg, vocab, 1, device='cpu')
    with torch.no_grad():
        model.dec_out_proj.bias[vocab.bar_id] += 3.0
        model.dec_out_proj.bias[vocab.eos_id] -= 30.0
    ckpt = save_checkpoint(os.path.join(tmp, 'w1'), 1, 1.0, model)
    out = os.path.join(tmp, 'gen')
    assert port_main(['infer-stage1', '-c', cfg_path, '-r', 'remi', '-m', 'lead_sheet',
                      '-i', ckpt, '-o', out, '-n', '2', '--batch', '3', '--serve',
                      '--device', 'cpu']) == 0
    names = sorted(os.listdir(out))
    songs = [f'samp_{g:02d}_{v}' for g in range(2) for v in ('Positive', 'Negative')]
    assert names == sorted(['config_lead.yaml'] + [s + x for s in songs
                                                     for x in ('.mid', '.txt')])
    for s in songs:
        data = open(os.path.join(out, s + '.mid'), 'rb').read()
        midi = MidiFile.parse_bytes(data)
        assert sum(len(i.notes) for i in midi.instruments) > 0
        assert int.from_bytes(data[10:12], 'big') == 3
