"""The port's inference drivers (``infer/run_stage1.py``,
``infer/run_stage2.py``) against the JAX package's on the same weights,
on tiny configs (2 layers, d_model 32) over synthetic corpora.

Each test draws numpy weights into the JAX model, saves them as a JAX
checkpoint for the JAX driver and carries them through ``convert.py`` into
a port checkpoint for the port's driver.  Both drivers run greedy
(``MODE_PARAMS`` / ``SAMPLING`` patched to ``top_p=0`` in both packages),
the Performer with JAX's feature draw in place of the port's, and the
stage-1 jobs continue prompts that hold their ``Key_*`` (the key step
samples at top-p 0.97 whatever ``top_p`` is).  Every output file must be
identical: the text files as text, the MIDI files byte for byte, the
config copies too; the summaries' piece counts must agree.  A
cross-framework near-tie could flip a greedy token, so every sampling
row's top-2 logit gap on the port's side must exceed ten times LOGIT_TOL,
the two frameworks' logit agreement on these models
(``test_torch_serve.py``, ``test_torch_stage1_serve.py``).  The REMI
representation's drivers are held the same way in ``test_torch_remi.py``."""

import json
import os
import pickle
import subprocess
import sys

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from emo_disentanger_tpu.cli import events2words as jax_events2words
from emo_disentanger_tpu.core.vocab import Vocab as JaxVocab
from emo_disentanger_tpu.infer import run_stage1 as jax_run1
from emo_disentanger_tpu.infer import run_stage2 as jax_run2
from emo_disentanger_tpu.train import train_stage1 as jax_train1
from emo_disentanger_tpu.train import train_stage2 as jax_train2
from emo_disentanger_tpu.train.checkpoint import save_checkpoint as jax_save
from emo_disentanger_tpu_torch import convert
from emo_disentanger_tpu_torch.__main__ import main as port_main
from emo_disentanger_tpu_torch.core.theory import MAJOR_KEY, MINOR_KEY
from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.data.midi_io import MidiFile
from emo_disentanger_tpu_torch.infer import run_stage1, run_stage2
from emo_disentanger_tpu_torch.infer import stage1 as port_stage1
from emo_disentanger_tpu_torch.infer import stage2 as port_stage2_host
from emo_disentanger_tpu_torch.infer import stage2_batch as port_stage2
from emo_disentanger_tpu_torch.models.performer import MusicPerformer
from emo_disentanger_tpu_torch.train import train_stage1 as port_train1
from emo_disentanger_tpu_torch.train import train_stage2 as port_train2
from emo_disentanger_tpu_torch.train.checkpoint import save_checkpoint
from helpers import write_fullsong_corpus, write_stage1_corpus, write_stage2_corpus
from torch_port_helpers import fill_params, one_torch_thread  # noqa: F401

LOGIT_TOL = 2e-5
N_LAYER = 2


class _Gaps:
    """Records, on the port's side, each step's logits as the sampler sees
    them and the rows that sample at that step (one sampler call a step)."""

    def __init__(self, monkeypatch, module, cls=None, rows_fn=None):
        """Without ``cls`` every row of every sampler call samples (the
        host-driven stage-2 generator draws one token a call)."""
        self.logits, self.rows = [], []
        real_sample = module.nucleus_sample

        def sample(logits, *a, **kw):
            self.logits.append(logits.detach().clone())
            if cls is None:
                self.rows.append(torch.ones(len(logits), dtype=torch.bool))
            return real_sample(logits, *a, **kw)
        monkeypatch.setattr(module, 'nucleus_sample', sample)
        if cls is not None:
            real_step = cls._step

            def step(gen, s, *a, **kw):
                self.rows.append(rows_fn(gen, s).clone())
                return real_step(gen, s, *a, **kw)
            monkeypatch.setattr(cls, '_step', step)

    def min_gap(self) -> float:
        assert len(self.logits) == len(self.rows)
        gaps = [float((top[:, 0] - top[:, 1])[rows].min())
                for lg, rows in zip(self.logits, self.rows) if rows.any()
                for top in [lg.float().topk(2).values]]
        assert len(gaps) > 20
        return min(gaps)


def _same_outputs(jdir, tdir):
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for name in names:
        with open(os.path.join(jdir, name), 'rb') as f:
            want = f.read()
        with open(os.path.join(tdir, name), 'rb') as f:
            assert f.read() == want, name
    return names


def _weights(tmp, params, seed, bias, to_torch):
    """numpy-filled params with the head bias moved: (the JAX checkpoint,
    the port checkpoint)."""
    params = jax.tree.map(np.array, fill_params(params, seed, 0.1))
    bias(params['params']['out_proj']['bias'])
    jpath = jax_save(os.path.join(tmp, 'jax_weights'), 1, 9.9,
                     jax.tree.map(jnp.asarray, params))
    tpath = os.path.join(tmp, 'ep001_loss9.900_params.pt')
    torch.save(to_torch(params, N_LAYER), tpath)
    return jpath, tpath


# ---------------------------------------------------------------- stage 1

S1_CASES = {
    # mode, batch, serve, corpus writer, weight seed, Beat / Bar offsets
    'lead-serve': ('lead_sheet', 3, True, write_stage1_corpus, 3, 0.5, 0.0),
    'lead-lockstep': ('lead_sheet', 3, False, write_stage1_corpus, 5, 0.5, 0.5),
    'lead-single': ('lead_sheet', 0, False, write_stage1_corpus, 0, 0.0, 0.5),
    'full-song': ('full_song', 4, False, write_fullsong_corpus, 3, 0.0, 0.0),
}
S1_PROMPTS = [
    (['Emotion_Positive', 'Key_C', 'Bar_None', 'Beat_0', 'Chord_I_M',
      'Note_Octave_5', 'Note_Degree_I', 'Note_Duration_480'], 6),
    (['Emotion_Negative', 'Key_a', 'Bar_None', 'Beat_4', 'Chord_VI_m',
      'Note_Octave_4', 'Note_Degree_III', 'Note_Duration_240', 'Beat_8'], 8),
]


def _stage1_config(tmp, writer):
    root = os.path.join(tmp, 'corpus_functional')
    events_dir, vocab_path, _ = writer(root, n_pieces=4)
    cfg = {
        'model': {'d_word_embed': 32, 'pre_lnorm': True,
                  'decoder': {'n_layer': N_LAYER, 'n_head': 2, 'd_model': 32,
                              'd_ff': 64, 'dropout': 0.0, 'mem_len': 0,
                              'tgt_len': 64}},
        'data': {'data_dir': events_dir.replace('functional', '{}'),
                 'vocab_path': vocab_path.replace('functional', '{}')},
    }
    path = os.path.join(tmp, 's1.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path, cfg, JaxVocab.load(vocab_path)


@pytest.mark.parametrize('name', sorted(S1_CASES))
def test_run_stage1_matches_jax_greedy(name, tmp_path, monkeypatch):
    mode, batch, serve, writer, seed, beat, bar = S1_CASES[name]
    tmp = str(tmp_path)
    cfg_path, cfg, jv = _stage1_config(tmp, writer)

    def bias(b):
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[[i for e, i in jv.event2idx.items() if e.startswith('Beat_')]] += beat
        b[jv.event2idx['Bar_None']] += bar
    _, params = jax_train1.build_model_and_params(cfg, jv)
    jckpt, tckpt = _weights(tmp, params, seed, bias, convert.flax_txl_to_torch)

    prompts = S1_PROMPTS
    if mode == 'full_song':
        prompts = [(['Emotion_Q1', 'Key_C', 'Bar_None', 'Beat_0',
                     'Note_Octave_5', 'Note_Degree_I', 'Note_Duration_480',
                     'Note_Velocity_64'], 6)]
    for mod in (jax_run1, run_stage1):
        monkeypatch.setitem(mod.MODE_PARAMS, mode,
                            dict(mod.MODE_PARAMS[mode], top_p=0.0))
    gaps = _Gaps(monkeypatch, port_stage1, port_stage1.SongLoop,
                 lambda g, s: g._running(s) & (s['fed'] >= s['primer_len']))
    kw = dict(n_groups=len(prompts), seed=0, max_events_override=64,
              max_bars_override=8, prompts=prompts, batch_size=batch,
              serve=serve)
    jdir, tdir = os.path.join(tmp, 'jax_out'), os.path.join(tmp, 'port_out')
    got = run_stage1.run(cfg_path, 'functional', mode, inference_params=tckpt,
                         output_dir=tdir, device='cpu', **kw)
    want = jax_run1.run(cfg_path, 'functional', mode, inference_params=jckpt,
                        output_dir=jdir, **kw)
    assert got['pieces'] == want['pieces'] > 0
    names = _same_outputs(jdir, tdir)
    n_jobs = len(prompts) * len(run_stage1.MODE_PARAMS[mode]['emotions'])
    assert sum(n.endswith('_roman.txt') for n in names) == want['pieces']
    assert want['pieces'] >= n_jobs - 1
    assert gaps.min_gap() > 10 * LOGIT_TOL

    # a second run over the directory renders nothing
    again = run_stage1.run(cfg_path, 'functional', mode, inference_params=tckpt,
                           output_dir=tdir, device='cpu', **kw)
    assert again['pieces'] == 0 and sorted(os.listdir(tdir)) == names


def test_leadsheet_prompt_matches_jax(tmp_path):
    events_dir, _, names = write_stage1_corpus(str(tmp_path), n_pieces=2)
    for name in names:
        for n_bars in range(3):
            assert run_stage1.get_leadsheet_prompt(events_dir, name, n_bars) == \
                jax_run1.get_leadsheet_prompt(events_dir, name, n_bars)


# ---------------------------------------------------------------- stage 2

S2_CASES = {
    # backbone, batch, serve, weight seed, Beat / Track_LeadSheet offsets
    'performer-serve': ('performer', 4, True, 12, 0.0, 1.0),
    'performer-lockstep': ('performer', 4, False, 13, 0.0, 1.0),
    'performer-single': ('performer', 0, False, 14, 0.0, 1.0),
    # bars long enough that some jobs re-anchor, and some stop at max_events
    'gpt2-lockstep': ('gpt2', 4, False, 12, 0.0, 1.0),
}
LEAD_SHEETS = {
    'samp_00_Positive': ['Key_C', 'Bar_None', 'Beat_0', 'Chord_I_M',
                         'Note_Octave_5', 'Note_Degree_I', 'Note_Duration_480',
                         'Bar_None', 'Beat_0', 'Chord_V_7', 'Note_Octave_5',
                         'Note_Degree_V', 'Note_Duration_480'],
    'samp_01_Negative': ['Key_a', 'Bar_None', 'Beat_4', 'Chord_I_m',
                         'Note_Octave_4', 'Note_Degree_III', 'Note_Duration_240',
                         'Bar_None', 'Beat_0', 'Chord_IV_m', 'Bar_None',
                         'Beat_8', 'Note_Octave_5', 'Note_Degree_I',
                         'Note_Duration_960'],
    # a key the stage-2 vocabulary lacks: rendered in C, with a warning
    'samp_02_Positive': ['Key_F#', 'Bar_None', 'Beat_12', 'Chord_II_m7',
                         'Note_Octave_5', 'Note_Degree_II', 'Note_Duration_120'],
}


def _stage2_config(tmp):
    root = os.path.join(tmp, 'corpus_functional')
    events_dir, vocab_path, _ = write_stage2_corpus(root, n_pieces=4)
    cfg = {
        'data_loader': {'data_path': events_dir.replace('functional', '{}'),
                        'vocab_path': vocab_path.replace('functional', '{}')},
        'model': {'d_embed': 32, 'd_ff': 64, 'd_model': 32,
                  'feature_map': {'n_dims': 16}, 'max_len': 256, 'n_head': 2,
                  'n_layer': N_LAYER, 'use_segemb': True, 'n_segment_types': 2},
    }
    path = os.path.join(tmp, 's2.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path, cfg, JaxVocab.load(vocab_path)


def _write_lead_sheets(out_dir):
    os.makedirs(out_dir)
    for name, events in LEAD_SHEETS.items():
        with open(os.path.join(out_dir, name + '_roman.txt'), 'w') as f:
            f.write('\n'.join(events) + '\n')


def _sampling_rows(gen, s):
    return ((s['status'] == port_stage2.STATUS_RUNNING)
            & (s['mode'] == port_stage2.MODE_SAMPLE) & ~s['in_primer'])


@pytest.mark.parametrize('name', sorted(S2_CASES))
def test_run_stage2_matches_jax_greedy(name, tmp_path, monkeypatch, capsys):
    model_type, batch, serve, seed, beat, lead = S2_CASES[name]
    tmp = str(tmp_path)
    cfg_path, cfg, jv = _stage2_config(tmp)

    def bias(b):
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[[i for e, i in jv.event2idx.items() if e.startswith('Beat_')]] += beat
        b[jv.event2idx['Track_LeadSheet']] += lead
    jm, params, _ = jax_train2.build_model_and_params(cfg, jv, model_type)
    to_torch = (convert.flax_performer_to_torch if model_type == 'performer'
                else convert.flax_gpt2_to_torch)
    jckpt, tckpt = _weights(tmp, params, seed, bias, to_torch)
    if model_type == 'performer':
        # JAX's one draw a run (seed + 17) in place of the port's
        jom = np.array(jm.draw_omegas(jax.random.PRNGKey(17)))
        monkeypatch.setattr(MusicPerformer, 'draw_omegas',
                            lambda self, gen: torch.from_numpy(jom).to(self.device))
    for mod in (jax_run2, run_stage2):
        monkeypatch.setitem(mod.SAMPLING, model_type,
                            dict(mod.SAMPLING[model_type], top_p=0.0))
    gaps = (_Gaps(monkeypatch, port_stage2, port_stage2.Stage2BatchGenerator,
                  _sampling_rows) if batch else _Gaps(monkeypatch, port_stage2_host))
    reanchors = []
    real_reanchor = port_stage2.Stage2BatchGenerator._reanchor_all
    monkeypatch.setattr(port_stage2.Stage2BatchGenerator, '_reanchor_all',
                        lambda gen, s: reanchors.append(1) or real_reanchor(gen, s))
    # the least cache that holds a 32-token window and a 256-token bar: a
    # bar that ends past clock ~28 re-anchors GPT-2 before the next
    kw = dict(seed=0, max_events=160, max_bars_override=3, batch_size=batch,
              serve=serve, gpt2_cache_len=290, gpt2_window=32)
    jdir, tdir = os.path.join(tmp, 'jax_out'), os.path.join(tmp, 'port_out')
    for out in (jdir, tdir):
        _write_lead_sheets(out)
    capsys.readouterr()
    got = run_stage2.run(cfg_path, 'functional', model_type, inference_params=tckpt,
                         output_dir=tdir, device='cpu', **kw)
    assert 'Key_F# not in stage-2 vocab' in capsys.readouterr().out
    want = jax_run2.run(cfg_path, 'functional', model_type, inference_params=jckpt,
                        output_dir=jdir, **kw)
    assert got['pieces'] == want['pieces'] == 6
    names = _same_outputs(jdir, tdir)
    assert sum(n.endswith('_full.mid') for n in names) == 6
    assert gaps.min_gap() > 10 * LOGIT_TOL
    assert bool(reanchors) == (model_type == 'gpt2')

    again = run_stage2.run(cfg_path, 'functional', model_type, inference_params=tckpt,
                           output_dir=tdir, device='cpu', **kw)
    assert again['pieces'] == 0


# ------------------------------------------------------------- the CLIs

def _write_corpora(root):
    """Event pickles of a stage-1 lead-sheet corpus and a stage-2 corpus in
    the layouts ``events2words`` reads (events at tuple positions 1 and 2)."""
    keys = [f'Key_{k}' for k in list(MAJOR_KEY) + list(MINOR_KEY)]
    beats = [f'Beat_{b}' for b in range(16)]
    lead = ['Bar_None', 'EOS_None'] + beats + keys
    full = lead + ['Track_LeadSheet', 'Track_Full']
    for sub, events, pos in (
            ('stage1/emopia_events/lead_sheet_chord11_functional', lead, 1),
            ('stage2/emopia_events/full_song_chord11_functional', full, 2)):
        os.makedirs(os.path.join(root, 'events', sub, 'events'))
        for i in range(2):
            payload = [None] * pos + [events[i::2]]
            with open(os.path.join(root, 'events', sub, 'events', f'p{i}.pkl'),
                      'wb') as f:
                pickle.dump(tuple(payload), f)
    return (os.path.join(root, 'events', 'stage1', 'emopia_events',
                         'lead_sheet_chord11_{}', 'dictionary.pkl'),
            os.path.join(root, 'events', 'stage2', 'emopia_events',
                         'full_song_chord11_{}', 'dictionary.pkl'))


def test_cli_two_stage_pipeline(tmp_path, capsys, monkeypatch):
    """events2words (the same dictionaries as the JAX CLI), infer-stage1 in
    serve mode, infer-stage2 over its ``_roman.txt`` files and evaluate,
    each through ``__main__`` with ``--device cpu``, sampling as the
    reference does, songs cut to 4 bars (``MAX_BARS``); every MIDI file
    parses back with notes."""
    for mod in (run_stage1, run_stage2):
        monkeypatch.setattr(mod, 'MAX_BARS', 4)
    tmp = str(tmp_path)
    s1_vocab, s2_vocab = _write_corpora(os.path.join(tmp, 'port'))
    _write_corpora(os.path.join(tmp, 'jax'))
    assert port_main(['events2words', '-r', 'functional', '--root',
                      os.path.join(tmp, 'port')]) == 0
    jax_events2words.main(['-r', 'functional', '--root', os.path.join(tmp, 'jax')])
    for path in (s1_vocab, s2_vocab):
        with open(path.format('functional'), 'rb') as f:
            got = f.read()
        with open(path.format('functional').replace(
                os.path.join(tmp, 'port'), os.path.join(tmp, 'jax')), 'rb') as f:
            assert got == f.read()

    s1_cfg = {'model': {'d_word_embed': 32, 'pre_lnorm': True,
                        'decoder': {'n_layer': N_LAYER, 'n_head': 2, 'd_model': 32,
                                    'd_ff': 64, 'dropout': 0.1, 'mem_len': 0,
                                    'tgt_len': 64}},
              'data': {'vocab_path': s1_vocab}}
    s2_cfg = {'data_loader': {'vocab_path': s2_vocab},
              'model': {'d_embed': 32, 'd_ff': 64, 'd_model': 32,
                        'feature_map': {'n_dims': 16}, 'max_len': 256,
                        'n_head': 2, 'n_layer': N_LAYER, 'use_segemb': True,
                        'n_segment_types': 2}}
    paths = {}
    for name, cfg in (('s1', s1_cfg), ('s2', s2_cfg)):
        paths[name] = os.path.join(tmp, f'{name}.yaml')
        with open(paths[name], 'w') as f:
            yaml.safe_dump(cfg, f)
    v1 = Vocab.load(s1_vocab.format('functional'))
    m1 = port_train1.build_model_and_params(s1_cfg, v1, 1, device='cpu')
    v2 = Vocab.load(s2_vocab.format('functional'))
    m2, _ = port_train2.build_model_and_params(s2_cfg, v2, 'performer', 2,
                                               device='cpu')
    with torch.no_grad():
        # songs with bars, and no Emotion_Positive / Emotion_Negative past
        # the first token (the stage-2 vocabulary lacks them)
        m1.dec_out_proj.bias[v1.bar_id] += 3.0
        m1.dec_out_proj.bias[[v1.event2idx['Emotion_Positive'],
                              v1.event2idx['Emotion_Negative']]] -= 30.0
    # the smoke run's stage-2 head, under which sampled bars hold notes
    chip_smoke.note_grammar(m2, v2)
    ck1 = save_checkpoint(os.path.join(tmp, 'w1'), 1, 1.0, m1)
    ck2 = save_checkpoint(os.path.join(tmp, 'w2'), 1, 1.0, m2)

    out = os.path.join(tmp, 'gen')
    stage1 = ['infer-stage1', '-c', paths['s1'], '-r', 'functional',
              '-m', 'lead_sheet', '-i', ck1, '-o', out, '-n', '2',
              '--batch', '3', '--serve', '--device', 'cpu']
    assert port_main(stage1) == 0
    assert port_main(['infer-stage2', '-m', 'performer', '-c', paths['s2'],
                      '-r', 'functional', '-i', ck2, '-o', out, '--batch', '3',
                      '--serve', '--device', 'cpu']) == 0
    names = sorted(os.listdir(out))
    romans = [n for n in names if n.endswith('_roman.txt')]
    assert len(romans) == 4
    for name in romans:             # the sampled key has the valence's mode
        with open(os.path.join(out, name)) as f:
            key = f.readline().strip()
        assert key.startswith('Key_') and \
            (key.split('_')[1] in MAJOR_KEY) == ('Positive' in name), name
    fulls = [n for n in names if n.endswith('_full.mid')]
    # stage 2 names its files after the first two fields (samp_XX), as the
    # reference does
    assert sorted(fulls) == sorted(
        r[:len('samp_00')] + f'_{q}_full.mid' for r in romans
        for q in (('Q1', 'Q4') if 'Positive' in r else ('Q2', 'Q3')))
    for name in names:
        if name.endswith('.mid'):
            with open(os.path.join(out, name), 'rb') as f:
                data = f.read()
            midi = MidiFile.parse_bytes(data)
            assert sum(len(i.notes) for i in midi.instruments) > 0, name
            # conductor, piano and, for a lead sheet, the chord track (a
            # track without notes parses to no instrument)
            n_tracks = int.from_bytes(data[10:12], 'big')
            assert n_tracks == (2 if name.endswith('_full.mid') else 3), name
    capsys.readouterr()
    assert port_main(['evaluate', '-o', out]) == 0
    report = json.loads(capsys.readouterr().out)
    assert {k: v['n_pieces'] for k, v in report.items()} == \
        {'Positive': 2, 'Negative': 2}
    assert port_main(stage1) == 0                       # idempotent skip
    assert sorted(os.listdir(out)) == names


def test_main_dispatch(capsys):
    assert port_main(['--help']) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()[2:]]
    assert listed == ['train-stage1', 'train-stage2', 'infer-stage1',
                      'infer-stage2', 'midi2events', 'events2words',
                      'data-splits', 'evaluate']
    assert port_main(['nope']) == 1
    assert 'unknown command' in capsys.readouterr().out
    run = subprocess.run([sys.executable, '-m', 'emo_disentanger_tpu_torch',
                          '--help'], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert run.returncode == 0
    assert [line.split()[0] for line in run.stdout.splitlines()[2:]] == listed


@pytest.mark.parametrize('model_type', ['performer', 'gpt2'])
def test_stage2_load_pretrained_params(model_type, tmp_path):
    """A reference-style state dict (with the buffers the reference keeps:
    the Performer's ``feature_map.omega``, GPT-2's causal-mask constants)
    and a port checkpoint by its stem both load by name; a missing entry
    raises."""
    cfg = {'model': {'d_embed': 32, 'd_ff': 64, 'd_model': 32, 'n_head': 2,
                     'n_layer': N_LAYER, 'use_segemb': True,
                     'feature_map': {'n_dims': 16}}}
    vocab = Vocab({f'E_{i}': i for i in range(20)}, {i: f'E_{i}' for i in range(20)})
    build = lambda seed: port_train2.build_model_and_params(  # noqa: E731
        cfg, vocab, model_type, seed, device='cpu')[0]
    src = build(1)
    state = dict(src.state_dict())
    extra = ('transformer_decoder.decoder_layers.0.attention.inner_attention.'
             'feature_map.omega' if model_type == 'performer'
             else 'transformer.h.0.attn.masked_bias')
    state[extra] = torch.zeros(3)
    torch.save(state, str(tmp_path / 'reference.pt'))
    stem = save_checkpoint(str(tmp_path / 'ckpt'), 3, 1.0, src)[:-len('_params.pt')]
    for path in (str(tmp_path / 'reference.pt'), stem):
        dst = build(2)
        port_train2.load_pretrained_params(dst, path)
        for key, value in src.state_dict().items():
            assert torch.equal(dst.state_dict()[key], value), key
    del state[next(iter(src.state_dict()))]
    torch.save(state, str(tmp_path / 'partial.pt'))
    with pytest.raises(KeyError, match='lacks 1'):
        port_train2.load_pretrained_params(build(2), str(tmp_path / 'partial.pt'))
