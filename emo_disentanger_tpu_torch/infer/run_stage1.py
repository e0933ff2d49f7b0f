"""Stage-1 inference driver (port of ``emo_disentanger_tpu/infer/run_stage1.py``;
reference ``stage1_compose/inference.py``).

Generates ``n_groups`` pieces per emotion (Positive/Negative for lead sheets,
Q1..Q4 for one-stage full songs), skipping outputs that already exist
(idempotent re-runs, reference ``inference.py:204-206``), writing ``.mid``,
``.txt`` and, for the functional representation, the ``_roman.txt`` that
stage 2 reads (the stage-1 -> stage-2 contract).  Functional songs hold
Roman numerals and are converted to absolute pitches for ``.mid`` and
``.txt``; REMI songs are absolute already and stage 2 reads their ``.txt``.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Union

import numpy as np
import torch

from ..core.vocab import Vocab
from ..train.train_stage1 import build_model_and_params, load_pretrained_params
from ..utils.device import resolve_device
from ..utils.io import load_yaml, pickle_load
from .convert2midi import TempoEvent, events_to_midi
from .pipeline import events_to_txt, roman_events_to_absolute
from .stage1 import Stage1Generator
from .stage1_batch import Stage1BatchGenerator

MODE_PARAMS = {
    # reference inference.py:127-137
    'lead_sheet': dict(temp=1.2, top_p=0.97, max_dec_len=512,
                       emotions=('Positive', 'Negative')),
    'full_song': dict(temp=1.1, top_p=0.99, max_dec_len=2400,
                      emotions=('Q1', 'Q2', 'Q3', 'Q4')),
}
MAX_BARS = 128


def get_leadsheet_prompt(data_dir: str, piece: str, prompt_n_bars: int):
    """Prompt continuation support (reference ``inference.py:32-41``)."""
    bar_pos, evs = pickle_load(os.path.join(data_dir, piece))
    prompt_evs = ['{}_{}'.format(x['name'], x['value'])
                  for x in evs[:bar_pos[prompt_n_bars] + 1]]
    assert sum(1 for e in prompt_evs if e == 'Bar_None') == prompt_n_bars + 1
    return prompt_evs, len(bar_pos)


def _prompt_fields(prompts, jobs):
    """Primers (the job's Emotion token over the raw prompt's first event),
    target bars and prompt bars (the raw prompt's Bar_None count minus one,
    the reference's convention) of prompt-continuation jobs."""
    primers, targets, pbars = [], [], []
    for group, emotion, _ in jobs:
        prompt_evs, n_bars = prompts[group]
        primers.append(['Emotion_{}'.format(emotion)] + prompt_evs[1:])
        targets.append(n_bars)
        pbars.append(max(0, sum(1 for e in prompt_evs if e == 'Bar_None') - 1))
    return dict(primers=primers, target_bars=targets, prompt_bars=pbars)


def run(config_path: str, representation: str, mode: str, *,
        inference_params: str, output_dir: str, n_groups: int = 20,
        play_midi: bool = False, seed: int = 0,
        max_events_override: Optional[int] = None,
        max_bars_override: Optional[int] = None,
        prompts: Optional[List] = None,
        batch_size: int = 0, serve: bool = False,
        device: Union[str, torch.device] = 'cuda') -> dict:
    """``batch_size > 0`` decodes that many songs at once through
    :class:`Stage1BatchGenerator` (emotion-token or prompt-continuation
    primers); with ``serve`` it streams ALL jobs through the ``batch_size``
    slots with refill-on-finish instead of lockstep groups.  Otherwise one
    :class:`Stage1Generator` song at a time.  Runs on CUDA unless
    ``device='cpu'`` is given."""
    dev = resolve_device(device)
    config = load_yaml(config_path)
    params_cfg = MODE_PARAMS[mode]
    functional = representation == 'functional'

    os.makedirs(output_dir, exist_ok=True)
    shutil.copy(config_path, os.path.join(
        output_dir, 'config_lead.yaml' if mode == 'lead_sheet' else 'config_full.yaml'))

    vocab = Vocab.load(config['data']['vocab_path'].format(representation))
    model = build_model_and_params(config, vocab, device=dev)
    load_pretrained_params(model, inference_params)
    model.eval()

    max_events = max_events_override or params_cfg['max_dec_len']
    max_bars = max_bars_override or MAX_BARS
    sampling = dict(temp=params_cfg['temp'], top_p=params_cfg['top_p'],
                    max_events=max_events, max_bars=max_bars,
                    functional=functional, device=dev)

    # collect the pending (group, emotion) jobs (idempotent skip)
    jobs = []
    for group in range(n_groups):
        for emotion in params_cfg['emotions']:
            out_name = 'samp_{:02d}_{}'.format(group, emotion)
            if os.path.exists(os.path.join(output_dir, out_name + '.mid')):
                print('[info] {} exists, skipping ...'.format(out_name))
                continue
            jobs.append((group, emotion, out_name))

    results = {}   # out_name -> (events, seconds)
    if batch_size > 0 and jobs and serve:
        bgen = Stage1BatchGenerator(model, vocab, batch=batch_size, **sampling)
        kwargs = {} if prompts is None else _prompt_fields(prompts, jobs)
        songs, stats = bgen.serve([j[1] for j in jobs], seed=seed, **kwargs)
        per = stats['seconds'] / max(len(jobs), 1)
        for i, (_, _, out_name) in enumerate(jobs):
            results[out_name] = (songs[i], per)
    elif batch_size > 0 and jobs:
        bgen = Stage1BatchGenerator(model, vocab, batch=batch_size, **sampling)
        for g0 in range(0, len(jobs), batch_size):
            group_jobs = jobs[g0:g0 + batch_size]
            padded = group_jobs + [group_jobs[0]] * (batch_size - len(group_jobs))
            kwargs = {} if prompts is None else _prompt_fields(prompts, padded)
            songs, stats = bgen.generate([j[1] for j in padded],
                                         seed=seed + g0, **kwargs)
            for i, (_, _, out_name) in enumerate(group_jobs):
                results[out_name] = (songs[i],
                                     stats['seconds'] / max(len(group_jobs), 1))
    else:
        generator = Stage1Generator(model, vocab, **sampling)
        for group, emotion, out_name in jobs:
            primer = target_bars = pbar = None
            if prompts is not None:
                one = _prompt_fields(prompts, [(group, emotion, out_name)])
                primer = one['primers'][0]
                target_bars = one['target_bars'][0]
                pbar = one['prompt_bars'][0]
            events, stats = generator.generate(
                emotion, seed=seed + group * 131 + sum(map(ord, emotion)) % 1000,
                primer_events=primer, target_bars=target_bars,
                prompt_bars=pbar)
            results[out_name] = (events, stats['seconds'])

    gen_times = []
    n_ok = 0
    for group, emotion, out_name in jobs:
        if out_name not in results:
            continue
        events, secs = results[out_name]
        midi_path = os.path.join(output_dir, out_name + '.mid')
        if events is None:
            print('[FATAL] model stuck on {}'.format(out_name))
            continue
        gen_times.append(secs)

        key = 'Key_C'
        for ev in events:
            if 'Key' in ev:
                key = ev
        events_abs = (roman_events_to_absolute(key, events)
                      if functional else events)[1:]

        if mode == 'lead_sheet':
            events_to_midi(key, events_abs, mode,
                           output_midi_path=midi_path, play_chords=True,
                           enforce_tempo=True,
                           enforce_tempo_evs=[TempoEvent(110, 0, 0)])
        else:
            events_to_midi(key, events_abs, mode, output_midi_path=midi_path)
        events_to_txt(events_abs, os.path.join(output_dir, out_name + '.txt'))
        if functional:
            events_to_txt(events[1:],
                          os.path.join(output_dir, out_name + '_roman.txt'))
        if play_midi:
            from .audio import midi_to_wav
            midi_to_wav(midi_path,
                        os.path.join(output_dir, out_name + '.wav'))
        n_ok += 1

    summary = {'pieces': n_ok,
               'avg_secs': float(np.mean(gen_times)) if gen_times else 0.0,
               'std_secs': float(np.std(gen_times)) if gen_times else 0.0}
    print('[info] finished generating {} pieces, avg. time: '
          '{:.2f} +/- {:.2f} secs.'.format(n_ok, summary['avg_secs'],
                                           summary['std_secs']))
    return summary
