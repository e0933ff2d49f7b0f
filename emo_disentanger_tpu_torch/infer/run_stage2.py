"""Stage-2 inference driver (port of ``emo_disentanger_tpu/infer/run_stage2.py``;
reference ``stage2_accompaniment/inference.py`` ``__main__``): glob the
stage-1 output dir for ``*_roman.txt`` (functional) / ``*.txt`` (REMI) lead
sheets, map the valence label to arousal quadrants (Positive -> Q1/Q4,
Negative -> Q2/Q3), generate the full performance per quadrant with the
Performer or GPT-2 backbone, and render ``*_full.mid``.  On the card the
Performer's serving steps run the decode-layer kernel
(``csrc/performer_decode.cu``) and GPT-2's re-anchors the flash-attention
kernel (``csrc/flash_attn_fwd.cu``).
"""

from __future__ import annotations

import os
import shutil
from itertools import chain
from typing import Optional, Union

import numpy as np
import torch

from ..core.vocab import Vocab
from ..train.train_stage2 import build_model_and_params, load_pretrained_params
from ..utils.device import resolve_device
from ..utils.io import load_yaml
from .convert2midi import events_to_midi
from .pipeline import (
    emotion_candidates_for_file, extract_midi_events_from_generation,
    read_generated_events,
)
from .stage2 import Stage2Generator
from .stage2_batch import Stage2BatchGenerator

MAX_BARS = 128
SAMPLING = {
    # reference inference.py:395,404
    'performer': dict(temp=1.1, top_p=0.99),
    'gpt2': dict(temp=1.2, top_p=0.97),
}


def run(config_path: str, representation: str, model_type: str, *,
        inference_params: str, output_dir: str, play_midi: bool = False,
        seed: int = 0, max_events: int = 10000,
        max_bars_override: Optional[int] = None,
        batch_size: int = 0, serve: bool = False,
        gpt2_cache_len: int = 4096, gpt2_window: int = 2048,
        gpt2_tiers=None, device: Union[str, torch.device] = 'cuda') -> dict:
    """``batch_size > 0`` decodes that many (file, quadrant) jobs at once
    through :class:`Stage2BatchGenerator` (both backbones; GPT-2 re-anchors
    its window inside the loop); with ``serve`` it streams ALL jobs through
    the ``batch_size`` slots with refill-on-finish instead of lockstep
    groups.  Otherwise one :class:`Stage2Generator` song at a time.  The
    Performer's feature matrices are drawn once per run.  Runs on CUDA
    unless ``device='cpu'`` is given."""
    dev = resolve_device(device)
    config = load_yaml(config_path)
    functional = representation == 'functional'
    samp = SAMPLING[model_type]

    vocab = Vocab.load(config['data_loader']['vocab_path'].format(representation))
    model, omegas = build_model_and_params(config, vocab, model_type, seed,
                                           device=dev)
    load_pretrained_params(model, inference_params)
    model.eval()
    if model_type == 'performer':
        # one feature draw per generation run (the reference redraws only at
        # step 0 of each piece, inference.py:266)
        omegas = model.draw_omegas(torch.Generator().manual_seed(seed + 17))

    shutil.copy(config_path, os.path.join(output_dir, 'config_full.yaml'))
    if functional:
        files = sorted(os.path.join(output_dir, f) for f in os.listdir(output_dir)
                       if f.endswith('roman.txt'))
    else:
        files = sorted(os.path.join(output_dir, f) for f in os.listdir(output_dir)
                       if f.endswith('.txt') and not f.endswith('roman.txt'))
    print('[# pieces]', len(files))

    if batch_size > 0:
        return _run_batched(model=model, vocab=vocab, omegas=omegas,
                            files=files, functional=functional,
                            output_dir=output_dir, samp=samp,
                            max_events=max_events,
                            max_bars=max_bars_override or MAX_BARS,
                            batch_size=batch_size, seed=seed,
                            play_midi=play_midi, serve=serve,
                            gpt2_cache_len=gpt2_cache_len,
                            gpt2_window=gpt2_window, gpt2_tiers=gpt2_tiers,
                            device=dev)

    generator = Stage2Generator(model, vocab, temp=samp['temp'],
                                top_p=samp['top_p'], max_events=max_events,
                                omegas=omegas, device=dev)
    n_ok = 0
    times = []
    for file_idx, path in enumerate(files):
        out_name = '_'.join(os.path.basename(path).split('_')[:2])
        for e in emotion_candidates_for_file(path):
            midi_path = os.path.join(output_dir, out_name + '_' + e + '_full.mid')
            if os.path.exists(midi_path):
                print('[info] {} exists, skipping ...'.format(midi_path))
                continue

            key, lead_sheet_bars = read_generated_events(path, vocab.event2idx)
            emotion_id = vocab.event2idx['Emotion_{}'.format(e)]
            tempo_id = vocab.event2idx['Tempo_110']
            if functional:
                primer = [emotion_id, vocab.event2idx[key], tempo_id]
            else:
                primer = [emotion_id, tempo_id]

            tokens, stats = generator.generate(
                primer, lead_sheet_bars,
                seed=seed + file_idx * 17 + sum(map(ord, e)) % 1000,
                max_bars=max_bars_override or MAX_BARS)
            times.append(stats['seconds'])

            events = vocab.decode(tokens)
            bars = extract_midi_events_from_generation(
                key, events, relative_melody=functional)
            events_to_midi(key, list(chain(*bars[:MAX_BARS])), 'full',
                           output_midi_path=midi_path)
            if play_midi:
                from .audio import midi_to_wav
                midi_to_wav(midi_path, os.path.join(
                    output_dir, out_name + '_' + e + '_full.wav'))
            n_ok += 1

    summary = {'pieces': n_ok,
               'avg_secs': float(np.mean(times)) if times else 0.0}
    print('[info] rendered {} full performances'.format(n_ok))
    return summary


def _run_batched(*, model, vocab, omegas, files, functional, output_dir, samp,
                 max_events, max_bars, batch_size, seed, play_midi,
                 serve=False, gpt2_cache_len=4096, gpt2_window=2048,
                 gpt2_tiers=None, device='cuda'):
    """Render all (file, quadrant) jobs in batched groups, or — with
    ``serve`` — stream them all through ``batch_size`` slots with
    refill-on-finish."""
    jobs = []   # (path, emotion, midi_path)
    for path in files:
        out_name = '_'.join(os.path.basename(path).split('_')[:2])
        for e in emotion_candidates_for_file(path):
            midi_path = os.path.join(output_dir, out_name + '_' + e + '_full.mid')
            if os.path.exists(midi_path):
                print('[info] {} exists, skipping ...'.format(midi_path))
                continue
            jobs.append((path, e, midi_path))
    if not jobs:
        return {'pieces': 0, 'avg_secs': 0.0}

    gen = Stage2BatchGenerator(model, vocab, batch=batch_size,
                               temp=samp['temp'], top_p=samp['top_p'],
                               max_events=max_events, max_bars=max_bars,
                               omegas=omegas, gpt2_cache_len=gpt2_cache_len,
                               gpt2_window=gpt2_window,
                               gpt2_tiers=gpt2_tiers, device=device)
    tempo_id = vocab.event2idx['Tempo_110']

    def prep(job_list):
        primers, bars_per, keys = [], [], []
        for path, e, _ in job_list:
            key, lead_bars = read_generated_events(path, vocab.event2idx)
            keys.append(key)
            bars_per.append(lead_bars[:max_bars])
            emotion_id = vocab.event2idx['Emotion_{}'.format(e)]
            if functional:
                primers.append([emotion_id, vocab.event2idx[key], tempo_id])
            else:
                primers.append([emotion_id, tempo_id])
        return primers, bars_per, keys

    def render(job_list, streams, keys):
        n = 0
        for i, (path, e, midi_path) in enumerate(job_list):
            events = vocab.decode(streams[i])
            bars = extract_midi_events_from_generation(
                keys[i], events, relative_melody=functional)
            events_to_midi(keys[i], list(chain(*bars[:max_bars])), 'full',
                           output_midi_path=midi_path)
            if play_midi:
                from .audio import midi_to_wav
                midi_to_wav(midi_path, midi_path[:-4] + '.wav')
            n += 1
        return n

    n_ok = 0
    times = []
    if serve:
        primers, bars_per, keys = prep(jobs)
        streams, stats = gen.serve(primers, bars_per, seed=seed,
                                   max_bars=max_bars)
        times.append(stats['seconds'])
        n_ok = render(jobs, streams, keys)
        print('[info] rendered {} full performances (continuous batching, '
              '{} slots, {} refill chunks)'.format(n_ok, batch_size,
                                                   stats['chunks']))
    else:
        for g0 in range(0, len(jobs), batch_size):
            group = jobs[g0:g0 + batch_size]
            pad = batch_size - len(group)
            group_padded = group + [group[0]] * pad
            primers, bars_per, keys = prep(group_padded)
            streams, stats = gen.generate(primers, bars_per,
                                          seed=seed + g0, max_bars=max_bars)
            times.append(stats['seconds'])
            n_ok += render(group, streams, keys)
        print('[info] rendered {} full performances (batched x{})'.format(
            n_ok, batch_size))
    return {'pieces': n_ok, 'avg_secs': float(np.mean(times))}
