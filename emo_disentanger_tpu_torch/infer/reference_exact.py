"""Reference-exact host-side decoding, for stream-parity validation.

Port of ``emo_disentanger_tpu/infer/reference_exact.py``.  Two replays:

* stage 1: the reference's ``generate_plain_xl``
  (``stage1_compose/inference_utils.py:51-135``) on the port's
  ``PlainTransformer``, whose KV-cache decode gives the logits (the
  reference recomputes them from its XL memories; the function is the
  same);
* stage 2: the reference's ``generate_conditional``
  (``stage2_accompaniment/inference.py:229-327``) on the port's GPT-2.  The
  logits come from the KV-cache decode while the stream fits the window and
  from the full window re-forward once it outgrows it (the reference
  renumbers positions every step there); that forward runs the
  flash-attention kernel on the card when the window qualifies.

Sampling uses the reference's exact numpy arithmetic (the unstabilized
softmax with its extended-precision retry) and its global-RNG
``np.random.choice`` draw, so seeding ``np.random`` alike on two sides
gives the same stream wherever their logits agree.

This module is a validation tool; production decoding uses
:mod:`.stage1_batch` and :mod:`.stage2_batch`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.vocab import MAJOR_KEY, Vocab
from ..models.gpt2 import MusicGPT2
from ..models.txl import PlainTransformer


def _temperature_exact(logits: np.ndarray, temperature: float) -> np.ndarray:
    """Reference stage-1 ``temperature`` (``inference_utils.py:14-24``):
    unstabilized softmax, retried in extended precision (stabilized) on
    overflow."""
    try:
        probs = np.exp(logits / temperature) / np.sum(np.exp(logits / temperature))
        assert np.count_nonzero(np.isnan(probs)) == 0
        return probs
    except (AssertionError, FloatingPointError):
        logits = logits.astype(np.longdouble)
        x = logits / temperature
        probs = np.exp(x - np.max(x))
        probs = probs / probs.sum()
        return probs.astype(float)


def _temperature_exact_s2(logits: np.ndarray, temperature: float,
                          inadmissibles=None) -> np.ndarray:
    """Reference stage-2 ``temperature`` (``inference.py:73-86``): optional
    inadmissible-set mask via in-place ``-= inf``, unstabilized softmax, and
    an unstabilized extended-precision retry."""
    if inadmissibles is not None:
        logits[inadmissibles] -= np.inf
    try:
        probs = np.exp(logits / temperature) / np.sum(np.exp(logits / temperature))
        assert np.count_nonzero(np.isnan(probs)) == 0
        return probs
    except (AssertionError, FloatingPointError):
        logits = logits.astype(np.longdouble)
        probs = np.exp(logits / temperature) / np.sum(np.exp(logits / temperature))
        return probs.astype(float)


def _nucleus_exact(probs: np.ndarray, p: float) -> int:
    """Reference ``nucleus`` (``inference_utils.py:27-41``), including the
    second-crossing quirk and the global-RNG draw."""
    probs = probs / sum(probs)
    sorted_probs = np.sort(probs)[::-1]
    sorted_index = np.argsort(probs)[::-1]
    cusum_sorted_probs = np.cumsum(sorted_probs)
    after_threshold = cusum_sorted_probs > p
    if sum(after_threshold) > 0:
        last_index = np.where(after_threshold)[0][1]
        candi_index = sorted_index[:last_index]
    else:
        candi_index = sorted_index[:3]
    candi_probs = np.array([probs[i] for i in candi_index], dtype=np.float64)
    candi_probs /= sum(candi_probs)
    return int(np.random.choice(candi_index, size=1, p=candi_probs)[0])


@torch.no_grad()
def generate_stage1_reference_exact(
    model: PlainTransformer, vocab: Vocab, *,
    primer_events: List[str], max_bars: int = 128, max_events: int = 512,
    temp: float = 1.2, top_p: float = 0.97,
    prompt_bars: Optional[int] = None, max_klen: Optional[int] = None,
) -> Tuple[Optional[List[int]], int]:
    """Token-for-token replay of the reference's ``generate_plain_xl`` on
    the port's ``PlainTransformer`` (``reference_exact.py:213-292``), on the
    model's device, one token a step through ``decode_step`` (the chunked
    live-prefix attention at B=1).  All primer tokens but the last are
    prefilled.  The replay is of the functional representation with the
    reference's 'rule' key determination: the key step (the second token)
    samples at 1.1 / 0.97 and redraws while the key's mode does not match
    the emotion's valence; the cache still grows by one entry for each
    draw.
    The caller seeds ``np.random``.  Returns (token ids including the final
    token the reference later drops, accepted samples), or (None, _) when
    256 consecutive beat rejections mark the song stuck."""
    dev = model.device
    generated = vocab.encode(primer_events)
    target_bars = max_bars
    generated_bars = prompt_bars or 0

    cache = model.init_decode_cache(1, max_klen or (max_events + 2048))
    step = lambda tok, t: model.decode_step(  # noqa: E731
        torch.tensor([tok], device=dev), t, cache)[0]

    t = 0
    for tok in generated[:-1]:
        step(tok, t)
        t += 1

    steps = 0
    cur_pos = 0
    failed_cnt = 0
    while generated_bars < target_bars:
        # float32, as the reference's numpy softmax runs in the tensor's dtype
        logits = step(generated[-1], t)[0].float().cpu().numpy()
        t += 1

        if len(generated) == 1:
            word = _nucleus_exact(_temperature_exact(logits, 1.1), 0.97)
            emotion_label = vocab.idx2event[generated[0]].split('_')[1]
            key_event = vocab.idx2event[word]
            if key_event.split('_')[0] != 'Key':
                raise ValueError('[info] key generation failed')
            positive = emotion_label in ('Q1', 'Q4', 'Positive')
            if positive != (key_event.split('_')[1] in MAJOR_KEY):
                continue
            word_event = vocab.idx2event[word]
        else:
            word = _nucleus_exact(_temperature_exact(logits, temp), top_p)
            word_event = vocab.idx2event[word]

        if 'Beat' in word_event:
            event_pos = int(word_event.split('_')[-1])
            if not event_pos >= cur_pos:
                failed_cnt += 1
                if failed_cnt >= 256:
                    return None, steps
                continue
            cur_pos = event_pos
            failed_cnt = 0

        if 'Bar' in word_event:
            generated_bars += 1
            cur_pos = 0
        if word_event == 'PAD_None':
            continue

        generated.append(word)
        steps += 1

        if len(generated) > max_events:
            break
        if word_event == 'EOS_None':
            break

    return generated, steps


@torch.no_grad()
def generate_stage2_reference_exact(
    model: MusicGPT2, vocab: Vocab, *,
    lead_sheet_events: List[List[int]], primer: List[int],
    max_events: int = 10000, skip_check: bool = False,
    max_bars: Optional[int] = None, temp: float = 1.2, top_p: float = 0.9,
    inadmissibles=None, window: int = 2048,
) -> Tuple[List[int], int]:
    """Token-for-token replay of the reference's ``generate_conditional`` on
    the port's GPT-2 (in ``eval()`` mode), on the model's device.  The
    caller seeds ``np.random``.  Returns (tokens, steps): the reference's
    return value (``generated[:-1]`` normally, the whole stream on a stuck
    exit) and the count of accepted samples."""
    dev = model.device
    tls = vocab.event2idx['Track_LeadSheet']
    tf = vocab.event2idx['Track_Full']
    generated = list(primer) + [tls] + list(lead_sheet_events[0]) + [tf]
    seg_inp = [0] * len(generated)
    seg_inp[-1] = 1

    target_bars = len(lead_sheet_events)
    generated_bars = 0
    if max_bars is not None:
        target_bars = min(max_bars, target_bars)

    cache_cap = window + 8
    cache = model.init_decode_cache(1, cache_cap)
    n_fed = 0
    logits_dev = None

    def feed(tokens: List[int], segs: List[int]):
        # stop at capacity: by then the stream has outgrown the window and
        # sampling has switched to the full re-forward, so the stale cache
        # is never read again
        nonlocal n_fed, logits_dev
        for tok, seg in zip(tokens, segs):
            if n_fed >= cache_cap:
                return
            logits_dev, _ = model.decode_step(
                torch.tensor([tok], device=dev), torch.tensor([seg], device=dev),
                n_fed, cache)
            n_fed += 1

    # prefill the seed (all but the last token produce no sampled logits)
    feed(generated, seg_inp)

    steps = 0
    cur_pos = 0
    failed_cnt = 0
    while generated_bars < target_bars:
        if len(generated) < window:
            # a fresh writable copy each time: temperature() edits in place
            logits = logits_dev[0].float().cpu().numpy().copy()
        else:
            logits = model(torch.tensor([generated[-window:]], device=dev),
                           torch.tensor([seg_inp[-window:]], device=dev),
                           keep_last_only=True)[0].float().cpu().numpy()
        probs = _temperature_exact_s2(logits, temp, inadmissibles=inadmissibles)
        word = _nucleus_exact(probs, top_p)
        word_event = vocab.idx2event[word]

        if not skip_check and 'Beat' in word_event:
            event_pos = int(word_event.split('_')[-1])
            if not event_pos >= cur_pos:
                failed_cnt += 1
                if failed_cnt >= 256:
                    return generated, steps      # stuck: the full stream
                continue
            cur_pos = event_pos
            failed_cnt = 0

        if word_event == 'Track_LeadSheet':
            steps += 1
            generated.append(word)
            seg_inp.append(0)
            generated_bars += 1
            if generated_bars < target_bars:
                bar = list(lead_sheet_events[generated_bars])
                inject = [word] + bar + [tf]
                inject_segs = [0] * (1 + len(bar)) + [1]
                generated.extend(bar + [tf])
                seg_inp.extend([0] * len(bar) + [1])
                cur_pos = 0
                if len(generated) < window:
                    feed(inject, inject_segs)
            continue

        if word_event == 'PAD_None' or (word_event == 'EOS_None'
                                        and generated_bars < target_bars - 1):
            continue
        elif word_event == 'EOS_None' and generated_bars == target_bars - 1:
            generated.append(word)
            break

        generated.append(word)
        seg_inp.append(1)
        steps += 1
        if len(generated) < window:
            feed([word], [1])

        if len(generated) > max_events:
            break

    return generated[:-1], steps
