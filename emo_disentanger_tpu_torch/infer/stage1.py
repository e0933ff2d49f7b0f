"""Stage-1 generation of one lead sheet, and the song loop it shares with
the batched generator.

Port of ``emo_disentanger_tpu/infer/stage1.py`` (reference
``generate_plain_xl``, ``stage1_compose/inference_utils.py:51-135``).  The
rules, as ``_make_song_loop`` (``stage1.py:42-152``) applies them:

* in the functional representation (``functional=True``) the key step
  (the second token) samples at temperature 1.1 / top-p 0.97 and must draw
  a ``Key_*`` token whose mode matches the emotion's valence
  (``rules.emotion_wants_major``); REMI (``functional=False``) has no key
  token, and its second token samples as any other;
* Beat positions must not decrease within a bar; 256 consecutive
  violations mark the song STUCK, and it returns None;
* PAD is skipped; ``Bar_None`` counts bars; EOS or the bar or event budget
  ends the song; the returned stream drops its final token;
* the KV cache grows by one entry on every iteration, accepted or
  rejected: the reference updates its memories before the rule check, so
  a rejected draw re-feeds the last accepted token.  The write position t
  is the iteration count, not the output length.  A song whose t reaches
  the cache's last row is marked OVERFLOW.

The loop is Python over device tensors: every rule is a table lookup on
the sampled ids, and a song that is not running is frozen by the status
masks.  The slots, the step's span, the status poll and the serve queue are
``slots.SlotLoop``'s; this module adds the step body, whose sampler is the
span ``emodis.serve.sample`` and whose counts are the running songs and
their clocks (``serve.slot_steps``, ``serve.live_rows``), while the model's
layers mark their cache work ``emodis.txl.attn``.  In the shared-clock loop
the write position is a host integer, so the chunked attention's chunk
count needs no device read.

The decode cache is in ``cache_layout`` ('khd', 'hkd' or 'dk';
``EMODIS_S1_CACHE_LAYOUT`` when None, else 'khd'; ``ops.attention``), as
JAX's generators take it (``stage1.py:163-182``).  ``Stage1Generator``
decodes a 'khd' cache with the chunked attention and a head-major one with
the whole-cache attention, as JAX does (``stage1.py:46-49``).

Over a mesh (``Stage1BatchGenerator``'s ``mesh``), a rank runs its rows of
the B songs: every step draws ``torch.rand(B)`` uniforms on every rank and
each keeps its rows, and the host reads are reduced over the data axes, so
every rank steps as often as one device would (``slots``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.vocab import Vocab
from ..models.txl import PlainTransformer
from ..ops.attention import VALID_LAYOUTS
from ..ops.sampling import nucleus_sample
from ..utils.profiling import accumulate, span
from .rules import build_rule_tables, emotion_wants_major
from .slots import HOST_CHECK_STEPS, SlotLoop

STATUS_RUNNING = 0
STATUS_DONE = 1
STATUS_STUCK = 2
STATUS_OVERFLOW = 3
STATUS_IDLE = 4          # serve(): slot has no job (queue exhausted)

# the key step's sampling settings (``inference_utils.py:90-94``)
KEY_TEMP, KEY_TOP_P = 1.1, 0.97


class SongLoop(SlotLoop):
    """The per-step body of stage-1 generation for B songs on one device,
    or this rank's rows of them over a ``mesh``'s data axes.
    ``Stage1Generator`` (B=1) and ``Stage1BatchGenerator`` build on it."""

    def __init__(self, model: PlainTransformer, vocab: Vocab, *, batch: int,
                 temp: float, top_p: float, max_events: int, max_bars: int,
                 device: Union[str, torch.device], functional: bool = True,
                 mesh=None, cache_layout: Optional[str] = None):
        self.cache_layout = (cache_layout if cache_layout is not None else
                             os.environ.get('EMODIS_S1_CACHE_LAYOUT', 'khd'))
        if self.cache_layout not in VALID_LAYOUTS:
            raise ValueError(f'cache_layout must be one of {VALID_LAYOUTS} '
                             f'(got {self.cache_layout!r})')
        if not isinstance(model, PlainTransformer):
            raise TypeError(f'expected PlainTransformer, got '
                            f'{type(model).__name__}')
        super().__init__(model, batch=batch, mesh=mesh, device=device)
        self.vocab = vocab
        self.temp = temp
        self.top_p = top_p
        self.max_events = max_events
        self.max_bars = max_bars
        self.functional = functional
        self.max_iters = max_events * 2 + 2048
        tb = build_rule_tables(vocab)
        on_dev = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self._is_beat = on_dev(tb.is_beat)
        self._beat_pos = on_dev(tb.beat_pos.astype(np.int64))
        self._is_bar = on_dev(tb.is_bar)
        self._is_pad = on_dev(tb.is_pad)
        self._is_eos = on_dev(tb.is_eos)
        self._is_key = on_dev(tb.is_key)
        self._key_major = on_dev(tb.key_major)
        self._ar = torch.arange(self.nb, device=self.device)

    # ---- jobs ----

    def _primer_rows(self, primers: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
        """[N, P] primer matrix, P the longest primer, and the lengths.  A
        song takes its primer's tokens while fewer than its length are fed
        and samples after, so the zeros past a short row are never read."""
        longest = max(len(p) for p in primers)
        if longest > self.max_events:
            raise ValueError('primer longer than max_events')
        prim = np.zeros((len(primers), longest), np.int64)
        plen = np.zeros(len(primers), np.int64)
        for b, row in enumerate(primers):
            prim[b, :len(row)] = row
            plen[b] = len(row)
        return prim, plen

    def _jobs(self, emotions: List[str], primers, prompt_bars, target_bars
              ) -> Dict[str, np.ndarray]:
        """The N jobs' fields as numpy arrays [N, ...]: emotion-token
        primers unless ``primers`` (event lists, each starting with its
        Emotion token) are given; the bar counter starts at ``prompt_bars``,
        by default the primer's Bar_None count minus one, the reference's
        convention (``inference.py:35-38``, ``inference_utils.py:57-60``)."""
        N = len(emotions)
        if primers is None:
            rows = [[self.vocab.event2idx['Emotion_{}'.format(e)]]
                    for e in emotions]
            pb = np.zeros(N, np.int64)
        else:
            if len(primers) != N:
                raise ValueError('one primer per emotion')
            rows = [self.vocab.encode(p) for p in primers]
            pb = np.asarray(prompt_bars if prompt_bars is not None else
                            [max(0, sum(e == 'Bar_None' for e in p) - 1)
                             for p in primers], np.int64)
        prim, plen = self._primer_rows(rows)
        if isinstance(target_bars, (list, tuple, np.ndarray)):
            tb = np.minimum(np.asarray(target_bars, np.int64), self.max_bars)
        else:
            tb = np.full(N, target_bars or self.max_bars, np.int64)
        want = np.asarray([emotion_wants_major(e) for e in emotions])
        return {'primer': prim, 'primer_len': plen, 'prompt_bars': pb,
                'target_bars': tb, 'want_major': want}

    def _fresh(self, f: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-slot state of the jobs whose fields are ``f`` (``_job_rows``,
        one a slot of this rank), before any step: the primer's first token
        is next, and the output holds the primer."""
        E = self.max_events + 8
        out = torch.zeros(self.nb, E, dtype=torch.long, device=self.device)
        out[:, :f['primer'].shape[1]] = f['primer']
        zeros = torch.zeros(self.nb, dtype=torch.long, device=self.device)
        return {'primer': f['primer'], 'primer_len': f['primer_len'],
                'target_bars': f['target_bars'], 'want_major': f['want_major'],
                'last': f['primer'][:, 0], 'fed': torch.ones_like(zeros),
                'out': out, 'out_len': f['primer_len'].clone(),
                'bars': f['prompt_bars'].clone(), 'cur_pos': zeros,
                'failed': zeros, 'rejects': zeros, 'esteps': zeros,
                'status': torch.full_like(zeros, STATUS_RUNNING)}

    # ---- the loop body ----

    def _running(self, s: Dict) -> torch.Tensor:
        return (s['status'] == STATUS_RUNNING) & (s['bars'] < s['target_bars'])

    def _advance(self, s: Dict, gen: torch.Generator, counting: bool, *,
                 max_klen: int, full_attention: Optional[bool] = None) -> None:
        """The decode step and rule update of ``_step``, for every song.
        With a host-integer ``s['t']`` all songs share the write position
        (the chunked attention, or the whole cache with
        ``full_attention``); with a tensor [B] each has its own
        (``decode_step_pe``), and a song that runs ``max_iters`` steps is
        marked STUCK."""
        act = self._running(s)
        if counting:
            self._count_step(s, act)
        per_element = isinstance(s['t'], torch.Tensor)
        if per_element:
            logits, _ = self.model.decode_step_pe(s['last'], s['t'], s['cache'],
                                                  self.cache_layout)
        else:
            logits, _ = self.model.decode_step(s['last'], s['t'], s['cache'],
                                               full_attention=full_attention,
                                               layout=self.cache_layout)
        s['t'] = s['t'] + 1
        in_primer = s['fed'] < s['primer_len']
        prim_next = s['primer'].gather(1, s['fed'].clamp(
            max=s['primer'].shape[1] - 1)[:, None])[:, 0]
        key_step = (s['out_len'] == 1) & ~in_primer & self.functional
        # one batched sort: the key step's settings are chosen per row
        u = torch.rand(self.batch, generator=gen, device=self.device)
        with span('emodis.serve.sample'):
            sampled_tok = nucleus_sample(
                logits, torch.where(key_step, KEY_TEMP, self.temp),
                torch.where(key_step, KEY_TOP_P, self.top_p), u[self.rows])
        word = torch.where(in_primer, prim_next, sampled_tok)

        is_beat, is_bar = self._is_beat[word], self._is_bar[word]
        beat_pos = self._beat_pos[word]
        key_ok = self._is_key[word] & (self._key_major[word] == s['want_major'])
        reject_key = key_step & ~key_ok
        reject_beat = is_beat & (beat_pos < s['cur_pos']) & ~reject_key
        reject_pad = self._is_pad[word] & ~reject_key & ~reject_beat
        reject = (reject_key | reject_beat | reject_pad) & ~in_primer

        sampled = act & ~in_primer
        failed = torch.where(sampled & reject_beat, s['failed'] + 1, torch.where(
            sampled & is_beat & ~reject, 0, s['failed']))
        stuck = failed >= 256
        accept = sampled & ~reject
        s['fed'] = s['fed'] + (act & in_primer)
        idx = s['out_len'].clamp(max=s['out'].shape[1] - 1)
        s['out'][self._ar, idx] = torch.where(accept, word, s['out'][self._ar, idx])
        s['out_len'] = s['out_len'] + accept
        s['bars'] = s['bars'] + (accept & is_bar)
        s['cur_pos'] = torch.where(accept & is_bar, 0, torch.where(
            accept & is_beat, beat_pos, s['cur_pos']))
        s['last'] = torch.where(accept | (act & in_primer), word, s['last'])

        done = accept & (self._is_eos[word] | (s['out_len'] > self.max_events))
        overflow = s['t'] >= max_klen - 1
        if per_element:
            s['esteps'] = s['esteps'] + act
            stuck = stuck | (s['esteps'] >= self.max_iters)
        status = torch.where(act & overflow, STATUS_OVERFLOW, s['status'])
        status = torch.where(done, STATUS_DONE, status)
        s['status'] = torch.where(act & stuck, STATUS_STUCK, status)
        s['failed'] = failed
        s['rejects'] = s['rejects'] + (sampled & reject)

    def _count_step(self, s: Dict, act: torch.Tensor) -> None:
        """Add the step's running songs and the sum of their clocks at the
        step's start to the device accumulator that ``_poll`` flushes into
        ``COUNTS`` through its one host read.  Each rank counts its own
        songs."""
        accumulate(s, torch.stack([act.sum(), (s['t'] * act).sum()]))

    def _lockstep(self, s: Dict, gen: torch.Generator, iters: int, *,
                  max_klen: int, full_attention: Optional[bool]) -> int:
        """Step the shared-clock songs until none runs, the loop has run
        ``max_iters`` steps in all, or the clock reaches the cache's last
        row (the step that gets there marks the running songs OVERFLOW).
        Returns the step count."""
        while (iters < self.max_iters and s['t'] < max_klen - 1
               and self._poll(s)[0]):
            for _ in range(min(HOST_CHECK_STEPS, self.max_iters - iters,
                               max_klen - 1 - s['t'])):
                self._step(s, gen, max_klen=max_klen,
                           full_attention=full_attention)
                iters += 1
        if 'counted' in s:        # steps since the last read
            self._poll(s)
        return iters

    def _song(self, out_row: np.ndarray, n: int, status: int
              ) -> Optional[List[str]]:
        """None for a stuck song; otherwise its events without the final
        token, as the reference returns them."""
        if status == STATUS_STUCK:
            return None
        return self.vocab.decode(out_row[:n].tolist()[:-1])


class Stage1Generator(SongLoop):
    """One song at a time, host-orchestrated (``stage1.py:155-236``)."""

    def __init__(self, model: PlainTransformer, vocab: Vocab, *,
                 temp: float = 1.2, top_p: float = 0.97,
                 max_events: int = 512, max_bars: int = 128,
                 functional: bool = True, reject_slack: int = 1024,
                 cache_layout: Optional[str] = None,
                 device: Union[str, torch.device] = 'cuda'):
        super().__init__(model, vocab, batch=1, temp=temp, top_p=top_p,
                         max_events=max_events, max_bars=max_bars,
                         device=device, functional=functional,
                         cache_layout=cache_layout)
        self.max_klen = max_events + reject_slack

    @torch.no_grad()
    def generate(self, emotion: str, seed: int,
                 primer_events: Optional[List[str]] = None,
                 target_bars: Optional[int] = None,
                 prompt_bars: Optional[int] = None,
                 ) -> Tuple[Optional[List[str]], dict]:
        """Generate one piece: (events without the dropped last token, or
        None for a stuck song; stats).  All primer tokens but the last are
        prefilled first; decode steps take the chunked attention (B=1) in
        'khd' and the whole-cache one in the head-major layouts.
        ``prompt_bars`` defaults to the primer's Bar_None count minus one
        (the reference's prompt convention, which assumes the primer opens
        with its Emotion token)."""
        primer_events = primer_events or ['Emotion_{}'.format(emotion)]
        jobs = self._jobs([emotion], [primer_events],
                          None if prompt_bars is None else [prompt_bars],
                          target_bars)
        t0 = time.time()
        s = self._fresh(self._job_rows(jobs, [0]))
        plen = int(jobs['primer_len'][0])
        s['cache'] = self.model.init_decode_cache(1, self.max_klen,
                                                  self.cache_layout)
        prim = s['primer'][:, :plen]
        for i in range(plen - 1):
            self.model.decode_step(prim[:, i], i, s['cache'],
                                   layout=self.cache_layout)
        s['t'] = plen - 1
        s['last'] = prim[:, plen - 1]
        s['fed'] = s['primer_len'].clone()
        self._lockstep(s, self._generator(seed), 0, max_klen=self.max_klen,
                       full_attention=None)
        status = int(s['status'][0])
        n = int(s['out_len'][0])
        stats = {'status': status, 'bars': int(s['bars'][0]), 'n_events': n,
                 'seconds': time.time() - t0}
        return self._song(s['out'][0].cpu().numpy(), n, status), stats
