"""Stage-2 generation for one song, orchestrated from the host.

Port of ``emo_disentanger_tpu/infer/stage2.py`` (reference
``generate_conditional``, ``stage2_accompaniment/inference.py:231-327``):
primer + per-bar teacher-forced lead-sheet injection, beat-monotonicity
rejection with a 256-strike stuck guard (which returns the partial piece),
PAD and early-EOS skips, and segment ids 0 for lead-sheet tokens (the
sampled Track_LeadSheet included) and 1 for full-track tokens.

The decoder carries state where the reference re-encodes its last 2048
tokens for every token: the Performer its per-layer FAVOR+ (S, z) sums, and
GPT-2 a KV cache with absolute positions that one parallel forward over the
trailing ``gpt2_window`` tokens re-anchors when the cache fills (the
mid-bar guard at ``gpt2_cache_len - 2``) or cannot hold the next bar with
``reanchor_margin`` to spare.  That forward runs the flash-attention kernel
on the card.  Rejected samples redraw from the same logits without
advancing the state.  Each sample is read on the host to apply the rules.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.vocab import Vocab
from ..models.gpt2 import MusicGPT2
from ..models.performer import MusicPerformer
from ..ops.sampling import nucleus_sample
from ..utils.device import resolve_device
from .rules import build_rule_tables

STATUS_RUNNING = 0
STATUS_BAR_DONE = 1     # sampled Track_LeadSheet, bar finished
STATUS_EOS = 2
STATUS_MAX = 3
STATUS_STUCK = 4


class Stage2Generator:
    """Host-driven decode of one song for one (model, vocab) pair."""

    def __init__(self, model, vocab: Vocab, *, temp: float, top_p: float,
                 max_events: int = 10000, gpt2_cache_len: int = 4096,
                 gpt2_window: int = 2048, reanchor_margin: int = 256,
                 omegas: Optional[torch.Tensor] = None,
                 forbid: Union[np.ndarray, torch.Tensor, None] = None,
                 device: Union[str, torch.device] = 'cuda'):
        """``forbid``: optional bool mask [V] of tokens never sampled (e.g.
        JAX's ``construct_inadmissible_set``)."""
        self.device = resolve_device(device)
        self.is_performer = isinstance(model, MusicPerformer)
        if not self.is_performer and not isinstance(model, MusicGPT2):
            raise TypeError(f'expected MusicPerformer or MusicGPT2, got '
                            f'{type(model).__name__}')
        if model.device != self.device:
            raise ValueError(f'model on {model.device}; expected {self.device}')
        if self.is_performer and omegas is None:
            raise ValueError('Performer decoding needs drawn omegas')
        if not self.is_performer and model.training:
            raise ValueError('GPT-2 re-anchors run the deterministic forward; '
                             'call model.eval() first')
        self.model = model
        self.vocab = vocab
        self.temp = temp
        self.top_p = top_p
        self.max_events = max_events
        self.cache_len = gpt2_cache_len
        self.window = gpt2_window
        self.reanchor_margin = reanchor_margin
        self.omegas = None if omegas is None else omegas.to(self.device).float()
        self.forbid = None
        if forbid is not None:
            self.forbid = torch.as_tensor(forbid).to(self.device, torch.bool)
            if self.forbid.shape != (vocab.size,):
                raise ValueError(f'forbid must be [{vocab.size}] (got '
                                 f'{tuple(self.forbid.shape)})')
        self.tables = build_rule_tables(vocab)

    # ----------------------------------------------------------- plumbing
    def _init_state(self):
        if self.is_performer:
            return self.model.init_decode_state(1)
        return self.model.init_decode_cache(1, self.cache_len)

    def _step(self, token: int, seg: int, t: int, state):
        """One decode step at position ``t`` -> (logits [V], state)."""
        tok = torch.tensor([token], device=self.device)
        sg = torch.tensor([seg], device=self.device)
        if self.is_performer:
            logits, state = self.model.decode_step(tok, sg, t, self.omegas, state)
        else:
            logits, state = self.model.decode_step(tok, sg, t, state)
        return logits[0], state

    def _inject(self, tokens: Sequence[int], segs: Sequence[int], t: int, state):
        """Teacher-force ``tokens`` through the state -> (logits after the
        last one, state, new t)."""
        logits = torch.zeros(self.vocab.size, device=self.device)
        for tok, seg in zip(tokens, segs):
            logits, state = self._step(tok, seg, t, state)
            t += 1
        return logits, state, t

    def _reanchor(self, all_tokens: List[int], all_segs: List[int]):
        """GPT-2 cache rebuild: one forward over the last ``window`` tokens
        (PAD-filled to the window) -> (logits at the last real token, a
        fresh cache of ``cache_len`` positions, the new clock)."""
        keep = all_tokens[-self.window:]
        pad = self.window - len(keep)
        toks = torch.tensor([keep + [self.vocab.pad_id] * pad], device=self.device)
        segs = torch.tensor([all_segs[-self.window:] + [0] * pad],
                            device=self.device)
        logits, k, v = self.model(toks, segs, return_kv=True)
        cache = self.model.init_decode_cache(1, self.cache_len)
        cache['k'][:, :, :self.window] = k
        cache['v'][:, :, :self.window] = v
        return logits[0, len(keep) - 1], cache, len(keep)

    def _sample(self, logits, state, t, out: List[int], cur_pos, failed,
                gen, bars, target_bars):
        """Sample until a bar ends, the song ends, the model is stuck or (for
        GPT-2) the clock reaches the cache guard; accepted tokens go to
        ``out``.  Returns (logits, state, t, cur_pos, failed, status)."""
        tb = self.tables
        max_iters = self.max_events * 2 + 4096
        guard = None if self.is_performer else self.cache_len - 2
        status = STATUS_RUNNING
        for _ in range(max_iters):
            if status != STATUS_RUNNING or (guard is not None and t >= guard):
                break
            word = int(nucleus_sample(logits[None], self.temp, self.top_p, gen,
                                      self.forbid)[0])
            beat_bad = bool(tb.is_beat[word]) and tb.beat_pos[word] < cur_pos
            eos_early = bool(tb.is_eos[word]) and bars < target_bars - 1
            failed = (failed + 1 if beat_bad else
                      0 if tb.is_beat[word] else failed)
            if failed >= 256:
                status = STATUS_STUCK
                continue
            if beat_bad or tb.is_pad[word] or eos_early:
                continue
            logits, state = self._step(word, 0 if tb.is_track_lead[word] else 1,
                                       t, state)
            t += 1
            out.append(word)
            if tb.is_beat[word]:
                cur_pos = int(tb.beat_pos[word])
            status = (STATUS_BAR_DONE if tb.is_track_lead[word] else
                      STATUS_EOS if tb.is_eos[word] else
                      STATUS_MAX if len(out) > self.max_events else
                      STATUS_RUNNING)
        return logits, state, t, cur_pos, failed, status

    # ------------------------------------------------------------- public
    @torch.no_grad()
    def generate(self, primer: Sequence[int], lead_sheet_bars: List[List[int]],
                 *, seed: int = 0, max_bars: Optional[int] = None,
                 ) -> Tuple[List[int], dict]:
        """A full performance conditioned on per-bar lead-sheet token lists.
        Returns (token ids, stats); the final token is dropped as the
        reference does (``generated[:-1]``), except on a stuck exit.
        ``stats['reanchors']`` counts the GPT-2 window re-anchors."""
        vocab = self.vocab
        track_lead = vocab.event2idx['Track_LeadSheet']
        track_full = vocab.event2idx['Track_Full']
        target_bars = len(lead_sheet_bars)
        if max_bars is not None:
            target_bars = min(max_bars, target_bars)

        tokens = list(primer) + [track_lead] + list(lead_sheet_bars[0]) + [track_full]
        segs = [0] * (len(tokens) - 1) + [1]
        t0 = time.time()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, state, t = self._inject(tokens, segs, 0, self._init_state())
        all_tokens, all_segs = list(tokens), list(segs)
        bars = cur_pos = failed = reanchors = 0
        status = STATUS_RUNNING
        rounds = 0
        while bars < target_bars:
            rounds += 1
            if rounds > 4 * (target_bars + 1) + 64:
                # a model that samples rejected tokens forever would spin the
                # re-anchor / sample cycle endlessly
                status = STATUS_STUCK
                break
            n0 = len(all_tokens)
            logits, state, t, cur_pos, failed, status = self._sample(
                logits, state, t, all_tokens, cur_pos, failed, gen, bars,
                target_bars)
            all_segs.extend(0 if tok == track_lead else 1
                            for tok in all_tokens[n0:])
            if status == STATUS_BAR_DONE:
                bars += 1
                if bars < target_bars:
                    inject = list(lead_sheet_bars[bars]) + [track_full]
                    if len(all_tokens) + len(inject) >= self.max_events:
                        status = STATUS_MAX
                        break
                    inj_segs = [0] * (len(inject) - 1) + [1]
                    # GPT-2: re-anchor when the cache cannot hold the bar
                    if (not self.is_performer and t + len(inject)
                            + self.reanchor_margin >= self.cache_len):
                        logits, state, t = self._reanchor(all_tokens, all_segs)
                        reanchors += 1
                    logits, state, t = self._inject(inject, inj_segs, t, state)
                    all_tokens.extend(inject)
                    all_segs.extend(inj_segs)
                    cur_pos = 0
                continue
            if status == STATUS_RUNNING and not self.is_performer:
                # the cache guard: re-anchor and continue the same bar
                logits, state, t = self._reanchor(all_tokens, all_segs)
                reanchors += 1
                continue
            break

        stats = {'status': status, 'bars': bars, 'n_events': len(all_tokens),
                 'reanchors': reanchors, 'seconds': time.time() - t0}
        if status == STATUS_STUCK:
            return all_tokens, stats
        return all_tokens[:-1], stats
