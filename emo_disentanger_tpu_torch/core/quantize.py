"""Time/velocity/tempo quantization grids (copy of
``emo_disentanger_tpu/core/quantize.py``).

Parity with the reference constants (``midi2events_emopia.py:17-28``): a bar
is 4 beats of 480 ticks; the event grid is 16 positions per bar (16th notes);
42 velocity bins, 65 bpm bins, 61 onset-shift bins; durations in multiples of
a 16th note, capped at one bar downstream.
"""

from __future__ import annotations

import numpy as np

BEAT_RESOL = 480
BAR_RESOL = BEAT_RESOL * 4          # 1920 ticks
TICK_RESOL = BEAT_RESOL // 4        # 120 ticks  (16 positions / bar)
POSITIONS_PER_BAR = BAR_RESOL // TICK_RESOL  # 16

DEFAULT_TEMPO = 110
MIN_VELOCITY = 40

DEFAULT_VELOCITY_BINS = np.linspace(4, 127, 42, dtype=int)
DEFAULT_BPM_BINS = np.linspace(32, 224, 64 + 1, dtype=int)
DEFAULT_SHIFT_BINS = np.linspace(-60, 60, 60 + 1, dtype=int)
# 60, 120, ..., 3840 ticks (1/8 beat steps up to 8 beats)
DEFAULT_DURATION_BINS = np.arange(BEAT_RESOL / 8, BEAT_RESOL * 8 + 1, BEAT_RESOL / 8)

# Vocabulary-side duration values: one 16th (120) .. one bar (1920).
VOCAB_DURATION_VALUES = np.arange(TICK_RESOL, BAR_RESOL + TICK_RESOL, TICK_RESOL)


def nearest_bin(bins: np.ndarray, value) -> int:
    """Snap a scalar to the nearest bin value (ties resolve to the lower bin,
    matching ``np.argmin(abs(bins - v))``)."""
    return int(bins[np.argmin(np.abs(bins - value))])


def quantize_tick(tick: float, resol: int = TICK_RESOL) -> int:
    """Round a tick time to the grid (banker's rounding via np.round, matching
    the reference's ``int(np.round(t / r) * r)``)."""
    return int(np.round(tick / resol) * resol)
