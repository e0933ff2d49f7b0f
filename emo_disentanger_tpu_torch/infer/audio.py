"""Optional MIDI -> WAV synthesis (copy of ``emo_disentanger_tpu/infer/audio.py``;
reference ``midi_to_wav``, ``stage1_compose/inference.py:80-83``, via
FluidSynth + the Salamander grand-piano soundfont).

The synth is an external tool; we shell out to the ``fluidsynth`` binary when
present and raise a clear error otherwise (the framework itself stays
dependency-free).
"""

from __future__ import annotations

import os
import shutil
import subprocess

DEFAULT_SOUND_FONT = ('SalamanderGrandPiano-SF2-V3+20200602/'
                      'SalamanderGrandPiano-V3+20200602.sf2')


def midi_to_wav(midi_path: str, output_path: str,
                sound_font_path: str = DEFAULT_SOUND_FONT,
                sample_rate: int = 44100) -> str:
    exe = shutil.which('fluidsynth')
    if exe is None:
        raise RuntimeError(
            'fluidsynth binary not found; install FluidSynth and provide a '
            'soundfont (e.g. the Salamander grand piano) to render WAV audio')
    if not os.path.exists(sound_font_path):
        raise FileNotFoundError(f'soundfont not found: {sound_font_path}')
    subprocess.run([exe, '-ni', sound_font_path, midi_path,
                    '-F', output_path, '-r', str(sample_rate)],
                   check=True, capture_output=True)
    return output_path
