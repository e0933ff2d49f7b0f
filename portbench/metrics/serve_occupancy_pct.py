"""serve_occupancy_pct: the share of the slots that ran in the traced
decode steps.  100 x the running slots summed over the steps the program
counted while the profiler recorded (``COUNTS['serve.slot_steps']`` of
``emo_disentanger_tpu_torch.utils.profiling``, exact, flushed at the
generator's status reads), over the cell's slots times those steps
(``COUNTS['serve.steps']``).  A slot whose song has finished waits for the
refill at its chunk's end.  A program that keeps no such counts gives
nothing."""


def read(ctx):
    try:
        from emo_disentanger_tpu_torch.utils.profiling import COUNTS
    except ImportError:
        return None
    if COUNTS['serve.steps'] <= 0:
        return None
    slots = ctx['cell']['traffic']['slots']
    return (100.0 * COUNTS['serve.slot_steps']
            / (slots * COUNTS['serve.steps']))
