"""serve_mfu: the decode step's share of the card's peak.  The least time
of the traced steps (every weight read once a step; the running slots'
FAVOR+ state read and written, or GPT-2's live cache prefix read and new
rows written; FLOPs at the bf16 peak if longer; ``work.decode_step_work``)
over the traced window's span.  The running slots and cache rows a step
are the call's average, from its returned stats (the driver's
``counts``)."""


def read(ctx):
    r, cfg, c = ctx['reading'], ctx['cfg'], ctx['counts']
    if r.window_s <= 0 or r.steps <= 0 or c['steps'] <= 0:
        return None
    w = ctx['work']
    elem = w.ELEM_BYTES[cfg['serving']['weights_dtype']]
    flops, nbytes = w.decode_step_work(cfg, c['vocab'], c['slot_steps'] / c['steps'],
                                       c['live_rows'] / c['steps'], elem)
    least = w.least_seconds(flops, nbytes, cfg['serving']['weights_dtype'])
    return 100.0 * least * r.steps / r.window_s
