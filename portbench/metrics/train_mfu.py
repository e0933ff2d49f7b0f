"""train_mfu: the train step's share of the card's peak.  The least time
of a step (its model FLOPs at the bf16 peak, or its needed bytes at the
memory's peak, whichever is longer; ``work.train_step_work``) over the
step's measured time in the traced window (its span over the traced
steps)."""


def read(ctx):
    r, cfg, c = ctx['reading'], ctx['cfg'], ctx['counts']
    if r.window_s <= 0:
        return None
    w = ctx['work']
    flops, nbytes = w.train_step_work(cfg, c['vocab'], c['batch'], c['seq_len'])
    least = w.least_seconds(flops, nbytes, cfg['training']['compute_dtype'])
    return 100.0 * least * r.steps / r.window_s
