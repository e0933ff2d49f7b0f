"""decode_layer_roofline_pct: the Performer decode kernel's (#12) share of
its roofline.  A layer's bytes at the running slots a step (its weights,
each slot's state read and written, its rows in and out;
``work.performer_decode_layer_bytes``), every layer and traced step, at the
memory's peak, over the device time of #12's kernels in the traced steps
(its projections and its state update).  The running slots a step are the
call's average, from its returned stats (the driver's ``counts``)."""

KERNELS = ('gemv_kernel', 'favor_state_kernel', 'favor_state_gen')


def read(ctx):
    r, cfg, c = ctx['reading'], ctx['cfg'], ctx['counts']
    spent = r.kernel_seconds(KERNELS)
    if spent <= 0 or r.steps <= 0 or c['steps'] <= 0:
        return None
    w = ctx['work']
    elem = w.ELEM_BYTES[cfg['serving']['weights_dtype']]
    layer = w.performer_decode_layer_bytes(cfg, c['slot_steps'] / c['steps'], elem)
    least = cfg['n_layer'] * r.steps * layer / w.HBM_BYTES_PER_S
    return 100.0 * least / spent
