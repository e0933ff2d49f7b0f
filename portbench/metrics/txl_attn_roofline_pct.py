"""txl_attn_roofline_pct: the stage-1 Transformer-XL decode attention's
share of its roofline.  The least bytes of the cache work over the traced
steps (the running slots' live k and v rows read, their new rows written,
the position heads of the distances read; ``work_txl.attn_bytes`` over the
program's exact counts, ``COUNTS['serve.steps']``, ``['serve.slot_steps']``
and ``['serve.live_rows']`` of ``emo_disentanger_tpu_torch.utils.profiling``),
at the memory's peak, over the device time launched inside the program's
``emodis.txl.attn`` spans (each layer's row writes and attention, whatever
implements them).  A program without the span or the counts gives
nothing."""

from portbench import work_txl


def read(ctx):
    try:
        from emo_disentanger_tpu_torch.utils.profiling import COUNTS
    except ImportError:
        return None
    r, cfg = ctx['reading'], ctx['cfg']
    spent = r.op_device_seconds('emodis.txl.attn')
    if spent <= 0 or COUNTS['serve.steps'] <= 0:
        return None
    w = ctx['work']
    elem = w.ELEM_BYTES[cfg['serving']['weights_dtype']]
    nbytes = work_txl.attn_bytes(cfg, COUNTS['serve.steps'],
                                 COUNTS['serve.slot_steps'],
                                 COUNTS['serve.live_rows'], elem)
    return 100.0 * nbytes / w.HBM_BYTES_PER_S / spent
