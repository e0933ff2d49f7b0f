"""kv_attn_roofline_pct: GPT-2 decode attention's share of its roofline.
The live k and v prefix of the running slots, every layer and traced step
(``work.kv_prefix_bytes``), at the memory's peak, over the device time the
profiler gives the two einsums over the cache in the traced steps
(``aten::einsum`` and the copies and products it launches).  The cache
rows a step are the call's average, from its returned stats (the driver's
``counts``)."""


def read(ctx):
    r, cfg, c = ctx['reading'], ctx['cfg'], ctx['counts']
    spent = r.op_device_seconds('aten::einsum')
    if spent <= 0 or r.steps <= 0 or c['steps'] <= 0:
        return None
    w = ctx['work']
    elem = w.ELEM_BYTES[cfg['serving']['weights_dtype']]
    rows = c['live_rows'] / c['steps'] * r.steps
    return 100.0 * w.kv_prefix_bytes(cfg, rows, elem) / w.HBM_BYTES_PER_S / spent
