"""txl_serve_mfu: the stage-1 decode step's share of the card's peak.  The
least time of the traced steps (every weight read once a step, the running
slots' live k and v prefix read and new rows written, the position heads,
their logits; the FLOPs at the bf16 peak if longer; ``work_txl.step_work``
over the program's exact counts, ``COUNTS['serve.steps']``,
``['serve.slot_steps']`` and ``['serve.live_rows']`` of
``emo_disentanger_tpu_torch.utils.profiling``) over the device time
launched inside the program's ``emodis.serve.step`` spans.  The device
time, not the traced window: the profiler's own host cost stretches the
window (and the device's idle share, ``idle_pct.serve``, reads it) from
run to run.  A program without the span or the counts gives nothing."""

from portbench import work_txl


def read(ctx):
    try:
        from emo_disentanger_tpu_torch.utils.profiling import COUNTS
    except ImportError:
        return None
    r, cfg = ctx['reading'], ctx['cfg']
    spent = r.op_device_seconds('emodis.serve.step')
    if spent <= 0 or COUNTS['serve.steps'] <= 0:
        return None
    w = ctx['work']
    dtype = cfg['serving']['weights_dtype']
    flops, nbytes = work_txl.step_work(
        cfg, ctx['counts']['vocab'], COUNTS['serve.steps'],
        COUNTS['serve.slot_steps'], COUNTS['serve.live_rows'],
        w.ELEM_BYTES[dtype])
    return 100.0 * w.least_seconds(flops, nbytes, dtype) / spent
