"""sampling_share_pct: the nucleus sampler's share of the decode step's
host time in the traced window: the host time inside both an
``emodis.serve.sample`` and an ``emodis.serve.step`` range over the host
time inside ``emodis.serve.step`` ranges."""

from portbench import spans


def read(ctx):
    r = ctx['reading']
    step = spans.seconds(r, 'emodis.serve.step')
    if step <= 0:
        return None
    return 100.0 * spans.overlap_seconds(r, 'emodis.serve.sample',
                                         'emodis.serve.step') / step
