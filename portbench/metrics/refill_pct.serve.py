"""refill_pct.serve: the share of the traced generation window spent in
the refill between two chunks (the span ``emodis.serve.refill``: the
status read, the harvest of finished songs, the re-arm of their slots),
over ``window_s``."""

from portbench import spans


def read(ctx):
    r = ctx['reading']
    spent = spans.seconds(r, 'emodis.serve.refill')
    if spent <= 0 or r.window_s <= 0:
        return None
    return 100.0 * spent / r.window_s
