"""loader_pct.train: the share of the traced training window in which the
program's loader built batches (the span ``emodis.data.batch`` in
``Stage2Dataset.batches``: its rows and stacks, not the move to the
device), over ``window_s``."""

from portbench import spans


def read(ctx):
    r = ctx['reading']
    spent = spans.seconds(r, 'emodis.data.batch')
    if spent <= 0 or r.window_s <= 0:
        return None
    return 100.0 * spent / r.window_s
