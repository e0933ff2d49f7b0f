"""idle_pct.serve: the share of the traced generation window in which no
operation ran on the device."""


def read(ctx):
    r = ctx['reading']
    if r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
