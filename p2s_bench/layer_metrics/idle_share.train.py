"""idle_share.train (%): the share of the traced window in which no
operation ran on the device: 1 - (the union of the operations' intervals) /
(the window's wall time)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
