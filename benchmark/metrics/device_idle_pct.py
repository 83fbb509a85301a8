"""device_idle_pct: the share (%) of the traced stretch (from the window's
start until the first stream finished its traced sequence) in which no
operation of any stream ran on the card: the union of every worker's device
intervals on one clock."""


def read(ctx):
    if not ctx.get("window_ns"):
        return None
    return 100.0 * (1.0 - ctx["busy_ns"] / ctx["window_ns"])
