"""odom_rounds_per_frame: scan-to-scan re-association rounds a frame over the
whole timed loop: the program's ``gn_inner_loop`` launches (one a round) over
its ``segment_sum_batched`` launches (one a frame, the first frame of a
sequence included)."""


def read(ctx):
    c = ctx["window_counters"]
    if c.get("segment_sum_batched", 0) <= 0:
        return None
    return c.get("gn_inner_loop", 0) / c["segment_sum_batched"]
