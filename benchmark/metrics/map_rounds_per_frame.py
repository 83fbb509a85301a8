"""map_rounds_per_frame: scan-to-map rounds a frame over the whole timed
loop: the program's ``block_topk_windowed`` calls (a corner and a surf
search a round) over its frames (``segment_sum_batched`` launches)."""


def read(ctx):
    c = ctx["window_counters"]
    if c.get("segment_sum_batched", 0) <= 0 or c.get("block_topk_windowed", 0) <= 0:
        return None
    return c["block_topk_windowed"] / 2 / c["segment_sum_batched"]
