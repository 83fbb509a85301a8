"""launches_per_frame: CUDA kernel launches over every stream's traced
sequence (the first of the window), over those sequences' frames."""


def read(ctx):
    if not ctx.get("traced_frames"):
        return None
    return ctx["launches"] / ctx["traced_frames"]
