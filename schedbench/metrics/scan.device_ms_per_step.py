"""Ops: milliseconds the card spent on the scan lanes' replayed step
graphs per replay, from the CUDA events each step loop records around
its replays (``scan_stats``' ``device_s`` over ``replays``, both lanes
together), over the untraced part of the window.  Set against
``scan.ms_per_step``, the host's whole lane call a step, it says how much
of an untraced step the card is busy."""


def read(ctx):
    lanes = ctx.untraced.lanes.values()
    replays = sum(lane.get("replays", 0) for lane in lanes)
    if not replays:
        return None
    return sum(lane.get("device_s", 0.0) for lane in lanes) / replays * 1e3
