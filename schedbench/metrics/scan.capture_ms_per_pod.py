"""Ops: milliseconds the scan lanes spent on their step graphs' warm-up
step and capture (``scan_stats``' ``capture_s``, once a lane call) per
pod the lanes placed, over the untraced part of the window."""


def read(ctx):
    lanes = ctx.untraced.lanes.values()
    placed = sum(lane.get("placed", 0) for lane in lanes)
    if not placed:
        return None
    return sum(lane.get("capture_s", 0.0) for lane in lanes) / placed * 1e3
