"""Ops: pods the scan lanes placed per step or block replayed
(``scan_stats``), over the untraced part of the window: 1 when every
block carries one pod."""


def read(ctx):
    u = ctx.untraced
    steps = sum(lane.get("steps", 0) for lane in u.lanes.values())
    placed = sum(lane.get("placed", 0) for lane in u.lanes.values())
    if not steps:
        return None
    return placed / steps
