"""Ops: milliseconds of ``scan_evaluate`` (the lane's call: the step
graph's capture and its replays, to the choices on the host) per step
replayed, the exact lane's pods and the blocked lane's blocks counted
together (``scan_stats``), over the untraced part of the window."""


def read(ctx):
    u = ctx.untraced
    steps = sum(lane.get("steps", 0) for lane in u.lanes.values())
    ev = u.phases.get("scan_evaluate")
    if not steps or not ev:
        return None
    return ev["total_s"] / steps * 1e3
