"""Ops: milliseconds of ``scan_prepare`` (a lane call's set-up before its
step loop: the round-invariant planes, the carried state, the live-row
read) per pod the scan lanes placed, over the untraced part of the
window."""


def read(ctx):
    u = ctx.untraced
    prepare = u.phases.get("scan_prepare")
    placed = sum(lane.get("placed", 0) for lane in u.lanes.values())
    if not prepare or not placed:
        return None
    return prepare["total_s"] / placed * 1e3
