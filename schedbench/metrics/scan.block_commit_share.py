"""Ops: the share of the blocked lane's replayed blocks that committed in
the hand-written commit kernel (``scan_stats``' blocked ``block_commits``
over its ``steps``), over the untraced part of the window: 1.0 when every
replayed block commits in the kernel, 0 where the lane ran its plain
twin (the CPU).  Nothing where the program has no such counter."""


def read(ctx):
    lane = ctx.untraced.lanes.get("blocked", {})
    steps = lane.get("steps", 0)
    if "block_commits" not in lane or not steps:
        return None
    return lane["block_commits"] / steps
