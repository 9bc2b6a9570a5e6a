"""Engine, scan lanes: milliseconds of the constraint tables' build in
``scan_build`` (``_build_constraints``; ``scan_stats``'
``build_constraints_s``) per pod the lanes placed, over the untraced
part of the window."""


def read(ctx):
    lanes = [lane for lane in ctx.untraced.lanes.values()
             if "build_constraints_s" in lane]
    placed = sum(lane.get("placed", 0) for lane in lanes)
    if not placed:
        return None
    return sum(lane["build_constraints_s"] for lane in lanes) / placed * 1e3
