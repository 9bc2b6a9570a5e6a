"""Engine, scan lanes: milliseconds of the node and pod tables' builds in
``scan_build`` (``scan_stats``' ``build_tables_s``) per pod the lanes
placed, over the untraced part of the window."""


def read(ctx):
    lanes = [lane for lane in ctx.untraced.lanes.values()
             if "build_tables_s" in lane]
    placed = sum(lane.get("placed", 0) for lane in lanes)
    if not placed:
        return None
    return sum(lane["build_tables_s"] for lane in lanes) / placed * 1e3
