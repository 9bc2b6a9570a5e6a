"""Engine, scan lanes: host milliseconds per pod the lanes placed, taken
as the self time of ``scan_flush`` (the backlog's revalidation, the
snapshots, assume and the winners' loop), ``scan_grouping`` and
``scan_build`` (tables): each span less the spans nested in it
(``scan_evaluate``, ``commit``/``bind``, lock waits), over the untraced
part of the window."""


def read(ctx):
    u = ctx.untraced
    placed = sum(lane.get("placed", 0) for lane in u.lanes.values())
    if not placed:
        return None
    host = sum(u.self_s.get(p, 0.0)
               for p in ("scan_flush", "scan_grouping", "scan_build"))
    return host / placed * 1e3
