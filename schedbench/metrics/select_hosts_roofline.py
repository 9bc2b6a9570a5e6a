"""Kernels: ``select_hosts``' share of its roofline over the traced
interval, in percent.  The time is the device time of every launch the
profiler saw under that name.  The least time is that of the work the
placed pods needed: one (1 x N) row of scores and mask per pod the scan
lanes placed in the interval, at the node table's width N, with one
candidate per row (``roofline.py``; bound by bytes at these shapes).
Padding rows of a block and pods retried or left unplaced are not
counted, so the share is never overstated."""

from schedbench.roofline import least_seconds


def read(ctx):
    t = ctx.traced
    if t is None or t.trace is None or not t.trace.select_hosts:
        return None
    rows = sum(lane.get("placed", 0) for lane in t.lanes.values())
    spent = sum(t.trace.select_hosts)
    if not rows or spent <= 0:
        return None
    least, _bound = least_seconds(rows, ctx.node_width, rows)
    return least / spent * 100.0
