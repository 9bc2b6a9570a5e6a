"""Control plane: host milliseconds of the engine's batched bind
(CycleMetrics ``bind``: ``bind_many`` through the client into the store)
per pod the watch saw bound, over the untraced part of the window."""


def read(ctx):
    u = ctx.untraced
    bind = u.phases.get("bind")
    if not bind or not u.binds:
        return None
    return bind["total_s"] / u.binds * 1e3
