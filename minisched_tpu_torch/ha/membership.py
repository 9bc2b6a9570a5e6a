"""The rendezvous shard map: which member owns a key.

A part of ``minisched_tpu/ha/membership.py``: ``shard_owner``
(``:47-60``), the rendezvous (highest-random-weight) hash the sharded
write plane (``controlplane/shards.py``) places namespaces with.  The
owner of a key is the member with the highest blake2s score of
``"{member}|{key}"``: a pure function of the key and the member set, the
same in every process, and minimal-churn by construction (removing a
member moves exactly that member's keys).

Left out, for ROADMAP item 8: the rest of the module, the member
registry (``Membership``: member leases, the heartbeat at ttl/3, the
derived live set, epochs and change callbacks) that the HA engines of
``ha/plane.py`` wire into the queue.
"""

from __future__ import annotations

from hashlib import blake2s
from typing import Optional, Sequence

__all__ = ["shard_owner"]


def shard_owner(uid: str, members: Sequence[str]) -> Optional[str]:
    """Rendezvous hash: the member with the highest blake2s score for
    this uid owns it (None for no members).  Ties (a 2^-64 curiosity)
    go to the smaller id, so the map stays a pure function."""
    best: Optional[str] = None
    best_score = -1
    for m in members:
        score = int.from_bytes(
            blake2s(f"{m}|{uid}".encode(), digest_size=8).digest(), "big")
        if score > best_score or (score == best_score
                                  and (best is None or m < best)):
            best, best_score = m, score
    return best
