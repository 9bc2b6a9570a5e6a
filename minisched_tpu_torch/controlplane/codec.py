"""The JSON object codec of the control plane, for the kinds a request
carries.

A copy of ``_encode``, ``_decode`` and ``KIND_TYPES`` from
``minisched_tpu/controlplane/checkpoint.py``: objects become plain JSON
values field by field, by recursion over the dataclasses' type hints, and
back.  The port's kinds are Node, Pod, PersistentVolume,
PersistentVolumeClaim and Lease (durable, as in JAX: a recovered plane
replays leases with their pre-crash ``renew_time``, already expired by
wall clock).

``_decode`` keeps only the fields the target dataclass has, as the JAX
codec does: a document written from the JAX package's objects loses the
fields the port's objects lack (a pod's ``scheduler_name`` and status
conditions), none of which the port reads.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, get_args, get_origin, get_type_hints

from minisched_tpu_torch.api import objects

#: kind string → top-level dataclass
KIND_TYPES = {
    "Node": objects.Node,
    "Pod": objects.Pod,
    "PersistentVolume": objects.PersistentVolume,
    "PersistentVolumeClaim": objects.PersistentVolumeClaim,
    "Lease": objects.Lease,
}


#: dataclass → its resolved type hints (resolving them per object is
#: most of a decode's time)
_HINTS: Dict[type, Dict[str, Any]] = {}


def _encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _encode(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    return obj


def _decode(tp: Any, data: Any) -> Any:
    if data is None:
        return None
    origin = get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in get_args(tp) if a is not type(None)]
        return _decode(args[0], data)
    if origin in (list, tuple):
        (item_tp,) = get_args(tp)[:1] or (Any,)
        return [_decode(item_tp, v) for v in data]
    if origin is dict:
        _, val_tp = get_args(tp) or (Any, Any)
        return {k: _decode(val_tp, v) for k, v in data.items()}
    if dataclasses.is_dataclass(tp):
        hints = _HINTS.get(tp)
        if hints is None:
            hints = _HINTS[tp] = get_type_hints(tp)
        kwargs = {f.name: _decode(hints[f.name], data[f.name])
                  for f in dataclasses.fields(tp) if f.name in data}
        return tp(**kwargs)
    return data
