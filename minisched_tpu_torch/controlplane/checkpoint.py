"""The checkpoint codec of the durable store: objects as language-neutral
JSON documents, and the snapshot document a compaction writes.

A copy of ``CHECKPOINT_VERSION``, ``KIND_TYPES``, ``_encode``,
``_decode`` and ``build_snapshot_doc`` from
``minisched_tpu/controlplane/checkpoint.py``.  Serialization walks the
dataclasses' fields, and decoding their type hints, so the WAL records,
the checkpoint files and the REST façade speak one JSON.

The bytes are the JAX package's, so a WAL or checkpoint written by
either package opens in the other.  Two of the port's dataclasses differ
from JAX's (``api/objects.py``): ``PodSpec`` orders ``gang`` before
``priority`` and has no ``scheduler_name``, and ``PodStatus`` has no
``conditions``.  The codec's view of them (``_JAX_FIELDS``) writes JAX's
field order and JAX's defaults for the fields the port lacks
(``"default-scheduler"``, ``[]``), which is all the JAX package ever
stores there; decoding keeps only the fields the port's dataclass has,
as JAX's ``_decode`` does, so a document naming another scheduler or
carrying pod conditions loses them in the port.

The uid watermark: JAX's ``uid_floor`` is its process-global uid
counter; the port's uids come from each store's own sequence
(``ObjectStore._uid_seq``), so ``build_snapshot_doc`` takes it as an
argument.

Left out: ``snapshot_store``, ``save_checkpoint``, ``restore_store`` and
``load_checkpoint``, the standalone checkpoint files; the durable
store's compaction (``durable.DurableObjectStore.compact``) is the
port's checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from minisched_tpu_torch.api import objects
from minisched_tpu_torch.controlplane.codec import KIND_TYPES, _decode

__all__ = ["CHECKPOINT_VERSION", "KIND_TYPES", "_decode", "_encode",
           "build_snapshot_doc"]

CHECKPOINT_VERSION = 1

#: marks a field the port's dataclass has (read off the object)
_OWN = object()

#: JAX's field order for the port's dataclasses that differ from JAX's,
#: with JAX's default for each field the port lacks
_JAX_FIELDS: Dict[type, Tuple[Tuple[str, Any], ...]] = {
    objects.PodSpec: (
        ("node_name", _OWN), ("containers", _OWN), ("node_selector", _OWN),
        ("tolerations", _OWN), ("affinity", _OWN),
        ("topology_spread_constraints", _OWN), ("volumes", _OWN),
        ("priority", _OWN), ("scheduler_name", "default-scheduler"),
        ("gang", _OWN)),
    objects.PodStatus: (
        ("phase", _OWN), ("conditions", []), ("nominated_node_name", _OWN)),
}

#: dataclass → the (field name, _OWN or JAX default) pairs it encodes
_FIELDS: Dict[type, Tuple[Tuple[str, Any], ...]] = {}


def _fields(tp: type) -> Tuple[Tuple[str, Any], ...]:
    out = _FIELDS.get(tp)
    if out is None:
        out = _JAX_FIELDS.get(tp) or tuple(
            (f.name, _OWN) for f in dataclasses.fields(tp))
        have = {f.name for f in dataclasses.fields(tp)}
        missing = have - {name for name, _ in out}
        if missing:
            raise TypeError(f"{tp.__name__}: the codec's view leaves out "
                            f"{sorted(missing)}")
        _FIELDS[tp] = out
    return out


def _encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {name: _encode(getattr(obj, name)) if default is _OWN
                else _encode(default)
                for name, default in _fields(type(obj))}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    return obj


def build_snapshot_doc(objects_by_kind: Dict[str, Dict[str, Any]],
                       resource_version: int,
                       uid_floor: int = 0) -> Dict[str, Any]:
    """Assemble a checkpoint document from raw kind → key → object maps
    (``DurableObjectStore.compact`` calls it inside the store lock, on
    the stored objects, without cloning them).  ``uid_floor`` is the top
    of the store's uid sequence: recovery floors the sequence there, so a
    restarted process never re-issues a uid, even one whose object was
    deleted before the snapshot."""
    return {
        "version": CHECKPOINT_VERSION,
        "resource_version": resource_version,
        "uid_floor": uid_floor,
        "objects": {
            kind: [_encode(o) for o in objs.values()]
            for kind in KIND_TYPES
            if (objs := objects_by_kind.get(kind))
        },
    }
