"""Offline storage-integrity verifier: ``python -m minisched_tpu_torch fsck``.

A whole copy of ``minisched_tpu/controlplane/fsck.py`` over the port's
durable store, with ``wal_double_binds`` (JAX
``faults/__init__.py:192``) copied in until the port of ``faults/``.
Its reports equal JAX's on the same files.

The scrub thread (DurableObjectStore.scrub) checks a LIVE store; this
module is the offline half — point it at a WAL path and it verifies
every durable artifact the way a paranoid operator would before trusting
a recovered plane:

* **frames** — every record in the WAL, ``.history`` archive, and any
  ``.pending-archive`` segment decodes with a valid CRC; torn tails are
  classified (expected crash weather), mid-file corruption is an error
  with byte offset + rv window
* **checkpoint digests** — both generations against their sha256
  sidecars (a missing sidecar on a pre-integrity checkpoint is a
  warning, not an error)
* **replay** — the REAL recovery path (a readonly DurableObjectStore:
  checkpoint fallback chain ⊕ WAL tail, strict corruption policy)
  actually produces a state
* **rv/uid monotonicity** — put/del record rvs never regress within a
  file, no uid ever names two different object keys
* **aggregate index** — the per-node request aggregates the bind
  transaction trusts (client._node_budgets) equal an independent
  recompute from the replayed objects
* **exactly-once** — the full-history double-bind audit
  (``wal_double_binds``)

Returns a JSON-able report; ``ok`` is False iff any error was found.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from minisched_tpu_torch.controlplane.walio import (
    WalCorrupt,
    iter_wal_records_lenient,
    scan_file,
)


def wal_double_binds(wal_path: str):
    """Audit a DurableObjectStore WAL's FULL history for double binds:
    returns [(uid, first_node, other_node), ...] for every pod that ever
    appeared bound to two different nodes.  The archived segments
    (``<path>.history``, then a ``.pending-archive`` a crash left) are
    read first, in append order, so compaction never shrinks the
    evidence.  Records ride the frame reader in LENIENT mode: torn tails
    drop silently and a corrupt region is skipped by magic resync — an
    audit wants every record it can still prove intact, while REPLAY of
    the same bytes hard-fails (fsck reports the divergence)."""
    bound_to: dict = {}
    violations = []
    paths = [
        p
        for p in (
            wal_path + ".history",
            wal_path + ".pending-archive",  # claimed by a compaction a
            wal_path,                       # crash interrupted mid-copy
        )
        if os.path.exists(p)
    ]
    for path in paths:
        for rec in iter_wal_records_lenient(path):
            if rec.get("op") != "put" or rec.get("kind") != "Pod":
                continue
            obj = rec["obj"]
            node = (obj.get("spec") or {}).get("node_name")
            uid = (obj.get("metadata") or {}).get("uid")
            if not node:
                continue
            prev = bound_to.setdefault(uid, node)
            if prev != node:
                violations.append((uid, prev, node))
    return violations


def _check_record_stream(path: str, errors: List[str], warnings: List[str]) -> Dict[str, Any]:
    """One file's frame scan folded into the report lists."""
    rep = scan_file(path)
    if rep.get("missing"):
        return rep
    if rep.get("corrupt"):
        c = rep["corrupt"]
        errors.append(
            f"{path}: corrupt record at byte {c['offset']} (record "
            f"#{c['index']}): {c['reason']}; last good rv "
            f"{c['last_good_rv']}, first resynced rv {c['resync_rv']}"
        )
    if rep.get("torn_tail"):
        warnings.append(
            f"{path}: torn tail after {rep['records']} records "
            f"(crash mid-append; replay truncates it)"
        )
    return rep


def _check_rv_uid(path: str, errors: List[str], uid_keys: Dict[str, str]) -> None:
    """rv monotonicity within one file + uid↔key aliasing across all
    files (the caller shares ``uid_keys``)."""
    from minisched_tpu_torch.controlplane.walio import _rec_rv

    last_rv = 0
    for rec in iter_wal_records_lenient(path):
        op = rec.get("op")
        if op in ("put", "del"):
            rv = _rec_rv(rec)
            if rv and rv < last_rv:
                errors.append(
                    f"{path}: rv regressed {last_rv} -> {rv} "
                    f"(op={op}, kind={rec.get('kind')})"
                )
            last_rv = max(last_rv, rv)
        if op == "put":
            meta = (rec.get("obj") or {}).get("metadata") or {}
            uid, key = meta.get("uid"), (
                f"{meta.get('namespace', '')}/{meta.get('name', '')}"
            )
            if uid:
                prev = uid_keys.setdefault(uid, key)
                if prev != key:
                    errors.append(
                        f"{path}: uid {uid!r} names two objects "
                        f"({prev!r} and {key!r})"
                    )


def _check_checkpoints(
    wal_path: str, checkpoint_path: str,
    errors: List[str], warnings: List[str],
) -> Dict[str, Any]:
    from minisched_tpu_torch.controlplane.durable import checkpoint_digest

    out: Dict[str, Any] = {}
    for path, which in (
        (checkpoint_path, "current"),
        (checkpoint_path + ".prev", "prev"),
    ):
        if not os.path.exists(path):
            out[which] = {"missing": True}
            continue
        entry: Dict[str, Any] = {"size": os.path.getsize(path)}
        with open(path, "rb") as f:
            data = f.read()
        verdict = checkpoint_digest(path, data)
        entry["digest_ok"] = verdict["ok"]
        if verdict["ok"] is False:
            errors.append(
                f"{path}: sha256 mismatch (sidecar {verdict['want'][:12]}…, "
                f"file {verdict['got'][:12]}…)"
            )
        elif verdict["ok"] is None:
            warnings.append(f"{path}: no sha256 sidecar (pre-integrity)")
        try:
            doc = json.loads(data)
            entry["resource_version"] = int(doc.get("resource_version", 0))
            entry["uid_floor"] = int(doc.get("uid_floor", 0))
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            entry["parse_error"] = str(e)
            if entry.get("digest_ok"):
                # digest valid but body unparseable = writer bug, always
                # an error; digest-invalid bodies were already reported
                errors.append(f"{path}: unparseable checkpoint body: {e}")
        out[which] = entry
    return out


def fsck(wal_path: str, checkpoint_path: Optional[str] = None) -> Dict[str, Any]:
    """Run every offline integrity check; see the module docstring."""
    from minisched_tpu_torch.controlplane.durable import (
        CheckpointCorrupt,
        DurableObjectStore,
    )
    checkpoint_path = checkpoint_path or wal_path + ".ckpt"
    errors: List[str] = []
    warnings: List[str] = []
    files: Dict[str, Any] = {}
    for p in (
        wal_path,
        wal_path + ".history",
        wal_path + ".pending-archive",
    ):
        files[os.path.basename(p)] = _check_record_stream(p, errors, warnings)
    files["checkpoints"] = _check_checkpoints(
        wal_path, checkpoint_path, errors, warnings
    )
    uid_keys: Dict[str, str] = {}
    for p in (wal_path + ".history", wal_path + ".pending-archive", wal_path):
        if os.path.exists(p):
            _check_rv_uid(p, errors, uid_keys)

    state: Dict[str, Any] = {}
    store = None
    try:
        # the REAL recovery path, read-only: fallback chain + strict replay
        store = DurableObjectStore(
            wal_path, checkpoint_path=checkpoint_path,
            archive_compacted=os.path.exists(wal_path + ".history"),
            readonly=True,
        )
    except WalCorrupt as e:
        errors.append(f"replay: {e}")
    except CheckpointCorrupt as e:
        errors.append(f"checkpoint chain: {e}")
    except Exception as e:  # noqa: BLE001 — fsck reports, never crashes
        errors.append(f"replay failed: {type(e).__name__}: {e}")
    if store is not None:
        state["resource_version"] = store.resource_version
        state["ckpt_source"] = store._ckpt_source
        state["objects"] = {
            kind: len(objs)
            for kind, objs in store._objects.items()
            if objs
        }
        max_obj_rv = max(
            (
                o.metadata.resource_version
                for objs in store._objects.values()
                for o in objs.values()
            ),
            default=0,
        )
        if max_obj_rv > store.resource_version:
            errors.append(
                f"replayed rv counter {store.resource_version} behind "
                f"object rv {max_obj_rv} — reopen would re-issue versions"
            )
        # the aggregate index the bind transaction trusts, against the
        # shared independent recompute (same check the live scrub runs)
        from minisched_tpu_torch.controlplane.store import compute_node_agg

        recompute = compute_node_agg(store._objects.get("Pod", {}).values())
        if {k: list(v) for k, v in store._pod_node_agg.items()} != recompute:
            errors.append(
                "per-node aggregate index diverged from replayed pods"
            )
    violations = wal_double_binds(wal_path)
    if violations:
        errors.append(
            f"double binds in history: {violations[:5]}"
            + ("…" if len(violations) > 5 else "")
        )
    return {
        "wal": wal_path,
        "ok": not errors,
        "errors": errors,
        "warnings": warnings,
        "files": files,
        "state": state,
        "double_binds": len(violations),
    }


def repair(
    wal_path: str,
    checkpoint_path: Optional[str] = None,
    accept_loss: bool = False,
) -> Dict[str, Any]:
    """``fsck --repair``: make a corrupt WAL replayable again.

    Two escalation levels:

    1. **covered salvage** — open the store non-readonly with
       ``salvage="covered"``: the bad region truncates ONLY when every
       resync-decodable record past it has rv ≤ the restored
       checkpoint's (replay would have skipped them anyway — lossless).
    2. **accept-loss** — when salvage refuses (records past the
       corruption reach beyond the checkpoint), ``--accept-loss``
       truncates at the last good record anyway, DISCARDING committed
       state.  The rv range being thrown away is computed first and
       printed/returned so the operator's decision is informed, never
       silent: ``(last_good_rv, max resynced rv]`` plus however many
       records resynced (the corrupt frame itself is unreadable and may
       hide one more).

    Returns ``{repaired, action, discarded?, error?}``; a post-repair
    ``fsck()`` is the caller's verification step (main() runs it)."""
    from minisched_tpu_torch.controlplane.durable import (
        CheckpointCorrupt,
        DurableObjectStore,
    )
    from minisched_tpu_torch.controlplane.walio import (
        WalReader,
        _rec_rv,
        iter_records_lenient,
    )

    checkpoint_path = checkpoint_path or wal_path + ".ckpt"
    out: Dict[str, Any] = {"wal": wal_path, "repaired": False, "action": "none"}

    def _try_open(salvage: str) -> Optional[str]:
        """Open (non-readonly: torn tails / covered regions physically
        truncate) then close; returns the error string or None."""
        try:
            store = DurableObjectStore(
                wal_path,
                checkpoint_path=checkpoint_path,
                archive_compacted=os.path.exists(wal_path + ".history"),
                salvage=salvage,
            )
            store.close()
            return None
        except (WalCorrupt, CheckpointCorrupt) as e:
            return str(e)

    # scan for mid-file corruption BEFORE any salvage open: the loss
    # bound must be measured from the original bytes (the store's own
    # covered-salvage truncates as a side effect of a successful open)
    try:
        with open(wal_path, "rb") as f:
            data = f.read()
    except OSError as e:
        out["error"] = str(e)
        return out
    reader = WalReader(data, path=wal_path)
    corrupt: Optional[WalCorrupt] = None
    try:
        for _rec, _end in reader:
            pass
    except WalCorrupt as e:
        corrupt = e
    if corrupt is None:
        # frames are clean — any repair needed is torn-tail truncation
        # or the checkpoint chain, both handled by a normal salvage open
        err = _try_open("covered")
        if err is None:
            out["repaired"] = True
            out["action"] = "salvage-covered"
        else:
            out["error"] = err
        return out

    # bound what truncating at the last good record would LOSE — via the
    # LENIENT iterator, which resyncs to v2 magic (either checksum) AND
    # legacy v1 line boundaries; the store's own coverage probe
    # (resync_scan) sees only v2 magic, so a legacy-JSONL suffix would
    # otherwise be discarded silently under a "lossless" banner
    lost = list(iter_records_lenient(data, corrupt.offset + 1))
    lost_rvs = [rv for r in lost if (rv := _rec_rv(r)) > 0]
    # the checkpoint rv the restore chain can actually cover, taken
    # CONSERVATIVELY as the lowest parseable generation (restore may
    # fall back from current to prev)
    ckpt_rvs = []
    for p in (checkpoint_path, checkpoint_path + ".prev"):
        try:
            with open(p) as f:
                ckpt_rvs.append(int(json.load(f).get("resource_version", 0)))
        except (OSError, ValueError, TypeError, json.JSONDecodeError):
            continue
    ckpt_rv = min(ckpt_rvs) if ckpt_rvs else 0
    discarded = {
        "from_rv_exclusive": corrupt.last_good_rv,
        "to_rv": max(lost_rvs) if lost_rvs else None,
        "resynced_records": len(lost),
        "bytes": len(data) - reader.good_end,
        "offset": corrupt.offset,
    }
    # covered when every decodable lost record is already in the
    # snapshot, OR when NOTHING decodes past the corruption — the store
    # treats an undecodable bad tail like a torn tail and truncates it
    # under salvage (records that decode but carry no rv stay
    # uncovered: they bound nothing, mirroring _replay_wal's refusal)
    covered = (not lost) or (bool(lost_rvs) and max(lost_rvs) <= ckpt_rv)

    if covered:
        # provably lossless: every decodable lost record is already in
        # the snapshot — delegate the truncation to the store's salvage
        err = _try_open("covered")
        if err is None:
            out["repaired"] = True
            out["action"] = "salvage-covered"
            out["covered_loss"] = discarded
        else:
            out["error"] = err
        return out
    if not accept_loss:
        out["error"] = str(corrupt)
        out["discarded_if_accepted"] = discarded
        out["hint"] = (
            "records past the corruption are NOT covered by the checkpoint "
            f"(checkpoint rv {ckpt_rv}, lost records "
            f"{'reach rv ' + str(discarded['to_rv']) if lost_rvs else 'carry no resource_version'}); "
            "re-run with --accept-loss to discard them"
        )
        return out

    out["discarded"] = discarded
    import sys

    print(
        f"[fsck --repair] ACCEPTING LOSS on {wal_path}: discarding "
        f"{discarded['bytes']} bytes past byte {reader.good_end} — rv range "
        f"({discarded['from_rv_exclusive']}, {discarded['to_rv']}] "
        f"({discarded['resynced_records']} resynced records; the corrupt "
        "frame itself is unreadable and may hide one more)",
        file=sys.stderr,
        flush=True,
    )
    with open(wal_path, "rb+") as f:
        f.truncate(reader.good_end)
    err = _try_open("covered")
    if err is not None:
        out["error"] = err
        return out
    out["repaired"] = True
    out["action"] = "accept-loss-truncate"
    return out


def wal_digests(path: str) -> Dict[str, Any]:
    """``fsck --digests``: per-frame CRC32C digests over a WAL's raw
    bytes — the operator-facing half of the replication plane's digest
    gossip (DESIGN.md §27).  The live plane gossips PER-GROUP digests
    (a group's digest is the CRC32C of its frames' concatenated raw
    bytes, boundaries known only to the leader's ring); offline, the
    frame is the durable unit, and per-frame digests compose to any
    grouping — two replicas whose frame digests match byte-for-byte
    match under every grouping, and the first mismatching frame locates
    a divergence more precisely than a group span would."""
    from minisched_tpu_torch.controlplane.walio import (
        WalCorrupt,
        WalReader,
        _crc32c,
        _rec_rv,
    )

    out: Dict[str, Any] = {"wal": path, "frames": []}
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        out["error"] = str(e)
        return out
    out["size"] = len(data)
    out["file_crc32c"] = _crc32c(data)
    reader = WalReader(data, path=path)
    prev_end = 0
    try:
        for rec, end in reader:
            out["frames"].append({
                "index": len(out["frames"]),
                "offset": prev_end,
                "end": end,
                "rv": _rec_rv(rec),
                "op": rec.get("op"),
                "crc32c": _crc32c(data[prev_end:end]),
            })
            prev_end = end
    except WalCorrupt as e:
        out["corrupt"] = {"offset": e.offset, "reason": e.reason}
    out["torn_tail"] = bool(reader.torn_tail)
    out["good_end"] = reader.good_end
    return out


def wal_compare(path_a: str, path_b: str) -> Dict[str, Any]:
    """``fsck --compare``: diff two replica WALs offline by frame
    digest.  Replication ships contiguous byte ranges, so two healthy
    replicas' WALs are PREFIXES of one another (the shorter = a
    follower mid-catch-up); the report states whether that holds, how
    many frames agree, and — when it does not hold — the exact frame
    and byte offset where the histories forked (epoch-bump debris, a
    lying disk, or a fenced ex-leader's unacked tail)."""
    a, b = wal_digests(path_a), wal_digests(path_b)
    report: Dict[str, Any] = {"a": a, "b": b}
    fa, fb = a.get("frames", []), b.get("frames", [])
    common = 0
    diverged_at: Optional[Dict[str, Any]] = None
    for x, y in zip(fa, fb):
        if (x["offset"], x["end"], x["crc32c"]) != (
            y["offset"], y["end"], y["crc32c"]
        ):
            diverged_at = {
                "frame": common,
                "offset": x["offset"],
                "a": x, "b": y,
            }
            break
        common += 1
    if diverged_at is None:
        # a CRC-corrupt frame ends that side's digest list early, so the
        # zip above never sees the fork — the corrupt offset IS the fork
        for side, d in (("a", a), ("b", b)):
            bad = d.get("corrupt")
            if bad is not None:
                diverged_at = {
                    "frame": common,
                    "offset": bad.get("offset"),
                    "corrupt_side": side,
                    "reason": bad.get("reason"),
                }
                break
    report["common_frames"] = common
    report["diverged"] = diverged_at
    report["identical"] = (
        diverged_at is None
        and len(fa) == len(fb)
        and a.get("file_crc32c") == b.get("file_crc32c")
        and not a.get("corrupt") and not b.get("corrupt")
    )
    # prefix = one replica simply behind the other (healthy mid-catch-up);
    # a CRC-corrupt frame truncates that side's digest list, so without
    # the corrupt check a mid-file bit-flip would read as "just behind"
    report["prefix"] = (
        diverged_at is None
        and (common == len(fa) or common == len(fb))
        and not a.get("corrupt") and not b.get("corrupt")
    )
    return report


def state_digest(
    wal_path: str, checkpoint_path: Optional[str] = None
) -> Dict[str, Any]:
    """Replay one replica offline through the REAL recovery path
    (checkpoint fallback chain ⊕ WAL tail, readonly) and reduce the
    result to a canonical state document + its sha256.  The replica's
    identity independent of its byte history: two stores at different
    checkpoint generations replay different FILES but must land on the
    same state when they hold the same data."""
    import hashlib

    from minisched_tpu_torch.controlplane.checkpoint import build_snapshot_doc
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore

    store = DurableObjectStore(
        wal_path,
        checkpoint_path=checkpoint_path,
        archive_compacted=os.path.exists(wal_path + ".history"),
        readonly=True,
    )
    doc = build_snapshot_doc(store._objects, store.resource_version)
    # the uid watermark is not replica state: two replicas that replayed
    # identical objects can still disagree here
    doc.pop("uid_floor", None)
    body = json.dumps(doc, sort_keys=True).encode()
    return {
        "wal": wal_path,
        "resource_version": store.resource_version,
        "ckpt_source": store._ckpt_source,
        "objects": {
            kind: len(objs)
            for kind, objs in store._objects.items()
            if objs
        },
        "sha256": hashlib.sha256(body).hexdigest(),
    }


def replica_consistent(path_a: str, path_b: str) -> Dict[str, Any]:
    """``fsck --compare`` for checkpoint⊕tail topologies (DESIGN.md
    §28).  Raw frame-digest identity/prefix (wal_compare) is the fast
    path, but once checkpoint SHIPPING is on, two healthy replicas can
    sit on different checkpoint generations — their WALs are different
    byte tails of the same logical history and share no prefix at all.
    Consistency is then judged where it actually matters: both sides
    replay offline through the real recovery path (generation ⊕ tail)
    and must land on the SAME canonical state.  ``mode`` records which
    judgement decided (``raw`` or ``state``)."""
    raw = wal_compare(path_a, path_b)
    report: Dict[str, Any] = {"raw": raw}
    if raw["identical"] or raw["prefix"]:
        report["mode"] = "raw"
        report["consistent"] = True
        return report
    report["mode"] = "state"
    states = {}
    for side, path in (("a", path_a), ("b", path_b)):
        try:
            states[side] = state_digest(path)
        except Exception as e:  # noqa: BLE001 — fsck reports, not crashes
            states[side] = {"wal": path, "error": f"{type(e).__name__}: {e}"}
    report["state"] = states
    report["consistent"] = (
        "error" not in states["a"]
        and "error" not in states["b"]
        and states["a"]["sha256"] == states["b"]["sha256"]
    )
    return report


def main(argv: List[str]) -> int:
    """CLI entry (dispatched from ``python -m minisched_tpu_torch fsck``):
    prints the JSON report; exit 0 clean, 1 on any integrity error.
    ``--repair`` attempts covered salvage first; ``--accept-loss``
    additionally truncates uncovered tails, printing the rv range being
    discarded.  ``--digests`` prints per-frame CRC32C digests instead of
    the full check; ``--compare OTHER`` diffs two replica WALs (exit 1
    when they diverged — a shared prefix with one side behind is
    clean)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m minisched_tpu_torch fsck",
        description="verify WAL frames, checkpoint digests, rv/uid "
        "monotonicity, aggregate index, and exactly-once binds",
    )
    parser.add_argument("wal", help="path to the WAL file")
    parser.add_argument(
        "--checkpoint", default=None,
        help="checkpoint path (default: <wal>.ckpt)",
    )
    parser.add_argument(
        "--repair", action="store_true",
        help="attempt repair before verifying: covered salvage "
        "(lossless; truncates only records the checkpoint already holds)",
    )
    parser.add_argument(
        "--accept-loss", action="store_true",
        help="with --repair: if salvage refuses because records past the "
        "corruption are NOT covered, truncate anyway and print the rv "
        "range being discarded",
    )
    parser.add_argument(
        "--digests", action="store_true",
        help="emit per-frame CRC32C digests (the offline half of the "
        "replication plane's digest gossip) instead of the full check",
    )
    parser.add_argument(
        "--compare", metavar="OTHER", default=None,
        help="diff this WAL against another replica's: frame-digest "
        "identity/prefix fast path, then (checkpoint-shipping "
        "topologies) an offline generation⊕tail replay of BOTH sides — "
        "exit 1 only when neither judgement finds them consistent",
    )
    args = parser.parse_args(argv)
    if args.compare:
        report = replica_consistent(args.wal, args.compare)
        print(json.dumps(report, indent=2))
        return 0 if report["consistent"] else 1
    if args.digests:
        report = wal_digests(args.wal)
        print(json.dumps(report, indent=2))
        return 0 if not report.get("corrupt") and "error" not in report \
            else 1
    repair_report = None
    if args.repair:
        repair_report = repair(
            args.wal,
            checkpoint_path=args.checkpoint,
            accept_loss=args.accept_loss,
        )
    report = fsck(args.wal, checkpoint_path=args.checkpoint)
    if repair_report is not None:
        report["repair"] = repair_report
        # a repair that didn't complete keeps exit 1 via the fsck errors
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1
