"""WAL frame codec: length + CRC framing over the JSON record stream.

A whole copy of ``minisched_tpu/controlplane/walio.py``; the frames are
byte for byte the JAX package's, so a WAL written by either package
replays in the other.

The v1 WAL was plain JSONL — one ``json.dumps(rec)`` per line.  That
format detects exactly one failure mode (a torn tail that no longer
parses) and mis-handles every other: a flipped bit inside a string field
still parses and is SILENTLY APPLIED, a torn mid-file write makes replay
raise a bare ``JSONDecodeError`` with no offset, and there is no way to
distinguish "disk lied" from "writer bug".  v2 gives every record a
self-describing frame:

    MAGIC(4) | payload_len u32 LE | crc32(payload) u32 LE | payload

``payload`` is the same UTF-8 JSON document v1 put on a line, so the
record SCHEMA is unchanged — only the envelope differs.  The magic's last
byte names the checksum: 0 is ``zlib.crc32`` (CRC-32/ISO-HDLC), 1 is
CRC32C (Castagnoli).  The writer emits CRC32C only when the native
``google_crc32c`` library imports (a pure-Python table walk costs about
1 ms/KB on the batch bind path); without it the writer stays on zlib's
crc32, and the reader still verifies CRC32C frames another writer made,
through a pure-Python table.

Readers are MIXED-MODE: at every record boundary the next bytes are
either a v2 frame (magic match) or a legacy v1 line (first byte ``{``).
A pre-change JSONL WAL therefore replays byte-identically through the
same reader, and a legacy file reopened by the new writer simply grows
v2 frames after its v1 prefix.

Failure taxonomy (what :class:`WalReader` reports):

* **torn tail** — the last frame/line is incomplete (crash mid-append).
  Expected weather; the reader stops at the last good boundary and sets
  ``torn_tail``; the durable store physically truncates there.
* **mid-file corruption** — a CRC mismatch, an insane length, garbage
  where a boundary should be, or an unparseable legacy line that is NOT
  the tail.  The disk lied (bit rot, torn write that later appends
  buried).  The reader raises :class:`WalCorrupt` with the byte offset,
  record index, and whatever it can salvage by resyncing to the next
  magic — the caller decides between hard-fail (default) and salvage
  (see DurableObjectStore).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Iterator, List, Optional, Tuple

#: v2 frame magic.  0xAB first so no frame can be mistaken for JSON or
#: UTF-8 text; "W2" for humans in a hexdump; the last byte is the
#: algorithm/flags byte the original framing reserved: 0 = zlib crc32
#: (CRC-32/ISO-HDLC), 1 = CRC32C (Castagnoli).
WAL_MAGIC_PREFIX = b"\xabW2"
WAL_MAGIC = WAL_MAGIC_PREFIX + b"\x00"
WAL_MAGIC_C = WAL_MAGIC_PREFIX + b"\x01"
_HEADER = struct.Struct("<4sII")  # magic, payload_len, checksum(payload)
HEADER_SIZE = _HEADER.size

# -- CRC32C (flags byte 1) ---------------------------------------------------
# The native switch the flags byte reserved: google-crc32c (an optional C
# extension) checksums at memcpy speed.  The
# WRITER only emits CRC32C frames when the native library is importable —
# otherwise it stays on zlib crc32, never a pure-Python table walk on the
# append path.  The READER is mixed-mode across v1 lines and BOTH frame
# algorithms regardless of which writer produced them; verifying a CRC32C
# frame without the native library falls back to a pure-Python table
# (slow, but replay of a foreign WAL must not depend on an optional
# extension).
try:  # pragma: no cover - exercised via _crc32c below
    import google_crc32c as _gcrc32c

    def _crc32c_native(payload: bytes) -> int:
        return _gcrc32c.value(payload)

except ImportError:  # pragma: no cover
    _gcrc32c = None
    _crc32c_native = None

HAVE_NATIVE_CRC32C = _crc32c_native is not None

_CRC32C_TABLE: Optional[List[int]] = None


def _crc32c_py(payload: bytes) -> int:
    """Pure-Python CRC32C (Castagnoli, reflected 0x82F63B78) — the
    reader-side fallback only; the writer never takes this path."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    tab = _CRC32C_TABLE
    for b in payload:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _crc32c(payload: bytes) -> int:
    if _crc32c_native is not None:
        return _crc32c_native(payload)
    return _crc32c_py(payload)


def _find_magic(data: bytes, start: int) -> int:
    """Offset of the next frame magic (either algorithm) at/after
    ``start``, -1 if none — resync and lenient audits must find CRC32C
    frames too."""
    n = len(data)
    off = data.find(WAL_MAGIC_PREFIX, start)
    while 0 <= off:
        if off + 3 < n and data[off + 3] in (0, 1):
            return off
        off = data.find(WAL_MAGIC_PREFIX, off + 1)
    return -1


def _magic_at(data: bytes, off: int) -> bool:
    """O(1): does a frame magic (either algorithm) sit exactly at
    ``off``?  Boundary checks must not pay a forward scan per probe."""
    return (
        data[off:off + 3] == WAL_MAGIC_PREFIX
        and off + 3 < len(data)
        and data[off + 3] in (0, 1)
    )

#: a frame claiming a payload larger than this is corruption, not data —
#: no single store record approaches it (the biggest are multi-KB pod
#: documents), and without the bound a flipped length byte would make
#: the reader "wait" for gigabytes of payload that never existed.
MAX_FRAME_PAYLOAD = 64 * 1024 * 1024


class WalCorrupt(Exception):
    """Mid-file WAL corruption: a record that is neither a valid v2 frame
    nor a parseable legacy line, with good records after it (a torn TAIL
    is not corruption — it truncates silently).  Carries everything an
    operator needs to reason about the blast radius:

    ``path``        the file
    ``offset``      byte offset of the bad frame/line
    ``index``       how many records decoded before it
    ``last_good_rv``the highest rv applied before the bad frame (0 when
                    the caller could not attribute rvs)
    ``reason``      crc mismatch / bad length / unparseable line / ...
    ``resync_rv``   rv of the first record recovered AFTER the bad
                    region by magic-scan resync (None: nothing after)
    """

    def __init__(
        self,
        path: str,
        offset: int,
        index: int,
        reason: str,
        last_good_rv: int = 0,
        resync_rv: Optional[int] = None,
    ):
        self.path = path
        self.offset = offset
        self.index = index
        self.reason = reason
        self.last_good_rv = last_good_rv
        self.resync_rv = resync_rv
        super().__init__(
            f"WAL corruption in {path!r} at byte {offset} (record "
            f"#{index}): {reason}; last good rv={last_good_rv}"
            + (
                f", first resynced rv={resync_rv}"
                if resync_rv is not None
                else ", nothing decodable after"
            )
        )


def encode_frame(rec: Any, crc32c: Optional[bool] = None) -> bytes:
    """One v2 frame for a record dict (or pre-encoded payload bytes).

    ``crc32c`` selects the checksum algorithm (and the matching flags
    byte); the default — None — uses CRC32C when the native library is
    present and zlib crc32 otherwise, so one WAL may legitimately carry
    BOTH frame kinds (a file started before the library landed keeps
    growing; the mixed-mode reader accepts each frame by its own flags
    byte)."""
    payload = (
        rec if isinstance(rec, (bytes, bytearray)) else json.dumps(rec).encode()
    )
    use_c = HAVE_NATIVE_CRC32C if crc32c is None else crc32c
    if use_c:
        return (
            _HEADER.pack(WAL_MAGIC_C, len(payload), _crc32c(payload)) + payload
        )
    return _HEADER.pack(WAL_MAGIC, len(payload), zlib.crc32(payload)) + payload


def _rec_rv(rec: dict) -> int:
    """Best-effort resource_version of one WAL record (0 when the record
    carries none — e.g. ack records)."""
    op = rec.get("op")
    if op == "rv":
        return int(rec.get("rv", 0))
    if op == "put":
        try:
            return int(rec["obj"]["metadata"]["resource_version"])
        except (KeyError, TypeError, ValueError):
            return 0
    if op == "del":
        return int(rec.get("rv", 0))
    return 0


class WalReader:
    """Iterate (record, end_offset) over mixed v1/v2 WAL bytes.

    After iteration: ``good_end`` is the byte offset past the last good
    record (the truncation point for a torn tail), ``index`` the count of
    decoded records, ``torn_tail`` whether trailing bytes were dropped as
    an incomplete append.  Mid-file corruption raises :class:`WalCorrupt`
    from ``__iter__``; ``good_end``/``index`` remain valid (the good
    prefix) so the caller can salvage.
    """

    def __init__(self, data: bytes, path: str = "<wal>"):
        self._data = data
        self._path = path
        self.good_end = 0
        self.index = 0
        self.torn_tail = False
        self.last_good_rv = 0
        self.legacy_records = 0
        self.framed_records = 0

    def _corrupt(self, offset: int, reason: str) -> WalCorrupt:
        # limit=1: the error report only needs the FIRST resynced rv;
        # decoding the whole suffix here would be paid on every scan of
        # a corrupt file (scrub re-checks on a timer) — salvage does its
        # own full scan when it actually needs the complete loss bound
        resync = resync_scan(self._data, offset + 1, limit=1)
        return WalCorrupt(
            self._path,
            offset,
            self.index,
            reason,
            last_good_rv=self.last_good_rv,
            resync_rv=resync[0] if resync else None,
        )

    def __iter__(self) -> Iterator[Tuple[dict, int]]:
        data, n = self._data, len(self._data)
        off = 0
        while off < n:
            first = data[off:off + 1]
            if first in (b"\n", b"\r", b" "):
                off += 1
                self.good_end = off
                continue
            if _magic_at(data, off):
                if off + HEADER_SIZE > n:
                    self.torn_tail = True  # header cut by a crash
                    return
                magic, length, crc = _HEADER.unpack_from(data, off)
                if length > MAX_FRAME_PAYLOAD:
                    raise self._corrupt(
                        off, f"frame length {length} exceeds max"
                    )
                end = off + HEADER_SIZE + length
                if end > n:
                    self.torn_tail = True  # payload cut by a crash
                    return
                payload = data[off + HEADER_SIZE:end]
                # flags byte selects the checksum: 0 = zlib crc32,
                # 1 = CRC32C — one file may carry both frame kinds
                computed = (
                    _crc32c(payload) if magic[3] == 1 else zlib.crc32(payload)
                )
                if computed != crc:
                    raise self._corrupt(
                        off,
                        f"crc mismatch (stored {crc:#010x}, computed "
                        f"{computed:#010x}, "
                        f"{'crc32c' if magic[3] == 1 else 'crc32'})",
                    )
                try:
                    rec = json.loads(payload)
                except json.JSONDecodeError as e:
                    # crc valid but payload unparseable: writer bug, not
                    # bit rot — still corruption, still located
                    raise self._corrupt(off, f"framed payload: {e}")
                self.framed_records += 1
            elif first == b"{":
                # legacy v1 line: scan to newline, parse
                nl = data.find(b"\n", off)
                end = n if nl < 0 else nl + 1
                line = data[off:end].strip()
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    if end >= n:
                        self.torn_tail = True  # v1's only failure mode
                        return
                    raise self._corrupt(off, f"legacy line: {e}")
                self.legacy_records += 1
            else:
                # neither a frame nor JSON where a boundary must be; a
                # partial magic at EOF is a torn header, anything else
                # mid-file is corruption (both algorithms share the
                # 3-byte prefix, so a <4-byte tail matching it is torn
                # regardless of which flags byte was coming)
                if n - off < 4 and WAL_MAGIC_PREFIX.startswith(
                    data[off:off + 3]
                ):
                    self.torn_tail = True
                    return
                raise self._corrupt(
                    off, f"unrecognized record boundary byte {first!r}"
                )
            self.index += 1
            rv = _rec_rv(rec)
            if rv > self.last_good_rv:
                self.last_good_rv = rv
            self.good_end = end
            yield rec, end
            off = end


def resync_scan(
    data: bytes, start: int, limit: Optional[int] = None
) -> Optional[Tuple[int, List[dict]]]:
    """Scan forward from ``start`` for the next valid v2 frame and decode
    everything decodable from there (best effort — later corruption stops
    the scan; ``limit`` caps the decode for callers that only need the
    first record).  Returns (first resynced record's rv, records) or
    None.  This is the salvage-coverage probe: it tells the durable
    store what a truncate-at-the-bad-frame recovery would LOSE."""
    n = len(data)
    off = _find_magic(data, start)
    while 0 <= off < n:
        reader = WalReader(data[off:], path="<resync>")
        recs: List[dict] = []
        try:
            for rec, _end in reader:
                recs.append(rec)
                if limit is not None and len(recs) >= limit:
                    break
        except WalCorrupt:
            pass  # keep what decoded before the next bad region
        if recs:
            return _rec_rv(recs[0]), recs
        off = _find_magic(data, off + 1)
    return None


def _next_record_boundary(data: bytes, start: int) -> int:
    """The next plausible record start at/after ``start``: a v2 magic,
    or a newline followed by a legacy ``{`` line (how a v1 JSONL file
    resyncs — it has no magic to find).  -1 when neither exists."""
    candidates = []
    mg = _find_magic(data, start)
    if mg >= 0:
        candidates.append(mg)
    nl = data.find(b"\n", start)
    while nl >= 0:
        nxt = nl + 1
        if nxt >= len(data):
            break
        if data[nxt:nxt + 1] == b"{" or _magic_at(data, nxt):
            candidates.append(nxt)
            break
        nl = data.find(b"\n", nxt)
    return min(candidates) if candidates else -1


def iter_records_lenient(
    data: bytes, start: int = 0, path: str = "<lenient>"
) -> Iterator[dict]:
    """Best-effort record iterator over raw WAL bytes from ``start``:
    skips corrupt regions by resyncing to the next record boundary — v2
    magic (either checksum) OR a legacy line start — and drops torn
    tails silently.  The byte-level half of
    :func:`iter_wal_records_lenient`; fsck's repair also uses it to
    bound what a truncation would LOSE (legacy records included, which
    the v2-only ``resync_scan`` cannot see)."""
    off = start
    n = len(data)
    if off and not (data[off:off + 1] == b"{" or _magic_at(data, off)):
        off = _next_record_boundary(data, off)
        if off < 0:
            return
    while off < n:
        reader = WalReader(data[off:], path=path)
        try:
            for rec, _end in reader:
                yield rec
            return
        except WalCorrupt as e:
            nxt = _next_record_boundary(data, off + e.offset + 1)
            if nxt < 0:
                return
            off = nxt


def iter_wal_records_lenient(path: str) -> Iterator[dict]:
    """Best-effort record iterator for AUDITS (wal_double_binds, fsck's
    history pass): see :func:`iter_records_lenient`.  Replay must NEVER
    use this — silently skipping a record is exactly the bug the
    framing exists to catch — but an audit over a deliberately-
    corrupted archive wants every record it can still prove intact."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return
    yield from iter_records_lenient(data, 0, path=path)


def decode_group(data: bytes, path: str = "<repl-group>") -> List[dict]:
    """Strictly decode one CONTIGUOUS in-memory byte range of WAL frames —
    the replication unit (controlplane/repl.py ships exactly the byte
    range one group commit wrote, so byte order == rv order carries over
    to the follower for free).  Unlike file replay, a torn tail is NOT
    tolerated here: a shipped group is complete by contract, so trailing
    partial bytes raise :class:`WalCorrupt` like mid-file damage."""
    reader = WalReader(bytes(data), path)
    recs = [rec for rec, _end in reader]
    if reader.torn_tail or reader.good_end != len(data):
        raise WalCorrupt(
            path,
            reader.good_end,
            reader.index,
            "incomplete frame in shipped group",
            last_good_rv=reader.last_good_rv,
        )
    return recs


def group_crc32c(data: bytes) -> int:
    """Digest of one shipped group's RAW frame bytes (header + payload).
    CRC32C always — the digest crosses processes in the replication
    stream and the cross-replica scrub gossip, so both sides must agree
    on the algorithm regardless of which checksum each frame's own
    flags byte carries (the frame bytes, checksums included, are what
    is being compared)."""
    return _crc32c(bytes(data))


def count_records(path: str) -> int:
    """The whole records of a WAL file, v2 frames counted by their
    headers and v1 lines by their newlines, without a checksum or a
    decode (the port's own addition: a size reading where
    :func:`scan_file`'s full decode would cost seconds).  A torn tail is
    not counted; past a region that is neither, the count stops."""
    with open(path, "rb") as f:
        data = f.read()
    n, off, end = 0, 0, len(data)
    while off < end:
        if data[off:off + 1] in (b"\n", b"\r", b" "):
            off += 1
            continue
        if _magic_at(data, off):
            if off + HEADER_SIZE > end:
                break
            _magic, length, _crc = _HEADER.unpack_from(data, off)
            off += HEADER_SIZE + length
            if off > end:
                break
        elif data[off:off + 1] == b"{":
            nl = data.find(b"\n", off)
            if nl < 0:
                break
            off = nl + 1
        else:
            break
        n += 1
    return n


def scan_file(path: str) -> dict:
    """One file's integrity report (fsck building block): decodes every
    record, classifying the outcome instead of raising.  Returns
    ``{records, framed, legacy, torn_tail, corrupt: None | {offset,
    index, reason, last_good_rv, resync_rv}, size}``."""
    import os

    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return {"missing": True, "path": path}
    report: dict = {"path": path, "size": os.path.getsize(path)}
    reader = WalReader(data, path=path)
    corrupt = None
    try:
        for _rec, _end in reader:
            pass
    except WalCorrupt as e:
        corrupt = {
            "offset": e.offset,
            "index": e.index,
            "reason": e.reason,
            "last_good_rv": e.last_good_rv,
            "resync_rv": e.resync_rv,
        }
    report.update(
        records=reader.index,
        framed=reader.framed_records,
        legacy=reader.legacy_records,
        torn_tail=reader.torn_tail,
        corrupt=corrupt,
    )
    return report
