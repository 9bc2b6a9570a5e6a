"""The port's WAL frame codec (``controlplane/walio.py``) against JAX's,
and the port's copies of JAX's ``tests/test_walio_crc32c.py``.

Parity: the same records, made from a numpy seed, encode to the same
frame bytes in both packages, with CRC32 and with CRC32C forced; the
same bytes (clean, a flipped bit, a torn header, a torn mid-file frame,
legacy lines) read to the same records, offsets, flags and errors
through ``WalReader``, ``resync_scan``, ``decode_group``,
``group_crc32c`` and ``scan_file``.  A writer without the native CRC32C
library (the card machine has none) emits CRC32 frames and still reads
the CRC32C frames a JAX store wrote where the library exists.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from minisched_tpu.controlplane import walio as jwalio

from minisched_tpu_torch.controlplane import walio

# -- parity with JAX ----------------------------------------------------------


def _seeded_recs(seed, n=12):
    """WAL-shaped records (puts, dels, rv watermarks, acks) from a seed."""
    rng = np.random.default_rng(seed)
    recs = []
    rv = 0
    for i in range(n):
        rv += int(rng.integers(1, 4))
        op = ("put", "put", "del", "rv", "ack")[int(rng.integers(0, 5))]
        if op == "put":
            recs.append({"op": "put", "kind": "Pod", "obj": {
                "metadata": {"name": f"p{i}", "namespace": "default",
                             "uid": f"pod-{i:08d}", "resource_version": rv,
                             "labels": {"k": "v" * int(rng.integers(0, 40))}},
                "spec": {"node_name": f"n{int(rng.integers(0, 9))}"}}})
        elif op == "del":
            recs.append({"op": "del", "kind": "Node", "key": f"/n{i}",
                         "rv": rv})
        elif op == "rv":
            recs.append({"op": "rv", "rv": rv})
        else:
            recs.append({"op": "ack", "id": f"b{i}/0",
                         "entry": {"ok": bool(rng.integers(0, 2))}})
    return recs


@pytest.mark.parametrize("crc32c", [False, True, None],
                         ids=["crc32", "crc32c", "default"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_frame_bytes_equal_to_jax(seed, crc32c):
    for rec in _seeded_recs(seed):
        assert (walio.encode_frame(rec, crc32c=crc32c)
                == jwalio.encode_frame(rec, crc32c=crc32c))
        payload = json.dumps(rec).encode()
        assert (walio.encode_frame(payload, crc32c=crc32c)
                == jwalio.encode_frame(payload, crc32c=crc32c))


def _damaged(seed, damage):
    rng = np.random.default_rng(seed)
    recs = _seeded_recs(seed)
    frames = [jwalio.encode_frame(r, crc32c=bool(i % 2))
              for i, r in enumerate(recs)]
    data = bytearray(b"".join(frames))
    mid = sum(len(f) for f in frames[:len(frames) // 2])
    if damage == "bitflip":
        off = mid + jwalio.HEADER_SIZE + int(rng.integers(1, 10))
        data[off] ^= 1 << int(rng.integers(0, 8))
    elif damage == "torn_header":
        data += jwalio.WAL_MAGIC_C[:3]
    elif damage == "torn_tail":
        data += frames[0][:jwalio.HEADER_SIZE + 5]
    elif damage == "torn_mid":
        # a torn frame later appends buried: its prefix, then the rest
        f = frames[len(frames) // 2]
        data = (bytes(data[:mid]) + f[:jwalio.HEADER_SIZE + len(f) // 3]
                + bytes(data[mid + len(f):]))
    elif damage == "legacy":
        data = (json.dumps(recs[0]).encode() + b"\n" + bytes(data)
                + json.dumps(recs[1]).encode()[:7])
    return bytes(data)


def _read(mod, data):
    reader = mod.WalReader(data, path="x.wal")
    got, err = [], None
    try:
        for rec, end in reader:
            got.append((rec, end))
    except mod.WalCorrupt as e:
        err = (e.path, e.offset, e.index, e.reason, e.last_good_rv,
               e.resync_rv, str(e))
    return (got, err, reader.good_end, reader.index, reader.torn_tail,
            reader.last_good_rv, reader.legacy_records,
            reader.framed_records)


DAMAGES = ["clean", "bitflip", "torn_header", "torn_tail", "torn_mid",
           "legacy"]


@pytest.mark.parametrize("damage", DAMAGES)
@pytest.mark.parametrize("seed", [3, 4])
def test_reader_and_resync_equal_to_jax(seed, damage):
    data = _damaged(seed, damage)
    got = _read(walio, data)
    assert got == _read(jwalio, data)
    if damage in ("bitflip", "torn_mid"):
        assert got[1] is not None  # located mid-file corruption
    for start in (0, 1, len(data) // 2):
        assert walio.resync_scan(data, start) == jwalio.resync_scan(data,
                                                                   start)
        assert (list(walio.iter_records_lenient(data, start))
                == list(jwalio.iter_records_lenient(data, start)))


@pytest.mark.parametrize("damage", DAMAGES)
def test_decode_group_and_digest_equal_to_jax(damage):
    data = _damaged(5, damage)

    def decode(mod):
        try:
            return mod.decode_group(data)
        except mod.WalCorrupt as e:
            return ("corrupt", e.offset, e.index, e.reason)

    assert decode(walio) == decode(jwalio)
    if damage == "clean":
        assert decode(walio) == _seeded_recs(5)
    assert walio.group_crc32c(data) == jwalio.group_crc32c(data)


@pytest.mark.parametrize("damage", DAMAGES)
def test_scan_file_equal_to_jax(tmp_path, damage):
    path = tmp_path / "s.wal"
    path.write_bytes(_damaged(6, damage))
    assert walio.scan_file(str(path)) == jwalio.scan_file(str(path))
    assert walio.scan_file(str(tmp_path / "none")) == jwalio.scan_file(
        str(tmp_path / "none"))


@pytest.mark.parametrize("damage", ["clean", "torn_header", "torn_tail",
                                    "legacy", "bitflip"])
def test_count_records_equals_scan_file(tmp_path, damage):
    """The header-only count equals the full decode's on a file that reads
    to its end (a torn tail not counted), and counts a frame with a
    flipped payload bit, as it checks no checksum."""
    path = tmp_path / "c.wal"
    path.write_bytes(_damaged(7, damage))
    clean = tmp_path / "clean.wal"
    clean.write_bytes(_damaged(7, "clean"))
    want = walio.scan_file(str(clean if damage == "bitflip" else path))
    assert walio.count_records(str(path)) == want["records"] > 0


def test_writer_without_native_crc32c_reads_jax_crc32c_frames(monkeypatch):
    """Without ``google_crc32c`` (the card machine) the writer emits CRC32
    frames and the reader verifies CRC32C frames through the pure-Python
    table: a CRC32C WAL a JAX store wrote elsewhere still replays."""
    recs = _seeded_recs(7)
    crc32c_wal = b"".join(jwalio.encode_frame(r, crc32c=True) for r in recs)
    monkeypatch.setattr(walio, "_crc32c_native", None)
    monkeypatch.setattr(walio, "HAVE_NATIVE_CRC32C", False)
    frame = walio.encode_frame(recs[0])
    assert frame[:4] == walio.WAL_MAGIC
    assert frame == jwalio.encode_frame(recs[0], crc32c=False)
    assert [r for r, _ in walio.WalReader(crc32c_wal)] == recs
    bad = bytearray(crc32c_wal)
    bad[walio.HEADER_SIZE + 3] ^= 0x08
    with pytest.raises(walio.WalCorrupt, match="crc32c"):
        list(walio.WalReader(bytes(bad)))


# -- the port's copies of tests/test_walio_crc32c.py ---------------------------


def _recs(n, start_rv=1):
    return [
        {
            "op": "put",
            "kind": "Pod",
            "obj": {
                "metadata": {
                    "resource_version": start_rv + i,
                    "uid": f"u{start_rv + i}",
                    "namespace": "d",
                    "name": f"p{start_rv + i}",
                }
            },
        }
        for i in range(n)
    ]


def test_mixed_algorithm_roundtrip():
    recs = _recs(6)
    data = (
        walio.encode_frame(recs[0], crc32c=False)
        + walio.encode_frame(recs[1], crc32c=True)
        + json.dumps(recs[2]).encode() + b"\n"  # legacy v1 line
        + walio.encode_frame(recs[3])  # writer default
        + walio.encode_frame(recs[4], crc32c=True)
        + walio.encode_frame(recs[5], crc32c=False)
    )
    reader = walio.WalReader(data)
    assert [rec for rec, _ in reader] == recs
    assert reader.legacy_records == 1
    assert reader.framed_records == 5
    assert not reader.torn_tail


def test_crc32c_python_fallback_matches_native():
    """The pure-Python table against the native library where it exists,
    and against the Castagnoli check value everywhere."""
    assert walio._crc32c_py(b"123456789") == 0xE3069283
    if walio.HAVE_NATIVE_CRC32C:
        rng = np.random.default_rng(8)
        for size in (0, 1, 3, 64, 1000, 4096):
            payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            assert walio._crc32c_py(payload) == walio._crc32c_native(payload)


def test_crc32c_frame_corruption_located():
    recs = _recs(3)
    frames = [walio.encode_frame(r, crc32c=True) for r in recs]
    data = bytearray(b"".join(frames))
    off = len(frames[0]) + walio.HEADER_SIZE + 4  # payload byte of frame 1
    data[off] ^= 0x20
    reader = walio.WalReader(bytes(data))
    with pytest.raises(walio.WalCorrupt) as err:
        list(reader)
    assert err.value.offset == len(frames[0])
    assert "crc32c" in err.value.reason
    assert err.value.last_good_rv == 1
    assert err.value.resync_rv == 3  # magic-scan resync finds crc32c frames


def test_resync_and_lenient_iterate_over_both_magics(tmp_path):
    recs = _recs(4)
    data = (
        walio.encode_frame(recs[0], crc32c=False)
        + b"\x00garbage\x00"
        + walio.encode_frame(recs[1], crc32c=True)
        + walio.encode_frame(recs[2], crc32c=False)
        + walio.encode_frame(recs[3], crc32c=True)
    )
    path = tmp_path / "mixed.wal"
    path.write_bytes(data)
    got = list(walio.iter_wal_records_lenient(str(path)))
    assert got == recs  # audits skip the bad region, keep BOTH kinds
    resync = walio.resync_scan(
        data, len(walio.encode_frame(recs[0], crc32c=False)) + 1)
    assert resync is not None and resync[0] == 2


def test_torn_crc32c_header_is_tail_not_corruption():
    data = walio.encode_frame(_recs(1)[0], crc32c=True) + walio.WAL_MAGIC_C[:3]
    reader = walio.WalReader(data)
    assert len(list(reader)) == 1
    assert reader.torn_tail


def test_durable_store_roundtrip_with_crc32c_writer(tmp_path):
    """The live writer (encode_frame default) replays through reopen and
    passes fsck whichever algorithm the environment selected."""
    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.fsck import fsck

    wal = str(tmp_path / "c.wal")
    store = DurableObjectStore(wal)
    client = Client(store=store)
    client.nodes().create(make_node("n0"))
    client.pods().create_many([make_pod(f"p{i}") for i in range(8)])
    store.close()
    re = DurableObjectStore(wal)
    assert len(re.list("Pod")) == 8
    re.close()
    assert fsck(wal)["ok"]


def test_fsck_repair_accept_loss(tmp_path):
    """--repair: covered salvage refuses when uncovered records follow
    the corruption; --accept-loss truncates anyway and reports the rv
    range being discarded; the repaired WAL then replays clean."""
    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.fsck import fsck, repair

    wal = str(tmp_path / "r.wal")
    store = DurableObjectStore(wal)
    client = Client(store=store)
    client.pods().create_many([make_pod(f"p{i}") for i in range(20)])
    store.close()
    data = bytearray(open(wal, "rb").read())
    data[len(data) // 3] ^= 0x10  # mid-file flip, later records uncovered
    open(wal, "wb").write(bytes(data))

    refused = repair(wal)
    assert not refused["repaired"] and "accept-loss" in refused["hint"]

    rep = repair(wal, accept_loss=True)
    assert rep["repaired"] and rep["action"] == "accept-loss-truncate"
    d = rep["discarded"]
    assert d["to_rv"] == 20 and d["from_rv_exclusive"] < d["to_rv"]
    assert d["resynced_records"] > 0 and d["bytes"] > 0
    report = fsck(wal)
    assert report["ok"], report["errors"]
    # the surviving prefix replays
    re = DurableObjectStore(wal)
    assert 0 < len(re.list("Pod")) < 20
    re.close()


def test_fsck_repair_bad_tail_covered_without_accept_loss(tmp_path):
    """A corrupt FINAL frame with nothing decodable after it is a bad
    tail: the store's covered salvage truncates it automatically, so
    --repair must fix it WITHOUT demanding --accept-loss."""
    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.fsck import fsck, repair

    wal = str(tmp_path / "tail.wal")
    store = DurableObjectStore(wal)
    Client(store=store).pods().create_many(
        [make_pod(f"p{i}") for i in range(5)])
    store.close()
    data = bytearray(open(wal, "rb").read())
    data[-3] ^= 0x40  # payload byte of the LAST frame
    open(wal, "wb").write(bytes(data))

    rep = repair(wal)  # no accept_loss
    assert rep["repaired"] and rep["action"] == "salvage-covered"
    assert rep["covered_loss"]["resynced_records"] == 0
    assert fsck(wal)["ok"]


def test_fsck_repair_clean_wal_noop(tmp_path):
    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.fsck import repair

    wal = str(tmp_path / "clean.wal")
    store = DurableObjectStore(wal)
    Client(store=store).pods().create(make_pod("p0"))
    store.close()
    rep = repair(wal, accept_loss=True)
    assert rep["repaired"] and rep["action"] == "salvage-covered"
    assert "discarded" not in rep
    assert os.path.getsize(wal) > 0
