"""The port's native store against the reference, on the CPU.

- **Store parity**: seeded op sequences (numpy RNG) over strings with TTLs,
  sets, lists, sorted sets, hashes, ``cas`` and pattern pub/sub give the
  same results on the port's ``NativeStore`` (the C++ store, built by the
  port's own loader into ``agentainer_tpu_torch/_build/``) as on the
  reference's ``MemoryStore``, the behavioural spec. Key patterns use
  ``*`` and ``?`` only: the C++ glob has no ``[...]`` classes, in the
  reference too.
- **Codec parity**: ``encode_request``/``decode_response`` give the same
  bytes as ``agentainer_tpu.store.native``'s, and importing that module
  builds nothing.
- **AOF**: the cases of ``tests/test_native.py::TestAOF`` and
  ``tests/test_aof_recovery.py`` on the port's store: acknowledged writes
  reach the file without a close, every type survives a reopen, TTLs come
  back as absolute deadlines, deletes and flushes are logged, a torn tail
  (inside a record or its length prefix) drops that record whole and the
  log stays appendable, an empty or garbage file opens.

The library must build here: a failed build fails these tests, it never
skips them.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from agentainer_tpu.store import MemoryStore as JMemoryStore
from agentainer_tpu_torch import native
from agentainer_tpu_torch.store import native as wire
from agentainer_tpu_torch.store.native import NativeStore


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's library, built once (under its file lock) for the module;
    a build failure fails every test here."""
    assert native.available(), native.load_error()


def reopen(path) -> NativeStore:
    return NativeStore(aof_path=str(path))


# -- store parity ----------------------------------------------------------------

_OPS = (
    "set", "set_ttl", "get", "delete", "exists", "keys", "expire", "ttl",
    "sadd", "srem", "smembers", "rpush", "lpush", "lrem", "lrange", "llen", "ltrim",
    "zadd", "zrange", "zrange_limit", "zrem", "zcard", "hset", "hincrby", "hgetall",
    "cas", "cas_new", "publish",
)
# each op's keys: two of its own type, and now and then a key that any op
# writes, so wrong-typed ops are exercised too
_FAMILY = {"s": "set set_ttl get cas cas_new", "set": "sadd srem smembers",
           "l": "rpush lpush lrem lrange llen ltrim", "z": "zadd zrange zrange_limit zrem zcard",
           "h": "hset hincrby hgetall"}
_KEYS_OF = {op: [f"agent:{fam}{i}" for i in range(2)] for fam, ops in _FAMILY.items() for op in ops.split()}
_ANY_KEYS = sorted({k for ks in _KEYS_OF.values() for k in ks}) + ["agent:mixed"]


def _store_ops(store, seed: int) -> list:
    """A seeded op sequence; every op's result, or the class of the error a
    wrong-typed op raises; pub/sub messages through two pattern
    subscriptions; then a short TTL expiring."""
    rng = np.random.default_rng(seed)
    sub = store.psubscribe("agent:status:*")
    sub2 = store.psubscribe("chan:?")
    out = []
    for _ in range(400):
        op = _OPS[rng.integers(len(_OPS))]
        keys = _KEYS_OF.get(op, _ANY_KEYS)
        k = "agent:mixed" if rng.random() < 0.15 else keys[rng.integers(len(keys))]
        v = f"v{rng.integers(5)}"
        try:
            if op == "set":
                r = store.set(k, v)
            elif op == "set_ttl":
                r = store.set(k, v, ttl=float(rng.choice([600, 3600])))
            elif op == "get":
                r = store.get(k)
            elif op == "delete":
                r = store.delete(k, _ANY_KEYS[rng.integers(len(_ANY_KEYS))])
            elif op == "exists":
                r = store.exists(k)
            elif op == "keys":
                r = sorted(store.keys(str(rng.choice(["*", "agent:?0", "*s1", "agent:*", "agent:set?", "x*"]))))
            elif op == "expire":
                r = store.expire(k, 3600)
            elif op == "ttl":
                t = store.ttl(k)
                r = None if t is None else round(t, -2)
            elif op == "sadd":
                r = store.sadd(k, v, f"v{rng.integers(5)}")
            elif op == "srem":
                r = store.srem(k, v)
            elif op == "smembers":
                r = sorted(store.smembers(k))
            elif op == "rpush":
                r = store.rpush(k, v, v + "x")
            elif op == "lpush":
                r = store.lpush(k, v)
            elif op == "lrem":
                r = store.lrem(k, int(rng.choice([0, 1, -1, 2])), v)
            elif op == "lrange":
                r = store.lrange(k, int(rng.integers(-3, 2)), int(rng.choice([-1, 0, 2, 5])))
            elif op == "llen":
                r = store.llen(k)
            elif op == "ltrim":
                r = store.ltrim(k, int(rng.integers(-3, 2)), int(rng.choice([-1, 1, 3])))
            elif op == "zadd":
                r = store.zadd(k, float(rng.integers(10)) / 2, v)
            elif op == "zrange":
                r = store.zrangebyscore(k, float(rng.integers(5)), float(rng.integers(5, 12)))
            elif op == "zrange_limit":
                r = store.zrangebyscore(k, 0, 10, limit=int(rng.integers(0, 3)))
            elif op == "zrem":
                r = store.zremrangebyscore(k, 0, float(rng.integers(6)))
            elif op == "zcard":
                r = store.zcard(k)
            elif op == "hset":
                # integer values: where hincrby meets a non-integer field the
                # reference's two stores differ (pinned below)
                r = store.hset(k, str(rng.choice(["a", "b"])), str(rng.integers(-3, 4)))
            elif op == "hincrby":
                r = store.hincrby(k, str(rng.choice(["a", "b"])), int(rng.integers(-2, 3)))
            elif op == "hgetall":
                r = sorted(store.hgetall(k).items())
            elif op == "cas":
                r = store.cas(k, [None, "v0", "v1"][rng.integers(3)], v)
            elif op == "cas_new":
                r = store.cas(k, None, v, ttl=600.0)
            else:
                r = store.publish(str(rng.choice(["agent:status:a", "chan:b", "chan:bb", "other"])), v)
        except (TypeError, ValueError) as e:  # a wrong-typed op: the same error both ways
            r = type(e).__name__
        out.append((op, r))
    store.set("short", "x", ttl=0.05)
    store.set("long", "y", ttl=60)
    time.sleep(0.1)
    out.append(("expired", store.get("short"), store.get("long"), sorted(store.keys("*o*"))))
    out.append(("messages", sub.drain(), sub2.drain()))
    sub.close()
    sub2.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_store_op_sequences_match_reference_memory_store(seed):
    ns = NativeStore()
    try:
        got = _store_ops(ns, seed)
    finally:
        ns.close()
    want = _store_ops(JMemoryStore(), seed)
    assert got == want


def test_hincrby_on_a_non_integer_field_differs_as_in_the_reference():
    """``native/store.cc`` counts a non-integer hash field from 0 (strtoll),
    where ``MemoryStore`` raises ``ValueError``: the reference's own two
    stores differ, and the port reuses the C++ as it is."""
    ns, mem = NativeStore(), JMemoryStore()
    try:
        for s in (ns, mem):
            s.hset("h", "f", "v3")
        assert ns.hincrby("h", "f", 2) == 2
        with pytest.raises(ValueError):
            mem.hincrby("h", "f", 2)
    finally:
        ns.close()


def test_on_message_delivers_to_the_callback():
    s = NativeStore()
    seen = []
    try:
        stop = s.on_message("agent:status:*", lambda ch, msg: seen.append((ch, msg)))
        assert s.publish("agent:status:a1", "running") == 1
        deadline = time.monotonic() + 5
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        stop()
    finally:
        s.close()
    assert seen == [("agent:status:a1", "running")]


# -- codec parity ------------------------------------------------------------------


def test_codec_matches_the_reference_and_its_import_builds_nothing():
    probe = (
        "import json, agentainer_tpu.store.native as w, agentainer_tpu.native as n;"
        "print(json.dumps([n._lib is None, n._load_error is None]))"
    )
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, True]

    from agentainer_tpu.store import native as jwire

    ops = {n: getattr(jwire, n) for n in dir(jwire) if n.startswith(("OP_", "RESP_"))}
    assert {n: getattr(wire, n) for n in ops} == ops
    # native/common.h's Op enum, number for number (the AOF replay forms too)
    with open(os.path.join(native.NATIVE_DIR, "common.h")) as f:
        header = f.read()
    enum = header[header.index("enum Op"):]
    enum = enum[: enum.index("};")]
    for name in (n for n in dir(wire) if n.startswith("OP_")):
        assert f"{name} = {getattr(wire, name)}," in enum, name
    rng = np.random.default_rng(7)
    for _ in range(50):
        args = [rng.bytes(int(rng.integers(0, 300))) for _ in range(int(rng.integers(0, 6)))]
        op = int(rng.integers(1, 30))
        assert wire.encode_request(op, args) == jwire.encode_request(op, args)
        status = int(rng.integers(0, 3))
        resp = bytes([status]) + struct.pack("<I", len(args)) + b"".join(
            struct.pack("<I", len(a)) + a for a in args
        )
        assert wire.decode_response(resp) == jwire.decode_response(resp) == (status, args)


# -- AOF ---------------------------------------------------------------------------


def test_acked_writes_reach_the_file_without_close(tmp_path):
    aof = tmp_path / "store.aof"
    s = reopen(aof)
    s.set("agent:durable", "survives-sigkill")
    assert b"agent:durable" in aof.read_bytes()  # no close()/flush() first
    s.close()


def test_all_types_survive_reopen(tmp_path):
    aof = tmp_path / "store.aof"
    s = reopen(aof)
    s.set("agent:a", json.dumps({"id": "a", "status": "running"}))
    s.sadd("agents:list", "a", "b")
    s.rpush("l", "x", "y", "z")
    s.lrem("l", 1, "y")
    s.zadd("z", 3.0, "m3")
    s.zadd("z", 1.0, "m1")
    s.hset("h", "f", "v")
    s.hincrby("h", "n", 7)
    s.set("bin", bytes(range(256)))
    s.close()
    s2 = reopen(aof)
    try:
        assert json.loads(s2.get("agent:a")) == {"id": "a", "status": "running"}
        assert s2.smembers("agents:list") == {"a", "b"}
        assert s2.lrange("l", 0, -1) == [b"x", b"z"]
        assert s2.zrangebyscore("z", 0, 10) == [b"m1", b"m3"]
        assert s2.hgetall("h") == {"f": b"v", "n": b"7"}
        assert s2.get("bin") == bytes(range(256))
    finally:
        s2.close()


def test_ttl_survives_as_absolute_deadline(tmp_path):
    aof = tmp_path / "store.aof"
    s = reopen(aof)
    s.set("short", "v", ttl=0.05)
    s.set("long", "v", ttl=3600)
    s.set("later", "v")
    s.expire("later", 1800)
    s.close()
    time.sleep(0.07)
    s2 = reopen(aof)
    try:
        assert s2.get("short") is None  # the deadline passed while "down"
        assert s2.get("long") == b"v"
        assert 3500 < s2.ttl("long") <= 3600
        assert 1700 < s2.ttl("later") <= 1800
    finally:
        s2.close()


def test_delete_and_flush_are_logged(tmp_path):
    aof = tmp_path / "store.aof"
    s = reopen(aof)
    s.set("k1", "v1")
    s.set("k2", "v2")
    s.delete("k1")
    s.close()
    s2 = reopen(aof)
    assert s2.get("k1") is None and s2.get("k2") == b"v2"
    s2.flush()
    s2.close()
    s3 = reopen(aof)
    assert s3.keys("*") == []
    s3.close()


# ops applied before a tear; the torn op is appended after these
_TORN_OPS = [
    ("set", "alpha", "1"),
    ("set", "beta", "two"),
    ("rpush", "queue", ["a", "b", "c"]),
    ("hset", "meta", ("field", "val")),
    ("sadd", "members", ["m1", "m2"]),
    ("set", "alpha", "rewritten"),  # the later record wins on replay
]


def _apply(store) -> None:
    for op, key, arg in _TORN_OPS:
        if op == "set":
            store.set(key, arg)
        elif op == "rpush":
            store.rpush(key, *arg)
        elif op == "hset":
            store.hset(key, *arg)
        elif op == "sadd":
            store.sadd(key, *arg)


def _assert_parity(ns) -> None:
    """The recovered native state equals the reference MemoryStore's replay
    of the surviving ops."""
    mem = JMemoryStore()
    _apply(mem)
    for key in ("alpha", "beta"):
        assert ns.get(key) == mem.get(key)
    assert ns.lrange("queue", 0, -1) == mem.lrange("queue", 0, -1)
    assert ns.hgetall("meta") == mem.hgetall("meta")
    assert ns.smembers("members") == mem.smembers("members")


def _records(data: bytes) -> list[int]:
    """Start offsets of the AOF's whole length-prefixed records."""
    pos, starts = 0, []
    while pos + 4 <= len(data):
        (n,) = struct.unpack_from("<I", data, pos)
        if pos + 4 + n > len(data):
            break
        starts.append(pos)
        pos += 4 + n
    return starts


@pytest.mark.parametrize("cut", ["payload", "length_prefix"])
def test_torn_tail_drops_the_record_whole_and_stays_appendable(tmp_path, cut):
    aof = tmp_path / "store.aof"
    s = reopen(aof)
    _apply(s)
    s.rpush("torn", "x", "y")
    s.close()
    data = aof.read_bytes()
    last = _records(data)[-1]
    with open(aof, "r+b") as f:
        f.truncate(len(data) - 3 if cut == "payload" else last + 2)
    s2 = reopen(aof)
    _assert_parity(s2)  # every record before the tear survives, exactly
    assert s2.lrange("torn", 0, -1) == []  # the torn record dropped whole
    s2.set("post-recovery", "written-after-tear")
    s2.rpush("queue", "d")
    s2.close()
    s3 = reopen(aof)
    try:
        assert s3.get("post-recovery") == b"written-after-tear"
        assert s3.lrange("queue", 0, -1) == [b"a", b"b", b"c", b"d"]
        assert s3.get("alpha") == b"rewritten"
    finally:
        s3.close()


def test_empty_and_garbage_aof(tmp_path):
    empty = tmp_path / "empty.aof"
    empty.write_bytes(b"")
    s = reopen(empty)
    assert s.get("anything") is None
    s.set("k", "v")
    s.close()
    s2 = reopen(empty)
    assert s2.get("k") == b"v"
    s2.close()
    garbage = tmp_path / "garbage.aof"
    s = reopen(garbage)
    s.set("k", "v")
    s.close()
    with open(garbage, "ab") as f:
        f.write(b"\xff\xff\xff\x7f partial garbage")
    s2 = reopen(garbage)
    try:
        assert s2.get("k") == b"v"
    finally:
        s2.close()
