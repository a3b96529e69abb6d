"""The port's wire (vtpu_torch.runtime.protocol, vtpu_torch.utils.dtypes)
against vtpu's, byte for byte: the verb tables and header fields, one
frame of every verb, raw frames of f32, i32 and bf16 arrays, the PUT
headers both clients build, the framing's edge cases and the receive
pool.  bf16 crosses as torch's bytes on the port's side and as
ml_dtypes' on vtpu's: the bytes and the name are the same."""

import socket
import struct
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from vtpu.runtime import client as jclient
from vtpu.runtime import protocol as JP
from vtpu.utils import dtypes as jdtypes
from vtpu_torch.runtime import client as tclient
from vtpu_torch.runtime import protocol as TP
from vtpu_torch.utils import dtypes as tdtypes

ALL_VERBS = sorted(set(JP.TENANT_VERBS) | set(JP.ADMIN_VERBS))
TABLES = ("TENANT_VERBS", "ADMIN_VERBS", "BIND_FREE_VERBS",
          "IDEMPOTENT_VERBS", "NONIDEMPOTENT_VERBS", "REPLY_OPTIONAL_FIELDS",
          "WIRE_FIELDS", "MAX_FRAME", "CHUNK_BYTES")

# A value of each type a header field carries.
SAMPLE = {"tenant": "t1", "priority": 1, "device": 0, "devices": [0, 1],
          "hbm_limit": 8 << 20, "hbm_limits": [1 << 20, 2 << 20],
          "core_limit": 50, "oversubscribe": False, "pid": 4242,
          "data": b"\x00\x01\xfe\xff", "shape": [2, 3], "dtype": "bfloat16",
          "nbytes": 12, "raw_parts": 1, "args": ["x", "w"], "outs": ["y"],
          "repeats": 4, "carry": [[0, 0]], "free": ["z"], "exe": "e0",
          "exported": b"{}", "items": [{"exe": "e0", "args": ["x"]}],
          "limit": 3, "timeout": 2.5, "status": True, "phase": "begin",
          "ids": ["a", "b"], "trace": {"id": "ab" * 8, "ts": 1.5}}


def _message(verb):
    fields = JP.WIRE_FIELDS.get(verb, {"required": (), "optional": ()})
    msg = {"kind": verb}
    for name in (*fields["required"], *fields["optional"]):
        msg[name] = SAMPLE.get(name, f"<{name}>")
    return msg


@pytest.mark.parametrize("name", TABLES)
def test_tables_and_constants_equal(name):
    assert getattr(TP, name) == getattr(JP, name)


def test_every_verb_constant_ported():
    """Every verb name vtpu's protocol defines, under the same constant."""
    names = [k for k, v in vars(JP).items()
             if k.isupper() and isinstance(v, str) and v in ALL_VERBS]
    assert len(names) == len(ALL_VERBS) >= 20
    for k in names:
        assert getattr(TP, k) == getattr(JP, k)


@pytest.mark.parametrize("verb", ALL_VERBS)
def test_frame_header_byte_equal(verb):
    """One frame of the verb with every registered field."""
    msg = _message(verb)
    assert TP.frame_header(msg) == JP.frame_header(msg)
    n, = struct.unpack("<I", TP.frame_header(msg)[:4])
    assert n == len(TP.frame_header(msg)) - 4


def _arrays():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5), np.float32)
    i32 = rng.integers(-9, 9, (4, 7), dtype=np.int32)
    bf16 = rng.standard_normal((6, 2), np.float32).astype(ml_dtypes.bfloat16)
    return {"float32": f32, "int32": i32, "bfloat16": bf16}


def _torch_of(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1 << 20, 16])
def test_array_frames_byte_equal(dtype, chunk, monkeypatch):
    """A PUT of the same array: the header both clients build and its raw
    frames, split at CHUNK_BYTES, are the same bytes."""
    monkeypatch.setattr(JP, "CHUNK_BYTES", chunk)
    monkeypatch.setattr(TP, "CHUNK_BYTES", chunk)
    arr = _arrays()[dtype]
    jhdr, jflat = jclient.RuntimeClient._put_raw_parts(arr, "w0")
    thdr, tflat = tclient.RuntimeClient._put_raw_parts(_torch_of(arr), "w0")
    assert thdr == jhdr and thdr["dtype"] == dtype
    assert TP.frame_header(thdr) == JP.frame_header(jhdr)
    jfr = [bytes(b) for b in JP.raw_frames(jflat)]
    tfr = [bytes(b) for b in TP.raw_frames(tflat)]
    assert tfr == jfr
    assert len(tfr) == 2 * TP.raw_part_count(arr.nbytes)


@pytest.mark.parametrize("nbytes", [0, 1, 15, 16, 17, 160])
def test_raw_part_count(nbytes, monkeypatch):
    monkeypatch.setattr(JP, "CHUNK_BYTES", 16)
    monkeypatch.setattr(TP, "CHUNK_BYTES", 16)
    assert TP.raw_part_count(nbytes) == JP.raw_part_count(nbytes)
    assert len(TP.raw_frames(bytes(nbytes))) == 2 * TP.raw_part_count(nbytes)


@pytest.mark.parametrize("name", ["float32", "float16", "float64", "int8",
                                  "uint8", "int16", "int32", "int64", "bool",
                                  "bfloat16", "float8_e4m3fn", "float8_e5m2"])
def test_dtype_names(name):
    """Each wire name resolves to the torch type with vtpu's item size and
    back; numpy's own types to vtpu's numpy type; the extended ones are
    refused by the port's np_dtype (it never imports ml_dtypes)."""
    t = tdtypes.torch_dtype(name)
    assert tdtypes.dtype_name(t) == name
    assert t.itemsize == jdtypes.np_dtype(name).itemsize
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        with pytest.raises(TypeError, match="torch tensor"):
            tdtypes.np_dtype(name)
    else:
        assert tdtypes.np_dtype(name) == jdtypes.np_dtype(name)


def test_unknown_dtype_refused():
    with pytest.raises(TypeError):
        tdtypes.torch_dtype("complex256")
    with pytest.raises(TypeError):
        tdtypes.dtype_name(torch.complex64)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_tensor_bytes_round_trip(dtype):
    """The port's bytes of a tensor are numpy's bytes of vtpu's array, and
    back to the same bits."""
    arr = _arrays()[dtype]
    t = _torch_of(arr)
    assert bytes(tdtypes.tensor_bytes(t)) == arr.tobytes()
    back = tdtypes.tensor_from_bytes(arr.tobytes(), dtype, arr.shape)
    assert back.dtype == t.dtype and torch.equal(back, t)
    with pytest.raises(ValueError):
        tdtypes.tensor_from_bytes(arr.tobytes()[:-1], dtype, arr.shape)


def _pair():
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    return a, b


def test_send_recv_across_implementations():
    """A frame the port sends is read by vtpu's receiver and back."""
    a, b = _pair()
    try:
        msg = _message(TP.EXECUTE)
        TP.send_msg(a, msg)
        assert JP.recv_msg(b) == msg
        JP.send_msg(b, msg)
        assert TP.recv_msg(a) == msg
        payload = bytes(range(200))
        TP.send_frames(a, [TP.frame_header({"n": 1})] + TP.raw_frames(payload))
        assert JP.recv_msg(b) == {"n": 1}
        buf = bytearray(200)
        assert TP.recv_raw_into(b, memoryview(buf)) == 200
        assert bytes(buf) == payload
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("frame,match", [
    (struct.pack("<I", 5) + b"\xff\xfe\xfd\xfc\xfb", "undecodable"),
    (struct.pack("<I", 1) + b"\x01", "not a map"),
    (struct.pack("<I", (1 << 30) + 1), "too large"),
])
def test_malformed_frames_raise_protocol_error(frame, match):
    a, b = _pair()
    try:
        a.sendall(frame)
        with pytest.raises(TP.ProtocolError, match=match):
            TP.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_raw_frame_over_announced_size():
    a, b = _pair()
    try:
        TP.send_frames(a, TP.raw_frames(bytes(64)))
        with pytest.raises(TP.ProtocolError, match="exceeds announced"):
            TP.recv_raw_into(b, memoryview(bytearray(32)))
    finally:
        a.close()
        b.close()


def test_peer_closed_mid_frame():
    a, b = _pair()
    a.sendall(struct.pack("<I", 100) + b"abc")
    a.close()
    try:
        with pytest.raises(ConnectionError):
            TP.recv_msg(b)
    finally:
        b.close()


def test_recv_pool_matches_vtpu():
    """The same take/give sequence gives the same counters."""
    got = []
    for mod in (TP, JP):
        stats = {}
        pool = mod.RecvPool(cap_bytes=100, stats=stats)
        for n in (10, 8, 50, 200, 30):
            buf = pool.take(n)
            assert len(buf) >= n
            pool.give(buf)
        got.append(stats)
    assert got[0] == got[1] and got[0]["drops"] == 1


def test_reply_err_frame_equal():
    frames = []
    for mod in (TP, JP):
        a, b = _pair()
        try:
            mod.reply_err(a, "NOT_FOUND", "x")
            frames.append(b.recv(1 << 16))
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]


def _wire(send):
    """The bytes ``send(sock)`` puts on a socket pair (sent from a thread,
    so a payload larger than the socket's buffer does not block)."""
    a, b = socket.socketpair()
    try:
        def run():
            send(a)
            a.shutdown(socket.SHUT_WR)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        chunks = []
        while True:
            c = b.recv(1 << 20)
            if not c:
                break
            chunks.append(c)
        th.join(timeout=10)
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65535, 65536, (1 << 20) + 3])
def test_send_msg_tail_is_send_msg_on_the_wire(n):
    """The copy-free send of a message with a large bin last puts the same
    bytes on the wire as vtpu's ``send_msg``, which reads it back."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    got = _wire(lambda s: TP.send_msg_tail(s, {"blob": "ab" * 32}, "data",
                                           data))
    assert got == _wire(lambda s: JP.send_msg(s, {"blob": "ab" * 32,
                                                  "data": data}))
    a, b = socket.socketpair()
    try:
        th = threading.Thread(target=a.sendall, args=(got,), daemon=True)
        th.start()
        assert JP.recv_msg(b) == {"blob": "ab" * 32, "data": data}
        th.join(timeout=10)
    finally:
        a.close()
        b.close()
