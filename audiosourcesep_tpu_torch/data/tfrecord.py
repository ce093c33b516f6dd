"""TFRecord IO without TensorFlow (port of ``audiosourcesep_tpu/data/tfrecord.py``).

The reference's on-disk format (datasets/preprocessing.py:197-271):
TFRecord framing (length + masked CRC32C) around ``tf.train.Example``
protos with two features, ``array`` (packed float list) and ``shape``
(packed int64 list). Files written here are byte-identical to the JAX
package's, and each reads the other's.

CRC32C comes from the repository's ``native/asr_native.cpp``, built with
``g++`` at first use into ``audiosourcesep_tpu_torch/kernels/_build/``
(gitignored); without a compiler a pure-Python loop computes the same
value, about a hundred times slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_NATIVE_SRC = _REPO / "native" / "asr_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "kernels" / "_build"
_native = None


def _load_native():
    """The native library (built on first use), or False."""
    global _native
    if _native is not None:
        return _native
    _native = False
    if not _NATIVE_SRC.is_file():
        return _native
    digest = hashlib.sha256(_NATIVE_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"libasr_native_{digest}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                            str(_NATIVE_SRC)], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError):
            tmp.unlink(missing_ok=True)
            return _native
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:          # built for another machine
        return _native
    lib.asr_masked_crc32c.restype = ctypes.c_uint32
    lib.asr_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    _native = lib
    return _native


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _crc_table()


def _crc32c_py(data: bytes) -> int:
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC32C: rotate right by 15, add a constant."""
    lib = _load_native()
    if lib:
        return lib.asr_masked_crc32c(data, len(data))
    crc = _crc32c_py(data)
    return ((crc >> 15) | (crc << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal tf.train.Example proto (array: float_list, shape: int64_list)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_delim(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + _varint(len(payload)) + payload


def serialize_example(array: np.ndarray) -> bytes:
    """tf.train.Example bytes with the reference's 'array'+'shape' schema
    (preprocessing.py:197-217)."""
    array = np.asarray(array, np.float32)
    float_payload = array.reshape(-1).astype("<f4").tobytes()
    float_list = _len_delim(0x0A, float_payload)         # FloatList.value
    feature_array = _len_delim(0x12, float_list)         # Feature.float_list

    shape_payload = b"".join(_varint(int(d)) for d in array.shape)
    int64_list = _len_delim(0x0A, shape_payload)         # Int64List.value
    feature_shape = _len_delim(0x1A, int64_list)         # Feature.int64_list

    def map_entry(key: bytes, feature: bytes) -> bytes:
        body = _len_delim(0x0A, key) + _len_delim(0x12, feature)
        return _len_delim(0x0A, body)                    # Features.feature

    features = map_entry(b"array", feature_array) + map_entry(
        b"shape", feature_shape)
    return _len_delim(0x0A, features)                    # Example.features


def parse_example(data: bytes) -> np.ndarray:
    """Parse an Example with the 'array'+'shape' schema back to an ndarray."""
    buf = memoryview(data)

    def walk_message(view) -> dict:
        fields = {}
        pos = 0
        while pos < len(view):
            key, pos = _read_varint(view, pos)
            field, wire = key >> 3, key & 7
            if wire == 2:
                ln, pos = _read_varint(view, pos)
                fields.setdefault(field, []).append(view[pos:pos + ln])
                pos += ln
            elif wire == 0:
                val, pos = _read_varint(view, pos)
                fields.setdefault(field, []).append(val)
            elif wire == 5:
                fields.setdefault(field, []).append(view[pos:pos + 4])
                pos += 4
            elif wire == 1:
                fields.setdefault(field, []).append(view[pos:pos + 8])
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")
        return fields

    example = walk_message(buf)
    features = walk_message(example[1][0])
    array = None
    shape = None
    for entry in features.get(1, []):
        kv = walk_message(entry)
        key = bytes(kv[1][0]).decode()
        feature = walk_message(kv[2][0])
        if key == "array":
            float_list = walk_message(feature[2][0])
            payload = float_list.get(1, [b""])[0]
            array = np.frombuffer(bytes(payload), "<f4")
        elif key == "shape":
            int64_list = walk_message(feature[3][0])
            raw = int64_list.get(1, [b""])[0]
            if isinstance(raw, int):       # an unpacked single dimension
                shape = [raw]
            else:
                view = memoryview(raw)
                shape, pos = [], 0
                while pos < len(view):
                    d, pos = _read_varint(view, pos)
                    shape.append(d)
    if array is None:
        raise ValueError("Example missing 'array' feature")
    return array.reshape(shape) if shape else array


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------

def write_records(path: str, payloads: Iterable[bytes]) -> int:
    """Write raw payloads with TFRecord framing; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))
            n += 1
    return n


def read_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """The payloads of a TFRecord file; a bad CRC raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos + 12 <= n:
        (length,) = struct.unpack_from("<Q", data, pos)
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if verify_crc and masked_crc32c(data[pos:pos + 8]) != len_crc:
            raise ValueError(f"{path}: corrupt length CRC at offset {pos}")
        start = pos + 12
        payload = data[start:start + length]
        (data_crc,) = struct.unpack_from("<I", data, start + length)
        if verify_crc and masked_crc32c(payload) != data_crc:
            raise ValueError(f"{path}: corrupt data CRC at offset {start}")
        yield payload
        pos = start + length + 4


# ---------------------------------------------------------------------------
# array-level API (the reference's save/load_tf_records contract)
# ---------------------------------------------------------------------------

def save_tf_records(arrays: Iterable[np.ndarray], filename: str) -> int:
    """Save arrays to one .tfrecord file (preprocessing.py:228-244)."""
    if not filename.endswith(".tfrecord"):
        filename += ".tfrecord"
    return write_records(filename, (serialize_example(a) for a in arrays))


def load_tf_records(filenames: Sequence[str]) -> List[np.ndarray]:
    """Load arrays from .tfrecord files (preprocessing.py:247-271)."""
    if isinstance(filenames, (str, os.PathLike)):
        filenames = [filenames]
    out: List[np.ndarray] = []
    for fn in filenames:
        out.extend(parse_example(p) for p in read_records(fn))
    return out
