"""Pure-Python TFRecord writer for JPEG classification records: the
framing (length, masked CRC32C of the length, payload, masked CRC32C of
the payload) and a hand-encoded `tf.train.Example` holding `image/encoded`
(bytes) and `image/class/label` (int64, 1-based as in the classic ImageNet
shards). Needs neither TensorFlow nor a protobuf library.

    from tools.tfrecord_write import write_shards
    write_shards(out_dir, jpegs, labels, shards=4, per_shard=1024)

writes `train-0000k-of-0000n` files, record i of the whole set holding
`jpegs[i % len(jpegs)]` with `labels[i % len(labels)]`. Each distinct
payload's CRC is computed once, so a small source repeated many times
packs quickly.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Sequence

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (0x82F63B78 ^ (_c >> 1)) if _c & 1 else (_c >> 1)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of the TFRecord framing."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def example_bytes(jpeg: bytes, label: int) -> bytes:
    """A serialized tf.train.Example with `image/encoded` and
    `image/class/label` (the int64 list packed, as TensorFlow writes it)."""
    if label < 0:
        raise ValueError(f"label {label} < 0: the varint here is unsigned")
    image = _field(1, _field(1, jpeg))            # Feature.bytes_list
    klass = _field(3, _field(1, _varint(label)))  # Feature.int64_list
    features = (_field(1, _field(1, b"image/encoded") + _field(2, image))
                + _field(1, _field(1, b"image/class/label")
                         + _field(2, klass)))
    return _field(1, features)


def record_bytes(payload: bytes, payload_crc: int | None = None) -> bytes:
    """One framed TFRecord; `payload_crc` (the masked CRC) when known."""
    length = struct.pack("<Q", len(payload))
    if payload_crc is None:
        payload_crc = masked_crc32c(payload)
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", payload_crc))


def write_shards(out_dir: str, jpegs: Sequence[bytes],
                 labels: Sequence[int], *, shards: int, per_shard: int,
                 prefix: str = "train") -> list:
    """`shards` files of `per_shard` records under `out_dir`; returns their
    paths in order."""
    os.makedirs(out_dir, exist_ok=True)
    framed: Dict[tuple, bytes] = {}
    paths = []
    i = 0
    for s in range(shards):
        path = os.path.join(out_dir, f"{prefix}-{s:05d}-of-{shards:05d}")
        with open(path, "wb") as f:
            for _ in range(per_shard):
                key = (i % len(jpegs), i % len(labels))
                rec = framed.get(key)
                if rec is None:
                    rec = record_bytes(example_bytes(jpegs[key[0]],
                                                     int(labels[key[1]])))
                    framed[key] = rec
                f.write(rec)
                i += 1
        paths.append(path)
    return paths
