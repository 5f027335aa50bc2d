"""Native TensorBoard scalar-event writer — no TensorFlow, no tensorboard
package.  The port's copy of ``ic_gan_tpu/utils/tensorboard.py``.

The reference's StyleGAN2 loop emits TensorBoard event files when the
``torch.utils.tensorboard`` import succeeds (ref
``stylegan2_ada_pytorch/training/training_loop.py:389-396,698-715``), which
needs the tensorboard package; the two wire formats are small and frozen, so
they are implemented directly:

- **TFRecord framing**: ``<u64 length><u32 masked_crc(length)><payload>
  <u32 masked_crc(payload)>`` with CRC32C (Castagnoli) and TF's rotate+add
  mask.
- **Event protos** (``tensorflow/core/util/event.proto``): ``wall_time``
  (field 1, double), ``step`` (2, varint), ``file_version`` (3, string),
  ``summary`` (5) holding ``Summary.Value{tag, simple_value}`` messages —
  encoded with the same varint/length-delimited helpers as the GraphDef
  codec (``io/graphdef.py``).

Any standard TensorBoard install reads the resulting
``events.out.tfevents.*`` files.
"""

from __future__ import annotations

import os
import socket
import struct
import time

from ic_gan_tpu_torch.io.graphdef import _fields, _ld, _tag, _varint

# --- CRC32C (Castagnoli, reflected poly 0x82F63B78), table-driven ---------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TF's masking: rotate right by 15, add a constant (record_writer.h)."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


# --- Event proto encoding ---------------------------------------------------


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    out = _tag(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _tag(2, 0) + _varint(step)
    if file_version:
        out += _ld(3, file_version.encode())
    if summary:
        out += _ld(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    v = _ld(1, tag.encode()) + _tag(2, 5) + struct.pack("<f", float(value))
    return _ld(1, v)  # Summary.value (repeated field 1)


class SummaryWriter:
    """Minimal ``add_scalar``-only SummaryWriter writing standard
    ``events.out.tfevents.<time>.<host>`` files into ``logdir``."""

    _seq = 0  # distinguishes writers created within the same second

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "localhost"
        SummaryWriter._seq += 1
        self.path = os.path.join(
            logdir,
            f"events.out.tfevents.{int(time.time())}.{host}"
            f".{os.getpid()}.{SummaryWriter._seq}",
        )
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value, global_step: int = 0,
                   walltime: float = None):
        summary = _scalar_value(tag, value)
        self._f.write(
            _record(_event(walltime or time.time(), int(global_step), summary=summary))
        )

    def add_scalars(self, scalars: dict, global_step: int = 0):
        for tag, value in scalars.items():
            if value is None:
                continue
            self.add_scalar(tag, value, global_step)
        self.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_scalar_events(path: str):
    """Decode scalar events back out of an event file (the test oracle; also
    handy for offline inspection without tensorboard installed).

    Returns a list of ``(step, tag, value)``; validates every record CRC.
    """
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert _masked_crc(header) == hcrc, "header CRC mismatch"
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert _masked_crc(payload) == pcrc, "payload CRC mismatch"
        pos += 16 + length

        step, summary = 0, None
        for fnum, wt, span in _fields(payload):
            if fnum == 2 and wt == 0:
                step = span
            elif fnum == 5 and wt == 2:
                summary = payload[span[0]:span[1]]
        if summary is None:
            continue
        for fnum, wt, span in _fields(summary):
            if fnum == 1 and wt == 2:
                val = summary[span[0]:span[1]]
                tag, simple = None, None
                for vf, vwt, vspan in _fields(val):
                    if vf == 1 and vwt == 2:
                        tag = val[vspan[0]:vspan[1]].decode()
                    elif vf == 2 and vwt == 5:
                        (simple,) = struct.unpack_from("<f", val, vspan[0])
                if tag is not None:
                    out.append((step, tag, simple))
    return out
