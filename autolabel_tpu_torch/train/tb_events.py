"""TensorBoard scalar events without tensorboardX.

Counterpart of autolabel_tpu/train/tb_events.py, kept as the port's own
copy: the tfevents wire format is TFRecord framing (length + masked
crc32c) around two hand-encoded protobuf messages (Event{wall_time, step,
summary}, Summary{Value{tag, simple_value}}). The trainer writes one event
per epoch at <workspace>/run/<name>; read_events reads a file back with
both CRCs checked, as TensorBoard's reader does, and reads the JAX
package's files as that package reads these.
"""
import os
import socket
import struct
import time

# -- crc32c (Castagnoli), table-driven ----------------------------------------

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            _CRC_TABLE.append(crc)
    return _CRC_TABLE


def crc32c(data):
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    """TFRecord's rotated+offset crc32c mask."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding --------------------------------------------------

def _varint(value):
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(num, value):
    return _varint(num << 3) + _varint(value)


def _field_double(num, value):
    return _varint((num << 3) | 1) + struct.pack('<d', value)


def _field_float(num, value):
    return _varint((num << 3) | 5) + struct.pack('<f', value)


def _field_bytes(num, payload):
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _scalar_event(wall_time, step, scalars):
    """Event{wall_time=1, step=2, summary=5{Value=1{tag=1, simple_value=2}}}"""
    summary = b''.join(
        _field_bytes(1, _field_bytes(1, tag.encode('utf-8')) +
                     _field_float(2, float(value)))
        for tag, value in scalars.items())
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, summary))


def _version_event(wall_time):
    # Event.file_version = field 3 (string): the reader preamble.
    return _field_double(1, wall_time) + _field_bytes(3, b'brain.Event:2')


# -- writer / reader -------------------------------------------------------------

class TBEventWriter:
    """Append-only tfevents scalar writer."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        stamp = int(time.time())
        host = socket.gethostname()
        self.path = os.path.join(logdir,
                                 f'events.out.tfevents.{stamp}.{host}')
        self._file = open(self.path, 'ab')
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload):
        header = struct.pack('<Q', len(payload))
        self._file.write(header)
        self._file.write(struct.pack('<I', _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack('<I', _masked_crc(payload)))
        self._file.flush()

    def add_scalars(self, step, scalars, wall_time=None):
        """scalars: {tag: float}. One Event record per call."""
        self._write_record(_scalar_event(
            time.time() if wall_time is None else wall_time, step, scalars))

    def close(self):
        self._file.close()


def read_events(path):
    """Round-trip reader (CRC-checked): [(step, {tag: value})]."""
    records = []
    with open(path, 'rb') as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (expect,) = struct.unpack('<I', f.read(4))
            if _masked_crc(header) != expect:
                raise ValueError(f'{path}: corrupt length crc')
            (length,) = struct.unpack('<Q', header)
            payload = f.read(length)
            (expect,) = struct.unpack('<I', f.read(4))
            if _masked_crc(payload) != expect:
                raise ValueError(f'{path}: corrupt payload crc')
            records.append(payload)
    events = []
    for payload in records:
        step, scalars = _parse_event(payload)
        if scalars:
            events.append((step, scalars))
    return events


def _read_varint(buf, pos):
    shift, value = 0, 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _parse_fields(buf):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 5:
            value = buf[pos:pos + 4]
            pos += 4
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        else:
            raise ValueError(f'wire type {wire}')
        yield num, wire, value


def _parse_event(payload):
    step, scalars = 0, {}
    for num, wire, value in _parse_fields(payload):
        if num == 2 and wire == 0:
            step = value
        elif num == 5 and wire == 2:  # summary
            for vnum, vwire, vvalue in _parse_fields(value):
                if vnum == 1 and vwire == 2:  # Summary.Value
                    tag, simple = None, None
                    for fnum, fwire, fvalue in _parse_fields(vvalue):
                        if fnum == 1 and fwire == 2:
                            tag = fvalue.decode('utf-8')
                        elif fnum == 2 and fwire == 5:
                            (simple,) = struct.unpack('<f', fvalue)
                    if tag is not None and simple is not None:
                        scalars[tag] = simple
    return step, scalars
