"""RecordIO pack format (parity: python/mxnet/recordio.py and dmlc's
recordio: ``MXRecordIO``, ``MXIndexedRecordIO``, ``IRHeader``, ``pack``,
``unpack``, ``pack_img``, ``unpack_img``).

Counterpart of ``mxtpu/recordio.py`` over the native reader and writer
(``_native``, ``src/core/recordio.cc``): each record is the magic
``0xCED7230A`` and a ``uint32`` length, then the payload padded to 4
bytes; a packed record starts with the ``IfQQ`` header (flag, label, id,
id2) and, when ``flag > 0``, ``flag`` float32 labels; the ``.idx``
sidecar is ``key\\tposition`` lines. Files written by either package
read in the other byte for byte. ``pack_img`` encodes with PIL (JPEG or
PNG) and, where PIL is missing, writes mxtpu's raw ``RAW0`` form, which
``unpack_img`` reads as part of the file format.
"""
from __future__ import annotations

import ctypes
import io as _io
import struct
from collections import namedtuple

import numpy as _np

from . import _native

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential record file reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self._nh = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        lib = self._lib = _native.get_lib()
        h = ctypes.c_void_p()
        create = lib.MXTPURecordWriterCreate if self.writable \
            else lib.MXTPURecordReaderCreate
        _native.check_call(create(self.uri.encode("utf-8"), ctypes.byref(h)))
        self._nh = h
        self.is_open = True

    def close(self):
        if self.is_open:
            free = self._lib.MXTPURecordWriterFree if self.writable \
                else self._lib.MXTPURecordReaderFree
            self.is_open = False
            _native.check_call(free(self._nh))
            self._nh = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # teardown: the handle is gone with the process
            pass

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        pos = ctypes.c_uint64()
        fn = self._lib.MXTPURecordWriterTell if self.writable \
            else self._lib.MXTPURecordReaderTell
        _native.check_call(fn(self._nh, ctypes.byref(pos)))
        return pos.value

    def seek(self, pos):
        assert not self.writable
        _native.check_call(self._lib.MXTPURecordReaderSeek(self._nh, pos))

    def write(self, buf):
        assert self.writable
        buf = bytes(buf)
        _native.check_call(self._lib.MXTPURecordWriterWrite(
            self._nh, buf, len(buf)))

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        assert not self.writable
        data = ctypes.c_void_p()
        size = ctypes.c_uint64()
        _native.check_call(self._lib.MXTPURecordReaderNext(
            self._nh, ctypes.byref(data), ctypes.byref(size)))
        if not data.value:
            return None
        return ctypes.string_at(data.value, size.value)


class MXIndexedRecordIO(MXRecordIO):
    """Keyed random access through an ``.idx`` sidecar."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable:
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        else:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.is_open and self.writable:
            self.fidx.close()
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """The header, its label array when the label is not a scalar, then
    the payload ``s``."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        return struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                           header.id2) + s
    label = _np.asarray(header.label, dtype=_np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """(IRHeader, payload) of a packed record; the label is a float32
    array when the header's flag counts one."""
    flag, label, idx, idx2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = _np.frombuffer(s[:flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, idx, idx2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image (JPEG for ``.jpg``/``.jpeg``, else PNG)
    with PIL and pack it; without PIL, pack mxtpu's raw ``RAW0`` form."""
    try:
        from PIL import Image
    except ImportError:
        arr = _np.asarray(img, dtype=_np.uint8)
        meta = struct.pack("<III", *(arr.shape + (1,) * (3 - arr.ndim))[:3])
        return pack(header, b"RAW0" + meta + arr.tobytes())
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
    Image.fromarray(_np.asarray(img, dtype=_np.uint8)).save(
        buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """(IRHeader, HWC uint8 image) of a record packed by ``pack_img``."""
    del iscolor  # the image keeps the channels it was packed with
    header, s = unpack(s)
    if s[:4] == b"RAW0":
        h, w, c = struct.unpack("<III", s[4:16])
        img = _np.frombuffer(s[16:], dtype=_np.uint8).reshape(
            (h, w, c) if c > 1 else (h, w))
        return header, img
    from PIL import Image
    return header, _np.asarray(Image.open(_io.BytesIO(s)))
