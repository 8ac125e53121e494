"""The port's recordio (``mxtpu_torch/recordio.py`` over the native
reader and writer it builds from ``src/core``) against mxtpu's: the same
records written by both packages give the same ``.rec`` bytes and
``.idx`` text; each package reads the other's files (scalar labels,
label arrays, JPEG, PNG and ``RAW0`` payloads); ``pack``/``unpack``/
``pack_img``/``unpack_img`` agree byte for byte. The library is built
into ``build/mxtpu_torch/`` (never ``mxtpu/native/``), and a failed
build raises with the compiler's output."""
import os
import shutil
import struct

import numpy as np
import pytest

from mxtpu import recordio as mx_rio


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _records(seed=0):
    """(key, header, payload) triples: scalar and array labels, odd
    lengths (the 4-byte padding), an empty payload."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(9):
        if i % 3 == 0:
            label = float(i)
        elif i % 3 == 1:
            label = rng.rand(i % 5 + 2).astype(np.float32).tolist()
        else:
            label = [2.0, 5.0, 1.0, 0.1, 0.2, 0.6, 0.7]
        payload = rng.bytes(int(rng.randint(0, 40)) if i != 4 else 0)
        out.append((i * 7, (0, label, i, i + 1), payload))
    return out


def _write(rio, idx, rec, records):
    w = rio.MXIndexedRecordIO(str(idx), str(rec), "w")
    for key, header, payload in records:
        w.write_idx(key, rio.pack(rio.IRHeader(*header), payload))
    w.close()


def test_rec_bytes_and_idx_text_are_mxtpus(mt, tmp_path):
    recs = _records()
    _write(mt.recordio, tmp_path / "a.idx", tmp_path / "a.rec", recs)
    _write(mx_rio, tmp_path / "b.idx", tmp_path / "b.rec", recs)
    assert (tmp_path / "a.rec").read_bytes() == \
        (tmp_path / "b.rec").read_bytes()
    assert (tmp_path / "a.idx").read_text() == \
        (tmp_path / "b.idx").read_text()
    raw = (tmp_path / "a.rec").read_bytes()
    magic, length = struct.unpack("<II", raw[:8])
    assert magic == 0xCED7230A and len(raw) % 4 == 0


@pytest.mark.parametrize("writer,reader", [("port", "mxtpu"),
                                           ("mxtpu", "port")])
def test_each_package_reads_the_others_file(mt, tmp_path, writer, reader):
    pk = {"port": mt.recordio, "mxtpu": mx_rio}
    recs = _records(seed=1)
    _write(pk[writer], tmp_path / "x.idx", tmp_path / "x.rec", recs)
    rio = pk[reader]
    r = rio.MXIndexedRecordIO(str(tmp_path / "x.idx"),
                              str(tmp_path / "x.rec"), "r")
    assert r.keys == [k for k, _, _ in recs]
    for key, header, payload in reversed(recs):
        got, s = rio.unpack(r.read_idx(key))
        assert s == payload
        assert (got.flag, got.id, got.id2) == (
            0 if isinstance(header[1], float) else len(header[1]),
            header[2], header[3])
        np.testing.assert_array_equal(np.asarray(got.label, np.float32),
                                      np.asarray(header[1], np.float32))
    r.close()
    seq = rio.MXRecordIO(str(tmp_path / "x.rec"), "r")
    n = 0
    while seq.read() is not None:
        n += 1
    assert n == len(recs)
    seq.reset()
    assert rio.unpack(seq.read())[1] == recs[0][2]
    seq.close()


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_and_unpack_img_cross(mt, tmp_path, fmt):
    rng = np.random.RandomState(2)
    img = rng.randint(0, 255, (24, 20, 3), dtype=np.uint8)
    header = mt.recordio.IRHeader(0, [1.0, 2.0], 5, 0)
    ours = mt.recordio.pack_img(header, img, quality=90, img_fmt=fmt)
    theirs = mx_rio.pack_img(mx_rio.IRHeader(*header), img, quality=90,
                             img_fmt=fmt)
    assert ours == theirs
    h1, a = mt.recordio.unpack_img(theirs)
    h2, b = mx_rio.unpack_img(ours)
    np.testing.assert_array_equal(a, b)
    assert h1.id == h2.id == 5
    if fmt == ".png":
        np.testing.assert_array_equal(a, img)


def test_raw0_records_read_in_both(mt):
    """mxtpu's PIL-less form: ``RAW0``, the (h, w, c) shape, the bytes."""
    img = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
    body = b"RAW0" + struct.pack("<III", 4, 5, 3) + img.tobytes()
    for rio in (mt.recordio, mx_rio):
        packed = rio.pack(rio.IRHeader(0, 3.0, 1, 0), body)
        for other in (mt.recordio, mx_rio):
            h, got = other.unpack_img(packed)
            np.testing.assert_array_equal(got, img)
            assert h.label == 3.0
    gray = np.arange(12, dtype=np.uint8).reshape(3, 4)
    body = b"RAW0" + struct.pack("<III", 3, 4, 1) + gray.tobytes()
    packed = mt.recordio.pack(mt.recordio.IRHeader(0, 0.0, 0, 0), body)
    np.testing.assert_array_equal(mt.recordio.unpack_img(packed)[1], gray)
    np.testing.assert_array_equal(mx_rio.unpack_img(packed)[1], gray)


def test_pack_and_unpack_bytes_are_mxtpus(mt):
    for header in [(0, 1.5, 3, 4), (0, [1.0, 2.0, 3.0], 1, 2),
                   (0, np.arange(6, dtype=np.float32), 0, 0)]:
        ours = mt.recordio.pack(mt.recordio.IRHeader(*header), b"abc")
        assert ours == mx_rio.pack(mx_rio.IRHeader(*header), b"abc")
        a, b = mt.recordio.unpack(ours), mx_rio.unpack(ours)
        assert a[1] == b[1] == b"abc"
        assert a[0].flag == b[0].flag
        np.testing.assert_array_equal(a[0].label, b[0].label)


def test_tell_seek_and_bad_flag(mt, tmp_path):
    rio = mt.recordio
    w = rio.MXRecordIO(str(tmp_path / "t.rec"), "w")
    positions = []
    for i in range(4):
        positions.append(w.tell())
        w.write(b"x" * (i + 1))
    w.close()
    w.close()  # idempotent
    assert positions == [0, 12, 24, 36]
    r = rio.MXRecordIO(str(tmp_path / "t.rec"), "r")
    r.seek(positions[2])
    assert r.read() == b"xxx" and r.tell() == positions[3]
    r.close()
    with pytest.raises(ValueError):
        rio.MXRecordIO(str(tmp_path / "t.rec"), "a")
    with pytest.raises(mt.MXNetError, match="cannot open"):
        rio.MXRecordIO(str(tmp_path / "missing" / "t.rec"), "r")


def test_native_library_is_built_into_build_dir(mt):
    from mxtpu_torch import _native
    path = _native.library_path()
    assert path.parent == mt.build.BUILD_DIR
    assert "mxtpu" + "/native" not in str(path)
    _native.get_lib()
    assert path.exists()
    assert list(_native.SOURCES) == ["storage.cc", "recordio.cc",
                                     "engine.cc", "c_api.cc"]


def test_failed_build_raises_with_the_compilers_output(mt, tmp_path,
                                                       monkeypatch):
    from mxtpu_torch import _native
    for name in _native.SOURCES:
        (tmp_path / name).write_text((_native.SRC_DIR / name).read_text())
    for h in _native.SRC_DIR.glob("*.h"):
        (tmp_path / h.name).write_text(h.read_text())
    (tmp_path / "recordio.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(_native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "out")
    assert _native.library_path().parent == tmp_path / "out"
    with pytest.raises(mt.MXNetError,
                       match="(?s)g\\+\\+ failed.*recordio.cc.*error"):
        _native.build()
    assert not list((tmp_path / "out").glob("*.so"))


def test_the_library_is_named_by_its_g_plus_plus(mt, monkeypatch):
    """Only the g++ on PATH builds the runtime; another g++ (path or
    version) names another library, and none at all raises."""
    from mxtpu_torch import _native
    here = _native.library_path()
    gxx, banner = _native._gxx()
    assert shutil.which("g++") == gxx and "g++" in os.path.basename(gxx)
    monkeypatch.setattr(_native, "_gxx", lambda: (gxx, banner + "x"))
    assert _native.library_path() != here
    monkeypatch.setattr(_native, "_gxx", lambda: ("/other/g++", banner))
    assert _native.library_path() != here
    monkeypatch.undo()
    monkeypatch.setenv("CXX", "/no/such/compiler")
    assert _native.library_path() == here
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    with pytest.raises(mt.MXNetError, match="g\\+\\+ not found"):
        _native.library_path()


def test_importing_the_record_pipeline_builds_and_loads_nothing():
    """A fresh interpreter imports the record modules: the native library
    is neither built nor loaded until a reader or iterator is made, and
    neither JAX nor mxtpu is imported."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import mxtpu_torch\n"
            "from mxtpu_torch import recordio, image, image_record, _native\n"
            "from mxtpu_torch.image import detection\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'mxtpu', 'cv2'))\n"
            "print(_native._lib is None, bad)\n" % repo)
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True []"
