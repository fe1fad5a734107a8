"""The port's HDF5 reader and writer (gd3d_torch/data/hdf5.py) against h5py,
which gd3d reads MegaDepth's depth and the HDF5 stereo / flow ground truth
with and writes .flo5 flows with: every layout, chunk index, filter and
numeric type that h5py writes at its default file format, with
libver="latest" and with "v108" (superblocks 0, 3 and 2) reads back to
h5py's array bit for bit (dtype and byte order included); the writer's
files read back equal through h5py; what stays unsupported raises a
ValueError naming the file and the feature."""
import os
import sys

import h5py
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_threads import one_torch_thread  # noqa: E402,F401
from gd3d_torch.data import hdf5  # noqa: E402

A = np.random.RandomState(0).rand(37, 29, 2).astype(np.float32)

CASES = {
    "contiguous": {},
    "compact": {"compact": True},
    "gzip_auto_chunks": dict(compression="gzip", compression_opts=5),
    "gzip_shuffle_fletcher32": dict(compression="gzip", shuffle=True, fletcher32=True,
                                    chunks=(8, 8, 2)),
    "chunks_no_filter": dict(chunks=(5, 7, 2)),
    "single_chunk": dict(chunks=(37, 29, 2)),
    "single_chunk_gzip": dict(chunks=(37, 29, 2), compression="gzip"),
    "unlimited_first": dict(chunks=(4, 8, 2), maxshape=(None, 29, 2)),
    "unlimited_first_gzip": dict(chunks=(4, 8, 2), maxshape=(None, 29, 2), compression="gzip"),
    "unlimited_middle": dict(chunks=(4, 8, 2), maxshape=(37, None, 2)),
    "unlimited_two": dict(chunks=(4, 8, 2), maxshape=(None, None, 2)),
    "unlimited_two_gzip": dict(chunks=(4, 8, 2), maxshape=(None, None, 2), compression="gzip",
                               shuffle=True),
    "unlimited_two_deep": dict(chunks=(1, 1, 2), maxshape=(None, None, 2), compression="gzip",
                               big=(60, 70, 2)),
    "maxshape_larger": dict(chunks=(4, 8, 2), maxshape=(80, 40, 2)),
    "paged_fixed_array": dict(chunks=(1, 1, 2)),
    "paged_fixed_array_gzip": dict(chunks=(1, 1, 2), compression="gzip"),
    "extensible_array_blocks": dict(chunks=(1, 29, 2), maxshape=(None, 29, 2),
                                    big=(3000, 29, 2)),
    "fill_value_partial": dict(chunks=(5, 5, 2), fillvalue=7.5, partial=True),
    "float64_big_endian": dict(dtype=">f8", chunks=(8, 8, 2), compression="gzip"),
    "float16": dict(dtype="<f2"),
    "int16_big_endian": dict(dtype=">i2", chunks=(9, 9, 1)),
    "uint8_gzip": dict(dtype="u1", compression="gzip"),
    "int64": dict(dtype="<i8"),
    "uint32_shuffle": dict(dtype="<u4", chunks=(6, 6, 2), shuffle=True),
}


def write_h5py(path, libver, kw, name="x"):
    kw = dict(kw)
    dtype, compact = kw.pop("dtype", None), kw.pop("compact", False)
    partial, big = kw.pop("partial", False), kw.pop("big", None)
    data = A if dtype is None else (A * 1000).astype(dtype)
    if big:
        data = np.random.RandomState(1).rand(*big).astype(np.float32)
    with h5py.File(path, "w", libver=libver) as f:
        if compact:
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            sid = h5py.h5s.create_simple(data.shape)
            dsid = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype), sid,
                                   dcpl=dcpl)
            dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        elif partial:
            d = f.create_dataset(name, shape=data.shape, dtype=data.dtype, **kw)
            d[:10, :10] = data[:10, :10]
        else:
            f.create_dataset(name, data=data, **kw)


@pytest.mark.parametrize("libver", ["earliest", "v108", "latest"])  # superblocks 0, 2, 3
@pytest.mark.parametrize("case", sorted(CASES))
def test_read_matches_h5py(tmp_path, libver, case):
    path = tmp_path / f"{case}.h5"
    write_h5py(path, libver, CASES[case])
    with h5py.File(path) as f:
        want = np.asarray(f["x"])
    got = hdf5.read_dataset(path, "x")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_groups_and_paths_match_h5py(tmp_path, libver):
    """Nested groups, and a symbol-table group of 40 links (several SNOD
    nodes under its B-tree)."""
    path = tmp_path / "g.h5"
    rng = np.random.RandomState(2)
    with h5py.File(path, "w", libver=libver) as f:
        for i in range(40 if libver == "earliest" else 6):
            f.create_dataset(f"a/b/d{i:02d}", data=rng.rand(3, 4))
        f.create_dataset("top", data=rng.rand(5))
    with h5py.File(path) as f:
        for name in ("a/b/d00", "a/b/d05", "/top") + (("a/b/d39",) if libver == "earliest" else ()):
            np.testing.assert_array_equal(hdf5.read_dataset(path, name), np.asarray(f[name]))
    with pytest.raises(ValueError, match="no object 'missing'"):
        hdf5.read_dataset(path, "a/missing")


@pytest.mark.parametrize("dtype", ["<f4", ">f8", "<f2", "<i4", ">u2", "u1"])
@pytest.mark.parametrize("shape", [(97, 131, 2), (7,), (1100, 700)])
def test_writer_reads_back_in_h5py(tmp_path, dtype, shape):
    x = (np.random.RandomState(3).rand(*shape) * 200).astype(dtype)
    path = tmp_path / "w.h5"
    hdf5.write_dataset(path, "flow", x)
    with h5py.File(path) as f:
        d = f["flow"]
        assert d.compression == "gzip" and d.compression_opts == 5 and d.chunks is not None
        got = np.asarray(d)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(hdf5.read_dataset(path, "flow"), x)


def _refusal(tmp_path, make, match):
    path = tmp_path / "r.h5"
    make(path)
    with pytest.raises(ValueError, match=match) as err:
        hdf5.read_dataset(path, "x")
    assert str(path) in str(err.value)


@pytest.mark.parametrize("what,match", [
    ("lzf", "lzf filter"),
    ("compound", "compound datatype"),
    ("string", "string datatype"),
    ("external_link", "external link"),
    ("soft_link", "soft link"),
    ("dense_links", "dense"),
    ("external_storage", "external storage"),
    ("virtual", "virtual"),
    ("scaleoffset", "scaleoffset filter"),
    ("not_hdf5", "not an HDF5 file"),
])
def test_unsupported_files_are_refused(tmp_path, what, match):
    def make(path):
        if what == "not_hdf5":
            path.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(100))
            return
        with h5py.File(path, "w", libver="latest") as f:
            if what == "lzf":
                f.create_dataset("x", data=A, compression="lzf")
            elif what == "scaleoffset":
                f.create_dataset("x", data=(A * 100).astype("i4"), scaleoffset=0)
            elif what == "compound":
                f.create_dataset("x", data=np.zeros(4, [("a", "f4"), ("b", "i2")]))
            elif what == "string":
                f.create_dataset("x", data=np.array([b"ab", b"cd"]))
            elif what == "external_link":
                f["x"] = h5py.ExternalLink("other.h5", "/y")
            elif what == "soft_link":
                f.create_dataset("y", data=A)
                f["x"] = h5py.SoftLink("/y")
            elif what == "dense_links":
                for i in range(12):
                    f.create_dataset(f"d{i}", data=A[:2])
                f.create_dataset("x", data=A)
            elif what == "external_storage":
                ext = str(path) + ".raw"
                A.tofile(ext)
                f.create_dataset("x", shape=A.shape, dtype=A.dtype, external=[(ext, 0, A.nbytes)])
            elif what == "virtual":
                layout = h5py.VirtualLayout(shape=(4,), dtype="f4")
                layout[:] = h5py.VirtualSource("src.h5", "y", shape=(4,))
                f.create_virtual_dataset("x", layout)
    _refusal(tmp_path, make, match)
