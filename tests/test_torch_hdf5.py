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
    ("virtual", "virtual"),
    ("reference", "reference datatype"),
    ("not_hdf5", "not an HDF5 file"),
])
def test_unsupported_files_are_refused(tmp_path, what, match):
    def make(path):
        if what == "not_hdf5":
            path.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(100))
            return
        with h5py.File(path, "w", libver="latest") as f:
            if what == "reference":
                f.create_dataset("y", data=A)
                f.create_dataset("x", data=np.array([f["y"].ref] * 2, h5py.ref_dtype))
            elif what == "virtual":
                layout = h5py.VirtualLayout(shape=(4,), dtype="f4")
                layout[:] = h5py.VirtualSource("src.h5", "y", shape=(4,))
                f.create_virtual_dataset("x", layout)
    _refusal(tmp_path, make, match)


# Files of every filter, type, link and storage kind beyond the numeric
# datasets above that h5py writes (see write_case); each read back as h5py's
# dset[()] (dtype, shape and values; object arrays element by element)
MORE_CASES = [
    "lzf", "lzf_incompressible", "szip_f4", "szip_f8", "szip_i2", "szip_i2be", "szip_u1",
    "szip_smooth", "nbit_i31", "nbit_i10", "nbit_f4", "nbit_u16", "scaleoffset",
    "scaleoffset_be", "scaleoffset_float", "scaleoffset_double", "compound", "compound_nested",
    "string", "string_nullterm", "string_spacepad", "vlen_str", "vlen_str_v0", "vlen_seq",
    "enum", "array", "soft_link", "soft_link_rel", "soft_link_v0", "external_link",
    "dense_links", "external_storage", "offsets_2", "offsets_4", "int10_no_filter",
]


def write_case(path, what, data=None):
    """Write the HDF5 file of case `what` (MORE_CASES) at `path` with h5py;
    `data` (float32, 3-d, default A) sets the numbers. Returns the name of the
    dataset to read. External files go beside `path` (the external-storage
    file under a name relative to the working directory, which must be
    path's directory, as HDF5 resolves it from there)."""
    A = globals()["A"] if data is None else data
    rng = np.random.RandomState(len(what))
    path = str(path)
    libver = "earliest" if what.endswith("_v0") else "latest"
    if what.startswith("offsets_"):
        size = int(what.split("_")[1])
        fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
        fcpl.set_sizes(size, size)
        fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
        with h5py.File(fid) as f:
            f.create_dataset("g/x", data=A[:6], chunks=(2, 8, 2), compression="gzip")
            f.create_dataset("c", data=A[:3])
        return "g/x"
    chunks = (min(8, A.shape[0]), min(8, A.shape[1]), A.shape[2])
    with h5py.File(path, "w", libver=libver) as f:
        if what == "lzf":
            f.create_dataset("x", data=A, compression="lzf", chunks=chunks)
        elif what == "lzf_incompressible":
            f.create_dataset("x", data=rng.randint(0, 255, (40, 40), "u1"), compression="lzf")
        elif what.startswith("szip"):
            kind = what.split("_")[1]
            x = {"f4": (A - 0.5) * 10, "i2": ((A - 0.5) * 2000).astype("<i2"),
                 "u1": (A * 255).astype("u1"), "f8": A.astype(">f8"),
                 "i2be": ((A - 0.5) * 2000).astype(">i2"),
                 "smooth": np.cumsum(np.ones(A.shape, "<i4"), 1).astype("<i4")}[kind]
            opts = ("ec", 16) if kind in ("i2", "smooth") else ("nn", 8)
            f.create_dataset("x", data=x, compression="szip", compression_opts=opts,
                             chunks=(min(16, A.shape[0]),) + A.shape[1:])
        elif what.startswith("nbit"):
            kind = what.split("_")[1]
            base = {"i31": h5py.h5t.STD_I32LE, "i10": h5py.h5t.STD_I16BE,
                    "f4": h5py.h5t.IEEE_F32LE, "u16": h5py.h5t.STD_U16LE}[kind].copy()
            if kind in ("i31", "i10"):
                base.set_precision(31 if kind == "i31" else 10)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk(chunks)
            dcpl.set_filter(h5py.h5z.FILTER_NBIT, h5py.h5z.FLAG_OPTIONAL)
            did = h5py.h5d.create(f.id, b"x", base, h5py.h5s.create_simple(A.shape), dcpl=dcpl)
            vals = {"i31": ((A - 0.5) * 3e6).astype("<i4"), "i10": ((A - 0.5) * 900).astype("<i2"),
                    "f4": A, "u16": (A * 60000).astype("<u2")}[kind]
            did.write(h5py.h5s.ALL, h5py.h5s.ALL, vals)
        elif what == "int10_no_filter":  # a 10-bit integer in 2 bytes, no filter
            t = h5py.h5t.STD_I16BE.copy()
            t.set_precision(10)
            did = h5py.h5d.create(f.id, b"x", t, h5py.h5s.create_simple((6,)))
            did.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array([-600, -3, 0, 7, 511, 700], "<i2"))
        elif what.startswith("scaleoffset"):
            x = {"scaleoffset": ((A - 0.3) * 1000).astype("<i4"),
                 "scaleoffset_be": ((A - 0.3) * 1000).astype(">i2"),
                 "scaleoffset_float": (A - 0.5) * 7,
                 "scaleoffset_double": ((A - 0.5) * 7).astype("<f8")}[what]
            factor = {"scaleoffset_float": 3, "scaleoffset_double": 2}.get(what, 0)
            f.create_dataset("x", data=x, scaleoffset=factor, chunks=chunks)
        elif what == "compound":
            x = np.zeros(6, [("a", "<f4"), ("b", ">i2"), ("c", "u1")])
            x["a"], x["b"], x["c"] = rng.rand(6), rng.randint(-99, 99, 6), np.arange(6)
            f.create_dataset("x", data=x, chunks=(4,), compression="gzip")
        elif what == "compound_nested":
            inner = np.dtype([("u", "<i4"), ("v", "<f8", (2,))])
            x = np.zeros((3, 2), [("p", inner), ("q", "S3"), ("r", "<f2")])
            x["p"]["u"] = rng.randint(0, 9, (3, 2))
            x["p"]["v"] = rng.rand(3, 2, 2)
            x["q"] = [[b"ab", b"c"], [b"def", b""], [b"x", b"yz"]]
            x["r"] = rng.rand(3, 2)
            f.create_dataset("x", data=x)
        elif what == "string":
            f.create_dataset("x", data=np.array([b"ab", b"cd", b"", b"xyz"]))
        elif what in ("string_nullterm", "string_spacepad"):
            t = h5py.h5t.C_S1.copy()
            t.set_size(5)
            t.set_strpad(h5py.h5t.STR_NULLTERM if what == "string_nullterm"
                         else h5py.h5t.STR_SPACEPAD)
            did = h5py.h5d.create(f.id, b"x", t, h5py.h5s.create_simple((4,)))
            did.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array([b"ab", b"cdefg", b"", b"x y"], "S5"))
        elif what.startswith("vlen_str"):
            f.create_dataset("x", data=np.array(["a", "bc\u00e9", "", "long string " * 3], object),
                             dtype=h5py.string_dtype())
        elif what == "vlen_seq":
            d = f.create_dataset("x", (4,), dtype=h5py.vlen_dtype(np.dtype("<i4")))
            for i in range(4):
                d[i] = np.arange(i * 3, dtype="<i4") - i
        elif what == "enum":
            dt = h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 42}, basetype="i2")
            f.create_dataset("x", data=np.array([0, 42, 1, 1], "i2"), dtype=dt)
        elif what == "array":
            t = h5py.h5t.array_create(h5py.h5t.IEEE_F32LE, (3, 2))
            did = h5py.h5d.create(f.id, b"x", t, h5py.h5s.create_simple((5,)))
            buf = rng.rand(5, 3, 2).astype("<f4").tobytes()
            did.write(h5py.h5s.ALL, h5py.h5s.ALL, np.frombuffer(buf, [("a", "<f4", (3, 2))]),
                      mtype=t)
        elif what.startswith("soft_link"):
            f.create_dataset("g/y", data=A)
            if what == "soft_link_v0":
                f["x"] = h5py.SoftLink("/g/y")
                return "x"
            f["g2/x"] = h5py.SoftLink("/g/y")
            f["x"] = h5py.SoftLink("g2/x")
            f["g/rel"] = h5py.SoftLink("y")
            return "g/rel" if what.endswith("rel") else "x"
        elif what == "external_link":
            other = os.path.join(os.path.dirname(path), "external_link_target.h5")
            with h5py.File(other, "w") as g:
                g.create_dataset("grp/y", data=A)
            f["x"] = h5py.ExternalLink("external_link_target.h5", "/grp/y")
        elif what == "dense_links":
            for i in range(12):
                f.create_dataset(f"d{i}", data=np.float32(i))
            f.create_dataset("x", data=A)
        elif what == "external_storage":
            ext = os.path.basename(path) + ".raw"
            (A * 3).tofile(os.path.join(os.path.dirname(path), ext))
            f.create_dataset("x", shape=A.shape, dtype=A.dtype, external=[(ext, 0, A.nbytes)])
        else:
            raise KeyError(what)
    return "x"


def assert_same_as_h5py(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    if want.dtype != object:
        np.testing.assert_array_equal(got, want)
        return
    for a, b in zip(got.reshape(-1), want.reshape(-1)):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b


@pytest.mark.parametrize("what", MORE_CASES)
def test_more_files_match_h5py(tmp_path, monkeypatch, what):
    """Each filter (lzf, szip, n-bit, scale-offset), type (compound and
    nested, fixed and variable-length strings, sequences, enum, array, a
    narrow integer), link (soft, relative, in an old-style group, external,
    dense storage), external storage and small offset size that h5py
    writes reads back as h5py's dset[()]: the former refusals of lzf,
    compound, string, external and soft links, dense links, external
    storage and scale-offset among them."""
    monkeypatch.chdir(tmp_path)  # HDF5 finds external storage from here
    path = tmp_path / f"{what}.h5"
    name = write_case(path, what)
    with h5py.File(path) as f:
        want = f[name][()]
    assert_same_as_h5py(hdf5.read_dataset(path, name), want)


def test_external_link_file_is_found_beside_the_referring_file(tmp_path, monkeypatch):
    """HDF5 looks for an external link's file beside the referring file
    before the working directory; a missing one raises naming it."""
    sub = tmp_path / "sub"
    sub.mkdir()
    write_case(sub / "e.h5", "external_link")
    monkeypatch.chdir(tmp_path)
    np.testing.assert_array_equal(hdf5.read_dataset(sub / "e.h5", "x"), A)
    (sub / "external_link_target.h5").unlink()
    with pytest.raises(ValueError, match="external_link_target.h5"):
        hdf5.read_dataset(sub / "e.h5", "x")
