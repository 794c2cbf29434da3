"""Low-level HDF5 helpers reproducing the reference's encodings (Hdf5/Hdf5File.cpp).

- Scalars: (1,1,1)-shaped datasets, u64 for sizes/flags, float32 for physics scalars
  (Hdf5File.h:810-822; writeScalarValue template instantiations).
- Datasets: chunked, gzip-deflate at the run's compression level, tagged with fixed-length
  `data_type` ("float"|"long") and `domain_type` ("real"|"complex") attributes
  (Hdf5File.cpp:59-68, 877-917).
- File header: root-group string attributes (Hdf5FileHeader.cpp:62-88).
"""

from __future__ import annotations

import datetime
import socket
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:
    import h5py

from kwave_tpu.io import names
from kwave_tpu.io.memory import MemoryFile


def open_file(target, mode: str = "r", **kwargs):
    """Open an HDF5 file: an h5py.File for a path, or the given `io.memory.MemoryFile`
    itself (emptied first when ``mode`` is ``"w"``). The one place that imports h5py, so
    a machine without it can still run everything that is handed a MemoryFile."""
    if isinstance(target, MemoryFile):
        if mode == "w":
            target.clear()
        return target
    import h5py

    return h5py.File(target, mode, **kwargs)


def is_group(obj) -> bool:
    """True for an HDF5 group (h5py or in-memory), false for a dataset."""
    return hasattr(obj, "keys")


def _fixed_str(value: str) -> np.bytes_:
    """Fixed-length C string attribute (the reference writes H5T_C_S1 of exact size)."""
    return np.bytes_(value.encode())


def write_attr(obj, name: str, value) -> None:
    if isinstance(value, str):
        obj.attrs.create(name, _fixed_str(value))
    elif isinstance(value, (int, np.integer)):
        obj.attrs.create(name, np.int64(value))  # writeLongLongAttribute (ssize_t)
    elif isinstance(value, (float, np.floating)):
        obj.attrs.create(name, np.float32(value))  # writeFloatAttribute
    else:
        obj.attrs.create(name, value)


def read_attr(obj, name: str):
    v = obj.attrs[name]
    if isinstance(v, bytes):
        return v.decode()
    return v


def write_scalar(f: h5py.File, name: str, value, dtype=None) -> None:
    """(1,1,1) scalar dataset; u64 for ints, float32 for floats (Hdf5File readScalarValue
    counterpart, Hdf5File.h:810-822)."""
    if dtype is None:
        dtype = np.uint64 if isinstance(value, (int, np.integer)) else np.float32
    arr = np.full((1, 1, 1), value, dtype=dtype)
    ds = f.create_dataset(name, data=arr)
    tag_dataset(ds, data=names.DATA_FLOAT if dtype == np.float32 else names.DATA_LONG)


def read_scalar(f: h5py.File, name: str):
    v = np.asarray(f[name]).reshape(-1)[0]
    return int(v) if np.issubdtype(v.dtype, np.integer) else float(v)


def tag_dataset(ds: h5py.Dataset, data: str = names.DATA_FLOAT,
                domain: str = names.DOMAIN_REAL) -> None:
    """data_type / domain_type attributes (Hdf5File::writeMatrixDataType/DomainType,
    Hdf5File.cpp:896-917)."""
    ds.attrs.create(names.DATA_TYPE, _fixed_str(data))
    ds.attrs.create(names.DOMAIN_TYPE, _fixed_str(domain))


def create_dataset(
    f,
    name: str,
    shape: tuple[int, ...],
    chunks: Optional[tuple[int, ...]] = None,
    compression_level: int = 0,
    dtype=np.float32,
    domain: str = names.DOMAIN_REAL,
) -> h5py.Dataset:
    """Chunked, gzip-deflated dataset with type tags (Hdf5File::createDataset,
    Hdf5File.cpp:321-367). Shapes are C-order (slowest first) — callers pass the
    already-reversed (nz, ny, nx) tuple."""
    kwargs = {}
    if chunks is not None:
        kwargs["chunks"] = tuple(min(c, s) if s > 0 else c for c, s in zip(chunks, shape))
    if compression_level > 0:
        kwargs["compression"] = "gzip"
        kwargs["compression_opts"] = compression_level
    ds = f.create_dataset(name, shape=shape, dtype=dtype, **kwargs)
    tag_dataset(
        ds,
        data=names.DATA_FLOAT if dtype == np.float32 else names.DATA_LONG,
        domain=domain,
    )
    return ds


def write_file_header(
    f: h5py.File,
    file_type: str,
    major: str = "1",
    minor: str = "1",
    created_by: str = "kwave_tpu v0.1",
) -> None:
    """Root-group header attribute block (Hdf5FileHeader; attr names :70-88)."""
    write_attr(f, names.FILE_TYPE, file_type)
    write_attr(f, names.MAJOR_VERSION, major)
    write_attr(f, names.MINOR_VERSION, minor)
    write_attr(f, names.CREATED_BY, created_by)
    write_attr(
        f, names.CREATION_DATE, datetime.datetime.now().strftime("%d/%m/%y %H:%M:%S")
    )
    write_attr(f, names.FILE_DESCRIPTION, "kwave_tpu simulation output")
    write_attr(f, names.HOST_NAMES, socket.gethostname())


def read_file_type(f: h5py.File) -> str:
    return read_attr(f, names.FILE_TYPE)


#: File versions the reader accepts, matching the reference
#: (Hdf5FileHeader::checkMajorFileVersion/checkMinorFileVersion accept major "1",
#: minor "0" or "1" — Hdf5/Hdf5FileHeader.h:201-348).
SUPPORTED_MAJOR = "1"
SUPPORTED_MINORS = ("0", "1")


def validate_file_header(f: h5py.File, expected_type: str, path: str = "") -> None:
    """Fail fast with an actionable error when a file of the wrong kind or an
    unsupported version is opened (the reference validates file_type and
    major/minor version on open and terminates with a clear message,
    Hdf5/Hdf5FileHeader.h:201-348 wired via Parameters::readScalarsFromInputFile;
    without this, a checkpoint/output/v1.0 file passed as ``-i`` dies with a
    KeyError deep inside the dataset reader)."""
    where = f" {path!r}" if path else ""
    try:
        ftype = read_attr(f, names.FILE_TYPE)
    except KeyError:
        raise ValueError(
            f"file{where} has no 'file_type' attribute — not a k-Wave HDF5 "
            f"{expected_type} file (expected file_type={expected_type!r})"
        ) from None
    if ftype != expected_type:
        hint = {
            names.FILE_TYPE_CHECKPOINT:
                " (a checkpoint file goes to the checkpoint/resume option, "
                "not the input)",
            names.FILE_TYPE_OUTPUT:
                " (an output file is a simulation result; pass it to --post, "
                "not as the input)",
        }.get(ftype, "")
        raise ValueError(
            f"file{where} is a k-Wave {ftype!r} file, not an "
            f"{expected_type!r} file{hint}"
        )
    major = str(read_attr(f, names.MAJOR_VERSION)) if names.MAJOR_VERSION in f.attrs else "?"
    minor = str(read_attr(f, names.MINOR_VERSION)) if names.MINOR_VERSION in f.attrs else "?"
    if major != SUPPORTED_MAJOR or minor not in SUPPORTED_MINORS:
        supported = ", ".join(f"{SUPPORTED_MAJOR}.{m}" for m in SUPPORTED_MINORS)
        raise ValueError(
            f"file{where} has file version {major}.{minor}; this build supports "
            f"versions {supported} (Hdf5FileHeader.h:201-348 parity)"
        )
