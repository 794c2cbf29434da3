"""In-memory stand-in for the part of h5py that the file contract uses.

A `MemoryFile` goes wherever the readers and writers take a file path
(`io.hdf5.open_file` passes it through), so the input reader, the driver and the
output writer run unchanged where h5py is not installed, with every dataset
held as a NumPy array. Chunking and gzip options are storage layout and are
ignored: values, shapes, dtypes and attributes are what the h5py file would
hold. Nothing is written to disk.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class Attrs(dict):
    """Attribute dict with h5py's ``attrs.create(name, value)`` spelling."""

    def create(self, name: str, value: Any) -> None:
        self[name] = value


class MemoryDataset:
    """A NumPy array with an attribute dict, indexed like an h5py dataset."""

    def __init__(self, data: np.ndarray):
        self._data = data
        self.attrs = Attrs()

    @property
    def shape(self) -> tuple[int, ...]:
        return self._data.shape

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def dtype(self) -> np.dtype:
        return self._data.dtype

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, key):
        return np.array(self._data[key])  # h5py reads return fresh arrays

    def __setitem__(self, key, value) -> None:
        self._data[key] = value

    def __array__(self, dtype=None, copy=None):
        return np.array(self._data, dtype=dtype)


class MemoryGroup:
    """Named datasets and sub-groups, with h5py's create/lookup methods."""

    def __init__(self):
        self._items: dict[str, Any] = {}
        self.attrs = Attrs()

    def create_dataset(self, name: str, shape=None, dtype=None, data=None,
                       **storage) -> MemoryDataset:
        """``storage`` takes h5py's chunks/compression keywords, which do not change
        what a read returns."""
        if name in self._items:
            raise ValueError(f"dataset {name!r} already exists")
        if data is not None:
            arr = np.array(data, dtype=dtype)
        else:
            arr = np.zeros(shape, dtype if dtype is not None else np.float32)
        ds = MemoryDataset(arr)
        self._items[name] = ds
        return ds

    def create_group(self, name: str) -> "MemoryGroup":
        if name in self._items:
            raise ValueError(f"group {name!r} already exists")
        grp = MemoryGroup()
        self._items[name] = grp
        return grp

    def __getitem__(self, name: str):
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def keys(self):
        return self._items.keys()

    def items(self):
        return self._items.items()


class MemoryFile(MemoryGroup):
    """Root group. Opening it with mode ``"w"`` empties it, as h5py truncates a file;
    closing it keeps its contents, so it can be opened again and read."""

    def clear(self) -> None:
        self._items.clear()
        self.attrs.clear()

    def close(self) -> None:
        pass

    def __enter__(self) -> "MemoryFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
