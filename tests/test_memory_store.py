"""The in-memory store (io.memory) holds what the HDF5 file would: same datasets, values,
shapes, dtypes and attributes, through the same readers and writers."""

import numpy as np
import pytest

from kwave_tpu.driver import RunConfig, run_simulation
from kwave_tpu.io.hdf5 import is_group, open_file
from kwave_tpu.io.input_file import InputData, read_input_file, write_input_file
from kwave_tpu.io.memory import MemoryFile
from kwave_tpu.solver import Grid, Medium


def _input(nt=47, corners=False):
    n = 16
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt)
    rng = np.random.default_rng(5)
    c0 = (1500.0 + 40.0 * rng.random(grid.shape)).astype(np.float32)
    src = np.arange(40, 60, dtype=np.int64)
    t = np.arange(nt, dtype=np.float32)
    kw = dict(sensor_mask_corners=np.array([[2, 3, 4, 6, 7, 9], [10, 10, 10, 12, 11, 13]])
              ) if corners else dict(sensor_mask_index=np.sort(
                  rng.choice(grid.n_elements, 48, replace=False)).astype(np.int64))
    return InputData(
        grid=grid, medium=Medium(c0=c0, rho0=1000.0, alpha_coeff=0.5, alpha_power=1.5),
        pml_size=(3, 3, 3), pml_alpha=(2.0,) * 3, absorbing=True,
        p_source_index=src, p_source_flag=nt, p_source_mode=1,
        p_source_input=(10.0 * np.sin(2 * np.pi * t / 10.0)).astype(np.float32),
        **kw,
    )


def _items(group, prefix=""):
    for k in sorted(group.keys()):
        obj = group[k]
        if is_group(obj):
            yield from _items(obj, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", obj


def test_input_roundtrip_memory_matches_hdf5(tmp_path):
    data = _input()
    path = str(tmp_path / "in.h5")
    mem = MemoryFile()
    write_input_file(path, data)
    write_input_file(mem, data)
    with open_file(path) as f:
        disk = {k: (np.asarray(d), dict(d.attrs)) for k, d in _items(f)}
    memd = {k: (np.asarray(d), dict(d.attrs)) for k, d in _items(mem)}
    assert disk.keys() == memd.keys()
    for k, (a, attrs) in disk.items():
        b, attrs_m = memd[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert attrs.keys() == attrs_m.keys(), k
    a, b = read_input_file(path), read_input_file(mem)
    assert a.grid == b.grid
    np.testing.assert_array_equal(a.medium.c0, b.medium.c0)
    np.testing.assert_array_equal(a.sensor_mask_index, b.sensor_mask_index)
    np.testing.assert_array_equal(a.p_source_input, b.p_source_input)


def test_memory_file_behaves_like_a_file():
    f = MemoryFile()
    ds = f.create_dataset("x", shape=(2, 3), dtype=np.float32, chunks=(1, 3),
                          compression="gzip", compression_opts=4)
    ds[0, :] = [1, 2, 3]
    ds.attrs.create("tag", np.bytes_(b"float"))
    grp = f.create_group("g")
    grp.create_dataset("1", data=np.arange(4, dtype=np.uint64))
    with pytest.raises(ValueError):
        f.create_dataset("x", shape=(1,))
    assert is_group(f["g"]) and not is_group(f["x"])
    f.close()  # closing keeps the contents: the store can be opened again
    with open_file(f, "r+") as g:
        assert g is f
        np.testing.assert_array_equal(g["x"][0], [1, 2, 3])
        assert g["x"].attrs["tag"] == b"float" and g["g"]["1"].dtype == np.uint64
        assert np.asarray(g["x"]).shape == (2, 3) and len(g["x"]) == 2
    assert len(open_file(f, "w")) == 0 and not f.attrs  # "w" truncates, as h5py does


@pytest.mark.parametrize("case", ["float_aggregates", "40bit_velocity_intensity",
                                  "cuboid_40bit", "no_overlap_fields"])
def test_run_into_memory_matches_hdf5(tmp_path, case):
    flags, kw, corners = {
        "float_aggregates": (dict(p_raw=True, p_c=True, p_rms=True, p_max=True,
                                  p_min=True), {}, False),
        "40bit_velocity_intensity": (dict(p_c=True, u_non_staggered_c=True),
                                     dict(mode40=True, i_avg_c=True, harmonics=2), False),
        "cuboid_40bit": (dict(p_raw=True, p_c=True), dict(mode40=True), True),
        "no_overlap_fields": (dict(p_c=True, p_final=True, p_max_all=True, u_raw=True),
                              dict(no_overlap=True), False),
    }[case]
    data = _input(corners=corners)
    run = RunConfig(flags=flags, period=10.0, **kw)
    path = str(tmp_path / "out.h5")
    mem = MemoryFile()
    run_simulation(data, run, path)
    run_simulation(data, run, mem)
    with open_file(path) as f:
        disk = {k: (np.asarray(d), dict(d.attrs)) for k, d in _items(f)}
        file_type = f.attrs["file_type"]
    memd = {k: (np.asarray(d), dict(d.attrs)) for k, d in _items(mem)}
    assert disk.keys() == memd.keys() and disk
    for k, (a, attrs) in disk.items():
        b, attrs_m = memd[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert attrs.keys() == attrs_m.keys(), k
        for name, v in attrs.items():
            np.testing.assert_array_equal(v, attrs_m[name], err_msg=f"{k}@{name}")
    assert mem.attrs["file_type"] == file_type
