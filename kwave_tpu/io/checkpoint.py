"""Checkpoint file: the 7 field matrices + t_index + grid dims + per-stream coefficient
accumulators.

Contract from KSpaceFirstOrderSolver::saveCheckpointData (KSpaceFirstOrderSolver.cpp:
1176-1232) and BaseOutputStream::checkpoint (BaseOutputStream.cpp:551-606):

- file_type = "checkpoint"; scalars t_index, Nx, Ny, Nz
- matrices p, rhox, rhoy, rhoz, ux_sgx, uy_sgy, uz_sgz (MatrixContainer.cpp:29-42)
- compressed-stream state: `Temp_<dataset>_1` / `Temp_<dataset>_2` coefficient buffers
  (reloaded by loadCheckpointCompressionCoefficients, BaseOutputStream.cpp:528-544)
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from kwave_tpu.io import names
from kwave_tpu.io.hdf5 import (
    create_dataset,
    open_file,
    read_scalar,
    write_file_header,
    write_scalar,
)
from kwave_tpu.solver.step import SimState


_FIELD_NAMES = (
    ("p", names.P),
    ("rho_x", names.RHOX),
    ("rho_y", names.RHOY),
    ("rho_z", names.RHOZ),
    ("ux_sgx", names.UX_SGX),
    ("uy_sgy", names.UY_SGY),
    ("uz_sgz", names.UZ_SGZ),
)


def write_checkpoint(
    path: str,
    state: SimState,
    t_index: int,
    grid_shape: tuple[int, int, int],  # (nx, ny, nz)
    stream_coeffs: Optional[dict[str, tuple[np.ndarray, Optional[np.ndarray]]]] = None,
) -> None:
    """stream_coeffs: dataset name -> (buffer1, buffer2|None), flat float arrays in the
    reference interleaved layout (encoder.frames_to_flat_*)."""
    nx, ny, nz = grid_shape
    with open_file(path, "w") as f:
        write_file_header(f, names.FILE_TYPE_CHECKPOINT)
        write_scalar(f, names.T_INDEX, int(t_index))
        write_scalar(f, names.NX, nx)
        write_scalar(f, names.NY, ny)
        write_scalar(f, names.NZ, nz)
        for attr, dname in _FIELD_NAMES:
            v = getattr(state, attr)
            if v is None:
                continue
            arr = np.asarray(v, np.float32)
            full = arr.reshape((nz, ny, nx))
            ds = create_dataset(f, dname, (nz, ny, nx))
            ds[...] = full
        for sname, (buf1, buf2) in (stream_coeffs or {}).items():
            d1 = np.asarray(buf1, np.float32).reshape(-1)
            ds = create_dataset(f, f"Temp_{sname}_1", (1, 1, d1.size))
            ds[...] = d1.reshape(1, 1, -1)
            if buf2 is not None:
                d2 = np.asarray(buf2, np.float32).reshape(-1)
                ds = create_dataset(f, f"Temp_{sname}_2", (1, 1, d2.size))
                ds[...] = d2.reshape(1, 1, -1)


def read_checkpoint(path: str) -> dict[str, Any]:
    """Returns {'t_index', 'grid_shape', 'fields': {name: array}, 'stream_coeffs':
    {stream: (buf1, buf2|None)}} (recovery path, KSpaceFirstOrderSolver.cpp:186-228)."""
    with open_file(path, "r") as f:
        out: dict[str, Any] = {
            "t_index": read_scalar(f, names.T_INDEX),
            "grid_shape": (
                read_scalar(f, names.NX),
                read_scalar(f, names.NY),
                read_scalar(f, names.NZ),
            ),
            "fields": {},
            "stream_coeffs": {},
        }
        for _, dname in _FIELD_NAMES:
            if dname in f:
                out["fields"][dname] = np.asarray(f[dname], np.float32)
        temps = [k for k in f.keys() if k.startswith("Temp_")]
        for k in temps:
            if k.endswith("_1"):
                sname = k[len("Temp_") : -2]
                buf1 = np.asarray(f[k], np.float32).reshape(-1)
                k2 = f"Temp_{sname}_2"
                buf2 = np.asarray(f[k2], np.float32).reshape(-1) if k2 in f else None
                out["stream_coeffs"][sname] = (buf1, buf2)
        return out
