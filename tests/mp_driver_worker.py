"""Worker for the two-process FULL-DRIVER test (run via subprocess, one per rank).

Runs the complete run_simulation over a global 4-device mesh spanning two processes
(2 virtual CPU devices each): z-sharded fields, pencil FFT over the process boundary,
GSPMD stream processing, and the process-0 writer receiving every emission through
WriterGather (driver._host) — non-writer ranks ship only their addressable shards
to process 0; a tripwire below asserts `process_allgather` (the r3 replicate-to-all
path) is NEVER called, so no rank ever receives another rank's emissions.

Usage: python tests/mp_driver_worker.py <rank> <nprocs> <port> <out_h5> [mode]

mode "single" (default): one uninterrupted run.
mode "legs": interrupted two-leg run — leg 1 checkpoints mid-record, leg 2 resumes
from the checkpoint (multi-process recovery, the distributed generalization of the
reference's multi-leg main.cpp:147-169).
mode "die": failure injection — the HIGHEST rank exits hard (os._exit) right before
its second WriterGather send; the writer must fail fast with an error NAMING that
rank (never hang until the full timeout with no diagnosis).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=2").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def build_input():
    """Deterministic tiny 3D case — must match the reference run in the test."""
    from kwave_tpu.io.input_file import InputData
    from kwave_tpu.solver import Grid, Medium

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.sort(
        np.random.default_rng(3).choice(grid.n_elements, 64, replace=False)
    ).astype(np.int64)
    return InputData(
        grid=grid,
        medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4),
        pml_alpha=(2.0,) * 3,
        sensor_mask_index=mask,
        p0=p0,
    )


def build_input_cuboid():
    """Cuboid-corner mask variant: the writer's per-cuboid group assembly and the
    padded 40-bit cuboid rows cross the process boundary (mode 'cuboid')."""
    import numpy as np

    from kwave_tpu.io.input_file import InputData
    from kwave_tpu.solver import Grid, Medium

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=40)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    corners = np.array([[2, 2, 2, 7, 6, 5], [9, 9, 9, 12, 12, 12]])
    return InputData(
        grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        sensor_mask_corners=corners, p0=p0,
    )


def main() -> int:
    rank, nprocs, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "single"

    from kwave_tpu.parallel import make_mesh
    from kwave_tpu.parallel.distributed import initialize

    initialize(coordinator=f"localhost:{port}", num_processes=nprocs, process_id=rank)
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 2 * nprocs

    from kwave_tpu.driver import RunConfig, run_simulation

    # tripwire: the driver's writer edge must be the point-to-point WriterGather,
    # never the replicate-to-all process_allgather (which would hand every rank a
    # global-size emission buffer and P x the DCN bytes). jax internals
    # (device_put's assert_equal) legitimately allgather tiny metadata — forbid
    # only calls issued from kwave_tpu code (the r3 fetch_global path).
    from jax.experimental import multihost_utils

    _orig_allgather = multihost_utils.process_allgather

    def _caller_guarded(tree, *a, **k):
        caller = sys._getframe(1).f_code.co_filename
        if "kwave_tpu" in caller:
            raise AssertionError(
                f"process_allgather called from {caller} — driver emissions "
                "must go through WriterGather"
            )
        return _orig_allgather(tree, *a, **k)

    multihost_utils.process_allgather = _caller_guarded

    if mode == "die" and rank == nprocs - 1:
        # kill this rank right before its second gather send (mid-run, after the
        # first window's emissions already crossed the channel successfully). Like a
        # real send it first waits for its own shards: dying with that window's
        # collectives still in flight would fail the writer inside the collective,
        # before it ever reaches the side channel this test exercises.
        from kwave_tpu.parallel.distributed import WriterGather

        orig_gather = WriterGather.gather
        calls = [0]

        def dying_gather(self, tree):
            calls[0] += 1
            if calls[0] >= 2:
                jax.block_until_ready(tree)
                os._exit(17)
            return orig_gather(self, tree)

        WriterGather.gather = dying_gather

    mesh = make_mesh()  # all global devices
    data = build_input_cuboid() if mode == "cuboid" else build_input()
    flags = dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True)
    if mode == "cuboid":
        run = RunConfig(flags=flags, period=10.0, harmonics=2, mode40=True)
        summary = run_simulation(data, run, out, mesh=mesh)
    elif mode == "legs":
        ckpt = out + ".ckpt.h5"
        run1 = RunConfig(flags=flags, period=10.0, harmonics=2,
                         checkpoint_file=ckpt, checkpoint_interval_steps=20)
        summary1 = run_simulation(data, run1, out, mesh=mesh)
        assert summary1.get("__checkpointed_at__") == (20,), summary1
        run2 = RunConfig(flags=flags, period=10.0, harmonics=2)
        summary = run_simulation(data, run2, out, mesh=mesh, resume_from=ckpt)
    else:
        run = RunConfig(flags=flags, period=10.0, harmonics=2)
        summary = run_simulation(data, run, out, mesh=mesh)
    if rank == 0:
        assert "p_c" in summary, summary
    else:
        assert summary == {}, summary  # non-writer produces no file
    jax.effects_barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
