"""kspaceFirstOrder-JAX command-line entry (main.cpp:840-937 equivalent).

`python -m kwave_tpu.cli -i input.h5 -o output.h5 --p_c ...`
"""

from __future__ import annotations

import sys
import time

from kwave_tpu.driver import run_simulation
from kwave_tpu.utils import compile_cache
from kwave_tpu.io.input_file import read_input_file
from kwave_tpu.params import args_to_run_config, build_parser

VERSION = ("kspaceFirstOrder-JAX v0.1 (kwave_tpu; capability target: "
           "kspaceFirstOrder-CUDA v1.3)")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.version:
        print(VERSION)
        return 0

    from kwave_tpu.utils.observability import Logger

    Logger.level = args.verbose  # Basic/Advanced/Full (Logger.h:57-63)

    compile_cache.enable()

    # Multi-host bring-up (POD_RUNBOOK.md): one process per host, each driving all of
    # its host's devices. Must run before any backend touch so the global device view
    # spans every host.
    if args.num_processes is not None:
        from kwave_tpu.parallel.distributed import initialize

        if args.num_processes > 1 and (
            args.coordinator is None or args.process_id is None
        ):
            parser.error(
                "--num_processes requires --coordinator HOST:PORT and "
                "--process_id R"
            )
        initialize(coordinator=args.coordinator,
                   num_processes=args.num_processes,
                   process_id=args.process_id)
    elif args.coordinator is not None or args.process_id is not None:
        parser.error("--coordinator/--process_id need --num_processes N")
    return simulate(args, args.input_file, args.output_file)


def simulate(args, input_file, output_file) -> int:
    """Everything after argument parsing and start-up: read the input, run (or
    post-process), write the output. ``input_file``/``output_file`` are the -i/-o paths,
    or `io.memory.MemoryFile` stores in their place where h5py is not installed
    (chip_smoke.py drives the CLI that way)."""
    t0 = time.time()
    data = read_input_file(input_file)

    if args.post:
        # --post: post-processing only on an existing output file (main.cpp --post;
        # Parameters.cpp:525-546 re-reads c_* attrs from the output — our reader takes
        # them from the datasets directly)
        from kwave_tpu.postproc import post_process_output_file

        mask = data.sensor_mask_index
        if mask is None:
            from kwave_tpu.driver import _corners_to_indices

            mask = _corners_to_indices(data.sensor_mask_corners, data.grid)
        if args.I_avg or args.Q_term:
            post_process_output_file(output_file, data.grid, mask,
                                     want_i_avg=args.I_avg, want_q_term=args.Q_term,
                                     from_coeffs=False, block_size=args.block_size)
        if args.I_avg_c or args.Q_term_c:
            post_process_output_file(output_file, data.grid, mask,
                                     want_i_avg=args.I_avg_c, want_q_term=args.Q_term_c,
                                     from_coeffs=True, block_size=args.block_size)
        print(f"[kwave_tpu] post-processing done in {time.time() - t0:.2f}s")
        return 0

    if args.benchmark is not None:
        # --benchmark truncates Nt (Parameters.cpp:130-133)
        import dataclasses

        data.grid = dataclasses.replace(data.grid, nt=min(args.benchmark, data.grid.nt))
    run = args_to_run_config(args, dt=data.grid.dt)
    load_s = time.time() - t0
    run.data_load_seconds = load_s  # feeds the data_load phase timer / output attr

    if not any(run.flags.values()) and not (
        args.I_avg or args.I_avg_c or args.Q_term or args.Q_term_c
    ):
        # The reference's store-p-by-default was deliberately disabled in v1.3
        # (CommandLineParameters.cpp:946: `mStorePressureRawFlag = false; // true;`) but
        # a run with no outputs at all is useless, so keep the old default ONLY when no
        # output of any kind (including intensity/Q-term) was requested.
        run.flags["p_raw"] = True

    mesh = None
    import jax

    if jax.process_count() > 1:
        # Multi-process launch: the mesh must span every global device — a
        # narrower mesh would exclude some ranks' chips and strand those
        # processes (their device_puts have no addressable target while the
        # writer waits out the gather timeout).
        from kwave_tpu.parallel import make_mesh

        if args.devices is not None and args.devices != len(jax.devices()):
            build_parser().error(
                f"--devices {args.devices} under a multi-process launch must "
                f"equal the global device count ({len(jax.devices())}); each "
                "process owns its local chips — narrow the slice itself instead"
            )
        mesh = make_mesh()
    elif args.devices is not None and args.devices > 1:
        from kwave_tpu.parallel import make_mesh

        mesh = make_mesh(args.devices)

    t1 = time.time()
    summary = run_simulation(
        data, run, output_file,
        resume_from=args.checkpoint_file
        if args.checkpoint_file and _checkpoint_exists(args.checkpoint_file) else None,
        mesh=mesh,
    )
    sim_s = time.time() - t1

    if args.copy_sensor_mask and jax.process_index() == 0:
        # --copy_sensor_mask: carry the mask into the output file (1-based on disk, as
        # in the input format); writer-gated — only process 0 holds the file
        import numpy as np

        from kwave_tpu.io import names as dn
        from kwave_tpu.io.hdf5 import open_file, tag_dataset

        with open_file(output_file, "r+") as f:
            if data.sensor_mask_index is not None:
                ds = f.create_dataset(
                    dn.SENSOR_MASK_INDEX,
                    data=(data.sensor_mask_index.astype(np.uint64) + 1)[None, None, :],
                )
                tag_dataset(ds, data=dn.DATA_LONG)
            elif data.sensor_mask_corners is not None:
                ds = f.create_dataset(
                    dn.SENSOR_MASK_CORNERS,
                    data=(data.sensor_mask_corners.astype(np.uint64) + 1)[None, :, :],
                )
                tag_dataset(ds, data=dn.DATA_LONG)

    if args.verbose >= 0:
        print(f"[kwave_tpu] load {load_s:.2f}s  simulate+store {sim_s:.2f}s")
        for name, shape in summary.items():
            print(f"  {name}: {shape}")
    return 0


def _checkpoint_exists(path: str) -> bool:
    import os

    from kwave_tpu.io.hdf5 import open_file

    if not os.path.exists(path):
        return False
    try:
        with open_file(path, "r") as f:
            return "t_index" in f
    except OSError:
        return False


if __name__ == "__main__":
    sys.exit(main())
