"""Two-process jax.distributed test: the multi-host gather path on one machine.

The reference is strictly single-process; this validates the SURVEY §2.9 multi-host
equivalents — distributed init, a global mesh over two processes' devices, sensor-sharded
encode, and the index-ordered cross-process gather (process_allgather / DCN path) — against
the single-process result.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_encode_gather(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "mp_worker.py")
    port = _free_port()
    out = str(tmp_path / "rank0.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), "2", str(port), out],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for r in range(2)
    ]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append((p.returncode, so, se))
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-2000:])
    assert os.path.exists(out)

    # single-process reference over the same series
    import jax

    from kwave_tpu import encoder
    from kwave_tpu.basis import generate_basis

    cb = generate_basis(20.0, 1, 2, normalize=True)
    n_global = 4  # 2 processes x 2 virtual devices
    t_steps, n_sensors = 200, 64 * n_global
    t = np.arange(t_steps, dtype=np.float32)[:, None]
    phase = np.linspace(0, 2 * np.pi, n_sensors, dtype=np.float32)[None, :]
    x = (1e5 * np.sin(2 * np.pi * t / 20.0 + phase)).astype(np.float32)
    f_re, f_im = encoder.encode_series_fast(jax.numpy.asarray(x), cb)

    got = np.load(out)
    np.testing.assert_allclose(got["re"], np.asarray(f_re), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got["im"], np.asarray(f_im), rtol=1e-5, atol=1e-2)


def test_two_process_full_driver(tmp_path):
    """The COMPLETE driver across two processes over a global 4-device mesh: process 0
    writes one output file whose contents match a single-process run on an identical
    4-device mesh (same partitioning -> same numerics)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "mp_driver_worker.py")
    port = _free_port()
    out = str(tmp_path / "mp_out.h5")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), "2", str(port), out],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for r in range(2)
    ]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed driver workers timed out")
        outs.append((p.returncode, so, se))
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])
    assert os.path.exists(out)

    # single-process reference on an identical 4-device mesh (same partitioning)
    import h5py

    from tests.mp_driver_worker import build_input
    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.parallel import make_mesh

    data = build_input()
    ref = str(tmp_path / "ref_out.h5")
    run_simulation(
        data,
        RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True),
                  period=10.0, harmonics=2),
        ref,
        mesh=make_mesh(4),
    )
    with h5py.File(out, "r") as fa, h5py.File(ref, "r") as fb:
        for name in ("p", "p_c", "p_rms", "p_max_all"):
            a = np.asarray(fa[name])
            b = np.asarray(fb[name])
            assert a.shape == b.shape, name
            scale = max(np.abs(b).max(), 1e-30)
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6 * scale,
                                       err_msg=name)


def test_two_process_checkpoint_resume(tmp_path):
    """Multi-process recovery: a 2-process run interrupted at t=20 and resumed from the
    checkpoint produces BYTE-IDENTICAL output to an uninterrupted single-process run on
    an identical 4-device mesh (same partitioning -> same numerics; the resume restores
    encoder accumulators and aggregates on every rank)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "mp_driver_worker.py")
    port = _free_port()
    out = str(tmp_path / "mp_legs.h5")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), "2", str(port), out, "legs"],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for r in range(2)
    ]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed resume workers timed out")
        outs.append((p.returncode, so, se))
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])

    import h5py

    from tests.mp_driver_worker import build_input
    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.parallel import make_mesh

    data = build_input()
    ref = str(tmp_path / "ref_uninterrupted.h5")
    run_simulation(
        data,
        RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True),
                  period=10.0, harmonics=2),
        ref,
        mesh=make_mesh(4),
    )
    with h5py.File(out, "r") as fa, h5py.File(ref, "r") as fb:
        for name in ("p", "p_c", "p_rms", "p_max_all"):
            a = np.asarray(fa[name])
            b = np.asarray(fb[name])
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_writer_gather_single_process_mixed_leaves():
    """WriterGather's single-process branch (used by dryrun/mesh-in-one-process
    runs): mixed pytrees of None / numpy / scalars / device arrays come back as
    host numpy with values intact."""
    import jax
    import jax.numpy as jnp

    from kwave_tpu.parallel.distributed import WriterGather

    g = WriterGather()
    tree = {
        "none": None,
        "np": np.arange(4),
        "scalar": 3,
        "dev": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "tup": (jnp.int32(7), None),
    }
    out = g.gather(tree)
    assert out["none"] is None
    np.testing.assert_array_equal(out["np"], np.arange(4))
    assert out["scalar"] == 3
    assert isinstance(out["dev"], np.ndarray)
    np.testing.assert_array_equal(out["dev"], np.arange(6).reshape(2, 3))
    assert out["tup"][0] == 7 and out["tup"][1] is None
    g.close()


def _spawn_driver_workers(tmp_path, nprocs, mode=None, out_name="mp_out.h5",
                          timeout=420, extra_env=None):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "mp_driver_worker.py")
    port = _free_port()
    out = str(tmp_path / out_name)
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    env.pop("XLA_FLAGS", None)
    argv_tail = [str(port), out] + ([mode] if mode else [])
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), str(nprocs)] + argv_tail,
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for r in range(nprocs)
    ]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{nprocs}-process driver workers timed out")
        outs.append((p.returncode, so, se))
    return out, outs


def test_four_process_full_driver(tmp_path):
    """Four processes (2 virtual devices each, global 8-device mesh) through the
    hardened WriterGather: per-shard length-prefixed streaming from 3 peers,
    writer assembly in index order — output equal to a single-process run on an
    identical 8-device mesh (r4 VERDICT #3 done-criterion)."""
    out, outs = _spawn_driver_workers(tmp_path, 4, out_name="mp4_out.h5")
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])
    assert os.path.exists(out)

    import h5py

    from tests.mp_driver_worker import build_input
    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.parallel import make_mesh

    data = build_input()
    ref = str(tmp_path / "ref8_out.h5")
    run_simulation(
        data,
        RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True),
                  period=10.0, harmonics=2),
        ref,
        mesh=make_mesh(8),
    )
    with h5py.File(out, "r") as fa, h5py.File(ref, "r") as fb:
        for name in ("p", "p_c", "p_rms", "p_max_all"):
            a = np.asarray(fa[name])
            b = np.asarray(fb[name])
            assert a.shape == b.shape, name
            scale = max(np.abs(b).max(), 1e-30)
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6 * scale,
                                       err_msg=name)


def test_peer_death_names_the_rank(tmp_path):
    """Failure injection (r4 VERDICT #3): the highest rank exits hard right
    before its second gather send. The writer must fail FAST (TCP close, not the
    full timeout) with an error naming the dead rank — the reference's
    'boring-reliable' single-consumer funnel (BaseOutputStream.cpp:369-388)
    replaced by a transport that at least tells you who died."""
    out, outs = _spawn_driver_workers(
        tmp_path, 2, mode="die", out_name="mp_die.h5", timeout=180,
        extra_env={"KWAVE_GATHER_TIMEOUT_S": "60"},
    )
    rc0, so0, se0 = outs[0]
    rc1, _, _ = outs[1]
    assert rc1 == 17  # the injected death
    assert rc0 != 0, "writer must not report success after a peer died"
    assert "rank 1" in se0, se0[-3000:]
    assert ("closed the connection" in se0) or ("went silent" in se0), se0[-2000:]


def test_advertise_host_env_override(monkeypatch):
    """KWAVE_WRITER_HOST overrides auto-detection (pods where the routed
    interface is still not what peers should dial)."""
    from kwave_tpu.parallel.distributed import WriterGather

    monkeypatch.setenv("KWAVE_WRITER_HOST", "10.1.2.3")
    assert WriterGather._advertise_host() == "10.1.2.3"
    monkeypatch.delenv("KWAVE_WRITER_HOST")
    # without the override the resolver must return SOMETHING dialable
    host = WriterGather._advertise_host()
    assert isinstance(host, str) and host


def test_writer_gather_context_manager():
    from kwave_tpu.parallel.distributed import WriterGather

    with WriterGather() as g:
        out = g.gather({"a": np.arange(3)})
        np.testing.assert_array_equal(out["a"], np.arange(3))
    assert g._sock is None and g._srv is None


def test_cli_multiprocess_launch(tmp_path):
    """The POD_RUNBOOK.md launch recipe end-to-end: two CLI processes with
    --coordinator/--num_processes/--process_id form a global 4-device mesh,
    process 0 writes the output, and it matches a single-process run on an
    identically-partitioned mesh."""
    import h5py

    from tests.mp_driver_worker import build_input
    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.io.input_file import write_input_file
    from kwave_tpu.parallel import make_mesh

    data = build_input()
    inp = str(tmp_path / "cli_in.h5")
    write_input_file(inp, data)
    out = str(tmp_path / "cli_mp_out.h5")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    shim = "import sys; from kwave_tpu.cli import main; sys.exit(main(sys.argv[1:]))"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", shim, "-i", inp, "-o", out,
             "--p_raw", "--p_c", "--period", "10", "--harmonics", "2",
             "--coordinator", f"localhost:{port}", "--num_processes", "2",
             "--process_id", str(r)],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for r in range(2)
    ]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("CLI multi-process launch timed out")
        outs.append((p.returncode, so, se))
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])

    # the reference input was read from file, so rebase expectations identically
    from kwave_tpu.io.input_file import read_input_file

    ref = str(tmp_path / "cli_ref.h5")
    run_simulation(
        read_input_file(inp),
        RunConfig(flags=dict(p_raw=True, p_c=True), period=10.0, harmonics=2),
        ref, mesh=make_mesh(4),
    )
    with h5py.File(out, "r") as fa, h5py.File(ref, "r") as fb:
        for name in ("p", "p_c"):
            np.testing.assert_array_equal(np.asarray(fa[name]),
                                          np.asarray(fb[name]), err_msg=name)


def test_two_process_cuboid_40bit(tmp_path):
    """Cuboid-corner mask + 40-bit stream across two processes: per-cuboid
    group assembly and padded packed rows cross the hardened WriterGather.
    Output byte-identical to a single-process run on the same 4-device mesh
    (same partitioning -> same numerics -> same requantized bits)."""
    out, outs = _spawn_driver_workers(tmp_path, 2, mode="cuboid",
                                      out_name="mp_cub.h5")
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])

    import h5py

    from tests.mp_driver_worker import build_input_cuboid
    from kwave_tpu.driver import RunConfig, run_simulation
    from kwave_tpu.parallel import make_mesh

    ref = str(tmp_path / "ref_cub.h5")
    run_simulation(
        build_input_cuboid(),
        RunConfig(flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True),
                  period=10.0, harmonics=2, mode40=True),
        ref, mesh=make_mesh(4),
    )
    with h5py.File(out, "r") as fa, h5py.File(ref, "r") as fb:
        assert np.asarray(fa["p_max_all"]).shape == np.asarray(fb["p_max_all"]).shape
        np.testing.assert_array_equal(np.asarray(fa["p_max_all"]),
                                      np.asarray(fb["p_max_all"]))
        for name in ("p", "p_c", "p_rms"):
            for k in fa[name]:
                a, b = np.asarray(fa[name][k]), np.asarray(fb[name][k])
                assert a.shape == b.shape, (name, k)
                np.testing.assert_array_equal(
                    a.view(np.uint8), b.view(np.uint8), err_msg=f"{name}/{k}")
