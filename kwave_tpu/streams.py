"""Output streams: the sample -> reduce/compress -> file path, as a functional state machine.

A redesign of OutputStreams/* (BaseOutputStream, IndexOutputStream,
CuboidOutputStream, WholeDomainOutputStream, OutputStreamContainer): the reference's OO
hierarchy with zero-copy host buffers and one-step-delayed flushes
(OutputStreamContainer.h:56-58, KSpaceFirstOrderSolver.cpp:1060-1093) becomes

- a static `StreamSpec` list (which field, which reduce op, compression settings) — the
  analogue of OutputStreamContainer::init's flag wiring (OutputStreamContainer.cpp:70-325);
- one device-side state pytree (`init_stream_states`) holding encoder accumulators and
  reduce buffers;
- a pure `process_chunk` that consumes one oSize-step window of sampled rows per source
  and advances every stream at once — raw rows pass through, aggregates fold, compressed
  streams emit exactly one coefficient frame (the whole window is processed on-device; the
  reference's per-step OpenMP encode loop, IndexOutputStream.cpp:348-471, becomes the
  encoder's scan/matmul kernels);
- a host-side `StreamWriter` that owns the HDF5 datasets and flushes emissions
  (io.output_file contract).

Sampling start (-s flag) and the trailing partial window follow the reference's dataset
sizing: raw rows Nt-s, compressed frames floor((Nt-s)/oSize) (IndexOutputStream.cpp:105-117).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kwave_tpu import encoder, sampling
from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis
from kwave_tpu.io import names as dn
from kwave_tpu.io.output_file import (
    CompressionAttrs,
    create_aggregate_dataset,
    create_compressed_dataset,
    create_cuboid_group,
    create_field_dataset,
    create_raw_dataset,
)

# Sources a stream can sample (the reference's matrix wiring,
# OutputStreamContainer.cpp:84-266).
SOURCES = (
    "p",
    "ux_sgx",
    "uy_sgy",
    "uz_sgz",
    "ux_shifted",
    "uy_shifted",
    "uz_shifted",
)

# ops: raw | c | rms | max | min | max_all | min_all | final
# (BaseOutputStream::ReduceOperator, BaseOutputStream.h:68-88, + p_final/u_final which the
# reference stores straight from the field at the last step, KSpaceFirstOrderSolver.cpp:962-985)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    name: str  # dataset name, e.g. "p_c", "ux_rms"
    source: str  # one of SOURCES
    op: str
    mode40: bool = False
    shifted_basis: bool = False  # velocity non-staggered streams use shifted tables
    # --no_overlap: single aliased accumulator (BaseOutputStream.cpp:246-257); also
    # auto-forced when the record is shorter than one period (Parameters.cpp:141-145)
    overlap: bool = True
    # doNotSave: stream runs (samples/encodes/accumulates) but writes no dataset — the
    # reference's hidden dependency streams for I_avg_c/Q_term_c
    # (OutputStreamContainer.cpp:269-325)
    save: bool = True

    @staticmethod
    def from_flags(
        flags: dict[str, bool], is3d: bool, mode40: bool = False
    ) -> list["StreamSpec"]:
        """Flag surface -> stream list (OutputStreamContainer::init,
        OutputStreamContainer.cpp:70-325). `flags` keys: p_raw, p_c, p_rms, p_max, p_min,
        p_max_all, p_min_all, p_final, u_raw, u_c, u_non_staggered_raw, u_non_staggered_c,
        u_rms, u_max, u_min, u_max_all, u_min_all, u_final."""
        specs: list[StreamSpec] = []
        ax = ("x", "y", "z") if is3d else ("x", "y")

        def u_each(fmt, source_fmt, op, **kw):
            for a in ax:
                specs.append(
                    StreamSpec(fmt.format(a=a), source_fmt.format(a=a), op, **kw)
                )

        if flags.get("p_raw"):
            specs.append(StreamSpec(dn.P, "p", "raw"))
        if flags.get("p_c"):
            specs.append(StreamSpec(dn.P + dn.COMPRESS_SUFFIX, "p", "c", mode40=mode40))
        if flags.get("p_rms"):
            specs.append(StreamSpec("p_rms", "p", "rms"))
        if flags.get("p_max"):
            specs.append(StreamSpec("p_max", "p", "max"))
        if flags.get("p_min"):
            specs.append(StreamSpec("p_min", "p", "min"))
        if flags.get("p_max_all"):
            specs.append(StreamSpec("p_max_all", "p", "max_all"))
        if flags.get("p_min_all"):
            specs.append(StreamSpec("p_min_all", "p", "min_all"))
        if flags.get("p_final"):
            specs.append(StreamSpec("p_final", "p", "final"))
        if flags.get("u_raw"):
            u_each("u{a}", "u{a}_sg{a}", "raw")
        if flags.get("u_c"):
            u_each("u{a}" + dn.COMPRESS_SUFFIX, "u{a}_sg{a}", "c", mode40=mode40)
        if flags.get("u_non_staggered_raw"):
            u_each("u{a}_non_staggered", "u{a}_shifted", "raw")
        if flags.get("u_non_staggered_c"):
            # non-staggered velocity uses the shifted basis + kMaxExpU
            # (BaseOutputStream.cpp:68-83)
            u_each(
                "u{a}_non_staggered" + dn.COMPRESS_SUFFIX,
                "u{a}_shifted",
                "c",
                mode40=mode40,
                shifted_basis=True,
            )
        if flags.get("u_rms"):
            u_each("u{a}_rms", "u{a}_sg{a}", "rms")
        if flags.get("u_max"):
            u_each("u{a}_max", "u{a}_sg{a}", "max")
        if flags.get("u_min"):
            u_each("u{a}_min", "u{a}_sg{a}", "min")
        if flags.get("u_max_all"):
            u_each("u{a}_max_all", "u{a}_sg{a}", "max_all")
        if flags.get("u_min_all"):
            u_each("u{a}_min_all", "u{a}_sg{a}", "min_all")
        if flags.get("u_final"):
            u_each("u{a}_final", "u{a}_sg{a}", "final")
        return specs

    def e_const(self) -> int:
        return MAX_EXP_U if self.shifted_basis else MAX_EXP_P

    def complex_size(self) -> float:
        return 1.25 if self.mode40 else 2.0  # BaseOutputStream.cpp:98-101


def needs_shifted_velocity(specs: list[StreamSpec]) -> bool:
    return any(s.source.endswith("_shifted") for s in specs)


def needed_sources(specs: list[StreamSpec]) -> list[str]:
    seen: list[str] = []
    for s in specs:
        if s.op in ("max_all", "min_all", "final"):
            continue  # whole-domain: no sensor gather
        if s.source not in seen:
            seen.append(s.source)
    return seen


# ---------------------------------------------------------------------------
# Device-side state + chunk processing
# ---------------------------------------------------------------------------


def init_stream_states(
    specs: list[StreamSpec],
    n_sensors: int,
    n_grid: int,
    basis: Optional[CompressionBasis],
) -> dict[str, Any]:
    """One entry per stream: encoder state for `c`, reduce buffer for aggregates, None for
    raw/final (their data flows through chunk outputs / final state)."""
    states: dict[str, Any] = {}
    for s in specs:
        if s.op == "c":
            cfg = encoder.EncoderConfig.for_stream(
                basis, s.shifted_basis, s.mode40, s.overlap
            )
            states[s.name] = encoder.init_state(cfg, n_sensors)
        elif s.op in ("rms", "max", "min"):
            states[s.name] = sampling.init_reduce_buffer(s.op, n_sensors)
        elif s.op in ("max_all", "min_all"):
            states[s.name] = sampling.init_reduce_buffer(s.op.split("_")[0], n_grid)
        elif s.op == "iavg_c":
            # on-the-fly coefficient-space intensity accumulator (IndexOutputStream::
            # postSample, IndexOutputStream.cpp:299-342)
            states[s.name] = jnp.zeros(n_sensors, jnp.float32)
        else:  # raw / final
            states[s.name] = None
    return states


def encoder_tables(basis: CompressionBasis) -> dict[bool, dict[str, jax.Array]]:
    return {
        False: encoder.make_tables(basis, shifted=False),
        True: encoder.make_tables(basis, shifted=True),
    }


def process_chunk(
    states: dict[str, Any],
    chunks: dict[str, jax.Array],  # source -> [o, n_sensors] sampled rows
    fields: dict[str, jax.Array],  # source -> final field of the window (flat) for _all ops
    specs: list[StreamSpec],
    basis: Optional[CompressionBasis],
    emit: bool = True,
) -> tuple[dict[str, Any], dict[str, Any]]:
    """Advance all streams by one aligned oSize window. Returns (states, emissions):
    emissions[name] = raw rows [o, N] | coefficient frame — float mode (re, im)
    planes, 40-bit mode ONE wire-format uint32 word array (pack_40bit_emissions;
    unpacked with bitpack.frame_wire_bytes) | None.

    Aggregate folds consume the whole chunk at once (the reference folds per step,
    OutputStreamsCudaKernels.cu:83-107 — associative, so window-batched here).

    ``emit=False`` processes a partial trailing window (< oSize rows): compressed streams
    accumulate without emitting a frame (the reference accumulates every sampled step and
    flushes only at saving boundaries, IndexOutputStream.cpp:397-456), and the iavg_c
    pass is skipped (postSample fires per completed frame only)."""
    out: dict[str, Any] = {}
    new_states = dict(states)
    for s in specs:
        if s.op == "raw":
            out[s.name] = chunks[s.source]
        elif s.op == "c":
            cfg = encoder.EncoderConfig.for_stream(
                basis, s.shifted_basis, s.mode40, s.overlap
            )
            tables = encoder.make_tables(basis, s.shifted_basis)
            if emit:
                st, frame = encoder.encode_chunk(
                    states[s.name], chunks[s.source], cfg, tables
                )
                out[s.name] = frame
            else:
                st = encoder.accumulate_chunk(
                    states[s.name], chunks[s.source], cfg, tables
                )
                out[s.name] = None
            new_states[s.name] = st
        elif s.op == "rms":
            x = chunks[s.source]
            new_states[s.name] = states[s.name] + jnp.sum(x * x, axis=0)
        elif s.op == "max":
            new_states[s.name] = jnp.maximum(states[s.name], jnp.max(chunks[s.source], axis=0))
        elif s.op == "min":
            new_states[s.name] = jnp.minimum(states[s.name], jnp.min(chunks[s.source], axis=0))
        elif s.op in ("max_all", "min_all"):
            # whole-domain extrema are folded per step inside the driver's window scan
            # (driver.make_window_fn); if the caller passes stacked per-step fields here
            # instead, fold them now.
            x = fields.get(s.source)
            if x is not None:
                fold = jnp.max if s.op == "max_all" else jnp.min
                cur = fold(x, axis=0) if x.ndim == 2 else x
                new_states[s.name] = (
                    jnp.maximum(states[s.name], cur) if s.op == "max_all"
                    else jnp.minimum(states[s.name], cur)
                )
        # final: handled at end of run from the last state
    # second pass: coefficient-space intensity accumulation consumes the frames the `c`
    # streams just emitted (one per window) — IndexOutputStream::postSample semantics,
    # IndexOutputStream.cpp:299-342 (incl. the 40-bit decode of the packed partners)
    if emit:
        finalize_emissions(new_states, out, specs)
    return new_states, out


def finalize_emissions(
    states: dict[str, Any], emissions: dict[str, Any], specs: list[StreamSpec]
) -> None:
    """The per-frame post pass in its REQUIRED order, as one call (mutates both
    dicts in place): intensity accumulation consumes the SoA coefficient planes
    (postSample), THEN the 40-bit frames are packed to wire words for transport.
    Every emission producer (window loop, tiny-record partial) goes through this
    single helper so the ordering invariant lives in exactly one place."""
    accumulate_iavg_from_frames(states, emissions, specs)
    pack_40bit_emissions(emissions, specs)


def pack_40bit_emissions(emissions: dict[str, Any], specs: list[StreamSpec]) -> None:
    """Pack mode40 emission frames into wire-format words ON DEVICE (in place).

    Must run AFTER accumulate_iavg_from_frames (which consumes the SoA planes).
    Shipping the int32 SoA planes to the host/writer moves 12 B per coefficient;
    the wire format is 5 — this cuts the per-window device->host fetch and the
    multi-host WriterGather DCN bytes of every 40-bit stream by 2.4x
    (bitpack.pack_frame_wire)."""
    from kwave_tpu import bitpack

    for s in specs:
        if s.op == "c" and s.mode40 and emissions.get(s.name) is not None:
            emissions[s.name] = bitpack.pack_frame_wire(*emissions[s.name])


def accumulate_iavg_from_frames(
    states: dict[str, Any], frames: dict[str, Any], specs: list[StreamSpec]
) -> None:
    """One postSample pass (IndexOutputStream.cpp:299-342): every iavg_c stream consumes
    the just-completed coefficient frames of its p/u partner streams. Mutates `states`
    in place. Fires once per completed frame, including the tiny-record lastStep partial
    frame (postSample runs whenever getCurrentStoreBuffer() is set, :313)."""
    for s in specs:
        if s.op != "iavg_c":
            continue
        axis = s.name[1]  # "Ix_avg_c" -> "x"
        pf = frames["p" + dn.COMPRESS_SUFFIX]
        uf = frames[f"u{axis}_non_staggered" + dn.COMPRESS_SUFFIX]
        if s.mode40:
            from kwave_tpu import bitpack

            p_re, p_im = bitpack.decode40(*pf, MAX_EXP_P)
            u_re, u_im = bitpack.decode40(*uf, MAX_EXP_U)
        else:
            p_re, p_im = pf
            u_re, u_im = uf
        from kwave_tpu.decoder import avg_intensity_update

        states[s.name] = avg_intensity_update(states[s.name], p_re, p_im, u_re, u_im)


def finalize_aggregates(
    states: dict[str, Any], specs: list[StreamSpec], sampled_steps: int,
    compressed_frames: int = 0,
) -> dict[str, np.ndarray]:
    """Post-processing of aggregate buffers (BaseOutputStream::postProcess,
    BaseOutputStream.cpp:160-180: rms scaled by 1/(Nt-s) and sqrt'd; IAvgC divided by
    the number of completed frames, IndexOutputStream.cpp:482-490)."""
    out = {}
    for s in specs:
        if s.op == "rms":
            out[s.name] = np.asarray(sampling.post_rms(states[s.name], sampled_steps))
        elif s.op in ("max", "min", "max_all", "min_all"):
            out[s.name] = np.asarray(states[s.name])
        elif s.op == "iavg_c":
            out[s.name] = np.asarray(states[s.name]) / max(compressed_frames, 1)
    return out


# ---------------------------------------------------------------------------
# Checkpoint (de)serialization of stream states
# ---------------------------------------------------------------------------


def stream_states_to_checkpoint(
    states: dict[str, Any], specs: list[StreamSpec], n_sensors: int
) -> dict[str, tuple[np.ndarray, Optional[np.ndarray]]]:
    """Encoder accumulators -> the reference's Temp_<name>_1/2 flat buffers
    (BaseOutputStream::checkpoint, BaseOutputStream.cpp:551-606): float mode stores
    interleaved complex rows; 40-bit mode stores the packed 5-byte stream inside the
    float-sized buffer."""
    out = {}
    for s in specs:
        if s.op != "c":
            continue
        st = states[s.name]
        if s.mode40:
            def pack(h, r, i):
                flat = encoder.frames_to_flat_40b(np.asarray(h), np.asarray(r),
                                                  np.asarray(i))
                buf = np.zeros(
                    int(np.ceil(n_sensors * 1.25)) * np.asarray(h).shape[0], np.float32
                )
                buf.view(np.uint8)[: flat.size] = flat
                return buf

            b1 = pack(st["hdr1"], st["mr1"], st["mi1"])
            b2 = pack(st["hdr2"], st["mr2"], st["mi2"]) if "hdr2" in st else None
        else:
            b1 = encoder.frames_to_flat_float(st["acc1_re"], st["acc1_im"])
            b2 = (
                encoder.frames_to_flat_float(st["acc2_re"], st["acc2_im"])
                if "acc2_re" in st else None
            )
        out[s.name] = (b1, b2)
    return out


def restore_stream_states(
    states: dict[str, Any],
    coeffs: dict[str, tuple[np.ndarray, Optional[np.ndarray]]],
    specs: list[StreamSpec],
    sampled_steps_done: int,
    o_size: int,
) -> dict[str, Any]:
    """Inverse of `stream_states_to_checkpoint` + counter reseeding
    (loadCheckpointCompressionCoefficients, BaseOutputStream.cpp:528-544;
    mCompressedTimeStep reseed, IndexOutputStream.cpp:207-210)."""
    import jax.numpy as jnp_

    new = dict(states)
    for s in specs:
        if s.op != "c" or s.name not in coeffs:
            continue
        st = dict(states[s.name])
        h = st["hdr1"].shape[0] if s.mode40 else st["acc1_re"].shape[0]
        n = st["hdr1"].shape[1] if s.mode40 else st["acc1_re"].shape[1]
        b1, b2 = coeffs[s.name]

        if s.mode40:
            from kwave_tpu.oracle import bytes_to_soa

            def unpack(buf):
                raw = np.asarray(buf, np.float32).reshape(-1).view(np.uint8)[: 5 * n * h]
                hdr, mr, mi = bytes_to_soa(np.ascontiguousarray(raw))
                to = lambda a: jnp_.asarray(
                    a.reshape(n, h).T.astype(np.uint32).copy()
                )
                return to(hdr), to(mr), to(mi)

            st["hdr1"], st["mr1"], st["mi1"] = unpack(b1)
            if b2 is not None and "hdr2" in st:
                st["hdr2"], st["mr2"], st["mi2"] = unpack(b2)
        else:

            def unflat(buf):
                c = np.asarray(buf, np.float32).reshape(n, h, 2)
                return jnp_.asarray(c[..., 0].T.copy()), jnp_.asarray(c[..., 1].T.copy())

            st["acc1_re"], st["acc1_im"] = unflat(b1)
            if b2 is not None and "acc2_re" in st:
                st["acc2_re"], st["acc2_im"] = unflat(b2)
        st["sampled_step"] = jnp_.asarray(np.int32(sampled_steps_done))
        st["compressed_step"] = jnp_.asarray(np.int32(sampled_steps_done // o_size))
        new[s.name] = st
    return new


def restore_aggregates_from_file(
    states: dict[str, Any], specs: list[StreamSpec], h5file, sampled_steps_done: int
) -> dict[str, Any]:
    """Aggregates are flushed RAW (pre-postProcess) to the output file at checkpoint and
    reloaded on reopen (IndexOutputStream::reopen, IndexOutputStream.cpp:213-231);
    finalization (rms sqrt/scale) happens only on the last leg."""
    import jax.numpy as jnp_

    new = dict(states)
    if sampled_steps_done <= 0:
        return new
    from kwave_tpu.io.hdf5 import is_group

    for s in specs:
        if s.op in ("rms", "max", "min", "max_all", "min_all", "iavg_c"):
            obj = h5file[s.name]
            if is_group(obj):
                new[s.name] = jnp_.asarray(np.concatenate([
                    np.asarray(obj[k], np.float32).reshape(-1)
                    for k in sorted(obj.keys(), key=int)
                ]))
            else:
                new[s.name] = jnp_.asarray(np.asarray(obj, np.float32).reshape(-1))
    return new


def raw_aggregates(states: dict[str, Any], specs: list[StreamSpec]) -> dict[str, np.ndarray]:
    """Un-finalized aggregate buffers for a checkpoint-leg flush."""
    return {
        s.name: np.asarray(states[s.name])
        for s in specs
        if s.op in ("rms", "max", "min", "max_all", "min_all", "iavg_c")
    }


# ---------------------------------------------------------------------------
# Host-side writer
# ---------------------------------------------------------------------------


class StreamWriter:
    """Owns the output-file datasets for a stream set; flushes emissions as they arrive.

    Dataset sizing per the reference contract (IndexOutputStream::create,
    IndexOutputStream.cpp:87-171)."""

    def __init__(
        self,
        h5file,
        specs: list[StreamSpec],
        n_sensors: int,
        n_grid: int,
        sampled_steps: int,
        basis: Optional[CompressionBasis],
        compression_level: int = 0,
        reopen: bool = False,
        rows_done: int = 0,
        cuboid_shapes: Optional[list[tuple[int, int, int]]] = None,
        field_shape: Optional[tuple[int, ...]] = None,
    ):
        """`reopen` attaches to the existing datasets of a checkpointed run and seeks each
        stream to its resume position (IndexOutputStream::reopen,
        IndexOutputStream.cpp:202-246: raw rows = sampled steps done, compressed rows =
        floor(sampled/oSize)).

        `cuboid_shapes` [(cx, cy, cz), ...] switches raw/compressed streams to the
        reference's cuboid layout: an HDF5 group per stream with per-cuboid 4D datasets
        "1", "2", ... (CuboidOutputStream.cpp:656-722); the device pipeline still samples
        the linearized point list (one gather), and the writer splits each emission row
        back into cuboid blocks."""
        self.f = h5file
        self.specs = {s.name: s for s in specs}
        self.basis = basis
        self.n_sensors = n_sensors
        self.sampled_steps = sampled_steps
        self.cuboid_shapes = cuboid_shapes
        self.field_shape = field_shape
        o = basis.o_size if basis is not None else 1
        self.rows = {
            s.name: (rows_done if s.op == "raw" else rows_done // o) if reopen else 0
            for s in specs
        }
        if reopen:
            self.datasets = {s.name: h5file[s.name] for s in specs if s.save}
            return
        self.datasets = {}
        for s in specs:
            if not s.save:
                continue
            attrs = None
            if s.op == "c":
                attrs = CompressionAttrs(
                    harmonics=basis.harmonics,
                    period=basis.period,
                    mos=basis.mos,
                    shift=s.shifted_basis,
                    complex_size=s.complex_size(),
                    max_exp=s.e_const(),
                )
            if s.op in ("raw", "c") and cuboid_shapes is not None:
                self.datasets[s.name] = create_cuboid_group(
                    h5file, s.name, cuboid_shapes, sampled_steps, attrs=attrs,
                    compression_level=compression_level,
                )
            elif s.op == "raw":
                self.datasets[s.name] = create_raw_dataset(
                    h5file, s.name, n_sensors, sampled_steps, compression_level
                )
            elif s.op == "c":
                self.datasets[s.name] = create_compressed_dataset(
                    h5file, s.name, n_sensors, sampled_steps, attrs, compression_level
                )
            elif s.op in ("rms", "max", "min", "iavg_c"):
                if cuboid_shapes is not None:
                    # per-sensor aggregates of cuboid-mask runs keep the reference's
                    # per-cuboid group layout (CuboidOutputStream handles every reduce op)
                    self.datasets[s.name] = create_cuboid_group(
                        h5file, s.name, cuboid_shapes, 1,
                        compression_level=compression_level,
                    )
                else:
                    self.datasets[s.name] = create_aggregate_dataset(
                        h5file, s.name, n_sensors, compression_level
                    )
            elif s.op in ("max_all", "min_all", "final"):
                # whole-domain streams keep the full source-matrix dims in the file
                # (WholeDomainOutputStream.cpp:78-99; format table main.cpp:648-650)
                if field_shape is None:
                    raise ValueError(
                        f"stream {s.name!r} needs the grid field shape for its dataset"
                    )
                self.datasets[s.name] = create_field_dataset(
                    h5file, s.name, field_shape, compression_level
                )

    def _write_cuboid_rows(self, grp, spec, rows: np.ndarray, row0: int, values_per_pt):
        """Split linearized rows [n_rows, Npts*vpp] into per-cuboid 4D blocks
        (point order: cuboid-concatenated, x fastest — driver._corners_to_indices)."""
        n_rows = rows.shape[0]
        off = 0
        for ci, (cx, cy, cz) in enumerate(self.cuboid_shapes):
            npts = cx * cy * cz
            blk = rows[:, off * values_per_pt : (off + npts) * values_per_pt]
            ds = grp[str(ci + 1)]
            n = min(n_rows, ds.shape[0] - row0)
            if n > 0:
                ds[row0 : row0 + n, ...] = blk[:n].reshape(n, cz, cy, cx * values_per_pt)
            off += npts

    def flush_emissions(self, emissions: dict[str, Any]) -> None:
        """Write raw rows / one coefficient frame per compressed stream."""
        for name, data in emissions.items():
            if data is None:
                continue
            spec = self.specs[name]
            if not spec.save:  # hidden dependency stream (doNotSave)
                continue
            ds = self.datasets[name]
            if spec.op == "raw":
                rows = np.asarray(data)
                n = rows.shape[0]
                if self.cuboid_shapes is not None:
                    self._write_cuboid_rows(ds, spec, rows, self.rows[name], 1)
                    self.rows[name] += n
                    continue
                limit = ds.shape[1] - self.rows[name]
                n = min(n, limit)
                if n > 0:
                    ds[0, self.rows[name] : self.rows[name] + n, :] = rows[:n]
                    self.rows[name] += n
            elif spec.op == "c":
                if spec.mode40:
                    # emissions arrive as device-packed wire words
                    # (pack_40bit_emissions); the true payload is 5*N*H bytes
                    from kwave_tpu import bitpack

                    flat = bitpack.frame_wire_bytes(
                        data, self.n_sensors * self.basis.harmonics
                    )
                    if self.cuboid_shapes is not None:
                        # 40-bit cuboid rows are per-cuboid byte runs
                        self._write_cuboid_40b(ds, flat, self.rows[name])
                        self.rows[name] += 1
                        continue
                    if self.rows[name] >= ds.shape[1]:
                        continue
                    row = np.zeros(ds.shape[2], np.float32)
                    row.view(np.uint8)[: flat.size] = flat
                    ds[0, self.rows[name], :] = row.reshape(-1)
                    self.rows[name] += 1
                else:
                    row = encoder.frames_to_flat_float(*data)
                    if self.cuboid_shapes is not None:
                        h = self.basis.harmonics
                        self._write_cuboid_rows(
                            ds, spec, row.reshape(1, -1), self.rows[name], 2 * h
                        )
                        self.rows[name] += 1
                        continue
                    if self.rows[name] >= ds.shape[1]:
                        continue
                    ds[0, self.rows[name], :] = row.reshape(-1)
                    self.rows[name] += 1

    def _write_cuboid_40b(self, grp, flat_bytes: np.ndarray, row0: int) -> None:
        """One 40-bit frame into per-cuboid datasets: each point contributes 5*H bytes.

        O(#cuboids) host work per frame: the packed run is laid into the padded
        per-(z,y) x-rows with one strided byte-view assignment per cuboid (no
        per-row Python loop — CuboidOutputStream.cpp:400-533's serial point loop
        has no place on the host side here)."""
        h = self.basis.harmonics
        off_pts = 0
        for ci, (cx, cy, cz) in enumerate(self.cuboid_shapes):
            npts = cx * cy * cz
            ds = grp[str(ci + 1)]
            if row0 >= ds.shape[0]:
                off_pts += npts
                continue
            byte_run = flat_bytes[off_pts * 5 * h : (off_pts + npts) * 5 * h]
            # row-x size in floats: ceil(cx*1.25)*h per (y,z); bytes per x-row: 5*cx*h
            out = np.zeros(ds.shape[1:], np.float32)
            bpr = 5 * cx * h
            # [cz, cy, floats*4] byte view of the padded rows; fill the used prefix
            out.reshape(cz, cy, -1).view(np.uint8)[:, :, :bpr] = byte_run.reshape(
                cz, cy, bpr
            )
            ds[row0, ...] = out
            off_pts += npts

    def flush_aggregates(self, finals: dict[str, np.ndarray]) -> None:
        from kwave_tpu.io.hdf5 import is_group

        for name, data in finals.items():
            tgt = self.datasets[name]
            vals = np.asarray(data)
            if is_group(tgt):
                off = 0
                for ci, (cx, cy, cz) in enumerate(self.cuboid_shapes):
                    npts = cx * cy * cz
                    tgt[str(ci + 1)][...] = vals.reshape(-1)[off : off + npts].reshape(
                        1, cz, cy, cx
                    )
                    off += npts
            else:
                tgt[...] = vals.reshape(tgt.shape)

    def flush_final_fields(self, field_map: dict[str, np.ndarray]) -> None:
        """p_final/u*_final snapshots (KSpaceFirstOrderSolver.cpp:962-985)."""
        for name, data in field_map.items():
            self.datasets[name][...] = np.asarray(data).reshape(self.datasets[name].shape)
