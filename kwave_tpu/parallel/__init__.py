"""Multi-device parallelism: mesh setup, field/codec shardings, distributed simulate.

The reference is strictly single-GPU (SURVEY.md §2.9; Readme.md:12 "single NVIDIA GPU") —
this layer is new: spatial domain decomposition of the solver fields over
the mesh 'space' axis and sensor-block data parallelism for the codec, with basis tables
replicated. XLA GSPMD inserts the collectives (all-gathers around the sharded-axis FFTs;
reduce-scatters where profitable).
"""

from kwave_tpu.parallel.mesh import (
    codec_sharding,
    field_sharding,
    make_mesh,
    pencil_fft,
    replicated,
    shard_operators,
    shard_state,
)

__all__ = [
    "make_mesh",
    "field_sharding",
    "codec_sharding",
    "pencil_fft",
    "replicated",
    "shard_operators",
    "shard_state",
]
