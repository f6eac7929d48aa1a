"""``ColumnarBatch.key_reps`` of the port against the JAX package's over
the dtype matrix. Every bucket id depends on these int64 reps, so they
must be equal bit for bit, nulls and string hashes included."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from hyperspace_tpu.io.columnar import ColumnarBatch as JBatch
from hyperspace_tpu.utils.hashing import murmur3_64_bytes as jax_murmur64
from hyperspace_tpu_torch.io.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.utils.hashing import murmur3_64_bytes

rng = np.random.default_rng(5)
N = 300
MASK = rng.random(N) < 0.15


def _ints(dtype):
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, N, dtype=dtype, endpoint=True)
    v[:2] = [info.min, info.max]
    return v


def _floats(dtype):
    v = rng.normal(0, 1e6, N).astype(dtype)
    v[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, np.float32(1.5)]
    v[6] = np.nan
    return v


ARRAYS = {
    "int8": lambda: pa.array(_ints(np.int8)),
    "int16": lambda: pa.array(_ints(np.int16)),
    "int32": lambda: pa.array(_ints(np.int32)),
    "int64": lambda: pa.array(_ints(np.int64)),
    "uint8": lambda: pa.array(_ints(np.uint8)),
    "uint64": lambda: pa.array(_ints(np.uint64)),
    "float32": lambda: pa.array(_floats(np.float32)),
    "float64": lambda: pa.array(_floats(np.float64)),
    "date32": lambda: pa.array(_ints(np.int32) % 40000).cast(pa.date32()),
    "timestamp_us": lambda: pa.array(_ints(np.int64) // 1000, type=pa.timestamp("us")),
    "timestamp_ns_tz": lambda: pa.array(_ints(np.int64), type=pa.timestamp("ns", "UTC")),
    "string": lambda: pa.array(
        [f"k{i % 37}é" for i in range(N)], type=pa.string()
    ),
    "large_string": lambda: pa.array(
        ["", "a", "ü" * 5] * (N // 3), type=pa.large_string()
    ),
    "dict_string": lambda: pa.array([f"v{i % 5}" for i in range(N)]).dictionary_encode(),
    "bool": lambda: pa.array(rng.random(N) < 0.5),
}


@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("kind", sorted(ARRAYS))
def test_key_reps_match_reference(kind, with_nulls):
    arr = ARRAYS[kind]()
    if with_nulls:
        dictionary = pa.types.is_dictionary(arr.type)
        if dictionary:
            arr = arr.dictionary_decode()
        arr = pc.if_else(pa.array(MASK[: len(arr)]), pa.scalar(None, arr.type), arr)
        if dictionary:
            arr = arr.dictionary_encode()
    t = pa.table({"c": arr, "k": pa.array(np.arange(len(arr)))})
    got = TBatch.from_arrow(t).key_reps(["c", "k"])
    want = JBatch.from_arrow(t).key_reps(["c", "k"])
    assert got.dtype == np.int64 and got.shape == (2, len(arr))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("s", ["", "a", "ab", "abc", "abcd", "héllo wörld", "x" * 101])
def test_string_hash_matches_reference(s):
    b = s.encode("utf-8")
    assert murmur3_64_bytes(b) == jax_murmur64(b)


def test_round_trip_and_take_match_reference():
    t = pa.table({k: f() for k, f in ARRAYS.items() if k != "large_string"})
    idx = rng.permutation(N)
    got = TBatch.from_arrow(t).take(idx).to_arrow()
    want = JBatch.from_arrow(t).take(idx).to_arrow()
    assert _ipc_bytes(got) == _ipc_bytes(want)  # bitwise, NaN included


def _ipc_bytes(table: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()
