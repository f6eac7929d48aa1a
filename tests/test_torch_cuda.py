"""The port's hand-written kernels on the card, against their plain
PyTorch versions. Every test here is marked ``cuda`` and skips without a
CUDA device; the CPU tests hold the plain versions against the JAX
package. This file imports neither JAX nor the JAX package, so on a
machine with the card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pytest
import torch

from hyperspace_tpu_torch.io.columnar import ColumnarBatch
from hyperspace_tpu_torch.ops import filter as F
from hyperspace_tpu_torch.ops import hash as H
from hyperspace_tpu_torch.ops import join as J
from hyperspace_tpu_torch.plan import expressions as E
from torch_b3a_cases import B3A_PREDICATES, ROWS, b3a_table
from torch_b4_cases import b4_edge_cases
import torch_b5_cases
import torch_b5f_cases
import torch_b6_cases
import torch_b7_cases
from torch_b5_cases import B5_CASES, b5_kernel_errors, b5_layouts, groups
from torch_index_files import index_files

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _ragged(rng, sizes, lo, hi):
    sizes = np.asarray(sizes, dtype=np.int64)
    keys = rng.integers(lo, hi, int(sizes.sum()), dtype=np.int64, endpoint=True)
    return keys, np.concatenate([[0], np.cumsum(sizes)])


@pytest.mark.parametrize(
    "l_sizes, r_sizes, lo, hi",
    [
        ([50, 0, 300, 7], [40, 60, 0, 9], 0, 60),
        ([33, 2000, 31], [100, 2000, 1], 0, 2),
        ([1000, 1000], [1000, 1000], -(1 << 63), (1 << 63) - 1),
    ],
)
def test_b4_equals_its_plain_version(cuda_device, l_sizes, r_sizes, lo, hi):
    rng = np.random.default_rng(len(l_sizes) + hi % 97)
    l, l_offs = _ragged(rng, l_sizes, lo, hi)
    r, r_offs = _ragged(rng, r_sizes, lo, hi)
    l[::7], r[::5] = hi, hi  # the range's ends as real keys on both sides
    l[1::11], r[1::4] = lo, lo
    lk, l_row = J.segment_sort(torch.from_numpy(l).to(cuda_device), l_offs)
    rk, r_row = J.segment_sort(torch.from_numpy(r).to(cuda_device), r_offs)
    before = J.launches
    got = J.match_pairs_kernel(lk, l_offs, rk, r_offs, l_row, r_row)
    torch.cuda.synchronize()
    assert J.launches == before + 3  # count pass, scan, emit pass
    want = J.match_pairs_torch(lk, l_offs, rk, r_offs, l_row, r_row)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].numel() > 0


EDGE = b4_edge_cases()


@pytest.mark.parametrize("int64_index", [False, True])
@pytest.mark.parametrize("case", sorted(EDGE))
def test_b4_edge_cases_equal_the_plain_version(cuda_device, case, int64_index):
    """Each search branch of B4 (shared-memory window, per-lane galloping,
    groups across segments, ragged tails), with int32 and with int64
    lo / cnt: pairs equal in order to the plain version."""
    l, l_offs, r, r_offs = EDGE[case]
    lk = torch.from_numpy(l).to(cuda_device)
    rk = torch.from_numpy(r).to(cuda_device)
    got = J.match_pairs_kernel(lk, l_offs, rk, r_offs, int64_index=int64_index)
    torch.cuda.synchronize()
    want = J.match_pairs_torch(lk, l_offs, rk, r_offs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].numel() > 0


def test_b4_launches_nothing_for_an_empty_side(cuda_device):
    k = torch.arange(9, device=cuda_device)
    z = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    before = J.launches
    for args in ((z, [0, 0], k, [0, 9]), (k, [0, 9], z, [0, 0])):
        li, ri = J.match_pairs_kernel(*args)
        assert li.shape == ri.shape == (0,) and li.device.type == "cuda"
    assert J.launches == before


def test_b1_equals_its_plain_version(cuda_device):
    rng = np.random.default_rng(3)
    reps = torch.from_numpy(
        rng.integers(-(1 << 63), (1 << 63) - 1, size=(2, 1001), dtype=np.int64)
    ).to(cuda_device)
    got = H.bucket_ids_kernel(reps, 200)
    assert torch.equal(got, H.bucket_ids_torch(reps, 200))


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("case", sorted(B3A_PREDICATES))
def test_b3a_equals_its_plain_version(cuda_device, case, n):
    """Kernel B3a on each case's fused terms equals its plain version and
    the host evaluator; a NEVER_MATCH case launches nothing; the +-2^53
    float bounds on int columns do not take B3a."""
    build, route = B3A_PREDICATES[case]
    batch = ColumnarBatch.from_arrow(b3a_table(n))
    expr = build(E)
    before = F.launches
    fused = F.fused_range_mask(expr, batch, cuda_device)
    if route == "general":
        assert fused is None and F.launches == before
        return
    assert np.array_equal(fused, E.filter_mask(expr, batch))
    if route == "never":
        assert F.launches == before and not fused.any()
        return
    assert F.launches == before + 1
    args = F.range_args(batch, F.lower_range_terms(expr, batch), cuda_device)
    got = F.range_mask_kernel(args)
    torch.cuda.synchronize()
    assert torch.equal(got, F.range_mask_torch(args))


B5_LAYOUTS = b5_layouts()


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "uint64"])
@pytest.mark.parametrize("layout", sorted(B5_LAYOUTS))
def test_b5_equals_its_plain_version_over_the_layouts(cuda_device, layout, dtype):
    """Every B5 launch function over groups across its 2,048-position
    ranges, on their edges, empty, or with no rows at all, at and around
    the lane path's longest group and the fold's tile, with and without
    nulls: bit-equal to the plain version on a CPU copy."""
    perm, offs, vals = B5_LAYOUTS[layout]
    dev = cuda_device
    p = None if perm is None else torch.from_numpy(perm).to(dev)
    o = torch.from_numpy(offs).to(dev)
    v = torch.from_numpy(vals[dtype].view(np.int64) if dtype == "uint64" else vals[dtype]).to(dev)
    for valid in (None, torch.from_numpy(vals["valid"]).to(dev)):
        errs = b5_kernel_errors(p, o, v, valid, unsigned=dtype == "uint64")
        torch.cuda.synchronize()
        assert all(e == 0 for e in errs.values()), errs


@pytest.mark.parametrize("case", sorted(B5_CASES))
def test_b5_equals_its_plain_version_over_the_cases(cuda_device, case):
    """B5 on the cases the CPU tests hold the plain versions to against
    the JAX package: bit-equal to the plain version."""
    from hyperspace_tpu_torch.ops import aggregate as AG

    gid, vals, valid, num = B5_CASES[case]
    perm, offs = groups(gid, num)
    v, unsigned = AG.device_values(vals, cuda_device)
    ok = None if valid is None else torch.from_numpy(valid).to(cuda_device)
    before = AG.launches
    errs = b5_kernel_errors(perm.to(cuda_device), offs.to(cuda_device), v, ok, unsigned)
    torch.cuda.synchronize()
    assert all(e == 0 for e in errs.values()), errs
    assert AG.launches > before


B5_START = torch_b5_cases.B5_START_CASES


@pytest.mark.parametrize("case", sorted(B5_START))
def test_b5_fold_from_a_start_equals_its_plain_version(cuda_device, case):
    """B5's fold from a carried start on the card: bit-equal to the plain
    version on a CPU copy."""
    from hyperspace_tpu_torch.ops import aggregate as AG

    gid, vals, valid, num, start = B5_START[case]
    perm, offs = groups(gid, num)
    st = torch.from_numpy(np.asarray(start, dtype=vals.dtype))
    v = torch.from_numpy(vals)
    ok = None if valid is None else torch.from_numpy(valid)
    dev = cuda_device
    got = AG.segment_sum_count_kernel(perm.to(dev), offs.to(dev), v.to(dev),
                                      None if ok is None else ok.to(dev), st.to(dev))
    torch.cuda.synchronize()
    want = AG.segment_sum_count_torch(perm, offs, v, ok, st)
    assert torch_b5_cases.abs_err(got[0], want[0]) == 0
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("case", sorted(torch_b5f_cases.B3B_CASES))
def test_b3b_equals_its_plain_version(cuda_device, case):
    """The fused select's indices on the card equal ``torch.nonzero`` of
    the plain mask, in order."""
    from hyperspace_tpu_torch.ops import filter as F

    table, terms = torch_b5f_cases.B3B_CASES[case]
    before = F.select_launches
    assert torch_b5f_cases.select_kernel_errors(table, terms, cuda_device) == 0
    torch.cuda.synchronize()
    lowers = table.num_rows and not any(t[5] for t in terms)
    assert F.select_launches == before + (1 if lowers else 0)


@pytest.mark.parametrize("case", sorted(torch_b5f_cases.B5F_CASES))
def test_b5f_equals_its_plain_version(cuda_device, case):
    """The fused filter→aggregate on the card, chunk by chunk with the
    state carried, on the route its plan takes (one pass for the ``int_``
    cases, ordered for the others): every state array bit-equal to the
    plain version's on the CPU, and B5f launched as often as the route
    asks."""
    from hyperspace_tpu_torch.ops import fused_agg as FA

    before = FA.launches
    c = torch_b5f_cases.B5F_CASES[case]
    errs = torch_b5f_cases.fused_kernel_errors(c, cuda_device)
    torch.cuda.synchronize()
    assert all(e == 0 for e in errs.values()), errs
    assert FA.launches == before + torch_b5f_cases.b5f_launches(c)


def _int_case(n, groups, seed=5, terms=None):
    """A one-pass case of ``n`` rows in ``groups`` groups, most rows passing."""
    rng = np.random.default_rng(seed)
    t = torch_b5f_cases._int_table(rng, n, g=rng.integers(0, groups, n))
    return dict(chunks=[t], group_by=["g"], aggs=torch_b5f_cases.INT_AGGS,
                terms=torch_b5f_cases.window(1, n) if terms is None else terms)


@pytest.mark.parametrize("n", [1, 2048, 2049, 8192, 8193])
def test_b5f_one_pass_at_block_edges(cuda_device, n):
    """One row, exactly one block (2,048 rows) and one row past it, 8,192
    and 8,193 rows: the one-pass route bit-equal to the plain version,
    grouped and not."""
    from hyperspace_tpu_torch.ops import fused_agg as FA

    for group_by in (["g"], []):
        c = dict(_int_case(n, 50, terms=() if n == 1 else None), group_by=group_by)
        before = FA.launches
        errs = torch_b5f_cases.fused_kernel_errors(c, cuda_device)
        torch.cuda.synchronize()
        assert all(e == 0 for e in errs.values()), (group_by, errs)
        assert FA.launches == before + torch_b5f_cases.b5f_launches(c)


def test_b5f_one_pass_over_tens_of_thousands_of_blocks(cuda_device, monkeypatch):
    """Blocks of 64 rows over 2,000,000 rows (31,250 blocks) with 3,000
    groups: every block's groups merged, bit-equal to the plain version."""
    from hyperspace_tpu_torch.ops import fused_agg as FA

    monkeypatch.setattr(FA, "BLOCK_ROWS", 64)
    c = _int_case(2_000_000, 3_000)
    errs = torch_b5f_cases.fused_kernel_errors(c, cuda_device)
    torch.cuda.synchronize()
    assert all(e == 0 for e in errs.values()), errs


def test_b5f_one_pass_numbers_more_new_groups_than_it_ranks(cuda_device):
    """5,000 new groups in one chunk (past the 1,024 the finish kernel
    ranks itself: one torch.sort numbers them), 50 to a block, none
    overflowing: bit-equal to the plain version, and carried into a
    second chunk."""
    from hyperspace_tpu_torch.ops import fused_agg as FA

    rng = np.random.default_rng(9)
    tables = [torch_b5f_cases._int_table(rng, 200_000, g=np.repeat(np.arange(5_000), 40)[::-1])
              for _ in range(2)]
    c = dict(chunks=tables, group_by=["g"], aggs=torch_b5f_cases.INT_AGGS,
             terms=torch_b5f_cases.window(0, 200_000))
    assert 5_000 > FA.RANK_MAX
    errs = torch_b5f_cases.fused_kernel_errors(c, cuda_device)
    torch.cuda.synchronize()
    assert all(e == 0 for e in errs.values()), errs


def test_b5f_overflowing_blocks_take_the_ordered_route(cuda_device):
    """100,000 groups over 150,000 rows overflow every block's table: the
    chunk is folded by the ordered route, counted, and bit-equal."""
    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.io.columnar import ColumnarBatch
    from hyperspace_tpu_torch.ops import fused_agg as FA

    c = torch_b5f_cases.B5F_CASES["int_groups_100000"]
    errs = torch_b5f_cases.fused_kernel_errors(c, cuda_device)
    assert all(e == 0 for e in errs.values()), errs
    st = PC.AggState(torch_b5f_cases.port_plan(c), cuda_device)
    st.accumulate(ColumnarBatch.from_arrow(c["chunks"][0]))
    torch.cuda.synchronize()
    assert st.state.overflowed == 1


def test_b5f_one_pass_synchronises_once_a_chunk(cuda_device):
    """Under torch's sync debug mode, a one-pass chunk (grouped, with
    carried groups, and ungrouped) warns of one synchronising call: the
    read back of its counters."""
    import warnings

    from hyperspace_tpu_torch.execution import pipeline_compiler as PC
    from hyperspace_tpu_torch.ops import fused_agg as FA

    for group_by in (["g"], []):
        c = dict(torch_b5f_cases.B5F_CASES["int_three_chunks_new_groups_later"],
                 group_by=group_by)
        st = PC.AggState(torch_b5f_cases.port_plan(c), cuda_device)
        chunks = [st._chunk(ColumnarBatch.from_arrow(t)) for t in c["chunks"]]
        torch.cuda.synchronize()
        for chunk in chunks:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    st.state = FA.fused_filter_agg_kernel(st.state, chunk)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs = [w for w in seen if "synchroniz" in str(w.message)]
            assert len(syncs) == 1, [str(w.message) for w in syncs]
        assert st.state.overflowed == 0


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 8191, 8192, 8193, 6_001_215])
def test_b3b_equals_nonzero_in_repeated_launches(cuda_device, n):
    """B3b's decoupled look-back at round edges (2,048 rows), tile edges
    and over hundreds of tiles: 50 launches, each equal to np.nonzero of
    the mask, in order."""
    import pyarrow as pa

    rng = np.random.default_rng(n)
    valid = rng.random(n) > 0.05
    batch = ColumnarBatch.from_arrow(pa.table({
        "k": rng.integers(0, 1000, n), "v": pa.array(rng.normal(size=n), mask=~valid)}))
    terms = [("k", 100, False, 700, True, False), ("v", None, False, 1.0, True, False)]
    want = np.nonzero(F.range_mask_numpy(batch, terms))[0]
    args = F.range_args(batch, terms, cuda_device)
    before = F.select_launches
    for _ in range(50):
        assert np.array_equal(F.select_kernel(args).cpu().numpy(), want)
    assert F.select_launches == before + (50 if n else 0)


@pytest.mark.parametrize("case", torch_b6_cases.CASES, ids=torch_b6_cases.case_id)
def test_b6_equals_its_plain_version(cuda_device, case):
    """B6's planes bit-equal to the plain version on a CPU copy of the
    words, one launch a call (none for n = 0); views 4 bytes past a
    16-byte boundary included."""
    from hyperspace_tpu_torch.ops import zorder as Z

    n, _k, bits, _fill, offset = case
    words = torch_b6_cases.words_tensor(case, cuda_device)
    if offset and n:
        assert words.data_ptr() % 16 == 4
    before = Z.launches
    got = Z.interleave_kernel(words, bits)
    torch.cuda.synchronize()
    assert Z.launches == before + (1 if n else 0)
    assert torch.equal(got.cpu(), Z.interleave_torch(words.cpu(), bits))


def test_zorder_create_launches_b6_and_writes_the_cpu_bytes(cuda_device, tmp_path):
    """A z-order create on the card launches B6 for its build and its
    z-span capture and writes the files and zone maps a cpu session
    writes."""
    import json
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch.indexes.zorder import ZOrderCoveringIndexConfig
    from hyperspace_tpu_torch.ops import zorder as Z

    rng = np.random.default_rng(3)
    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(pa.table({"a": rng.integers(0, 10_000, 50_000),
                             "b": rng.normal(size=50_000),
                             "c": rng.integers(0, 50, 50_000)}), str(src / "p.parquet"))
    docs, data = [], []
    for device in (cuda_device, "cpu"):
        sess = HyperspaceSession(device=device)
        sess.conf.set("hyperspace.system.path", str(tmp_path / str(device)))
        before = Z.launches
        Hyperspace(sess).create_index(sess.read.parquet(str(src)),
                                      ZOrderCoveringIndexConfig("z", ["a", "c"], ["b"]))
        if device != "cpu":
            assert Z.launches - before >= 2  # the build's and the capture's
        d = os.path.join(str(tmp_path / str(device)), "z", "v__=1")
        with open(os.path.join(d, "_zonemaps.json")) as fh:
            doc = json.load(fh)
        for e in doc["files"].values():
            e.pop("mtime_ns")
        docs.append(doc)
        with open(os.path.join(d, "part-00000-zorder.parquet"), "rb") as fh:
            data.append(fh.read())
    assert docs[0] == docs[1] and "zorder" in docs[0]
    assert data[0] == data[1]


@pytest.mark.parametrize("case", torch_b7_cases.CASES + torch_b7_cases.BOUNDARY_CASES,
                         ids=torch_b7_cases.case_id)
def test_b7_equals_its_plain_version(cuda_device, case):
    """B7's two entries on the card, the build by the route m gives (block
    up to 2^20 bits, binned up to 2^24, global beyond): the bit indices
    element by element and the built filter's words equal to the plain
    version's on a CPU copy (the wrap case's words against the plain
    indices, since its plain build would need a 2 GiB plane); one launch
    a call, counted by route, none for n = 0."""
    from hyperspace_tpu_torch.ops import bloom as B

    n, m, k, _fill = case
    reps = torch.from_numpy(torch_b7_cases.reps_for(case))
    dev = reps.to(cuda_device)
    routes = ("block_launches", "binned_launches", "global_launches")
    before = B.launches, [getattr(B, r) for r in routes]
    idx = B.bit_indices_kernel(dev, m, k)
    words = B.build_bloom_kernel(dev, m, k)
    torch.cuda.synchronize()
    assert B.launches == before[0] + (2 if n else 0)
    want_routes = [c + (1 if n and r.startswith(B.build_route(m)) else 0)
                   for r, c in zip(routes, before[1])]
    assert [getattr(B, r) for r in routes] == want_routes
    want = B.bit_indices_torch(reps, m, k)
    assert torch.equal(idx.cpu(), want)
    if m != torch_b7_cases.WRAP_M:
        assert torch.equal(words.cpu(), B.build_bloom_torch(reps, m, k))
    else:
        got = words.cpu().numpy().view(np.uint64)
        assert np.array_equal(got, torch_b7_cases.words_from_indices(want.numpy(), m))


@pytest.mark.parametrize("m", torch_b7_cases.BITS + tuple(
    c[1] for c in torch_b7_cases.BOUNDARY_CASES))
def test_b7_build_plan_on_the_card_equals_the_python_plan(cuda_device, m):
    """``hs_bloom_build``'s plan (route, bits a block holds, copies ORed,
    scratch bytes) equals ``build_plan`` given the route's blocks the card
    holds at once, at every row count the main path and the cases use."""
    from hyperspace_tpu_torch.ops import bloom as B

    for n in (0, 1, 65_537, 750_152, 6_001_215):
        for k in (1, 7, 16):
            plan, resident = B.kernel_build_plan(n, m, k, cuda_device)
            assert plan == B.build_plan(m, n, k, resident)
            assert (resident > 0) == (plan.route != "global")


def test_b7_build_refuses_too_little_scratch(cuda_device):
    """The binned route's C entry returns an error code for scratch
    smaller than its plan's (the wrapper always hands it the plan's)."""
    from hyperspace_tpu_torch.ops import bloom as B

    m, k, n = torch_b7_cases.PHASE_M, 7, 5000
    reps = torch.zeros(n, dtype=torch.int64, device=cuda_device)
    words = torch.empty(m // 64, dtype=torch.int64, device=cuda_device)
    need = B.build_plan(m, n, k, 0).scratch_bytes
    scratch = torch.empty(need, dtype=torch.uint8, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    build = B._kernel_fns()[1]
    assert build(reps.data_ptr(), words.data_ptr(), scratch.data_ptr(), need - 16, n, m, k,
                 stream) == 1  # cudaErrorInvalidValue
    assert build(reps.data_ptr(), words.data_ptr(), scratch.data_ptr(), need, n, m, k,
                 stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(words.cpu(), B.build_bloom_torch(reps.cpu(), m, k))


def test_b7_phase_11_filter_takes_the_binned_route(cuda_device):
    """phase 11's sketch (m = 5,751,040, k = 7, a file's 750,152 reps) is
    built on the binned route, equal to the plain version."""
    from hyperspace_tpu_torch.ops import bloom as B

    m, k, n = torch_b7_cases.PHASE_M, torch_b7_cases.PHASE_K, 750_152
    plan, resident = B.kernel_build_plan(n, m, k, cuda_device)
    assert plan.route == "binned" and resident >= 88 and plan.partials >= 1
    reps = torch.from_numpy(np.random.default_rng(3).integers(0, 1_500_000, n, dtype=np.int64))
    before = (B.block_launches, B.binned_launches, B.global_launches)
    words = B.build_bloom_kernel(reps.to(cuda_device), m, k)
    assert (B.block_launches, B.binned_launches, B.global_launches) == (
        before[0], before[1] + 1, before[2])
    assert torch.equal(words.cpu(), B.build_bloom_torch(reps, m, k))


def _ds_source(tmp_path, n_files=4, rows=20_000):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(9)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(n_files):
        pq.write_table(pa.table({"k": rng.integers(0, 50_000, rows),
                                 "d": np.sort(rng.integers(i * 1000, (i + 1) * 1000, rows)),
                                 "s": [f"v{x}" for x in rng.integers(0, 300, rows)]}),
                       str(src / f"p{i}.parquet"))
    return str(src)


def test_dataskipping_create_and_probe_launch_b7(cuda_device, tmp_path):
    """A create on the card launches B7 once a source file (the Bloom
    sketches of an int and a string column: twice a file) and writes the
    sketch file a cpu session writes; a probe launches B7 once a rule
    try, and the files kept and the rows equal the cpu session's."""
    import os

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch.indexes.dataskipping import DataSkippingIndexConfig
    from hyperspace_tpu_torch.indexes.sketches import BloomFilterSketch, MinMaxSketch
    from hyperspace_tpu_torch.ops import bloom as B

    src = _ds_source(tmp_path)
    data, kept, rows = [], [], []
    for device in (cuda_device, "cpu"):
        sess = HyperspaceSession(device=device)
        sess.conf.set("hyperspace.system.path", str(tmp_path / str(device)))
        hs = Hyperspace(sess)
        df = sess.read.parquet(src)
        before = B.launches
        hs.create_index(df, DataSkippingIndexConfig(
            "ds", MinMaxSketch("d"), BloomFilterSketch("k", 0.01, 20_000),
            BloomFilterSketch("s", 0.01, 300)))
        if device != "cpu":
            assert B.launches - before == 2 * 4
        with open(os.path.join(str(tmp_path / str(device)), "ds", "v__=1",
                               "part-00000-sketch.parquet"), "rb") as fh:
            data.append(fh.read())
        sess.enable_hyperspace()
        q = df.filter(df["k"].isin([5, 77, 123_456]) | (df["s"] == "v7")).select("k", "d")
        before = B.launches
        leaves = sess.optimize(q.logical_plan).collect_leaves()
        if device != "cpu":
            assert B.launches - before == 2 * 2  # two probes at each of two nodes
        assert leaves[0].relation.index_info[2] == "DS"
        kept.append(leaves[0].relation.files)
        rows.append(q.collect())
    assert data[0] == data[1]
    assert kept[0] == kept[1]
    assert rows[0].equals(rows[1])


def test_b7_launch_failure_fails_the_query_and_does_not_abstain(cuda_device, tmp_path,
                                                                 monkeypatch):
    """An error code from B7's C entry raises KernelLaunchError through the
    create and through the optimizer, never an unrewritten plan."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch.indexes.dataskipping import DataSkippingIndexConfig
    from hyperspace_tpu_torch.indexes.sketches import BloomFilterSketch
    from hyperspace_tpu_torch.kernels import KernelLaunchError
    from hyperspace_tpu_torch.ops import bloom as B

    src = _ds_source(tmp_path, n_files=2, rows=1000)
    sess = HyperspaceSession(device=cuda_device)
    sess.conf.set("hyperspace.system.path", str(tmp_path / "idx"))
    hs = Hyperspace(sess)
    df = sess.read.parquet(src)
    config = DataSkippingIndexConfig("ds", BloomFilterSketch("k", 0.01, 1000))
    real = B._kernel_fns()
    monkeypatch.setattr(B, "_kernel_fns", lambda: (real[0], lambda *a: 700))
    with pytest.raises(KernelLaunchError):
        hs.create_index(df, config)
    monkeypatch.setattr(B, "_kernel_fns", lambda: real)
    hs.create_index(df, DataSkippingIndexConfig("ds2", BloomFilterSketch("k", 0.01, 1000)))
    monkeypatch.setattr(B, "_kernel_fns", lambda: (lambda *a: 700, real[1]))
    sess.enable_hyperspace()
    q = df.filter(df["k"] == 5).select("k")
    with pytest.raises(KernelLaunchError):
        sess.optimize(q.logical_plan)
    with pytest.raises(KernelLaunchError):
        q.collect()


# -- the index lifecycle on the card ------------------------------------------


def _lifecycle_source(root, rows=20_000):
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    d = root / "lc_src"
    d.mkdir()
    rng = np.random.default_rng(12)
    for i in range(3):
        pq.write_table(pa.table({"k": rng.integers(0, 5000, rows), "p": rng.integers(0, 50, rows),
                                 "v": rng.normal(0, 5, rows)}), str(d / f"part{i}.parquet"))
    return str(d), os.path.join(str(d), "part{}.parquet")


def _lifecycle_config(kind):
    from hyperspace_tpu_torch import (
        CoveringIndexConfig,
        DataSkippingIndexConfig,
        ZOrderCoveringIndexConfig,
    )
    from hyperspace_tpu_torch.indexes.sketches import BloomFilterSketch, MinMaxSketch

    return {
        "covering": lambda: CoveringIndexConfig("lc", ["k"], ["p", "v"]),
        "zorder": lambda: ZOrderCoveringIndexConfig("lc", ["k", "p"], ["v"]),
        "dataskipping": lambda: DataSkippingIndexConfig(
            "lc", MinMaxSketch("k"), BloomFilterSketch("p", 0.01, 50)),
    }[kind]()


@pytest.mark.parametrize("kind", ["covering", "zorder", "dataskipping"])
def test_lifecycle_on_the_card_equals_a_cpu_session(cuda_device, tmp_path, kind):
    """An append and an incremental refresh, a full optimize (it compacts
    the covering index's two files a bucket), a delete with an append (the
    lineage rewrite) and a full refresh in a cuda and a cpu session over
    one source: each action on the card launches its
    kind's kernel (B1 for the covering index's hash, B6 for the z-order
    interleave, B7 for the Bloom builds; the captures' B5f), and every
    index file equals the cpu session's."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, ops

    src, part = _lifecycle_source(tmp_path)
    kernel = {"covering": "murmur3_bucket_ids", "zorder": "zorder_interleave",
              "dataskipping": "bloom_bits"}[kind]
    sides = []
    for device in (cuda_device, "cpu"):
        sess = HyperspaceSession(device=device)
        sess.conf.set("hyperspace.system.path", str(tmp_path / str(device)))
        sess.conf.set("hyperspace.index.num_buckets", 16)
        sess.conf.set("hyperspace.index.lineage.enabled", True)
        hs = Hyperspace(sess)
        hs.create_index(sess.read.parquet(src), _lifecycle_config(kind))
        sides.append((device, sess, hs))
    rng = np.random.default_rng(4)

    def append(name, n):
        pq.write_table(pa.table({"k": rng.integers(0, 6000, n), "p": rng.integers(0, 50, n),
                                 "v": rng.normal(0, 5, n)}), os.path.join(src, name))

    steps = [
        (lambda: append("part3.parquet", 500), ("refresh_index", "incremental")),
        (lambda: None, ("optimize_index", "full")),
        (lambda: (os.remove(part.format(0)), append("part4.parquet", 700)),
         ("refresh_index", "incremental")),
        (lambda: append("part5.parquet", 300), ("refresh_index", "full")),
    ]
    for change, (op, mode) in steps:
        change()
        for device, sess, hs in sides:
            ops.reset_launch_counts()
            getattr(hs, op)("lc", mode)
            counts = ops.launch_counts()
            if device != "cpu" and not (op == "optimize_index" and kind != "covering"):
                assert counts[kernel] > 0, (op, mode, counts)
                if kind != "dataskipping":
                    assert counts["fused_filter_agg"] > 0, (op, mode, counts)
            if device == "cpu":
                assert not any(counts.values()), counts
        got, want = (index_files(str(tmp_path / str(d) / "lc")) for d, _s, _h in sides)
        assert got == want, (op, mode)
    for device, sess, _hs in sides:
        sess.enable_hyperspace()
    q = [s.read.parquet(src) for _d, s, _h in sides]
    rows = [df.filter((df["k"] >= 100) & (df["k"] < 400)).select("k", "p", "v").collect()
            for df in q]
    assert rows[0].equals(rows[1]) and rows[0].num_rows > 0


def test_a_b1_fault_during_refresh_on_the_card_fails_it_and_leaves_the_transient_entry(
    cuda_device, tmp_path, monkeypatch
):
    """An error code from B1's C entry on a CUDA tensor during a refresh
    raises KernelLaunchError out of the action, on its first attempt: the
    leased REFRESHING entry stays at the log tip (its lease is live, so no
    recovery takes it) until cancel, and the refresh then runs."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch.kernels import KernelLaunchError

    src, _part = _lifecycle_source(tmp_path, rows=2000)
    sess = HyperspaceSession(device=cuda_device)
    sess.conf.set("hyperspace.system.path", str(tmp_path / "idx"))
    hs = Hyperspace(sess)
    hs.create_index(sess.read.parquet(src), CoveringIndexConfig("lc", ["k"], ["v"]))
    pq.write_table(pa.table({"k": np.arange(10), "p": np.arange(10), "v": np.ones(10)}),
                   os.path.join(src, "part9.parquet"))
    monkeypatch.setattr(H, "_kernel_fn", lambda: (lambda *a: 700))
    with pytest.raises(KernelLaunchError):
        hs.refresh_index("lc", "incremental")
    log = sess.index_manager._managers("lc")[0]
    tip = log.get_latest_log()
    assert tip.state == "REFRESHING"
    assert len(tip.properties["recovery.leaseOwner"]) == 32
    monkeypatch.undo()
    hs.cancel("lc")
    hs.refresh_index("lc", "incremental")
    assert log.get_latest_log().state == "ACTIVE"


def test_a_b1_fault_at_a_short_lease_is_rolled_back_by_the_next_refresh(
    cuda_device, tmp_path, monkeypatch
):
    """The same fault at a 50 ms lease: B1 was launched once (never
    retried), and once the lease has expired the next refresh rolls the
    REFRESHING entry back by itself, with no cancel, and then runs B1 on
    the card."""
    import os
    import time

    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops
    from hyperspace_tpu_torch.kernels import KernelLaunchError

    src, _part = _lifecycle_source(tmp_path, rows=2000)
    sess = HyperspaceSession(device=cuda_device)
    sess.conf.set("hyperspace.system.path", str(tmp_path / "idx"))
    sess.conf.set("hyperspace.recovery.leaseMs", 50)
    hs = Hyperspace(sess)
    hs.create_index(sess.read.parquet(src), CoveringIndexConfig("lc", ["k"], ["v"]))
    pq.write_table(pa.table({"k": np.arange(10), "p": np.arange(10), "v": np.ones(10)}),
                   os.path.join(src, "part9.parquet"))
    calls = []
    monkeypatch.setattr(H, "_kernel_fn", lambda: (lambda *a: calls.append(1) or 700))
    with pytest.raises(KernelLaunchError):
        hs.refresh_index("lc", "incremental")
    assert len(calls) == 1
    log = sess.index_manager._managers("lc")[0]
    assert log.get_latest_log().state == "REFRESHING"
    monkeypatch.undo()
    time.sleep(0.15)
    ops.reset_launch_counts()
    hs.refresh_index("lc", "incremental")
    assert ops.launch_counts()["murmur3_bucket_ids"] > 0
    states = [log.get_log(i).state for i in range(log.get_latest_id() + 1)
              if log.get_log(i) is not None]
    assert states[-4:] == ["REFRESHING", "ACTIVE", "REFRESHING", "ACTIVE"]


def test_hybrid_join_hashes_the_appended_rows_with_b1_as_the_plain_version(cuda_device, tmp_path):
    """A co-bucketed join over a Hybrid Scan ``Union`` (a file appended
    after the build), sequential and pipelined: the appended rows' bucket
    ids come from B1 on the card and equal the plain version's, and the
    rows equal a cpu session's in order."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops
    from hyperspace_tpu_torch.execution import executor as X

    rng = np.random.default_rng(8)
    items, orders = tmp_path / "items", tmp_path / "orders"
    items.mkdir(), orders.mkdir()
    for i in range(2):
        pq.write_table(pa.table({"k": rng.integers(0, 3000, 20_000), "q": rng.integers(0, 9, 20_000)}),
                       str(items / f"p{i}.parquet"))
        pq.write_table(pa.table({"ok": np.arange(i * 1500, (i + 1) * 1500),
                                 "c": rng.integers(0, 50, 1500)}), str(orders / f"p{i}.parquet"))
    sessions = []
    for device in (cuda_device, "cpu"):
        s = HyperspaceSession(device=device)
        s.conf.set("hyperspace.system.path", str(tmp_path / str(device)))
        s.conf.set("hyperspace.index.num_buckets", 16)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(str(items)), CoveringIndexConfig("i", ["k"], ["q"]))
        hs.create_index(s.read.parquet(str(orders)), CoveringIndexConfig("o", ["ok"], ["c"]))
        s.conf.set("hyperspace.index.hybridscan.enabled", True)
        s.enable_hyperspace()
        sessions.append(s)
    pq.write_table(pa.table({"k": rng.integers(0, 3500, 700), "q": rng.integers(0, 9, 700)}),
                   os.path.join(str(items), "appended.parquet"))
    calls = []
    real = X.bucket_ids

    def recording(reps, num_buckets, seed=42):
        out = real(reps, num_buckets, seed)
        calls.append((reps, num_buckets, out))
        return out

    X.bucket_ids = recording
    try:
        rows = {}
        for pipelined in (False, True):
            for s in sessions:
                s.conf.set("hyperspace.serve.pipeline.enabled", pipelined)
                o, i = s.read.parquet(str(orders)), s.read.parquet(str(items))
                ops.reset_launch_counts()
                rows[(pipelined, s.device.type)] = o.join(
                    i, on=o["ok"] == i["k"]).select("ok", "c", "q").collect()
                if s.device.type == "cuda":
                    assert ops.launch_counts()["murmur3_bucket_ids"] >= 1
                    assert ops.launch_counts()["bucket_match_pairs"] > 0
    finally:
        X.bucket_ids = real
    card_calls = [c for c in calls if c[0].is_cuda]
    assert len(card_calls) == 2 and all(c[0].shape == (1, 700) for c in card_calls)
    for reps, num_buckets, out in card_calls:
        assert torch.equal(out, H.bucket_ids_torch(reps, num_buckets))
    for pipelined in (False, True):
        assert rows[(pipelined, "cuda")].equals(rows[(pipelined, "cpu")])
    assert rows[(False, "cuda")].equals(rows[(True, "cuda")])
    assert 700 <= rows[(False, "cuda")].num_rows


def test_pipelined_build_on_the_card_writes_the_legacy_routes_files(cuda_device, tmp_path):
    """``hyperspace.index.build.partitionFirst`` on (the pipelined writer,
    the card's runs copied back through pinned memory) and off: the same
    bucket files byte for byte, and both launch B1."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops

    rng = np.random.default_rng(12)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(3):
        pq.write_table(pa.table({"k": rng.integers(0, 40, 30_000), "s": rng.choice(["a", "b"], 30_000),
                                 "v": rng.normal(size=30_000)}), str(src / f"p{i}.parquet"))
    files = {}
    for pf in (True, False):
        s = HyperspaceSession(device=cuda_device)
        s.conf.set("hyperspace.system.path", str(tmp_path / f"pf{pf}"))
        s.conf.set("hyperspace.index.num_buckets", 32)
        s.conf.set("hyperspace.index.build.partitionFirst", pf)
        ops.reset_launch_counts()
        Hyperspace(s).create_index(s.read.parquet(str(src)), CoveringIndexConfig("b", ["k"], ["s", "v"]))
        assert ops.launch_counts()["murmur3_bucket_ids"] >= 1
        assert {"scan", "hash_shuffle", "sort", "write"} <= set(s.build_stats)
        files[pf] = index_files(str(tmp_path / f"pf{pf}" / "b"))
    assert files[True] == files[False]
    assert sum(1 for f in files[True] if f.endswith(".parquet") and "bucket" in f) > 1


def test_delta_filter_and_time_travel_on_the_card_equal_a_cpu_session(cuda_device, tmp_path):
    """A Delta table indexed on the card and in a cpu session over the same
    lake: the index files byte for byte; a bucket-pruned point filter (B1
    on its literal, B3a on its residual) and a filter pinned with
    ``version_as_of`` (served by the first index version through
    ``closest_index``) give rows equal in order to the cpu session's, and
    to the plan without Hyperspace."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from torch_lake import add_action, delta_metadata, delta_schema_string, write_commit

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops

    rng = np.random.default_rng(15)
    table = tmp_path / "ld"
    table.mkdir()
    files = []
    for i in range(3):
        t = pa.table({"k": rng.integers(0, 5000, 40_000), "q": rng.integers(0, 50, 40_000)})
        files.append(str(table / f"part{i}.parquet"))
        pq.write_table(t, files[-1])
    schema = delta_schema_string(pq.read_schema(files[0]))
    write_commit(str(table), 0, delta_metadata(schema)
                 + [{"add": add_action(str(table), f)} for f in files[:2]])
    keys = [int(k) for k in rng.integers(0, 5000, 3)]
    out = {}
    for device in (cuda_device, "cpu"):
        s = HyperspaceSession(device=device)
        s.conf.set("hyperspace.system.path", str(tmp_path / str(device)))
        s.conf.set("hyperspace.index.num_buckets", 16)
        s.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
        hs = Hyperspace(s)
        ops.reset_launch_counts()
        hs.create_index(s.read.delta(str(table)), CoveringIndexConfig("d", ["k"], ["q"]))
        if s.device.type == "cuda":
            assert ops.launch_counts()["murmur3_bucket_ids"] >= 1
        out[s.device.type] = {"s": s, "hs": hs}
    write_commit(str(table), 1, [{"add": add_action(str(table), files[2])}])
    for side in out.values():
        side["hs"].refresh_index("d", "full")
    assert index_files(str(tmp_path / "cuda" / "d")) == index_files(str(tmp_path / "cpu" / "d"))
    rows = {}
    for dev, side in out.items():
        s, hs = side["s"], side["hs"]
        s.index_manager.clear_cache()
        for version in (None, 0):
            df = s.read.delta(str(table), version_as_of=version)
            for k in keys:
                q = df.filter(df["k"] == k).select("k", "q")
                s.enable_hyperspace()
                text = hs.explain(q).split("Plan without indexes:")[0]
                log_version = 2 if version == 0 else 4
                assert f"Name: d, LogVersion: {log_version}" in text, text
                ops.reset_launch_counts()
                s.exec_stats.reset()
                got = q.collect()
                if dev == "cuda":
                    assert ops.launch_counts()["murmur3_bucket_ids"] >= 1
                    assert s.exec_stats.bucket_pruned_scans == 1
                s.disable_hyperspace()
                assert got.equals(q.collect())
                rows[(dev, version, k)] = got
    for version in (None, 0):
        for k in keys:
            assert rows[("cuda", version, k)].equals(rows[("cpu", version, k)])


def test_streamed_build_holds_each_wave_b1_to_the_plain_version(cuda_device, tmp_path):
    """A budgeted create on the card reads its 6 files in 3 waves of 2:
    each wave's B1 call equals the plain version on the same reps, and the
    bucket files equal those of the same streamed build through a
    ``device="cpu"`` session byte for byte."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops
    from hyperspace_tpu_torch.indexes import covering_build as CB

    rng = np.random.default_rng(16)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(6):
        pq.write_table(pa.table({"k": rng.integers(0, 100_000, 20_000),
                                 "s": rng.choice(["a", "b", "c"], 20_000),
                                 "v": rng.normal(size=20_000)}), str(src / f"p{i}.parquet"))
    paths = sorted(str(p) for p in src.iterdir())
    budget = int(CB.estimated_materialized_bytes(paths[:1], "parquet") * 2.5)
    calls = []
    real = H.bucket_ids_kernel

    def recording(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    H.bucket_ids_kernel = recording
    try:
        files = {}
        for device in (cuda_device, "cpu"):
            s = HyperspaceSession(device=device)
            s.conf.set("hyperspace.system.path", str(tmp_path / str(device)))
            s.conf.set("hyperspace.index.num_buckets", 16)
            s.conf.set("hyperspace.index.build.memoryBudgetBytes", budget)
            ops.reset_launch_counts()
            Hyperspace(s).create_index(s.read.parquet(str(src)),
                                       CoveringIndexConfig("st", ["k"], ["s", "v"]))
            assert s.build_stats["waves"] == 3 and s.build_stats["spill_files"] == 48
            if s.device.type == "cuda":
                # the three waves, then the capture's calls, if any
                assert ops.launch_counts()["murmur3_bucket_ids"] >= 3
            files[s.device.type] = index_files(str(tmp_path / str(device) / "st"))
    finally:
        H.bucket_ids_kernel = real
    wave_calls = [c for c in calls if c[0][0].shape == (1, 40_000)]
    assert len(wave_calls) == 3
    for args, out in wave_calls:
        assert torch.equal(out, H.bucket_ids_torch(*args))
    assert files["cuda"] == files["cpu"]
    assert sum(1 for f in files["cuda"] if f.endswith(".parquet")) >= 16


def test_stream_join_launches_b4_a_wave_and_a_warm_cached_filter_launches_b3a(
        cuda_device, tmp_path):
    """The streamed co-bucketed join at 3 waves on the card: rows equal in
    order to the same join on a ``device="cpu"`` session (streamed and
    materializing), one B4 call a wave, each wave's pairs equal to B4's
    plain version. Then with the serve cache on, a warm filter served from
    the cached scan launches B3a, its mask equal to the plain version, its
    rows the cpu session's."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops
    from hyperspace_tpu_torch.execution import executor as X
    from hyperspace_tpu_torch.io import parquet as pio

    rng = np.random.default_rng(19)
    items, orders = tmp_path / "items", tmp_path / "orders"
    items.mkdir(), orders.mkdir()
    for i in range(2):
        pq.write_table(pa.table({"k": rng.integers(0, 3000, 20_000), "q": rng.integers(0, 9, 20_000)}),
                       str(items / f"p{i}.parquet"))
        pq.write_table(pa.table({"ok": np.arange(i * 1500, (i + 1) * 1500),
                                 "c": rng.integers(0, 50, 1500)}), str(orders / f"p{i}.parquet"))
    sessions = {}
    for device in (cuda_device, "cpu"):
        s = HyperspaceSession(device=device)
        s.conf.set("hyperspace.system.path", str(tmp_path / str(device)))
        s.conf.set("hyperspace.index.num_buckets", 16)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(str(items)), CoveringIndexConfig("i", ["k"], ["q"]))
        hs.create_index(s.read.parquet(str(orders)), CoveringIndexConfig("o", ["ok"], ["c"]))
        s.enable_hyperspace()
        sessions[s.device.type] = (s, hs)
    # the wave budget that packs the 16 buckets into 3 waves: each bucket's
    # footer estimate, two columns a side
    est = {}
    for name in ("i", "o"):
        files = sessions["cuda"][1].get_index(name).content.files
        for f, n in zip(files, pio.file_row_counts(files)):
            b = pio.bucket_id_of_file(f)
            est[b] = est.get(b, 0) + n * 2 * 8
    budget = next(x for x in range(1, sum(est.values()) + 1, 64)
                  if len(X.pack_waves(est, x)) == 3)

    def q(s):
        o, i = s.read.parquet(str(orders)), s.read.parquet(str(items))
        return o.join(i, on=o["ok"] == i["k"]).select("ok", "c", "q")

    calls = []
    real = J.match_pairs_kernel

    def recording(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    J.match_pairs_kernel = recording
    try:
        want = q(sessions["cpu"][0]).collect()
        for s, _hs in sessions.values():
            s.conf.set("hyperspace.serve.stream.enabled", True)
            s.conf.set("hyperspace.serve.stream.maxBytes", budget)
        ops.reset_launch_counts()
        got = q(sessions["cuda"][0]).collect()
        torch.cuda.synchronize()
        assert dict(X.last_stream_stats) == {"stream_waves": 3, "stream_buckets": 16}
        # one B4 call a wave; each call launches its passes (count, scan, emit)
        assert len(calls) == 3 and ops.launch_counts()["bucket_match_pairs"] >= 3
        for args, out in calls:
            for a, b in zip(out, J.match_pairs_torch(*args)):
                assert torch.equal(a, b)
        assert got.equals(want)
        assert q(sessions["cpu"][0]).collect().equals(want)
    finally:
        J.match_pairs_kernel = real
    masks = []
    real_mask = F.range_mask_kernel

    def recording_mask(*args):
        out = real_mask(*args)
        masks.append((args, out))
        return out

    def f(s):
        df = s.read.parquet(str(items))
        return df.filter((df["k"] >= 100) & (df["k"] < 900) & (df["q"] < 5)).select("k", "q")

    want = f(sessions["cpu"][0]).collect()
    s = sessions["cuda"][0]
    s.conf.set("hyperspace.serve.cache.enabled", True)
    f(s).collect()  # cold: decodes and caches the scan
    F.range_mask_kernel = recording_mask
    try:
        ops.reset_launch_counts()
        hits = s.serve_cache.hits
        got = f(s).collect()
        torch.cuda.synchronize()
    finally:
        F.range_mask_kernel = real_mask
    assert s.serve_cache.hits == hits + 1
    assert ops.launch_counts()["range_mask"] >= 1 and masks
    for args, out in masks:
        assert torch.equal(out, F.range_mask_torch(*args))
    assert got.equals(want)


def _b8_columns(rng, n, dev):
    """A shard's rows for B8: bucket ids with some out of order, a valid
    mask with invalid rows scattered and last, and one column of each
    width the build decomposes batches into (8-byte ints and floats with
    NaN, 4-byte codes, 2-byte, 1-byte and bool)."""
    f = rng.normal(size=n)
    f[::9] = np.nan
    cols = [
        torch.from_numpy(rng.integers(-(2**62), 2**62, n)),
        torch.from_numpy(f),
        torch.from_numpy(rng.integers(-5, 300, n).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 2**16, n).astype(np.int16)),
        torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8)),
        torch.from_numpy(rng.integers(0, 2, n).astype(bool)),
    ]
    valid = np.ones(n, dtype=bool)
    valid[::13] = False
    valid[n - n // 5 :] = False
    return [c.to(dev) for c in cols], torch.from_numpy(valid).to(dev)


def _same_bits(a, b) -> bool:
    """Bit equality (``torch.equal`` holds NaN unequal to itself)."""
    if a.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return a.dtype == b.dtype and torch.equal(a, b)


#: B8's card cases: (n, D, num_buckets, cap, layout, offset). cap None is
#: the largest destination's count (tight); layout "random", "one_dest"
#: (every row to one destination) or "all_invalid"; offset 1 makes every
#: input a view one element into a larger tensor, so that no column's
#: address is 16-byte aligned. 2,097,152 rows at D = 4 and cap 1,048,576
#: are chip_smoke.py phase 18's shard, whose pack the order then takes
#: over 4,194,304 slots; 4,095 and 4,097 rows sit one row either side of
#: the kernels' tile; 50,000 buckets take B8b's two-digit route.
B8_CASES = [
    pytest.param(1, 1, 1, None, "random", 0, id="1-1-1"),
    pytest.param(1025, 4, 200, None, "random", 0, id="1025-4-200"),
    pytest.param(70_001, 4, 200, None, "random", 0, id="70001-4-200"),
    pytest.param(1_500_304, 4, 200, None, "random", 0, id="1500304-4-200"),
    pytest.param(33_000, 8, 50_000, None, "random", 0, id="33000-8-50000"),
    pytest.param(2_097_152, 4, 200, 1 << 20, "random", 0, id="phase18"),
    pytest.param(4095, 4, 200, None, "random", 0, id="tile-minus-1"),
    pytest.param(4097, 4, 200, None, "random", 0, id="tile-plus-1"),
    pytest.param(10_000, 4, 200, None, "one_dest", 0, id="one-destination"),
    pytest.param(10_000, 4, 200, None, "all_invalid", 0, id="all-invalid"),
    pytest.param(70_001, 4, 200, None, "random", 1, id="odd-offset"),
]


def _b8_inputs(rng, n, D, nb, layout, offset, dev):
    """bucket, valid and the columns of one B8 card case (``B8_CASES``)."""
    ids = rng.integers(0, nb, n + offset).astype(np.int32)
    if layout == "one_dest":
        ids = ids - ids % D + 1 % D
        ids[ids >= nb] -= D
    cols, valid = _b8_columns(rng, n + offset, "cpu")
    if layout == "all_invalid":
        valid = torch.zeros_like(valid)
    ids = torch.from_numpy(ids)
    return [t.to(dev)[offset:] for t in (ids, valid, *cols)]


@pytest.mark.parametrize("n, D, nb, cap, layout, offset", B8_CASES)
def test_b8_pack_and_order_equal_their_plain_versions(cuda_device, n, D, nb, cap, layout,
                                                       offset):
    """B8a and B8b on the card, bit-equal to their plain versions on the
    same card tensors, every column width included, and to themselves
    over three calls; a count past cap raises."""
    from hyperspace_tpu_torch.ops import exchange as X

    rng = np.random.default_rng(n + D + offset)
    ids, valid, *cols = _b8_inputs(rng, n, D, nb, layout, offset, cuda_device)
    if offset:
        assert all(c.data_ptr() % 16 for c in (ids, *cols) if c.element_size() > 1)
    dest = torch.where(valid, ids.long() % D, D)
    tight = max(int(torch.bincount(dest, minlength=D + 1)[:D].max()), 1)
    cap = cap or tight
    before = X.pack_launches
    runs = [X.pack_kernel(ids, valid, D, cap, [ids, valid, *cols]) for _ in range(3)]
    assert X.pack_launches == before + 3
    got = runs[0]
    want = X.pack_torch(ids, valid, D, cap, [ids, valid, *cols])
    for run in runs:
        assert torch.equal(run[0], want[0])
        assert all(_same_bits(g, w) for g, w in zip(run[1], want[1]))
    recv_ids, recv_valid = got[1][0].reshape(-1), got[1][1].reshape(-1)
    recv = [c.reshape(-1) for c in got[1][2:]]
    o_want = X.order_torch(recv_ids, recv_valid, nb, [recv_ids, *recv])
    for _ in range(3):
        o_got = X.order_kernel(recv_ids, recv_valid, nb, [recv_ids, *recv])
        assert torch.equal(o_got[1], o_want[1])
        assert all(_same_bits(g, w) for g, w in zip(o_got[0], o_want[0]))
    # the order over the rows as they came, views included
    o_got = X.order_kernel(ids, valid, nb, [ids, valid, *cols])
    o_want = X.order_torch(ids, valid, nb, [ids, valid, *cols])
    assert torch.equal(o_got[1], o_want[1])
    assert all(_same_bits(g, w) for g, w in zip(o_got[0], o_want[0]))
    if tight > 1 and cap == tight:
        with pytest.raises(ValueError, match="overflow"):
            X.pack_kernel(ids, valid, D, cap - 1, [ids])


def test_sharded_build_on_the_card_writes_the_one_shard_files(cuda_device, tmp_path):
    """A D = 2 build on one card (kernels B1, B8a, B8b, the sharded tail)
    and a D = 1 build write the same bucket files byte for byte; the
    sharded join serves the rows of the one-shard join in order."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession, ops

    rng = np.random.default_rng(20)
    src, dim = tmp_path / "src", tmp_path / "dim"
    src.mkdir()
    dim.mkdir()
    for i in range(3):
        pq.write_table(pa.table({"k": rng.integers(0, 400, 30_000), "s": rng.choice(["a", "b"], 30_000),
                                 "v": rng.normal(size=30_000)}), str(src / f"p{i}.parquet"))
    pq.write_table(pa.table({"j": np.arange(400), "w": rng.normal(size=400)}), str(dim / "d.parquet"))
    files, rows = {}, {}
    for D in (1, 2):
        s = HyperspaceSession(devices=[cuda_device] * D)
        s.conf.set("hyperspace.system.path", str(tmp_path / f"d{D}"))
        s.conf.set("hyperspace.index.num_buckets", 32)
        s.conf.set("hyperspace.build.exchange.strategy", "flat")
        ops.reset_launch_counts()
        hs = Hyperspace(s)
        f, d = s.read.parquet(str(src)), s.read.parquet(str(dim))
        hs.create_index(f, CoveringIndexConfig("b", ["k"], ["s", "v"]))
        hs.create_index(d, CoveringIndexConfig("dj", ["j"], ["w"]))
        counts = ops.launch_counts()
        if D == 2:
            assert counts["bucket_exchange_pack"] == 2 * D  # two creates, a shard each
            assert counts["bucket_exchange_order"] == 2 * D
            assert s.build_stats.get("tail_shards") == 2.0
        files[D] = index_files(str(tmp_path / f"d{D}" / "b"))
        s.enable_hyperspace()
        ops.reset_launch_counts()
        rows[D] = f.join(d, on=f["k"] == d["j"]).select("k", "v", "w").collect()
        shard = ops.launch_counts()["bucket_match_pairs.shard"]
        assert shard == (ops.launch_counts()["bucket_match_pairs"] if D == 2 else 0)
    assert files[1] == files[2]
    assert rows[1].equals(rows[2]) and rows[1].num_rows > 0


def _sql_sessions(cuda_device, tmp_path):
    """A cuda and a cpu session over one two-table lake, each with its own
    covering indexes on the join keys and the views ``items`` and
    ``orders``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession

    rng = np.random.default_rng(29)
    items, orders = tmp_path / "items", tmp_path / "orders"
    items.mkdir(), orders.mkdir()
    for i in range(2):
        pq.write_table(pa.table({"k": rng.integers(0, 3000, 20_000), "q": rng.integers(0, 9, 20_000)}),
                       str(items / f"p{i}.parquet"))
        pq.write_table(pa.table({"ok": np.arange(i * 1500, (i + 1) * 1500),
                                 "c": rng.integers(0, 50, 1500)}), str(orders / f"p{i}.parquet"))
    sessions = {}
    for device in (cuda_device, "cpu"):
        s = HyperspaceSession(device=device)
        s.conf.set("hyperspace.system.path", str(tmp_path / str(device)))
        s.conf.set("hyperspace.index.num_buckets", 16)
        s.conf.set("hyperspace.index.filterRule.useBucketSpec", True)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(str(items)), CoveringIndexConfig("i", ["k"], ["q"]))
        hs.create_index(s.read.parquet(str(orders)), CoveringIndexConfig("o", ["ok"], ["c"]))
        s.read.parquet(str(items)).create_or_replace_temp_view("items")
        s.read.parquet(str(orders)).create_or_replace_temp_view("orders")
        s.enable_hyperspace()
        sessions[s.device.type] = s
    return sessions


SQL_FILTER = "SELECT k, q FROM items WHERE k = 1234"
SQL_JOIN = "SELECT ok, c, q FROM orders JOIN items ON ok = k"


def test_sql_filter_and_join_on_the_card_equal_a_cpu_session(cuda_device, tmp_path):
    """The SQL surface on the card: the point filter launches B1 and B3a,
    the join B4, and the rows equal a cpu session's in order."""
    from torch_b5_cases import same_rows

    from hyperspace_tpu_torch import ops

    sessions = _sql_sessions(cuda_device, tmp_path)
    for text, kernels in ((SQL_FILTER, ("murmur3_bucket_ids", "range_mask")),
                          (SQL_JOIN, ("bucket_match_pairs",))):
        ops.reset_launch_counts()
        got = sessions["cuda"].sql(text).collect()
        launched = ops.launch_counts()
        assert all(launched[k] > 0 for k in kernels), (text, launched)
        want = sessions["cpu"].sql(text).collect()
        assert got.num_rows > 0 and same_rows(got, want), text


def test_profiler_trace_names_b1_and_b4(cuda_device, tmp_path):
    """``hyperspace.profile.traceDir`` on a cuda session: a Chrome trace a
    query whose CUDA kernel events name B1's and B4's symbols, with every
    kernel the query launched."""
    import json
    import os

    from hyperspace_tpu_torch.session import launches_without_kernels

    s = _sql_sessions(cuda_device, tmp_path)["cuda"]
    trace_dir = str(tmp_path / "trace")
    s.conf.set("hyperspace.profile.traceDir", trace_dir)
    s.sql(SQL_FILTER).collect()
    s.sql(SQL_JOIN).collect()
    s.conf.set("hyperspace.profile.traceDir", "")
    files = sorted(os.listdir(trace_dir))
    assert len(files) == 2, files
    kernels = []
    for name in files:
        assert launches_without_kernels(os.path.join(trace_dir, name)) == 0, name
        with open(os.path.join(trace_dir, name)) as fh:
            kernels.append({e["name"] for e in json.load(fh)["traceEvents"]
                            if e.get("cat") == "kernel"})
    assert any("murmur3_bucket_kernel" in n for n in kernels[0]), kernels[0]
    assert any("count_kernel" in n for n in kernels[1]), kernels[1]
    assert any("emit_kernel" in n for n in kernels[1]), kernels[1]


def test_frontend_threads_serve_the_filters_with_b1_and_b3a_held(cuda_device, tmp_path):
    """8 client threads serve 32 point and 4 IN-list filters through the
    session's serve frontend on the card: every B1 and B3a call, launched
    from the frontend's ``hs-serve-*`` threads, equals its plain version on
    the same inputs, and every answer equals the cpu session's in order."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from torch_b5_cases import same_rows

    sessions = _sql_sessions(cuda_device, tmp_path)
    rng = np.random.default_rng(31)
    keys = [int(k) for k in rng.integers(0, 3000, 32)]
    lists = [[int(k) for k in rng.integers(0, 3000, 5)] for _ in range(4)]

    def queries(s):
        df = s.read.parquet(str(tmp_path / "items"))
        return ([df.filter(df["k"] == k).select("k", "q") for k in keys]
                + [df.filter(df["k"].isin(ks)).select("k", "q") for ks in lists])

    lock, calls, threads_seen = threading.Lock(), {"b1": [], "b3a": []}, set()
    real = {"b1": H.bucket_ids_kernel, "b3a": F.range_mask_kernel}

    def recording(kind):
        def run(*args):
            out = real[kind](*args)
            with lock:
                calls[kind].append((args, out))
                threads_seen.add(threading.current_thread().name)
            return out
        return run

    want = [q.collect() for q in queries(sessions["cpu"])]
    H.bucket_ids_kernel, F.range_mask_kernel = recording("b1"), recording("b3a")
    fe = sessions["cuda"].serve_frontend
    try:
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(fe.serve, queries(sessions["cuda"])))
        torch.cuda.synchronize()
    finally:
        H.bucket_ids_kernel, F.range_mask_kernel = real["b1"], real["b3a"]
        fe.close()
    assert all(same_rows(g, w) for g, w in zip(got, want))
    assert sum(w.num_rows for w in want) > 0
    assert fe.stats()["failed"] == 0
    assert calls["b1"] and calls["b3a"], {k: len(v) for k, v in calls.items()}
    assert all(name.startswith("hs-serve") for name in threads_seen), threads_seen
    for args, out in calls["b1"]:
        assert torch.equal(out, H.bucket_ids_torch(*args))
    for args, out in calls["b3a"]:
        assert torch.equal(out, F.range_mask_torch(*args))


def test_b1_launch_error_propagates_through_the_serve_frontend(cuda_device, tmp_path,
                                                               monkeypatch):
    """An error code from B1's C entry inside a frontend serve fails the
    query with KernelLaunchError: ``failed`` rises by 1 and neither
    ``retries`` nor ``degraded`` moves (ROADMAP C.7, C.21)."""
    from hyperspace_tpu_torch.kernels import KernelLaunchError

    s = _sql_sessions(cuda_device, tmp_path)["cuda"]
    df = s.read.parquet(str(tmp_path / "items"))
    fe = s.serve_frontend
    try:
        assert fe.serve(df.filter(df["k"] == 77).select("k", "q")) is not None
        before = fe.stats()
        monkeypatch.setattr(H, "_kernel_fn", lambda: (lambda *a: 700))
        with pytest.raises(KernelLaunchError):
            fe.serve(df.filter(df["k"] == 1234).select("k", "q"))
        after = fe.stats()
        monkeypatch.undo()
        assert after["failed"] == before["failed"] + 1
        assert (after["retries"], after["degraded"]) == (before["retries"], before["degraded"])
        assert fe.serve(df.filter(df["k"] == 1234).select("k", "q")).num_rows >= 0
    finally:
        fe.close()
