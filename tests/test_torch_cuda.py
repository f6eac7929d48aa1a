"""The port's hand-written kernels on the card, against their plain
PyTorch versions. Every test here is marked ``cuda`` and skips without a
CUDA device; the CPU tests hold the plain versions against the JAX
package. This file imports neither JAX nor the JAX package, so on a
machine with the card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

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
