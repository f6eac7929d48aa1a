"""Every cell of the reference's crash matrix (``tests/test_crash_recovery.py``:
create, three refreshes, optimize, delete, restore and two vacuums, each at
every crash point it passes) through both packages in lockstep, with both
fault registries armed (``tests/torch_crash_twin.py::crash_cell``): the
crash counts, ``recover``'s reports, every log entry (the writer lease
checked well formed on both sides), the data file sets, the quarantine's
relative paths, the rows, and after the retry the index files byte for
byte are held equal. The same for a z-order and a data-skipping index.
"""

import os

import pytest
from torch_crash_twin import (
    CELLS,
    crash_cell,
    crash_twin,
    faults_of,
    quarantine,
    reset_faults,
    sample_source,
    wait_lease,
)
from torch_lifecycle_twin import append_file


@pytest.fixture(autouse=True)
def _clean_faults():
    reset_faults()
    yield
    reset_faults()


@pytest.mark.parametrize(("action", "point"), CELLS)
def test_crash_matrix_cell_matches_reference(tmp_path, action, point):
    crash_cell(tmp_path, sample_source(tmp_path), action, point)


@pytest.mark.parametrize("point", ["mid_data_write", "after_end_log"])
@pytest.mark.parametrize("kind", ["zorder", "ds"])
def test_create_crash_of_each_index_kind_matches_reference(tmp_path, kind, point):
    crash_cell(tmp_path, sample_source(tmp_path), "create", point, kind)


@pytest.mark.parametrize("kind", ["zorder", "ds"])
def test_refresh_crash_of_each_index_kind_matches_reference(tmp_path, kind):
    crash_cell(tmp_path, sample_source(tmp_path), "refresh_incremental", "mid_data_write", kind)


def test_mid_data_write_at_n_leaves_n_minus_one_files_in_both_packages(tmp_path):
    """``at=3``: two bucket files of the new version dir land before the
    crash; recovery quarantines exactly those two."""
    twin = crash_twin(tmp_path, sample_source(tmp_path))
    twin.create("covering", "idx", ["clicks"], ["query"])
    append_file(twin.src)
    for p, _s, hs in twin.sides():
        f = faults_of(p)
        f.set_crash("mid_data_write", "raise;at=3")
        with pytest.raises(f.SimulatedCrash):
            hs.refresh_index("idx", "full")
    wait_lease()
    reps = {p: hs.recover("idx") for p, _s, hs in twin.sides()}
    assert reps["port"] == reps["jax"]
    assert reps["port"]["gc"]["quarantined_dirs"] == 1
    q = {p: quarantine(os.path.join(twin.tsys if p == "port" else twin.jsys, "idx"))
         for p in ("port", "jax")}
    assert q["port"] == q["jax"]
    assert len([f for f in q["port"] if f.endswith(".parquet")]) == 2
