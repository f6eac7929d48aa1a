"""hslint for the port (``hyperspace_tpu_torch/analysis``), on the CPU.

* The gate: ``python -m hyperspace_tpu_torch.analysis`` reports zero
  unsuppressed findings on the port, and every suppression in the port
  carries a justification.
* Parity: the seven checkers copied unchanged (log_state, except_policy,
  locks, shared_state, contracts, obs, residency) give the JAX package's
  analyzer's findings, suppressions marked, on both packages. The one
  named difference: on the port, the JAX package's ``contracts`` reads
  ``scripts/dryrun_multihost.py`` for the collective sites' witness matrix
  (HS703), where the port's reads ``scripts/torch_dryrun_multihost.py``.
* The three checkers in the port's vocabulary (kernel_parity on
  ``csrc/*.cu`` and ``KERNEL_TWINS``, spmd on ``torch.distributed``,
  purity on ``torch.compile``) each have positive and negative cases on
  small torch snippets, twinning ``tests/test_hslint.py``'s.
"""

import os
import subprocess
import sys
import textwrap

import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu import analysis as ref
from hyperspace_tpu.analysis.core import Project as RefProject
from hyperspace_tpu_torch import analysis as port
from hyperspace_tpu_torch.analysis.core import Project

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(os.path.abspath(hyperspace_tpu_torch.__file__))
REF_DIR = os.path.dirname(os.path.abspath(hyperspace_tpu.__file__))
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

#: the checkers the port copies unchanged
UNADAPTED = ("log_state", "except_policy", "locks", "shared_state", "contracts", "obs",
             "residency")
ADAPTED = ("kernel_parity", "spmd", "purity")


def _write_tree(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))


def _lint(tmp_path, files, tests=None):
    """Unsuppressed findings of the port's analyzer for a fixture tree."""
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    _write_tree(pkg, files)
    tests_dir = None
    if tests is not None:
        tdir = tmp_path / "tests"
        tdir.mkdir(exist_ok=True)
        _write_tree(tdir, tests)
        tests_dir = str(tdir)
    return [f for f in port.run_analysis(str(pkg), tests_dir=tests_dir) if not f.suppressed]


def _rules(findings):
    return sorted({f.rule for f in findings})


class _Runs:
    """Each (analyzer, package) pair parsed once and each checker run once
    on it, suppressions marked as ``run_analysis`` marks them."""

    def __init__(self):
        self._projects = {}
        self._found = {}

    def project(self, analyzer, package_dir):
        key = (analyzer, package_dir)
        if key not in self._projects:
            cls = Project if analyzer == "port" else RefProject
            self._projects[key] = cls(package_dir, tests_dir=TESTS_DIR)
        return self._projects[key]

    def findings(self, analyzer, package_dir, checker):
        key = (analyzer, package_dir, checker)
        if key not in self._found:
            project = self.project(analyzer, package_dir)
            mod = getattr(port if analyzer == "port" else ref, checker)
            by_display = {sf.rel_path: sf for sf in project.files.values()}
            out = [(f.rule, f.path, f.line, f.message, False) for f in project.findings]
            for f in mod.check(project):
                sf = by_display.get(f.path)
                out.append((f.rule, f.path, f.line, f.message,
                            bool(sf is not None and sf.is_suppressed(f.rule, f.line))))
            self._found[key] = sorted(set(out))
        return self._found[key]


@pytest.fixture(scope="module")
def runs():
    """The parsed trees of both packages, freed when the module ends (they
    are large: collecting them later stalls the worker's exit)."""
    import gc

    r = _Runs()
    yield r
    r._projects.clear()
    r._found.clear()
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def cli_run():
    """``python -m hyperspace_tpu_torch.analysis`` on the port, started
    when the module's first test starts and read by the CLI test."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperspace_tpu_torch.analysis"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
    )
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


class TestPackageClean:
    def test_no_unsuppressed_findings(self, runs):
        active = [f for name in ADAPTED + UNADAPTED
                  for f in runs.findings("port", PORT_DIR, name) if not f[4]]
        assert active == [], "\n".join(map(str, active))

    def test_cli_exits_zero_on_the_port(self, cli_run):
        out, err = cli_run.communicate(timeout=600)
        assert cli_run.returncode == 0, out + err
        assert "hslint: 0 finding(s)" in out
        assert "1 package(s)" in out

    def test_every_suppression_is_justified(self):
        """A ``# hslint: disable=`` in the port has a reason: words in its
        own comment (before the marker or after the rule list), or a
        comment line next to it."""
        import re

        marker = re.compile(r"#(?P<before>[^#]*?)#?\s*hslint:\s*disable=[A-Za-z0-9_,]+(?P<after>.*)$")
        bare = []
        for dirpath, _dirs, names in os.walk(PORT_DIR):
            if os.path.basename(dirpath) == "analysis":
                continue  # the analyzer's own docstrings name the marker
            for name in (n for n in names if n.endswith(".py")):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    lines = fh.read().splitlines()
                for i, line in enumerate(lines):
                    m = marker.search(line)
                    if m is None:
                        continue
                    own = (m.group("before") + m.group("after")).strip()
                    near = [
                        lines[k] for k in (i - 2, i - 1, i + 1, i + 2)
                        if 0 <= k < len(lines) and lines[k].strip().startswith("#")
                        and "hslint: disable" not in lines[k]
                    ]
                    if not (own or near):
                        bare.append(f"{path}:{i + 1}: {line.strip()}")
        assert bare == [], "\n".join(bare)

    def test_the_analyzer_names_the_port(self):
        from hyperspace_tpu_torch.analysis import __main__ as cli

        assert cli.__doc__.startswith("CLI entry point: ``python -m hyperspace_tpu_torch.analysis")
        parser_src = open(cli.__file__, encoding="utf-8").read()
        assert 'prog="python -m hyperspace_tpu_torch.analysis"' in parser_src
        for name in os.listdir(os.path.join(PORT_DIR, "analysis")):
            if name.endswith(".py"):
                src = open(os.path.join(PORT_DIR, "analysis", name), encoding="utf-8").read()
                assert "from hyperspace_tpu.analysis" not in src
                assert "import jax" not in src

    def test_ruleset_matches_the_reference(self):
        assert port.ALL_RULES.keys() == ref.ALL_RULES.keys()
        assert [m.__name__.rsplit(".", 1)[1] for m in port.CHECKERS] == [
            m.__name__.rsplit(".", 1)[1] for m in ref.CHECKERS
        ]


# ---------------------------------------------------------------------------
# Parity of the unadapted checkers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", ["hyperspace_tpu", "hyperspace_tpu_torch"])
@pytest.mark.parametrize("checker", UNADAPTED)
def test_unadapted_checker_finds_what_the_reference_finds(runs, package, checker):
    pkg_dir = REF_DIR if package == "hyperspace_tpu" else PORT_DIR
    mine = runs.findings("port", pkg_dir, checker)
    theirs = runs.findings("ref", pkg_dir, checker)
    if checker == "contracts" and package == "hyperspace_tpu_torch":
        # the named difference: the reference's checker holds the port's
        # collective sites to the JAX package's dryrun script
        dryrun_holes = [f for f in theirs
                        if f[0] == "HS703" and "scripts/dryrun_multihost.py" in f[3]]
        assert dryrun_holes
        theirs = [f for f in theirs if f not in dryrun_holes]
    assert mine == theirs


def test_adapted_checkers_engage_on_the_port(runs):
    """The adapted checkers see the port's surfaces: suppressed findings
    aside, nothing, but kernel_parity reads every csrc source and spmd
    every registered site (the cases below hold what they would flag)."""
    for name in ADAPTED:
        assert [f for f in runs.findings("port", PORT_DIR, name) if not f[4]] == []
    from hyperspace_tpu_torch.analysis import kernel_parity

    project = runs.project("port", PORT_DIR)
    assert len(project.cuda_sources()) == 9
    assert kernel_parity._registry(project.file("ops/__init__.py").tree)[1]


# ---------------------------------------------------------------------------
# kernel_parity (HS1xx) on csrc/*.cu and KERNEL_TWINS
# ---------------------------------------------------------------------------

CU = """
    #include <cstdint>
    __global__ void foo_kernel(const int64_t* x, int32_t* out, int64_t n) {}
    extern "C" int hs_foo(const void* x, void* out, int64_t n, void* stream) {
      return 0;
    }
"""

CU_FUSED = """
    extern "C" {
    int hs_fused_bar(const void* x, int64_t n) { return 0; }
    long long hs_agg_bar_scratch(long long n) { return 8; }
    }  // extern "C"
"""

OPS_FOO = """
    def foo_kernel(x):
        return x

    def foo_torch(x):
        return x
"""

REG_OK = """
    KERNEL_TWINS = {
        "foo": ("pkg.ops.foo", "foo_kernel", "foo_torch", "pkg/csrc/foo.cu"),
    }
"""

CARD_TEST = {"test_torch_cuda.py": "def test_foo():\n    assert foo_kernel\n"}


class TestKernelParity:
    def test_export_with_no_registry_entry(self, tmp_path):
        files = {"csrc/foo.cu": CU, "ops/__init__.py": "KERNEL_TWINS = {}\n",
                 "ops/foo.py": OPS_FOO}
        findings = _lint(tmp_path, files, CARD_TEST)
        assert "HS101" in _rules(findings)
        assert "hs_foo" in findings[0].message

    def test_no_registry_at_all(self, tmp_path):
        files = {"csrc/foo.cu": CU, "ops/__init__.py": "def foo():\n    return None\n"}
        assert "HS101" in _rules(_lint(tmp_path, files, CARD_TEST))

    def test_stale_entry_and_unresolved_twin(self, tmp_path):
        files = {
            "csrc/foo.cu": CU,
            "ops/foo.py": OPS_FOO,
            "ops/__init__.py": """
                KERNEL_TWINS = {
                    "foo": ("pkg.ops.foo", "missing_wrapper", "foo_torch", "pkg/csrc/foo.cu"),
                    "gone": ("pkg.ops.foo", "foo_kernel", "foo_torch", "pkg/csrc/gone.cu"),
                    "lost": ("pkg.ops.nowhere", "foo_kernel", "foo_torch", "pkg/csrc/foo.cu"),
                }
            """,
        }
        rules = _rules(_lint(tmp_path, files, CARD_TEST))
        assert "HS102" in rules and "HS103" in rules

    def test_missing_card_test(self, tmp_path):
        files = {"csrc/foo.cu": CU, "ops/__init__.py": REG_OK, "ops/foo.py": OPS_FOO}
        findings = _lint(tmp_path, files, {
            "test_torch_cuda.py": "def test_x():\n    pass\n",
            # a CPU test naming the wrapper is not a test on the card
            "test_torch_foo.py": "def test_foo():\n    assert foo_kernel\n",
        })
        assert _rules(findings) == ["HS104"]

    def test_an_export_name_in_the_card_test_counts(self, tmp_path):
        files = {"csrc/foo.cu": CU, "ops/__init__.py": REG_OK, "ops/foo.py": OPS_FOO}
        assert _lint(tmp_path, files, {"test_torch_cuda.py": "X = 'hs_foo'\n"}) == []

    def test_clean(self, tmp_path):
        files = {"csrc/foo.cu": CU, "ops/__init__.py": REG_OK, "ops/foo.py": OPS_FOO}
        assert _lint(tmp_path, files, CARD_TEST) == []

    def test_fused_export_with_torch_twin_flagged(self, tmp_path):
        files = {
            "csrc/bar.cu": CU_FUSED,
            "ops/bar.py": "def fused_bar(x):\n    return x\n",
            "ops/__init__.py": """
                KERNEL_TWINS = {
                    "bar": ("pkg.ops.bar", "fused_bar", "torch.sort", "pkg/csrc/bar.cu"),
                }
            """,
        }
        findings = _lint(tmp_path, files, {"test_torch_cuda.py": "assert fused_bar\n"})
        assert "HS105" in _rules(findings)

    def test_fused_export_with_interpreted_twin_clean(self, tmp_path):
        files = {
            "csrc/bar.cu": CU_FUSED,
            "ops/bar.py": ("def fused_bar(x):\n    return x\n\n"
                           "def interpreted_bar(x):\n    return x\n"),
            "ops/__init__.py": """
                KERNEL_TWINS = {
                    "bar": ("pkg.ops.bar", "fused_bar", "interpreted_bar", "pkg/csrc/bar.cu"),
                }
            """,
        }
        assert _lint(tmp_path, files, {"test_torch_cuda.py": "assert fused_bar\n"}) == []

    def test_exports_of_the_port(self):
        from hyperspace_tpu_torch.analysis import kernel_parity

        p = Project(PORT_DIR)
        exports = {rel: kernel_parity.cuda_exports(p.text(rel)) for rel in p.cuda_sources()}
        assert exports["csrc/murmur3_bucket.cu"] == ["hs_murmur3_bucket_ids"]
        assert "hs_fused_group" in exports["csrc/fused_agg.cu"]
        assert sum(len(v) for v in exports.values()) >= 20
        # every source belongs to a KERNEL_TWINS entry
        from hyperspace_tpu_torch.ops import KERNEL_TWINS

        assert {os.path.basename(src) for *_x, src in KERNEL_TWINS.values()} == {
            os.path.basename(rel) for rel in exports
        }


# ---------------------------------------------------------------------------
# purity (HS3xx) on torch.compile / torch.jit.script
# ---------------------------------------------------------------------------


class TestPurity:
    def test_numpy_in_compiled_function(self, tmp_path):
        files = {"ops/k.py": """
            import numpy as np
            import torch

            @torch.compile
            def bad(x):
                return np.concatenate([x, x])
        """}
        assert "HS301" in _rules(_lint(tmp_path, files))

    def test_host_sync_in_compiled_function(self, tmp_path):
        files = {"ops/k.py": """
            import torch

            @torch.jit.script
            def bad(x):
                return x.sum().item()

            @torch.compile(mode="max-autotune")
            def also_bad(x):
                torch.cuda.synchronize()
                return x.cpu()
        """}
        findings = _lint(tmp_path, files)
        assert _rules(findings) == ["HS302"]
        assert len(findings) == 3

    def test_compile_by_name_and_partial(self, tmp_path):
        files = {"execution/k.py": """
            import functools
            import numpy as np
            import torch

            def local(x):
                return np.argsort(x)

            fast = torch.compile(local)

            @functools.partial(torch.compile, dynamic=True)
            def also_bad(x):
                return np.asarray(x)
        """}
        findings = _lint(tmp_path, files)
        assert "HS301" in _rules(findings)  # np.argsort in a compiled function
        assert "HS302" in _rules(findings)  # np.asarray under compile

    def test_clean_and_allowlist(self, tmp_path):
        files = {"ops/k.py": """
            import numpy as np
            import torch

            @torch.compile
            def good(x):
                return torch.sum(x) + np.int64(1)

            def host_helper(x):
                # not compiled: host numpy and syncs are fine here
                return np.asarray(x.cpu()).tolist()
        """}
        assert _lint(tmp_path, files) == []

    def test_suppression(self, tmp_path):
        files = {"ops/k.py": """
            import numpy as np
            import torch

            @torch.compile
            def bad(x):
                # a graph break by contract here
                return np.log(x)  # hslint: disable=HS301
        """}
        assert _lint(tmp_path, files) == []

    def test_annotations_are_not_compiled(self, tmp_path):
        files = {"ops/k.py": """
            import numpy as np
            import torch

            @torch.compile
            def good(x: np.ndarray) -> np.ndarray:
                y: np.ndarray = torch.sum(x)
                return y
        """}
        assert _lint(tmp_path, files) == []

    def test_outside_the_hot_dirs(self, tmp_path):
        files = {"tools/k.py": """
            import numpy as np
            import torch

            @torch.compile
            def bad(x):
                return np.log(x)
        """}
        assert _lint(tmp_path, files) == []


# ---------------------------------------------------------------------------
# spmd (HS8xx) on torch.distributed
# ---------------------------------------------------------------------------

SPMD_REGISTRY = '''
    COLLECTIVE_SITES = {
        "pkg.comm.exchange": (
            "all_to_all_single",
            "symmetric-all",
            "every process exchanges at the same step",
        ),
    }
'''

SPMD_COMM = """
    import torch.distributed as dist

    def exchange(out, x):
        dist.all_to_all_single(out, x)
        return out
"""

SPMD_GATED_REGISTRY = '''
    COLLECTIVE_SITES = {
        "pkg.comm.exchange": (
            "all_to_all_single",
            "symmetric-all",
            "every process exchanges at the same step",
        ),
        "pkg.logplane.publish": (
            "log_write",
            "coordinator-gated",
            "single-writer metadata seam",
        ),
    }
'''


class TestSpmd:
    def test_identity_branch_skipping_collective(self, tmp_path):
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "job.py": """
                import torch.distributed as dist

                from pkg.comm import exchange

                def run(out, x):
                    if dist.get_rank() == 0:
                        return exchange(out, x)
                    return x
            """,
        }
        findings = [f for f in _lint(tmp_path, files) if f.rule == "HS801"]
        assert findings and "exchange" in findings[0].message

    def test_identity_branch_via_tainted_local(self, tmp_path):
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "job.py": """
                from pkg.comm import exchange

                def run(mesh, out, x):
                    pid = mesh.process_index
                    if pid == 0:
                        exchange(out, x)
                    return x
            """,
        }
        assert "HS801" in _rules(_lint(tmp_path, files))

    def test_symmetric_branch_is_clean(self, tmp_path):
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "job.py": """
                import torch.distributed as dist

                from pkg.comm import exchange

                def run(out, x, y):
                    if dist.get_rank() == 0:
                        res = exchange(out, x)
                    else:
                        res = exchange(out, y)
                    return res
            """,
        }
        assert _lint(tmp_path, files) == []

    def test_world_size_branch_is_uniform(self, tmp_path):
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "job.py": """
                import torch.distributed as dist

                from pkg.comm import exchange

                def run(out, x):
                    if dist.get_world_size() > 1:
                        return exchange(out, x)
                    return x
            """,
        }
        assert _lint(tmp_path, files) == []

    def test_coordinator_gated_branch_is_clean(self, tmp_path):
        files = {
            "collectives.py": SPMD_GATED_REGISTRY,
            "comm.py": SPMD_COMM,
            "logplane.py": """
                import torch.distributed as dist

                def publish(x):
                    dist.broadcast(x, 0)
                    return x
            """,
            "job.py": """
                from pkg.comm import exchange
                from pkg.logplane import publish

                def run(runtime, out, x):
                    if runtime.is_coordinator:
                        publish(x)
                    return exchange(out, x)
            """,
        }
        assert _lint(tmp_path, files) == []

    def test_unregistered_collective(self, tmp_path):
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "rogue.py": """
                import torch.distributed as dist

                def sneak(t):
                    dist.all_reduce(t)
                    return t
            """,
        }
        findings = [f for f in _lint(tmp_path, files) if f.rule == "HS802"]
        assert findings and "sneak" in findings[0].message and "all_reduce" in findings[0].message

    def test_in_process_block_exchange_is_a_collective(self, tmp_path):
        """``_exchange_blocks``, the all_to_all between the shards of one
        mesh, needs a registry entry like a torch.distributed call."""
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "shards.py": """
                def _exchange_blocks(mesh, blocks):
                    return blocks

                def flat(mesh, blocks):
                    return _exchange_blocks(mesh, blocks)
            """,
        }
        findings = [f for f in _lint(tmp_path, files) if f.rule == "HS802"]
        assert len(findings) == 1 and "flat" in findings[0].message

    def test_torch_ops_named_like_collectives_are_not(self, tmp_path):
        """``torch.gather`` / ``Tensor.scatter`` are local ops: only calls
        through a torch.distributed receiver are collectives."""
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "local.py": """
                import torch

                def pick(x, idx):
                    y = torch.gather(x, 0, idx)
                    return y.scatter(0, idx, y), torch.broadcast_tensors(x, y)
            """,
        }
        assert _lint(tmp_path, files) == []

    def test_stale_registry_entries(self, tmp_path):
        files = {
            "collectives.py": '''
    COLLECTIVE_SITES = {
        "pkg.comm.exchange": (
            "all_to_all_single",
            "symmetric-all",
            "every process exchanges at the same step",
        ),
        "pkg.comm.gone": ("all_gather", "symmetric-all", "stale"),
        "pkg.comm.exchange2": ("all_gather", "bogus-contract", "bad"),
        "pkg.comm.exchange3": ("all_gather", "symmetric-all", ""),
        "pkg.comm.quiet": ("all_gather", "symmetric-all", "no op inside"),
    }
''',
            "comm.py": SPMD_COMM + """
    def exchange2(out, x):
        dist.all_gather(out, x)

    def exchange3(out, x):
        dist.all_gather(out, x)

    def quiet(x):
        return x
""",
        }
        rules = [f.rule for f in _lint(tmp_path, files)]
        assert rules.count("HS802") == 4

    def test_an_entry_reaching_a_registered_collective_is_live(self, tmp_path):
        """A one-process form that hands a job of processes to its
        multi-process form reaches that form's collective: not stale."""
        files = {
            "collectives.py": '''
    COLLECTIVE_SITES = {
        "pkg.comm.exchange": (
            "all_to_all_single",
            "symmetric-all",
            "every process exchanges at the same step",
        ),
        "pkg.comm.one_process": ("block copy", "symmetric-all", "delegates on a job"),
    }
''',
            "comm.py": SPMD_COMM + """
    def one_process(mesh, out, x):
        if mesh.processes > 1:
            return exchange(out, x)
        return x
""",
        }
        assert _lint(tmp_path, files) == []

    def test_process_local_loop_bound(self, tmp_path):
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "job.py": """
                import torch.distributed as dist

                from pkg.comm import exchange

                def waves(files, out, x):
                    mine = files[dist.get_rank()::dist.get_world_size()]
                    for f in mine:
                        x = exchange(out, x)
                    return x
            """,
        }
        findings = [f for f in _lint(tmp_path, files) if f.rule == "HS803"]
        assert findings and "exchange" in findings[0].message

    def test_allgathered_loop_bound_is_clean(self, tmp_path):
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "job.py": """
                import torch.distributed as dist

                from pkg.comm import exchange

                def waves(local_counts, out, x):
                    counts = [None] * dist.get_world_size()
                    dist.all_gather_object(counts, local_counts)
                    for c in counts:
                        x = exchange(out, x)
                    return x
            """,
        }
        rules = _rules(_lint(tmp_path, files))
        assert "HS803" not in rules and "HS802" in rules  # the gather itself wants an entry

    def test_suppression(self, tmp_path):
        files = {
            "collectives.py": SPMD_REGISTRY,
            "comm.py": SPMD_COMM,
            "job.py": """
                import torch.distributed as dist

                from pkg.comm import exchange

                def run(out, x):
                    # single-process probe path by contract
                    if dist.get_rank() == 0:  # hslint: disable=HS801
                        return exchange(out, x)
                    return x
            """,
        }
        assert _lint(tmp_path, files) == []

    @pytest.mark.parametrize("pkg, script", [("pkg", "dryrun_multihost.py"),
                                             ("pkg_torch", "torch_dryrun_multihost.py")])
    def test_contracts_require_the_package_s_dryrun(self, tmp_path, pkg, script):
        """HS703 over the witness matrix of the package's own dryrun: the
        port's scripts carry the prefix ``torch_``."""
        scripts = tmp_path / "scripts"
        scripts.mkdir()
        other = "dryrun_multihost.py" if script.startswith("torch_") else "torch_dryrun_multihost.py"
        (scripts / other).write_text(f'WITNESS = ("{pkg}.comm.exchange", "publish")\n')
        (scripts / script).write_text(f'WITNESS = ("{pkg}.comm.exchange",)\n')
        root = tmp_path / pkg
        root.mkdir()
        _write_tree(root, {
            "collectives.py": SPMD_GATED_REGISTRY.replace("pkg.", f"{pkg}."),
            "comm.py": SPMD_COMM,
            "logplane.py": """
                import torch.distributed as dist

                def publish(x):
                    dist.broadcast(x, 0)
            """,
        })
        findings = [f for f in port.run_analysis(str(root)) if f.rule == "HS703"]
        assert len(findings) == 1 and f"{pkg}.logplane.publish" in findings[0].message
        assert script in findings[0].message
        (scripts / script).write_text(f'WITNESS = ("{pkg}.comm.exchange", "publish")\n')
        assert [f for f in port.run_analysis(str(root)) if f.rule == "HS703"] == []

    def test_the_port_s_primitive_sites_are_registered(self):
        from hyperspace_tpu_torch.analysis import spmd
        from hyperspace_tpu_torch.parallel.collectives import COLLECTIVE_SITES

        analysis = spmd._Analysis(Project(PORT_DIR))
        bearing = {analysis.site_name(k) for k, f in analysis.facts.items() if f.primitives}
        assert {
            "hyperspace_tpu_torch.parallel.mesh.initialize_distributed",
            "hyperspace_tpu_torch.parallel.shuffle._all_to_all_bytes",
            "hyperspace_tpu_torch.parallel.shuffle._twostage_exchange_mp",
            "hyperspace_tpu_torch.parallel.shuffle._flat_exchange",
            "hyperspace_tpu_torch.parallel.shuffle._compact_exchange",
            "hyperspace_tpu_torch.indexes.covering_build._global_written",
            "hyperspace_tpu_torch.actions.base._action_rendezvous",
        } <= bearing <= set(COLLECTIVE_SITES)
