"""The port's twin of ``tests/test_config.py``: ``Config``'s defaults and
typed setters, and ``CacheWithTransform``, each case through both
packages, the port's values held to the JAX package's."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import pytest
from torch_corpus_twin import JAX, PORT

BOTH = (PORT, JAX)

DEFAULTS = {
    "apply_enabled": True,
    "num_buckets": 200,
    "lineage_enabled": False,
    "hybrid_scan_enabled": False,
    "hybrid_scan_max_appended_ratio": 0.3,
    "hybrid_scan_max_deleted_ratio": 0.2,
    "optimize_file_size_threshold": 256 * 1024 * 1024,
}


@pytest.mark.parametrize("prop", sorted(DEFAULTS))
def test_defaults(prop):
    mine, ref = (getattr(P.m("config").Config(), prop) for P in BOTH)
    assert mine == ref == DEFAULTS[prop]
    assert type(mine) is type(ref)


def test_set_get_typed():
    out = []
    for P in BOTH:
        conf = P.m("config").Config()
        conf.set(P.C.INDEX_NUM_BUCKETS, "16")
        seen = [conf.num_buckets]
        conf.set(P.C.INDEX_LINEAGE_ENABLED, "true")
        seen.append(conf.lineage_enabled)
        conf.set(P.C.INDEX_LINEAGE_ENABLED, False)
        seen.append(conf.lineage_enabled)
        assert seen == [16, True, False]
        out.append((seen, conf.version))
    assert out[0] == out[1]


def test_cache_with_transform_invalidates_on_change():
    out = []
    for P in BOTH:
        config = P.m("config")
        conf = config.Config()
        calls = []

        def transform(c):
            calls.append(1)
            return c.num_buckets * 2

        cache = config.CacheWithTransform(conf, transform)
        seen = [cache.load(), cache.load(), len(calls)]
        conf.set(P.C.INDEX_NUM_BUCKETS, 10)
        seen += [cache.load(), len(calls)]
        assert seen == [400, 400, 1, 20, 2]
        out.append(seen)
    assert out[0] == out[1]
