"""LookupResources / LookupSubjects along a Watch-driven delta chain,
the port against the reference: the chains and helpers are
tests/test_torch_delta.py's (this test runs in a file of its own so that
it and the rest of that file run on two workers).  Outputs are id
strings and index arrays: the tolerance is exact equality.
"""

import dataclasses
import random

import numpy as np

from gochugaru_tpu import rel as jrel
from gochugaru_tpu.engine.lookup import (
    lookup_resources_device as j_lookup_resources_device,
    lookup_subjects_device as j_lookup_subjects_device,
)
from gochugaru_tpu.engine.oracle import SnapshotOracle as JSnapshotOracle

from gochugaru_tpu_torch.engine.lookup import (
    lookup_resources_device as p_lookup_resources_device,
    lookup_subjects_device as p_lookup_subjects_device,
)
from gochugaru_tpu_torch.engine.oracle import SnapshotOracle

from test_flat_engine import NOW
from test_torch_delta import _feature_chain, _used_groups


def test_lookups_on_a_chain_match_reference():
    """LookupResources/LookupSubjects along a chain: a delta level
    declines the device frontier, so the host walker serves, over a
    transposed index that store/delta.py carries forward by
    advance_lookup_index (eagerly, once lookups are live).  Answers and
    the advanced index equal the reference's on the same writes."""
    rng, rels, ch = _feature_chain(seed=4)
    py = random.Random(8)
    used = _used_groups(rels)
    j_or = lambda: JSnapshotOracle(ch.j_snap, {}, now_us=NOW)  # noqa: E731
    p_or = lambda: SnapshotOracle(ch.p_snap, {}, now_us=NOW)  # noqa: E731
    advanced = 0
    for revision in range(2, 6):
        adds = [
            jrel.must_from_triple(f"doc:d{py.randrange(10)}", "reader",
                                  f"user:u{py.randrange(10)}"),
            jrel.must_from_tuple(f"doc:d{py.randrange(10)}#reader",
                                 f"group:{py.choice(used)}#member"),
        ]
        deletes = [jrel.must_from_triple(f"doc:d{py.randrange(10)}", "reader",
                                         f"user:u{py.randrange(10)}")]
        assert ch.step(adds, deletes)
        assert ch.pd.flat_meta.delta is not None
        advanced += getattr(ch.p_snap, "_lookup_index", None) is not None
        for u in ("u0", "u3", "u7"):
            want = j_lookup_resources_device(
                ch.je, ch.jd, "doc", "read", "user", u, now_us=NOW,
                oracle_factory=j_or)
            got = p_lookup_resources_device(
                ch.pe, ch.pd, "doc", "read", "user", u, now_us=NOW,
                oracle_factory=p_or)
            assert got == want, (revision, u)
        for d in ("d0", "d4"):
            want = j_lookup_subjects_device(
                ch.je, ch.jd, "doc", d, "read", "user", now_us=NOW,
                oracle_factory=j_or)
            got = p_lookup_subjects_device(
                ch.pe, ch.pd, "doc", d, "read", "user", now_us=NOW,
                oracle_factory=p_or)
            assert got == want, (revision, d)
        j_idx, p_idx = ch.j_snap._lookup_index, ch.p_snap._lookup_index
        for f in dataclasses.fields(p_idx):
            a, b = getattr(p_idx, f.name), getattr(j_idx, f.name)
            if isinstance(a, dict):  # perm_slots_of_tid
                assert a.keys() == b.keys(), f.name
                assert all(np.array_equal(a[t], b[t]) for t in a), f.name
            else:
                assert np.array_equal(a, b), f.name
    assert advanced >= 2, "later revisions carry the live index forward"
