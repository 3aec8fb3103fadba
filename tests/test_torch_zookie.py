"""Zookie tokens on the port (gochugaru_tpu_torch/fleet/zookie.py), as
tests/test_zookie.py holds the reference's: roundtrip, tamper/garbage
rejection, stale-token behavior per consistency strategy, and token
survival through the serving handle's coalesced batches.  The strategy
tests run on a host-only client and on a client whose checks take the
port's device path on ``cpu`` (the plain versions).  Tokens must equal
the reference's byte for byte (tests/test_torch_fleet.py holds that);
verdicts are bools, compared exactly."""

import threading

import pytest

from gochugaru_tpu.fleet import zookie as jzookie

from gochugaru_tpu_torch import consistency, rel
from gochugaru_tpu_torch.client import new_evaluator, with_host_only_evaluation
from gochugaru_tpu_torch.fleet import zookie
from gochugaru_tpu_torch.fleet.zookie import InvalidZookieError
from gochugaru_tpu_torch.store.store import RevisionToken, parse_revision
from gochugaru_tpu_torch.utils.context import background
from gochugaru_tpu_torch.utils.errors import RevisionUnavailableError

SCHEMA = """
definition user {}
definition doc {
    relation owner: user
    relation reader: user
    permission read = reader + owner
}
"""

CLIENTS = {
    "host": lambda: new_evaluator(with_host_only_evaluation()),
    "device": lambda: new_evaluator(device="cpu"),
}


def _client(kind="host"):
    c = CLIENTS[kind]()
    ctx = background()
    c.write_schema(ctx, SCHEMA)
    txn = rel.Txn()
    for i in range(4):
        txn.touch(rel.must_from_triple(f"doc:d{i}", "owner", f"user:u{i}"))
    c.write(ctx, txn)
    return c


# -- encode/decode ------------------------------------------------------------


def test_roundtrip_from_int_and_token():
    assert zookie.parse(zookie.mint(42)) == 42
    assert zookie.parse(zookie.mint(RevisionToken(7))) == 7
    assert zookie.revision_token(zookie.mint(7)) == RevisionToken(7)
    assert zookie.mint(42) == jzookie.mint(42)


def test_strategy_is_at_least():
    cs = zookie.strategy(zookie.mint(9))
    assert cs.requirement == consistency.Requirement.AT_LEAST
    assert parse_revision(cs.revision) == 9


def test_tamper_rejected():
    token = zookie.mint(5)
    prefix, revision, mac = token.split(".")
    with pytest.raises(InvalidZookieError):
        zookie.parse(f"{prefix}.{int(revision) + 1}.{mac}")
    bad_mac = ("0" if mac[0] != "0" else "1") + mac[1:]
    with pytest.raises(InvalidZookieError):
        zookie.parse(f"{prefix}.{revision}.{bad_mac}")


def test_wrong_key_rejected():
    token = zookie.mint(5, key=b"other-deployment")
    with pytest.raises(InvalidZookieError):
        zookie.parse(token)
    assert zookie.parse(token, key=b"other-deployment") == 5


@pytest.mark.parametrize(
    "garbage",
    ["", "zk1", "zk1.", "zk1.x.deadbeef", "zk2.5.deadbeef", "zk1.-1.x",
     "gtz1.5", "zk1.5", None, 42],
)
def test_garbage_rejected(garbage):
    with pytest.raises(InvalidZookieError):
        zookie.parse(garbage)


# -- stale-token behavior per strategy ----------------------------------------


@pytest.mark.parametrize("kind", sorted(CLIENTS))
def test_at_least_future_zookie_never_serves_stale(kind):
    c = _client(kind)
    future = zookie.mint(c.store.head_revision + 10)
    with pytest.raises(RevisionUnavailableError):
        c.check(
            background(), zookie.strategy(future),
            rel.must_from_triple("doc:d0", "read", "user:u0"),
        )


@pytest.mark.parametrize("kind", sorted(CLIENTS))
def test_at_least_current_zookie_serves(kind):
    c = _client(kind)
    ctx = background()
    txn = rel.Txn()
    txn.touch(rel.must_from_triple("doc:fresh", "reader", "user:new"))
    zk = zookie.mint(c.write(ctx, txn))
    got = c.check(
        ctx, zookie.strategy(zk),
        rel.must_from_triple("doc:fresh", "read", "user:new"),
    )
    assert got == [True]


@pytest.mark.parametrize("kind", sorted(CLIENTS))
def test_old_zookie_still_valid(kind):
    c = _client(kind)
    ctx = background()
    old = zookie.mint(c.store.head_revision)
    txn = rel.Txn()
    txn.touch(rel.must_from_triple("doc:later", "reader", "user:l8r"))
    c.write(ctx, txn)
    got = c.check(
        ctx, zookie.strategy(old),
        rel.must_from_triple("doc:later", "read", "user:l8r"),
    )
    assert got == [True]


@pytest.mark.parametrize("kind", sorted(CLIENTS))
def test_snapshot_pins_exact_revision(kind):
    c = _client(kind)
    ctx = background()
    pinned = RevisionToken(c.store.head_revision)
    c.store.snapshot_for(consistency.snapshot(pinned))  # materialize
    txn = rel.Txn()
    txn.touch(rel.must_from_triple("doc:d0", "reader", "user:pinned"))
    c.write(ctx, txn)
    q = rel.must_from_triple("doc:d0", "read", "user:pinned")
    assert c.check(ctx, consistency.snapshot(pinned), q) == [False]
    assert c.check(ctx, consistency.full(), q) == [True]


# -- survival through the serving handle's coalesced batches ------------------


@pytest.mark.parametrize("kind", sorted(CLIENTS))
def test_zookie_through_serving_handle_coalesced_batches(kind):
    c = _client(kind)
    ctx = background()
    txn = rel.Txn()
    txn.touch(rel.must_from_triple("doc:coal", "reader", "user:rw"))
    zk = zookie.mint(c.write(ctx, txn))

    results = {}
    errors = []
    queries = [
        ("fresh", rel.must_from_triple("doc:coal", "read", "user:rw"), True),
        ("base0", rel.must_from_triple("doc:d0", "read", "user:u0"), True),
        ("deny", rel.must_from_triple("doc:d1", "read", "user:u0"), False),
        ("base2", rel.must_from_triple("doc:d2", "read", "user:u2"), True),
    ]
    with c.with_serving(cs=zookie.strategy(zk)) as handle:
        def worker(name, q):
            try:
                results[name] = handle.check(background().with_timeout(20.0), q)[0]
            except BaseException as e:  # pragma: no cover - surfaced below
                errors.append((name, e))

        threads = [threading.Thread(target=worker, args=(n, q)) for n, q, _ in queries]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    assert not errors, errors
    for name, _, want in queries:
        assert results[name] is want, (name, results)
