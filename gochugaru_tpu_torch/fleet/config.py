"""Shared fleet tuning knobs (router and replica both read these)."""

from __future__ import annotations

from dataclasses import dataclass

from .zookie import DEFAULT_KEY


@dataclass(frozen=True)
class FleetConfig:
    """One config object for the whole fleet story; the defaults are the
    single-box test/bench posture (sub-second failure detection, bounded
    freshness waits)."""

    #: virtual nodes per ring member — smooths placement so one replica
    #: death re-spreads its keyspace across the survivors
    vnodes: int = 32
    #: health-probe cadence; with ``kill_threshold`` consecutive misses
    #: this bounds kill-detection latency at roughly their product
    probe_interval_s: float = 0.25
    probe_timeout_s: float = 1.0
    kill_threshold: int = 2
    #: bounded block on reads requiring a revision no ring member has
    #: reached yet (read-your-writes catchup); on expiry the request
    #: sheds with a retriable UnavailableError
    freshness_wait_s: float = 5.0
    freshness_poll_s: float = 0.05
    #: catchup lag (revisions behind upstream head) beyond which a
    #: replica reports not-ready and the router drains it from the ring;
    #: generous so steady write load doesn't flap membership
    ready_lag: int = 64
    #: idle heartbeat cadence on the replication stream — a quiescent
    #: replica still learns the upstream head this often
    heartbeat_s: float = 0.25
    io_timeout_s: float = 30.0
    connect_timeout_s: float = 2.0
    #: relationships per bootstrap-export frame
    bootstrap_chunk: int = 2048
    #: router-side parallel dispatch lanes (per-owner sub-batches)
    dispatch_workers: int = 8
    #: HMAC key zookies are minted/verified with — every front sharing
    #: traffic must share it
    zookie_key: bytes = DEFAULT_KEY
