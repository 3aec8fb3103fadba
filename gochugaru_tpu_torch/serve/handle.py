"""ServingHandle: the client-facing surface of the micro-batcher.

``handle.check(ctx, *rels)`` submits into the batcher and blocks on the
coalesced result; transient faults (a shed, an injected dispatch fault,
the breaker tripping mid-queue) reject the submission's future with a
classified error and the reference retry envelope RE-SUBMITS — so every
call resolves exactly once, through however many re-formed batches it
takes.  ``submit``/``submit_columns`` return the raw futures for
open-loop callers that must not block on their own traffic.

Copied from the reference package (host-only), with one change: the
dispatcher thread makes the engine's CUDA device its current device
before its first batch (a new thread starts on device 0).
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from ..engine.plan import EngineConfig
from ..rel.relationship import RelationshipLike, as_relationship
from ..utils import decisions as _decisions
from ..utils import trace as _trace
from ..utils.retry import retry_retriable_errors
from .batcher import MicroBatcher, ServeConfig, SubmitFuture


class ServingHandle:
    """One continuous-batching front-end over one Client, pinned to one
    consistency strategy (every formed batch evaluates at a single
    snapshot).  Context-manager friendly: closing drains the queue and
    stops the former/dispatcher threads."""

    def __init__(
        self, client, cs, config: Optional[ServeConfig] = None,
        *, use_cache: bool = True,
    ) -> None:
        self._client = client
        self._cs = cs
        #: with_serving(cache=False) forces this handle's evaluates
        #: cache-off even when the client carries a verdict cache (the
        #: bench A/B lever); the pinned strategy is otherwise the
        #: cache's read policy (full() bypasses by policy)
        self._use_cache = use_cache
        ecfg = client._engine_config or EngineConfig()
        adm = client._admission
        from ..consistency import Requirement

        self.batcher = MicroBatcher(
            tiers=ecfg.latency_tiers,
            cost=adm.cost,
            breaker=adm.breaker,
            admission=adm,
            config=config,
            dispatch_rels=self._dispatch_rels,
            dispatch_cols=self._dispatch_cols,
            # cross-batch singleflight parks a duplicate on its in-
            # flight twin's resolution — sound for MinLatency (the twin
            # is at least as fresh as if the duplicate had arrived when
            # its twin did), AtLeast (the twin's revision is >= the
            # floor) and Snapshot (same pinned revision); Full must see
            # the head at its own dispatch, so it never parks
            inflight_dedup=cs.requirement != Requirement.FULL,
        )
        #: the CUDA device index the dispatcher thread binds before its
        #: first batch (None on the CPU)
        dev = client.device
        self._cuda_index = (
            None if dev is None or dev.type != "cuda"
            else dev.index if dev.index is not None
            else torch.cuda.current_device()
        )
        self._bound = threading.local()

    # -- batch evaluation (called from the dispatcher thread) ------------
    def _bind_device(self) -> None:
        """Make the engine's CUDA device the calling thread's current
        device, once per thread: graphs replay and tensors allocate on
        the current device, and a new thread starts on device 0."""
        if self._cuda_index is not None and not getattr(self._bound, "ok", False):
            torch.cuda.set_device(self._cuda_index)
            self._bound.ok = True

    def _dispatch_rels(self, rels, latency, span):
        self._bind_device()
        client = self._client
        snap = client._store.snapshot_for(self._cs)
        span.set_attr("revision", int(snap.revision))
        return client._evaluate_rels(
            snap, rels, latency=latency, span=span,
            cs=self._cs if self._use_cache else None,
            dedup=self.batcher.config.dedup,
        )

    def _dispatch_cols(self, q_res, q_perm, q_subj, latency, span):
        self._bind_device()
        client = self._client
        snap = client._store.snapshot_for(self._cs)
        span.set_attr("revision", int(snap.revision))
        return client._evaluate_columns(
            snap, q_res, q_perm, q_subj, latency=latency, span=span,
            cs=self._cs if self._use_cache else None,
            dedup=self.batcher.config.dedup,
        )

    # -- blocking check surface ------------------------------------------
    @staticmethod
    def _client_id(client_id) -> Any:
        # fairness key defaults to the calling thread: each concurrent
        # caller is its own admission class unless it names one
        return client_id if client_id is not None else threading.get_ident()

    def check(
        self, ctx, *rs: RelationshipLike, client_id=None,
        explain: bool = False,
    ) -> List[bool]:
        """Batched permission check through the micro-batcher: submits
        into the next formed tier slot and awaits the coalesced result,
        under the same retry envelope ``client.check`` uses (a shed or
        a transient batch fault re-submits).

        ``explain=True`` additionally re-derives each verdict's typed
        resolution tree at the handle's pinned strategy — ONE snapshot
        for the whole batch's trees (witness codes extracted in one
        armed dispatch), returning ``List[ExplainedCheck]``: the
        coalesced verdict plus the tree.  The verdict came from the
        batcher's own dispatch snapshot; under ``min_latency`` a write
        landing between the coalesced dispatch and the explain can move
        the head, so a tree disagreeing with its served verdict is
        flagged ``verdict_skew`` (the tree's ``revision`` names the
        world it describes) instead of posing as the verdict's
        derivation."""
        self._client._check_overlap(ctx)
        rels = [as_relationship(r) for r in rs]
        if not rels:
            return []
        cid = self._client_id(client_id)
        root = _trace.root_span("serve.check", batch=len(rels))
        ctx = _trace.ctx_with_span(ctx, root)
        pre_snap = pre_ents = None
        if explain:
            # cache residency probed BEFORE submitting: entries the
            # coalesced dispatch itself inserts are fresh work, not
            # cache-served provenance
            pre_snap = self._client._store.snapshot_for(self._cs)
            pre_ents = self._client._peek_cached(pre_snap, rels, self._cs)

        def attempt():
            fut = self.batcher.submit_rels(cid, rels, ctx)
            out = fut.result(ctx)
            if fut.dedup_parked:
                # parked on an in-flight twin: these verdicts never ran
                # the evaluate layer themselves, so their provenance is
                # recorded HERE — counted, and logged dedup_parked
                _decisions.count_verdicts(
                    self.batcher._m,
                    sum(1 for v in out if v),
                    sum(1 for v in out if not v),
                    _decisions.strategy_name(self._cs),
                )
                if _decisions.enabled():
                    _decisions.record_rels(
                        rels, out, strategy=self._cs, dedup_parked=True,
                        latency_s=(
                            (fut.t_done or time.perf_counter())
                            - fut.t_submit
                        ),
                        trace_id=root.trace_id if root.sampled else None,
                        client_id=cid,
                    )
            return out

        with root:
            verdicts = retry_retriable_errors(ctx, attempt)
            if not explain:
                return verdicts
            client = self._client

            def derive():
                snap = client._store.snapshot_for(self._cs)
                # a write that moved the head since the pre-submit probe
                # makes its entries another revision's: every item is
                # then uncached rather than mislabelled
                ents = (
                    pre_ents
                    if pre_snap is not None
                    and snap.revision == pre_snap.revision
                    else [None] * len(rels)
                )
                # the witness extraction is a device dispatch: it runs
                # under the client's admission envelope, as explain does
                codes = client._admitted(
                    ctx, lambda: client._witness_batch(snap, rels))
                return client._explain_batch(
                    snap, rels, verdicts, self._cs, cache_ents=ents,
                    codes=codes,
                )

            return retry_retriable_errors(ctx, derive)

    def check_one(self, ctx, r: RelationshipLike, *, client_id=None) -> bool:
        return self.check(ctx, r, client_id=client_id)[0]

    def check_many(
        self, ctx, rs, *, client_id=None
    ) -> List[bool]:
        return self.check(ctx, *rs, client_id=client_id)

    def check_columns(
        self, ctx, q_res, q_perm, q_subj, *, client_id=None
    ) -> np.ndarray:
        """Columnar mirror of ``check``: pre-interned int32 columns in,
        bool verdicts out, coalesced with everything else in flight."""
        self._client._check_overlap(ctx)
        cid = self._client_id(client_id)
        root = _trace.root_span("serve.check", batch=int(q_res.shape[0]))
        ctx = _trace.ctx_with_span(ctx, root)

        def attempt():
            fut = self.batcher.submit_columns(cid, q_res, q_perm, q_subj, ctx)
            return fut.result(ctx)

        with root:
            return retry_retriable_errors(ctx, attempt)

    # -- open-loop surface -----------------------------------------------
    def submit(self, ctx, *rs: RelationshipLike, client_id=None) -> SubmitFuture:
        """Fire-and-await-later: returns the submission's future without
        blocking (sheds raise immediately — the open-loop caller counts
        them instead of retrying)."""
        self._client._check_overlap(ctx)
        rels = [as_relationship(r) for r in rs]
        return self.batcher.submit_rels(self._client_id(client_id), rels, ctx)

    def submit_columns(
        self, ctx, q_res, q_perm, q_subj, *, client_id=None
    ) -> SubmitFuture:
        self._client._check_overlap(ctx)
        return self.batcher.submit_columns(
            self._client_id(client_id), q_res, q_perm, q_subj, ctx
        )

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self.batcher.close()

    def __enter__(self) -> "ServingHandle":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
