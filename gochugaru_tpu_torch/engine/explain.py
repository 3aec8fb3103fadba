"""Decision provenance: explain trees for any check at a pinned revision.

Copied from the reference package (host-only); its codes are the ones
the port's flat program writes.

A verdict out of the fused gathers is a boolean; nothing so far answered
"why was this check *allowed/denied*" — the capability the reference's
server exposes as CheckPermission debug traces (SURVEY: SpiceDB
resolution semantics are the spec for our evaluator) and the first thing
a Zanzibar operator reaches for during an authorization incident.  This
module reconstructs a TYPED RESOLUTION TREE for any check by
instrumenting the existing host oracle walker (engine/oracle.py — the
exact-semantics reference) rather than duplicating semantics: the
oracle's ``check`` accepts a duck-typed ``recorder`` whose hooks cost one
``is not None`` branch when absent, so the hot fallback path is
untouched.

Tree contents:

- membership steps (direct edges, with the caveat/expiry gate detail
  that admitted or killed each one), wildcard grants, userset
  expansions, arrow traversals, union/intersection/exclusion operators;
- caveat evaluations WITH the merged (stored-over-query) context values
  that gated them, and expiry gates with their stamps;
- cycle cuts (least-fixpoint recursion) and memoized sub-answers;
- for denials, the EXHAUSTED FRONTIER: every edge the walk explored and
  why it failed (gated out, subject mismatch count, sub-verdict F).

**Device witness seeding**: the flat program (engine/flat.py
``make_flat_fn(witness=True)``) optionally emits a per-query WITNESS
CODE — the winning branch (direct edge vs fold vs T-probe vs wildcard vs
userset-closure vs rewrite, plus a recursion-level class) — as a fourth
int32 plane, from the definite masks its probe sites compute anyway;
disarmed, the program runs the same ops and kernel launches as without
it and returns three planes.  Explain for allowed verdicts seeds the
oracle walk from the witness (``seed_branch``) instead of a blind
re-walk, and the parity suite asserts witness ⊆ oracle path on
randomized worlds (tests/test_torch_explain.py).

Rendering mirrors the reference's debug-trace shape: a JSON object with
``resource``/``permission``/``subject``/``result`` and a nested
``tree`` of sub-resolutions.

Fault site ``explain.walk`` rides the chaos registry: an armed walk
raises BEFORE any tree state exists, the classified error reaches the
caller's retry envelope (client.explain), and the chaos suite asserts no
torn trees — a returned tree is always complete.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..utils import faults
from .oracle import F, T, U

__all__ = [
    "Recorder",
    "WIT_DIRECT",
    "WIT_FOLD",
    "WIT_NONE",
    "WIT_REWRITE",
    "WIT_SELF",
    "WIT_TPROBE",
    "WIT_USERSET",
    "WIT_WILDCARD",
    "explain_relationship",
    "seed_for",
    "tree_grant_kinds",
    "witness_branch",
    "witness_consistent",
    "witness_level",
    "witness_name",
]

# ---------------------------------------------------------------------------
# Witness codes (shared with engine/flat.py's armed kernel)
# ---------------------------------------------------------------------------

#: low 4 bits: the winning branch class; bits 4+: recursion-level class
#: (0 = a root-leaf probe answered; 1 = the permission-program rewrite —
#: arrows/unions/flattened hierarchies — carried the grant)
WIT_NONE = 0
WIT_SELF = 1  # reflexive userset identity (X#r ∈ X#r)
WIT_DIRECT = 2  # exact direct-edge hit at the root relation
WIT_WILDCARD = 3  # wildcard (`user:*`) grant at the root relation
WIT_TPROBE = 4  # T-index probe: pre-joined {userset edge × closure}
WIT_FOLD = 5  # permission-fold probe (pf_e / pf_u pair)
WIT_USERSET = 6  # userset row × live closure containment (KU path)
WIT_REWRITE = 7  # permission program (union/arrow/rc) at level ≥ 1

WIT_BRANCH_MASK = 0xF
WIT_LEVEL_SHIFT = 4

_WIT_NAMES = {
    WIT_NONE: None,
    WIT_SELF: "self",
    WIT_DIRECT: "direct",
    WIT_WILDCARD: "wildcard",
    WIT_TPROBE: "t_probe",
    WIT_FOLD: "fold",
    WIT_USERSET: "userset",
    WIT_REWRITE: "rewrite",
}


def witness_branch(code: int) -> int:
    return int(code) & WIT_BRANCH_MASK


def witness_level(code: int) -> int:
    return int(code) >> WIT_LEVEL_SHIFT


def witness_name(code: int) -> Optional[str]:
    return _WIT_NAMES.get(witness_branch(code))


def seed_for(code: int) -> Optional[str]:
    """The oracle-walk seed class for a device witness code: which edge
    class of the ROOT relation the walk should explore first.  T-probe,
    fold and userset-closure wins all correspond to userset edges on the
    host walk (the kernel branches are accelerations of userset ×
    closure / the pre-joined fold of the whole rewrite); rewrite wins
    carry no root-leaf seed."""
    b = witness_branch(code)
    if b == WIT_DIRECT:
        return "direct"
    if b == WIT_WILDCARD:
        return "wildcard"
    if b in (WIT_TPROBE, WIT_USERSET):
        return "userset"
    return None


# ---------------------------------------------------------------------------
# The recorder the oracle walker drives
# ---------------------------------------------------------------------------

_VERDICTS = {T: "allowed", U: "conditional", F: "denied"}


class Recorder:
    """Stack-shaped tree builder driven by ``Oracle.check(recorder=…)``.

    Bounded: past ``max_nodes`` attached nodes, further subtrees are
    built detached (so push/pop stays balanced) and dropped on pop, and
    the rendered tree carries ``truncated: true`` — a pathological world
    cannot blow the explain endpoint's memory."""

    __slots__ = ("root", "_stack", "max_nodes", "nodes", "truncated")

    def __init__(self, max_nodes: int = 50_000) -> None:
        self.root: Optional[Dict[str, Any]] = None
        self._stack: List[Dict[str, Any]] = []
        self.max_nodes = max_nodes
        self.nodes = 0
        self.truncated = False

    def _attach(self, node: Dict[str, Any]) -> None:
        if self.nodes >= self.max_nodes:
            self.truncated = True
            return
        self.nodes += 1
        if self._stack:
            self._stack[-1].setdefault("children", []).append(node)
        elif self.root is None:
            self.root = node

    def push(self, kind: str, **attrs: Any) -> None:
        node: Dict[str, Any] = {"kind": kind}
        for k, v in attrs.items():
            if v is not None:
                node[k] = v
        self._attach(node)
        self._stack.append(node)

    def pop(self, verdict: int) -> None:
        node = self._stack.pop()
        node["verdict"] = _VERDICTS.get(verdict, str(verdict))

    def leaf(self, kind: str, verdict: int, **attrs: Any) -> None:
        self.push(kind, **attrs)
        self.pop(verdict)

    def set(self, key: str, value: Any) -> None:
        if self._stack:
            self._stack[-1][key] = value


# ---------------------------------------------------------------------------
# Explain entry point
# ---------------------------------------------------------------------------


def explain_relationship(
    oracle,
    r,
    *,
    context: Optional[Dict[str, Any]] = None,
    witness: Optional[int] = None,
    revision: Optional[int] = None,
    cached: bool = False,
    now_us: Optional[int] = None,
    strategy: Optional[str] = None,
    max_nodes: int = 50_000,
) -> Dict[str, Any]:
    """One check's full resolution tree at one pinned oracle.

    ``witness`` (a device witness code, engine/flat.py armed kernel)
    seeds the walk toward the branch the kernel proved winning;
    ``cached``/``revision`` record provenance for verdicts that were
    served from the verdict cache — the tree itself is always RE-DERIVED
    against the pinned revision's oracle, never trusted from the cache.
    Raises the armed ``explain.walk`` fault before building any state,
    so a retried walk can never observe a torn tree."""
    faults.fire("explain.walk")
    rec = Recorder(max_nodes=max_nodes)
    seed = seed_for(witness) if witness else None
    t0 = time.perf_counter()
    tri = oracle.check_relationship(
        r, context, now_us=now_us, recorder=rec, seed_branch=seed
    )
    dur_ms = (time.perf_counter() - t0) * 1000.0
    out: Dict[str, Any] = {
        "resource": f"{r.resource_type}:{r.resource_id}",
        "permission": r.resource_relation,
        "subject": (
            f"{r.subject_type}:{r.subject_id}#{r.subject_relation}"
            if r.subject_relation
            else f"{r.subject_type}:{r.subject_id}"
        ),
        "result": _VERDICTS[tri],
        "duration_ms": round(dur_ms, 4),
        "tree": rec.root,
    }
    if revision is not None:
        out["revision"] = int(revision)
    if cached:
        out["cached"] = True
    if strategy is not None:
        out["strategy"] = strategy
    if witness:
        out["witness"] = witness_name(witness)
        out["witness_level"] = witness_level(witness)
    if r.caveat_context:
        out["context"] = dict(r.caveat_context)
    if rec.truncated:
        out["truncated"] = True
    return out


# ---------------------------------------------------------------------------
# Parity helpers (tests + smoke): witness ⊆ oracle path
# ---------------------------------------------------------------------------


def tree_grant_kinds(tree: Optional[Dict[str, Any]]) -> set:
    """The node kinds appearing on DEFINITE-allowed subtrees — the
    oracle path a device witness must be contained in."""
    out: set = set()

    def walk(node: Optional[Dict[str, Any]]) -> None:
        if not node or node.get("verdict") != "allowed":
            return
        out.add(node["kind"])
        for c in node.get("children", ()):  # only allowed subtrees count
            walk(c)

    walk(tree)
    return out


def _root_relation_kinds(tree: Optional[Dict[str, Any]]) -> set:
    """Granting node kinds DIRECTLY under the root item's relation node
    (depth-0 leaf classes — the device's root-leaf site analogue)."""
    if not tree or tree.get("verdict") != "allowed":
        return set()
    if tree.get("kind") not in ("relation",):
        return set()
    return {
        c["kind"] for c in tree.get("children", ())
        if c.get("verdict") == "allowed"
    }


def witness_consistent(explained: Dict[str, Any], code: int) -> bool:
    """witness ⊆ oracle path: does the explain tree contain the branch
    class the device kernel claims won?

    - ``self``: the tree is the reflexive-identity grant;
    - ``direct``/``wildcard``: a definite direct/wildcard edge grant on
      the ROOT relation;
    - ``t_probe``/``userset``: a definite userset expansion on the root
      relation (the T-index and KU branches are device accelerations of
      userset × closure);
    - ``fold``: the fold tables pre-join the whole rewrite, so the
      oracle counterpart is ANY definite path — the verdict must be
      allowed;
    - ``rewrite``: allowed via the permission program (the root node is
      a permission, not a bare relation leaf).
    """
    b = witness_branch(code)
    tree = explained.get("tree")
    if explained.get("result") != "allowed":
        return b == WIT_NONE
    if b == WIT_NONE:
        return False  # an allowed device-definite verdict has a branch
    if b == WIT_SELF:
        return tree is not None and (
            tree.get("kind") == "self"
            or "self" in tree_grant_kinds(tree)
        )
    if b == WIT_FOLD or b == WIT_REWRITE:
        return tree is not None and tree.get("verdict") == "allowed"
    kinds = _root_relation_kinds(tree)
    if not kinds:
        # permission-rooted tree: the root-leaf device site answered a
        # permission slot that is also a stored relation only when the
        # root IS a relation; otherwise fall back to path containment
        kinds = tree_grant_kinds(tree)
    if b == WIT_DIRECT:
        return "direct" in kinds or "self" in kinds
    if b == WIT_WILDCARD:
        return "wildcard" in kinds
    if b in (WIT_TPROBE, WIT_USERSET):
        return "userset" in kinds or "memoized" in kinds
    return False
