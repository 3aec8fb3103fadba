"""The harness on the CPU: the frozen generators against ``chip_smoke.py``'s,
the due-time and window arithmetic, the refusal to run without a card,
whole runs of every cell at a tiny size, the comparison catching an answer
altered where the program produces it, and the controls."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from zbench import control, stats
from zbench import run as R
from zbench.generators import docs as gen_docs
from zbench.generators import rbac as gen_rbac

ROOT = Path(__file__).resolve().parents[2]
#: every traffic kind on both configurations' files, whether or not
#: BENCHMARK.json lists the cell
CELLS = ["docs-nested.bulk", "rbac-github.interactive", "docs-nested.lookup", "rbac-github.bulk"]
TINY = {"rbac-github": {"n_repos": 300, "n_users": 50, "n_teams": 8, "n_orgs": 3},
        "docs-nested": {"n_users": 200, "n_groups": 20, "n_folders": 100, "n_docs": 2000,
                        "edges": 20000}}


# -- the frozen generators ----------------------------------------------------
def _port_columns(monkeypatch, build, **kw):
    """The relationship columns ``chip_smoke.build_*`` hands the port, as
    sorted (resource, relation, subject, subject relation) strings."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import gochugaru_tpu_torch.store.snapshot as S

    seen = {}
    orig = S.build_snapshot_from_columns

    def grab(rev, cs, interner, **cols):
        seen.update(cols, interner=interner, cs=cs)
        return orig(rev, cs, interner, **cols)

    monkeypatch.setattr(S, "build_snapshot_from_columns", grab)
    getattr(chip_smoke, build)(**kw)
    it, name = seen["interner"], seen["cs"].name_of_slot
    out = []
    for r, rel, s, sr in zip(seen["res"], seen["rel"], seen["subj"], seen["srel"]):
        out.append(("%s:%s" % it.key_of(int(r)), name[int(rel)], "%s:%s" % it.key_of(int(s)),
                    name[int(sr)] if sr >= 0 else ""))
    return sorted(out), chip_smoke


def _world_columns(w):
    return sorted((f"{g.res_type}:{w.name(g.res_type, a)}", g.relation,
                   f"{g.subj_type}:{w.name(g.subj_type, b)}", g.subj_rel)
                  for g in w.rels for a, b in zip(g.res, g.subj))


@pytest.mark.parametrize("seed", [11, 23])
def test_rbac_generator_matches_chip_smoke(monkeypatch, seed):
    sizes = dict(n_repos=300, n_users=50, n_teams=8, n_orgs=3)
    want, cs = _port_columns(monkeypatch, "build_rbac", seed=seed, **sizes)
    assert _world_columns(gen_rbac.generate(cs.RBAC_SCHEMA, seed, **sizes)) == want


@pytest.mark.parametrize("seed", [11, 23])
def test_docs_generator_matches_chip_smoke(monkeypatch, seed):
    want, cs = _port_columns(monkeypatch, "build_docs", scale=0.002, seed=seed)
    nu, ng, nf, nd = cs.docs_sizes(0.002)
    w = gen_docs.generate(cs.DOCS_SCHEMA, seed, n_users=nu, n_groups=ng, n_folders=nf,
                          n_docs=nd, edges=20_000)
    assert _world_columns(w) == want


# -- the arithmetic -----------------------------------------------------------
def test_percentile_nearest_rank_and_failures():
    assert stats.percentile([], 95) is None
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([1.0] * 94 + [float("inf")] * 6, 95) == float("inf")
    assert stats.finite_or(float("inf"), 1e9) == 1e9


def test_window_rate_counts_only_work_done_inside():
    # the unit ending after t1 (still in flight at the close) counts nothing
    assert stats.window_rate([0.5, 1.0, 2.5], [10, 10, 10], 0.0, 2.0) == 10.0


class _StalledFuture:
    def __init__(self, t_done, value):
        self.t_done, self._value = t_done, value

    def done(self):
        return time.perf_counter() >= self.t_done

    def result(self, ctx=None, timeout=None):
        time.sleep(max(0.0, self.t_done - time.perf_counter()))
        return self._value


class _StalledHandle:
    """Answers every request at once, except that nothing is answered
    before ``stall_end``: a server stalled at the start of the window."""

    def __init__(self):
        self.stall_end = None

    def submit_columns(self, ctx, q_res, q_perm, q_subj, client_id=None):
        return _StalledFuture(max(time.perf_counter(), self.stall_end),
                              np.zeros(q_res.shape[0], bool))


def _tiny_run(name, seconds=1.0, trace=False):
    bench = R.load_json(ROOT / "BENCHMARK.json")
    config, traffic = name.split(".")
    w = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    cfg = dict(R.load_json(ROOT / "zbench" / "configs" / f"{config}.json"), sizes=TINY[config])
    tr = R.load_json(ROOT / "zbench" / "traffic" / f"{traffic}.json")
    if tr["kind"] == "bulk":
        tr.update(batch=2000, pool_batches=4)
    if tr["kind"] == "serve":
        tr.update(rate_checks_per_s=20_000, pool_checks=4096, sample_requests=200)
    return R.Run(bench, w, cfg, tr, 2**31 + 7, seconds, trace, "cpu")


def test_stalled_request_is_late_from_its_due_time():
    from zbench.kinds import serve
    from zbench.world import generate

    run = _tiny_run("rbac-github.interactive")
    run.world = generate(run.config, run.seed)
    cell = serve.Cell(run)
    cell.draw()
    cell.pool = tuple(c.astype(np.int32) for c in cell.pool_idx)
    cell.plan(run.rate, 1.0)
    cell.h = h = _StalledHandle()
    t0 = time.perf_counter()
    h.stall_end = t0 + 0.5
    cell.start(t0, t0 + 1.0)
    cell.join()
    w = cell.windows[0]
    early = w.arrivals < 0.25
    assert early.any()
    # a request due at a, answered at 0.5 s, is 0.5 - a late, not ~0
    assert np.all(w.lat[early] >= (0.5 - w.arrivals[early]) * 1e3 - 1.0)
    assert np.all(np.isfinite(w.lat))


# -- no card, no result ---------------------------------------------------------
def _run_cli(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "-m", "zbench.run", "--workload", "docs-nested.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_fails_without_a_result():
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA device" in out.stderr


def test_bare_benchmark_directory_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "zbench", tmp_path / "zbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


# -- whole runs on the CPU --------------------------------------------------------
def _result(capsys, run):
    assert R.execute(run) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct(capsys, name):
    res = _result(capsys, _tiny_run(name))
    assert res["correct"] is True
    assert list(res)[-1] == "compared"
    e2e = {m["name"] for m in R.metrics_of(R.load_json(ROOT / "BENCHMARK.json"),
                                           "end_to_end", name)}
    assert set(res["metrics"]) == e2e


def _flip_first(out):
    out = np.asarray(out, bool).copy()
    out[0] = ~out[0]
    return out


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(capsys, monkeypatch, name):
    """An answer altered where the program produces it: one verdict of
    every batch flipped, or one id dropped from every lookup answer."""
    from gochugaru_tpu_torch.client import Client

    if name.endswith(".lookup"):
        for meth in ("lookup_resources", "lookup_subjects"):
            orig = getattr(Client, meth)

            def broken(self, *a, _orig=orig, **kw):
                ids = list(_orig(self, *a, **kw))
                return iter(ids[:-1] if ids else ["no-such-id"])

            monkeypatch.setattr(Client, meth, broken)
    else:
        orig = Client._evaluate_columns_direct
        monkeypatch.setattr(Client, "_evaluate_columns_direct",
                            lambda self, *a, **kw: _flip_first(orig(self, *a, **kw)))
    res = _result(capsys, _tiny_run(name))
    assert res["correct"] is False
    assert res["compared"]["mismatches"]["value"] > 0


def test_lookup_walker_reads_below_full_device_share(capsys, monkeypatch):
    """With the device frontier refused, the host walker serves every lookup:
    the answers stay correct and the device share reads 0, not 100."""
    from gochugaru_tpu_torch.engine import spmv

    monkeypatch.setattr(spmv, "frontier_ok", lambda *a, **kw: False)
    run = _tiny_run("docs-nested.lookup")
    assert _result(capsys, run)["correct"] is True
    assert run.counters["lookups.walker"] > 0
    assert R.read_metric("lookup.device_share.lookup", run) == 0.0
    assert R.read_metric("lookup.fused_share.lookup", run) == 0.0


def test_lookup_pool_is_drawn_from_the_seed():
    from zbench.kinds import lookup
    from zbench.world import generate

    pools = []
    for seed in (5, 2**31 + 7):
        run = _tiny_run("docs-nested.lookup")
        run.seed = seed
        run.world = generate(run.config, seed)
        cell = lookup.Cell(run)
        cell.draw()
        # by the generator's own object index, before the seed's relabelling
        back = {t: np.argsort(p) for t, p in run.world.perm.items()}
        pools.append(np.where(cell.kinds == 0, back["user"][cell.subj],
                              back["document"][cell.res]))
    assert pools[0].shape[0] == run.traffic["pool_requests"]
    assert not np.array_equal(pools[0], pools[1])


# -- the controls -----------------------------------------------------------------
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    run = _tiny_run(name)
    row = control.control_once(run.bench, run.workload, run.config, run.traffic, 5)
    assert row["mismatches"] > 0


# -- on the card --------------------------------------------------------------------
@pytest.mark.cuda
def test_card_run_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "zbench.run", "--workload", "docs-nested.bulk",
         "--seed", "12345", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0


# -- the frozen trace arithmetic and byte rule ------------------------------------
def test_ops_union_and_idle_gaps():
    from zbench import trace

    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert trace.ops_union(iv, 0.0, 10.0) == 4.0
    assert trace.ops_union(iv, 2.5, 5.5) == 1.0
    host = [(3.5, "flat.py:run"), (4.0, "flat.py:run"), (4.5, "client.py:settle"),
            (7.0, "client.py:settle")]
    gaps = trace.idle_gaps(iv, host, 0.0, 10.0)
    assert gaps[0] == ["host client.py:settle", 4e-6]  # 6 .. 10
    assert gaps[1] == ["host flat.py:run", 2e-6]       # 3 .. 5


def test_probe_bound_equals_chip_smoke():
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from zbench.roofline import probe_bound_ms

    g = torch.Generator().manual_seed(3)
    off = torch.sort(torch.randint(0, 4000, (1025,), generator=g)).values.to(torch.int32)
    tbl = torch.randint(0, 1 << 20, (4096, 4), generator=g, dtype=torch.int32)
    q = [torch.randint(0, 1 << 20, (5000,), generator=g, dtype=torch.int32) for _ in range(2)]
    for mode in ("block", "any", "until2", "gate"):
        kw = {"cap": 8, "mode": mode}
        want = chip_smoke.probe_bound(q, off, tbl, kw)[0]
        assert probe_bound_ms(q, off, tbl, kw) == pytest.approx(want, rel=1e-12)
