"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (``gochugaru_tpu_torch`` begins with
``gochugaru_tpu``, so a prefix test would be wrong); and the plain
references load nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "gochugaru_tpu"}

# one whole run of a cell at a tiny size on the CPU, then every top-level
# module name the process holds
_WALK = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, %(root)r)
from zbench import run as R
bench = R.load_json(R.ROOT / "BENCHMARK.json")
tiny = {"rbac-github": {"n_repos": 300, "n_users": 50, "n_teams": 8, "n_orgs": 3},
        "docs-nested": {"n_users": 200, "n_groups": 20, "n_folders": 100,
                        "n_docs": 2000, "edges": 20000}}
for name in %(cells)r:
    config, traffic = name.split(".")
    w = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    cfg = R.load_json(R.HERE / "configs" / f"{config}.json")
    tr = dict(R.load_json(R.HERE / "traffic" / f"{traffic}.json"), batch=2000, pool_batches=4,
              rate_checks_per_s=20000, pool_checks=4096)
    run = R.Run(bench, w, dict(cfg, sizes=tiny[cfg["name"]]), tr, 3, 0.5, False, "cpu")
    assert R.execute(run) == 0
for mod in ("zbench.sweep", "zbench.control", "zbench.trace", "zbench.roofline"):
    __import__(mod)
print("MODULES " + json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MODULES ")][-1]
    return set(json.loads(line[len("MODULES "):]))


def test_run_loads_no_jax_and_no_jax_package():
    cells = ["docs-nested.bulk", "rbac-github.interactive", "docs-nested.lookup",
             "rbac-github.bulk"]
    mods = _top_level_modules(_WALK % {"root": str(ROOT), "cells": cells})
    assert "gochugaru_tpu_torch" in mods  # the walk did reach the program
    assert not mods & FORBIDDEN


def test_references_load_nothing_of_the_program():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import zbench.reference.rbac, zbench.reference.docs, zbench.world\n"
        "import zbench.generators.rbac, zbench.generators.docs\n"
        "print('MODULES ' + json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    mods = _top_level_modules(code)
    assert "zbench" in mods
    assert not mods & (FORBIDDEN | {"gochugaru_tpu_torch", "torch"})
