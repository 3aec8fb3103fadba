"""The port's operator entry points from the command line, on the CPU:
each starts without JAX, refuses ``--device cuda`` at once where there is
no card, and the tuning pass and the prepare profile hold against the
reference's ``scripts/tune.py`` and ``scripts/profile_prepare.py``
(``tune_smoke.sh``'s assertions; the same knobs, ``pallas`` named
``kernels``; the same ``prepare.*`` stage timers).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from gochugaru_tpu_torch.scripts.procs import ROOT, Child, close_all, module_argv
from gochugaru_tpu_torch.tune import TuneDiff

ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
ENTRY = ("fleetd", "telemetryd", "tune", "profile_prepare")
#: arguments each needs besides --device to get past its parser
ARGS = {"fleetd": ("replica", "--upstream", "127.0.0.1:9"), "telemetryd": (),
        "tune": (), "profile_prepare": ()}


def _run(argv, timeout=60):
    return subprocess.run(argv, capture_output=True, text=True, env=ENV, cwd=ROOT,
                          timeout=timeout, stdin=subprocess.DEVNULL)


@pytest.mark.parametrize("name", ENTRY)
def test_help_runs_without_jax(name):
    mod = f"gochugaru_tpu_torch.scripts.{name}"
    args = ["replica", "--help"] if name == "fleetd" else ["--help"]
    p = _run([sys.executable, "-c",
              "import runpy, sys; sys.modules['jax'] = None;"
              f" sys.argv = ['{name}'] + {args!r};"
              f" runpy.run_module('{mod}', run_name='__main__')"])
    assert p.returncode == 0, p.stderr
    assert "usage:" in p.stdout and "--device" in p.stdout


@pytest.mark.parametrize("name", ENTRY)
def test_cuda_without_a_card_exits_nonzero_at_once(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _run(module_argv(f"gochugaru_tpu_torch.scripts.{name}", *ARGS[name],
                         "--device", "cuda"))
    assert p.returncode != 0
    assert "--device cuda" in p.stderr and "CUDA is unavailable" in p.stderr
    assert "Traceback" not in p.stderr
    assert not re.search(r"^(READY|ROUTER-READY|REPLICA-READY|# )", p.stdout, re.M)


def _tune_report(out):
    """(diff JSON text, the diff, fixed point or None, online moves, reverted hold, preset
    hold) from one run of a tune script with --json."""
    lines = out.splitlines()
    js = "\n".join(lines[lines.index("{"):max(
        i for i, ln in enumerate(lines) if ln == "}") + 1])
    diff = json.loads(js)
    preset = float(re.search(r"hold ([0-9.]+)ms", out).group(1)) / 1e3
    fixed = [json.loads(ln.split(": ", 1)[1]) for ln in lines
             if ln.startswith("# fixed point: ")]
    moves = sum(int(m) for m in re.findall(r"^#   tick \d+: moves=(\d+)", out, re.M))
    reverted = float(re.search(r"^# reverted to preset: hold=([0-9.e-]+)s", out,
                               re.M).group(1))
    return js, diff, (fixed[0] if fixed else None), moves, reverted, preset


def test_tune_against_reference(tmp_path):
    args = ("--json", "--repos", "300", "--users", "120", "--seconds", "1.5",
            "--online", "4")
    kids = []
    try:
        port = Child(module_argv("gochugaru_tpu_torch.scripts.tune", *args,
                                 "--device", "cpu"), str(tmp_path / "port.log"),
                     env=ENV)
        ref = Child([sys.executable, os.path.join(ROOT, "scripts", "tune.py"), *args],
                    str(tmp_path / "ref.log"), env=ENV)
        kids += [port, ref]
        assert port.wait(240) == 0, port.tail()
        assert ref.wait(240) == 0, ref.tail()
        js, diff, fixed, moves, reverted, preset = _tune_report(port.text())
        ref_diff = _tune_report(ref.text())[1]
    finally:
        close_all(kids)
    # tune_smoke.sh: a non-empty diff, evidence on every knob, a JSON round
    # trip, a fixed point, bounded moves and a revert to the preset
    assert diff["knobs"], "the default config under clock-bound load proposes"
    assert all(k["evidence"] for k in diff["knobs"])
    assert TuneDiff.from_json(js).to_json(indent=2) == js
    assert fixed == {"re_proposed": []}
    assert moves >= 1
    assert reverted == preset
    named = {"pallas": "kernels"}
    assert ({k["knob"] for k in diff["knobs"]}
            == {named.get(k["knob"], k["knob"]) for k in ref_diff["knobs"]})


def test_first_check_imports_no_sympy():
    """A process's first check broadcasts its query shapes without
    ``torch.broadcast_shapes``, whose first call imports sympy (seconds of
    every replica process's first check)."""
    p = _run([sys.executable, "-c",
              "import runpy, sys;"
              " sys.argv = ['profile_prepare', '--edges', '20000', '--device', 'cpu'];"
              " runpy.run_module('gochugaru_tpu_torch.scripts.profile_prepare',"
              " run_name='__main__');"
              " print('SYMPY', 'sympy' in sys.modules)"])
    assert p.returncode == 0, p.stderr
    assert "SYMPY False" in p.stdout


def _timers(out):
    return set(re.findall(r"^#\s+(prepare\.\S+)\s+[0-9.]+s$", out, re.M))


def test_profile_prepare_timers_equal_reference():
    port = _run(module_argv("gochugaru_tpu_torch.scripts.profile_prepare",
                            "--edges", "20000", "--top", "5", "--device", "cpu"),
                timeout=120)
    ref = _run([sys.executable, os.path.join(ROOT, "scripts", "profile_prepare.py"),
                "--edges", "20000", "--top", "5"], timeout=120)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    assert _timers(port.stdout) == _timers(ref.stdout)
    assert "prepare.total_s" in _timers(port.stdout)
    assert "# first check after import:" in port.stdout
    assert "Ordered by: cumulative time" in port.stdout
