"""The comparison that decides ``correct``, driven through the harness on
the CPU at 1,201 atoms: the reference agrees with the program's float64
path to rounding, the program's float32 path passes the cells' limits,
and the control and each fault the cells can have fail them."""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import check  # noqa: E402
from portbench.harness.program import Program  # noqa: E402
from portbench.run import run_cell  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
MODES = ("cell", "slab", "zcol")
WORKLOAD = {"cell": "cell100k.b32", "slab": "slab100k.b64",
            "zcol": "zcol100k.b32"}


def tiny_cell(mode, dtype="float32"):
    cfg = json.loads((DATA / f"tiny-{mode}.json").read_text())
    cfg["physics"]["dtype"] = dtype
    return types.SimpleNamespace(
        name=f"tiny-{mode}", entry={"chips": 1}, per_layer=[], config=cfg,
        traffic={"replicas": 4, "chunk_steps": 20, "warm_chunks": 1})


def run(cell, lim, seed=11, program_class=None, control=False):
    torch.set_num_threads(4)
    return run_cell(cell, seed, 0.0, False, "cpu", time.perf_counter(), lim,
                    program_class=program_class, control=control,
                    log=open("/dev/null", "w"))


@pytest.mark.parametrize("mode", MODES)
def test_reference_matches_program_float64(mode):
    """Same scene, same draws: the float64 program and the reference
    differ by rounding alone."""
    lim = {k: 1e-11 for k in check.NUMBERS}
    r = run(tiny_cell(mode, "float64"), lim)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("mode", MODES)
def test_program_passes_control_fails(mode):
    lim = check.limits(WORKLOAD[mode])
    r = run(tiny_cell(mode), lim, control=True)
    assert r["correct"], r["checks"]
    ok, table = check.verdict(r["control"], lim)
    assert not ok, table


def broken(fault):
    """A Program whose timed call is broken underneath."""

    class Broken(Program):
        def _build(self):
            super()._build()
            inner = self._run

            def run_(st, n):
                new, obs = inner(st, n)
                if fault == "unchanged":
                    return st, obs
                if fault == "half_batch":
                    h = st.position.shape[0] // 2
                    keep = {k: torch.cat([getattr(new, k)[:h],
                                          getattr(st, k)[h:]])
                            for k in ("position", "image", "velocity",
                                      "forces")}
                    return new.replace(**keep), obs
                if fault == "altered_position":
                    pos = new.position.clone()
                    pos[:, 0, 0] += 0.2
                    return new.replace(position=pos), obs
                if fault == "altered_force":
                    f = new.forces.clone()
                    f[:, 1] *= 1.5
                    return new.replace(forces=f), obs
                raise ValueError(fault)

            self._run = run_

    return Broken


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "altered_position", "altered_force"])
def test_fault_is_not_correct(fault):
    lim = check.limits(WORKLOAD["cell"])
    r = run(tiny_cell("cell"), lim, program_class=broken(fault))
    assert not r["correct"], r["checks"]


def test_no_jax_in_a_rehearsal():
    """A CPU run of the harness loads neither JAX nor the JAX package
    (top-level names compared whole: cavmd_tpu_torch is not cavmd_tpu)."""
    code = (
        "import sys, time, json, types; sys.path.insert(0, %r);"
        "from portbench.tests.test_portbench_check import tiny_cell, run;"
        "from portbench.harness.check import NUMBERS;"
        "from portbench.run import forbidden_modules;"
        "run(tiny_cell('cell'), {k: 1.0 for k in NUMBERS});"
        "print(json.dumps(forbidden_modules()))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.cuda
def test_control_fails_at_cell_size():
    """The control at the cell's own size on the card: the reference in
    bfloat16 in the program's place fails the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.harness.cells import Cell

    lim = check.limits("cell100k.b32")
    r = run_cell(Cell("cell100k.b32"), 20211, 3.0, False, "cuda",
                 time.perf_counter(), lim, control=True)
    assert r["correct"], r["checks"]
    assert not check.verdict(r["control"], lim)[0]
