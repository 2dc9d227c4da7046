"""The port's examples (examples/0*_torch.py, submit_torch.sh) at small
sizes on the CPU.

Each example's ``main`` runs through ``importlib`` (the file names start
with a digit), with ``device="cpu"``, and is held to the same protocol
through the JAX package (``scripts/jax_examples_reference.py``):

- 01 (NVE) and 07 (the polariton spectrum, NVE) are deterministic
  (``ex01``, ``ex07_runs``): the total energy and the photon series to
  1e-10 of their scale, the peaks equal;
- 02, 03, 04 and 06 are stochastic: the port's ``torch.Generator``
  streams are not JAX's keys, so the test hands the example JAX's
  thermal velocities (its ``thermalize_velocities`` or
  ``init_replica_states``, from the seeds and kT the example passes) and
  JAX's per-step Bussi and Langevin draws (a noise source given to its
  ``make_step_fn`` or ``make_domain_runner``), and holds every figure the
  example returns (universe drift, mean and final molecular T, the two
  reservoirs, kinetic energies) to JAX's (``ex02``, ``ex03``, ``ex04``,
  ``ex06``) step for step: 1e-10 of its scale in float64 (02), FLOAT32_RTOL
  in float32 (03, 04, 06). A wrong kT, tau, gamma, group or seed order
  in an example's baths moves its reservoirs and temperatures past these
  bounds. 04 runs on 2 x 1 gloo ranks (``parallel/launch.py:run_ranks``);
  its JAX reading is the unsharded batch;
- 08's two IR bands (the strongest absorption in each band window) lie
  within one spectral bin of JAX's at the example's seeds;
- 05 runs the driver and writes its files, and so does
  ``submit_torch.sh`` outside SLURM with a short CPU run's arguments.
"""

import concurrent.futures
import importlib.util
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.parallel.launch import run_ranks

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
# the protocols of the examples' small runs (keyword arguments of main,
# and of scripts/jax_examples_reference.py's exNN)
SMALL = {
    "01": dict(n_molecules=10, box_L=16.0, n_steps=100, fire_steps=20),
    "02": dict(n_molecules=20, box_L=21.0, n_steps=400, fire_steps=50,
               t_window=200),
    "03": dict(n_replicas=2, n_molecules=20, box_L=21.0, n_steps=200,
               fire_steps=50, t_window=100),
    "04": dict(n_molecules=64, box_L=32.0, r_cut=8.0, n_steps=40),
    "06": dict(runtime_ps=0.05, n_molecules=20, box_L=21.0, fire_steps=50,
               chunk=80),
    "07": dict(n_periods=20),
    "08": dict(n_chunks=4, chunk=250, reference_every=250),
}
# the seeds of the JAX examples' step streams (init_state's seed; a
# batch's replica r at seed + r)
STATE_SEEDS = {"02": [4], "03": [100, 101], "04": [0, 1], "06": [11]}
# float32 runs (03, 04, 06) against JAX's: FIRE and the trajectory round
# differently in the two packages. The largest gap of a figure over its
# scale was 8.7e-5 (04's Langevin reservoir; mean and final T up to
# 5.9e-6, CPU, 2026-10-18); a bath's tau moved by 10% moves its
# reservoir by more than this bound
FLOAT32_RTOL = 5e-4
# 08 at the example's seeds (scripts/jax_examples_reference.py --protocol
# tests, CPU, 2026-10-18; five seed variants read the same): the
# strongest wavenumber in each band window, and the spectrum's bin
# (cm^-1). A 0.125-ps segment resolves the bands only to its bin: they
# sit below the bonds' harmonic 1555 and 2325 cm^-1
JAX_IR_BANDS = {"O-O": 1389.850396658966, "N-N": 1945.790555322552}
JAX_IR_BIN_CM1 = 69.49251983294829
KT = PC.kT_from_kelvin(100.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the suite runs six workers on
    the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load(stem):
    """The example module ``examples/<stem>.py`` (names start with a
    digit, so it is loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{stem}", EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_ref():
    """scripts/jax_examples_reference.py, the JAX side of the examples."""
    spec = importlib.util.spec_from_file_location(
        "jax_examples_reference",
        ROOT / "scripts" / "jax_examples_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def jax_runs(jax_ref):
    """JAX's runs of the stochastic examples (``jax_ref.exNN(0, ...)``,
    their figures), started in one thread when the module starts, so that
    they compute beside the port's runs in this one: futures by name."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    runs = {name: pool.submit(getattr(jax_ref, f"ex{name}"), 0, **SMALL[name])
            for name in ("02", "03", "04", "06")}
    yield runs
    pool.shutdown(wait=True, cancel_futures=True)


# ------------------------------------------ JAX's draws in the port's run
def jax_draws(seeds, n_molecules, n_steps, dtype):
    """The JAX package's Bussi (method 0, the molecules) and Langevin
    (method 1, the photon) draws of each step for the step keys
    ``master_key(s)``, s in ``seeds`` (one row a replica):
    ``{("bussi", 0): (r1, r_gamma), ("langevin", 1): xi}`` as NumPy of
    (steps, B) and (steps, B, 1, 3)."""
    import jax
    import jax.numpy as jnp

    from cavmd_tpu.integrate.rng import (
        STREAM_BUSSI,
        STREAM_LANGEVIN,
        master_key,
        stream_key,
    )
    from cavmd_tpu.integrate.thermostats import bussi_noise

    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    dof = 3.0 * 2 * n_molecules  # the molecules' translational dof

    def one(key, t):
        r1, rg = bussi_noise(stream_key(key, STREAM_BUSSI, t, 0), dof, jd)
        xi = jax.random.normal(stream_key(key, STREAM_LANGEVIN, t, 1),
                               (1, 3), dtype=jd)
        return r1, rg, xi

    keys = jnp.stack([master_key(s) for s in seeds])
    per = jax.jit(jax.vmap(jax.vmap(one, (0, None)), (None, 0)))(
        keys, jnp.arange(n_steps))
    r1, rg, xi = (np.asarray(x) for x in per)
    return {("bussi", 0): (r1, rg), ("langevin", 1): xi}


class TableDraws:
    """A noise source for the port's step (``make_step_fn(noise=)``,
    ``make_domain_runner(noise=)``) that hands in rows ``rows`` of a
    ``jax_draws`` table at each host step. A draw the table lacks (another
    method index or kind) raises."""

    def __init__(self, table, rows=slice(None)):
        self.table, self.rows = table, rows

    def _t(self, x, state, shape):
        return torch.tensor(x[state.step, self.rows],
                            dtype=state.position.dtype).reshape(shape)

    def bussi(self, state, i, m):
        return tuple(self._t(x, state, state.batch_shape)
                     for x in self.table["bussi", i])

    def langevin(self, state, i, m, shape):
        return self._t(self.table["langevin", i], state, shape)


def jax_thermalized(key, mass, mask, kT, remove_drift=True):
    """JAX's ``thermalize_velocities`` on the port's tensors."""
    import jax.numpy as jnp

    from cavmd_tpu.integrate import thermalize_velocities

    v = thermalize_velocities(key, jnp.asarray(mass.numpy()),
                              jnp.asarray(mask.numpy()), kT,
                              remove_drift=remove_drift)
    return torch.tensor(np.asarray(v), dtype=mass.dtype)


def with_jax_noise(mod, table):
    """The example module ``mod`` with its ``make_step_fn`` handing the
    step JAX's draws."""
    real = mod.make_step_fn
    mod.make_step_fn = lambda ff, methods, **kw: real(
        ff, methods, noise=TableDraws(table), **kw)
    return mod


def with_jax_thermalization(mod):
    """The example module ``mod`` (02, 06) with its velocities drawn by
    JAX: ``make_generator(seed, STREAM_THERMALIZE)`` stands for the JAX
    example's ``master_key(seed)``, and ``thermalize_velocities`` draws
    with it from the mass, mask and kT the example passes."""
    from cavmd_tpu.integrate import master_key

    from cavmd_tpu_torch.integrate.rng import STREAM_THERMALIZE

    def make_generator(seed, stream, instance=0, device=None):
        assert (stream, instance) == (STREAM_THERMALIZE, 0)
        return master_key(seed)

    mod.make_generator = make_generator
    mod.thermalize_velocities = jax_thermalized
    return mod


def jax_replica_velocities(snap, mol, seeds, kT):
    """JAX's velocities of ``parallel/replicas.py:init_replica_states`` for
    replicas at ``seeds``: the thermalize streams 0 (the molecules ``mol``,
    drift removed) and 1 (the photon) of ``master_key(s)``."""
    from cavmd_tpu.integrate import master_key
    from cavmd_tpu.integrate.rng import STREAM_THERMALIZE, stream_key

    out = []
    for s in seeds:
        key = master_key(s)
        v = jax_thermalized(stream_key(key, STREAM_THERMALIZE, 0),
                            snap.mass, mol, kT)
        out.append(v + jax_thermalized(stream_key(key, STREAM_THERMALIZE, 1),
                                       snap.mass, ~mol, kT,
                                       remove_drift=False))
    return out


def with_jax_replicas(mod):
    """The example module ``mod`` (03) with its batch thermalized by JAX:
    ``init_replica_states(snap, ..., seed, kT)`` gives replica r JAX's
    velocities at seed + r."""
    real = mod.init_replica_states

    def init_replica_states(snap, ff, *, n_replicas, dt, seed, kT):
        velocities = jax_replica_velocities(
            snap, snap.typeid != ff.l_typeid,
            range(seed, seed + n_replicas), kT)
        return real([snap.replace(velocity=v) for v in velocities], ff,
                    dt=dt, seed=seed)

    mod.init_replica_states = init_replica_states
    return mod


def hold_figures(got, want, rtol):
    """Every figure of JAX's run in the port's (a number or a list a
    replica) within ``rtol`` of its scale (the largest |value| of the
    figure), but the universe drift: a max of differences of float32
    energies rounded apart in the two packages, it is held to 3x JAX's."""
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[key], np.float64)
        if key == "drift_ha":
            assert np.all(np.isfinite(g)) and np.all(g <= 3 * w), (g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=rtol * np.abs(w).max(),
                                       err_msg=key)


def test_01_nve_matches_jax_step_for_step(jax_ref):
    got = load("01_basic_nve_torch").main(device="cpu", **SMALL["01"])
    want = jax_ref.ex01(**SMALL["01"])
    np.testing.assert_allclose(got["energy"], want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    assert got["drift_ha"] == pytest.approx(
        float(np.abs(want - want[0]).max()), rel=1e-6, abs=1e-14)
    assert got["time_ps"] == pytest.approx(SMALL["01"]["n_steps"] * 2.5e-4)


def test_07_photon_series_and_peaks_match_jax(jax_ref):
    got = load("07_polariton_rabi_splitting_torch").main(
        device="cpu", **SMALL["07"])
    runs, bare = jax_ref.ex07_runs(**SMALL["07"])
    for g, qx, peaks in ((0.0, got["qx_g0"], got["peaks_g0"]),
                         (1e-3, got["qx"], got["peaks"])):
        want = runs[g]["qx"]
        np.testing.assert_allclose(qx, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())
        assert peaks == runs[g]["peaks"]
    assert got["bin_cm1"] == pytest.approx(runs[1e-3]["bin_cm1"])
    assert got["bare_cm1"] == pytest.approx(bare, rel=1e-12)


def test_02_two_baths_within_jax_readings(jax_runs):
    """float64, step for step with JAX's velocities and draws."""
    mod = with_jax_noise(
        with_jax_thermalization(load("02_two_bath_universe_energy_torch")),
        jax_draws(STATE_SEEDS["02"], SMALL["02"]["n_molecules"],
                  SMALL["02"]["n_steps"], torch.float64))
    got = mod.main(device="cpu", **SMALL["02"])
    hold_figures(got, jax_runs["02"].result(), 1e-10)
    assert got["time_ps"] == pytest.approx(SMALL["02"]["n_steps"] * 2.5e-4)


def test_03_replica_batch_within_jax_readings(jax_runs):
    """float32, 2 replicas step for step with JAX's velocities and
    draws."""
    kw = SMALL["03"]
    mod = with_jax_noise(
        with_jax_replicas(load("03_replicas_torch")),
        jax_draws(STATE_SEEDS["03"], kw["n_molecules"], kw["n_steps"],
                  torch.float32))
    got = mod.main(device="cpu", **kw)
    assert len(got["drift_ha"]) == kw["n_replicas"]
    hold_figures(got, jax_runs["03"].result(), FLOAT32_RTOL)
    # replica r is thermalized at seed 100 + r: the batch is not one
    # trajectory repeated
    assert got["cavity_ke_ha"][0] != got["cavity_ke_ha"][1]


def example04_on_rank(kwargs, velocities, table):
    """A ``run_ranks`` job: example 04's main on this rank with JAX's
    velocities (``velocities``, a replica each, for the seed and kT the
    example must pass) and rows of JAX's draws (``table``: rank (r, s)
    takes row r). The spawned rank imports this module, which imports no
    JAX at its top, and no JAX itself."""
    import torch.distributed as dist

    mod = load("04_slab_replicas_torch")
    real_init, real_runner = mod.init_replica_states, mod.make_domain_runner
    R = len(velocities)

    def init_replica_states(snap, ff, *, n_replicas, dt, seed, kT):
        assert (n_replicas, seed, kT) == (R, STATE_SEEDS["04"][0], KT)
        return real_init([snap.replace(velocity=torch.tensor(v))
                          for v in velocities], ff, dt=dt, seed=seed)

    def make_domain_runner(*args, **kw):
        r = dist.get_rank() // (dist.get_world_size() // R)
        return real_runner(*args, noise=TableDraws(table, slice(r, r + 1)),
                           **kw)

    mod.init_replica_states = init_replica_states
    mod.make_domain_runner = make_domain_runner
    return mod.main(device="cpu", **kwargs)


def test_04_replicas_over_slab_ranks_within_jax_readings(jax_runs):
    """2 x 1 gloo ranks: 2 replicas, one slab each, with JAX's velocities
    and draws; every rank returns the whole batch, held step for step to
    JAX's unsharded batch (float32)."""
    import cavmd_tpu_torch as pt

    kw = SMALL["04"]
    snap = pt.add_cavity_particle(pt.make_diatomic_system(
        kw["n_molecules"], box_L=kw["box_L"], seed=0, dtype=torch.float32,
        device="cpu"), coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
        seed=1)
    mol = snap.typeid != snap.typeid.max()  # the photon is the last type
    velocities = [v.numpy() for v in jax_replica_velocities(
        snap, mol, STATE_SEEDS["04"], KT)]
    table = jax_draws(STATE_SEEDS["04"], kw["n_molecules"], kw["n_steps"],
                      torch.float32)
    (on_ranks,) = run_ranks([(example04_on_rank, (kw, velocities, table))],
                            2, timeout=300)
    a, b = on_ranks
    assert (a["replicas"], a["slabs"]) == (2, 1)
    assert a == b
    hold_figures(a, jax_runs["04"].result(), FLOAT32_RTOL)
    assert a["final_ke_ha"][0] != a["final_ke_ha"][1]


def test_05_runs_the_driver(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = load("05_advanced_run_torch").main(
        ["--n-molecules", "10", "--runtime", "0.004",
         "--enable-energy-tracker"], device="cpu")
    assert got == {"rc": 0}
    out = tmp_path / "cavity_coupling_1eneg03"
    assert {"prod-1_energy_tracker.txt", "prod-1.gsd"} <= set(
        os.listdir(out))


def test_06_reference_anchor_within_jax_readings(jax_runs):
    """float32, in chunks, step for step with JAX's velocities and
    draws."""
    kw = SMALL["06"]
    n_steps = 200  # 0.05 ps in chunks of 80, 80 and 40
    mod = with_jax_noise(
        with_jax_thermalization(
            load("06_reference_anchor_validation_torch")),
        jax_draws(STATE_SEEDS["06"], kw["n_molecules"], n_steps,
                  torch.float32))
    got = mod.main(device="cpu", **kw)
    assert got["steps"] == n_steps
    hold_figures(got, jax_runs["06"].result(), FLOAT32_RTOL)


def test_08_ir_bands_within_a_bin_of_jax(tmp_path):
    got = load("08_ir_spectrum_torch").main(
        device="cpu", workdir=str(tmp_path), **SMALL["08"])
    assert got["workdir"] == str(tmp_path)
    assert got["n_segments"] == 4
    assert sorted(os.listdir(tmp_path)) == [
        f"dipole_autocorr_{n}.txt" for n in range(4)]
    assert got["bin_cm1"] == pytest.approx(JAX_IR_BIN_CM1)
    for band, want in JAX_IR_BANDS.items():
        assert abs(got["bands"][band] - want) <= JAX_IR_BIN_CM1, (
            band, got["bands"][band], want)


def test_submit_script_runs_the_port_cli(tmp_path):
    """The SLURM script outside SLURM, with a short CPU run's arguments
    after the coupling: one replica (the array task's, else replica 1)
    through the port's driver."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SLURM_")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        ["bash", str(EXAMPLES / "submit_torch.sh"), "2e-3", "--device",
         "CPU", "--n-molecules", "10", "--runtime", "0.004"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = tmp_path / "cavity_coupling_2eneg03"
    assert {"prod-1_energy_tracker.txt", "prod-1_cavity_mode.txt",
            "prod-1.gsd"} <= set(os.listdir(out))
    text = (EXAMPLES / "submit_torch.sh").read_text()
    assert "--vmap-replicas" in text and "--shard-replicas" in text


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*_torch.*")),
                         ids=lambda p: p.name)
def test_examples_import_no_jax(path):
    """The port's examples import ``cavmd_tpu_torch``, never ``jax`` or
    the JAX package."""
    text = path.read_text()
    assert "cavmd_tpu_torch" in text
    for line in text.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "cavmd_tpu"), line
