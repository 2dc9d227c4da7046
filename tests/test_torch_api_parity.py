"""The port's coverage of the JAX package's public names, read from source.

Every public module-level name of every module of ``cavmd_tpu/`` (its
functions, classes and constants; in an ``__init__.py`` also the names it
imports, which are its exports) must be bound in the module of the same
path in ``cavmd_tpu_torch/``, or have a row in ``NOT_PORTED``. A row
either names the port function that covers the name ("covered by
<port module>:<function>"), or quotes the item of ROADMAP.md's "Not
queued this round" that excludes it ('ROADMAP: "<quote>"').

Below the names, their signatures: every parameter of a public function
that both modules define, and every member of a public class that both
define (its methods and their parameters, its fields and class
attributes), must be in the port's counterpart, or have a row in
``SIGNATURE_GAPS``, keyed ``<module>:<function>(<parameter>)``,
``<module>:<Class>.<member>`` or ``<module>:<Class>.<method>(<parameter>)``.
A port class's members also count the attributes its methods set on
``self`` and the buffers it registers by name. A row's reason is one of
those above, where "covered by" may also name a class member
(``<Class>.<member>``) and add a note after a colon, or "renamed to
<name>": a parameter (member) of the same port function (class) that the
JAX one does not have.

Both packages are parsed with ``ast``; nothing of either is imported, so a
finished port is told from an unfinished one in well under a second.
"""

import ast
import functools
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "cavmd_tpu"
PORT_PKG = ROOT / "cavmd_tpu_torch"

NOT_PORTED = {
    # the Pallas wrappers: the CUDA wrappers of PERF.md §6 take their place
    "PallasPairPack": "covered by ops/pair_kernels.py:dense_pair_force",
    "make_fused_pair_pallas":
        "covered by ops/pair_kernels.py:dense_pair_force",
    "pallas_pair_apply": "covered by ops/pair_kernels.py:dense_pair_force",
    "CellPallasPack": "covered by ops/cell_kernels.py:cell_pair_force_fused",
    "fused_cell_pallas":
        "covered by ops/cell_kernels.py:cell_pair_force_fused",
    "fused_cell_cols_pallas":
        "covered by ops/cell_kernels.py:cell_pair_force_fused",
    "fused_cell_cols_slab_pallas":
        "covered by ops/cell_kernels.py:cell_pair_force_slab",
    "vma_struct": "covered by ops/cell_kernels.py:cell_pair_force_slab",
    "fused_zsort_cols_pallas":
        "covered by ops/zcol_kernels.py:zcol_pair_force",
    "plan_zcol_window": "covered by ops/zcol_kernels.py:plan_zcol_window",
    "cell_local_positions": 'ROADMAP: "K7\'s `prewrap`, `s1` and `jsplit`"',
    "spread_grid_pallas": "covered by ops/pppm_kernels.py:spread_grid",
    "pallas_spread_ok":
        'ROADMAP: "`_spread_grid_chunked`, `pallas_spread_ok`), which K2/K3 '
        'cover"',
    "PRE_NSCAL": "covered by ops/fused_integrator.py:pre_force_apply",
    "POST_NSCAL": "covered by ops/fused_integrator.py:post_force_apply",
    # the PPPM variants: a leading replica axis needs no function of its own
    "pppm_reciprocal_energy_batched":
        "covered by ops/pppm.py:pppm_reciprocal_energy",
    "pppm_force_and_energy_batched":
        "covered by ops/pppm.py:pppm_force_and_energy",
    "pppm_force_and_energy_pallas":
        "covered by ops/pppm.py:pppm_force_and_energy",
    "pppm_reciprocal_energy_chunked":
        'ROADMAP: "the chunked and VMEM-resident PPPM spreads"',
    "pppm_force_and_energy_chunked":
        'ROADMAP: "the chunked and VMEM-resident PPPM spreads"',
    # the incidence matmuls
    "bond_incidence": 'ROADMAP: "the incidence bond/exclusion matmuls"',
    "harmonic_bond_force_incidence":
        'ROADMAP: "the incidence bond/exclusion matmuls"',
    "ewald_exclusion_correction_incidence":
        'ROADMAP: "the incidence bond/exclusion matmuls"',
    # JAX PRNG keys and backend selection
    "master_key": "covered by integrate/rng.py:make_generator",
    "stream_key": "covered by integrate/rng.py:make_generator",
    "setup_backend": "covered by core/device.py:resolve_device",
    # the slab path's shard_map plumbing: the port's slabs are processes
    "AXIS": "covered by parallel/comm.py:Communicator",
    "RepState": "covered by parallel/domain.py:make_domain_step",
    # XLA's compile cache
    "enable_persistent_cache": 'ROADMAP: "`utils/jitcache.py`"',
}

# keyword and member differences, with their reasons
_KNOB = ('ROADMAP: "the Pallas and `shard_map` knobs of the domain runner '
         'and the fused integrator"')
_K7 = 'ROADMAP: "K7\'s `prewrap`, `s1` and `jsplit`"'
_RNG = ('ROADMAP: "`rng_impl=` on `init_state`, `Simulation` and '
        '`CavityMDSimulation`"')
_PACKS = ('ROADMAP: "the Pallas packs and the XLA tile pass\'s feature '
          'tables"')
SIGNATURE_GAPS = {
    # the JAX PRNG backends
    "drivers/advanced_run.py:CavityMDSimulation.__init__(rng_impl)": _RNG,
    "integrate/integrator.py:init_state(rng_impl)": _RNG,
    "simulation.py:Simulation.__init__(rng_impl)": _RNG,
    # lax.scan, Pallas and shard_map settings
    "integrate/integrator.py:run_steps(unroll)":
        'ROADMAP: "`run_steps(unroll=)` (a `lax.scan` setting)"',
    "ops/fused_integrator.py:pre_force_apply(interpret)": _KNOB,
    "ops/fused_integrator.py:post_force_apply(interpret)": _KNOB,
    "integrate/forcefield.py:ForceField.cell_block": _KNOB,
    **{f"parallel/domain.py:{fn}({k})": _KNOB
       for fn in ("make_domain_step", "make_domain_runner")
       for k in ("use_pallas", "interpret", "cell_block")},
    "parallel/domain.py:make_domain_step(axis)": _KNOB,
    "parallel/domain.py:make_domain_runner(mesh)": _KNOB,
    **{f"parallel/domain.py:{fn}({k})": _K7
       for fn in ("make_domain_step", "make_domain_runner")
       for k in ("prewrap", "s1", "jsplit")},
    "parallel/domain.py:ShardData.halo_ctr": _K7,
    "ops/neighbor.py:make_fused_cell_kernel(uniform_rcut)":
        'ROADMAP: "the Pallas-only `uniform_rcut` of '
        '`make_fused_cell_kernel`"',
    # tables only the Pallas kernels, the XLA tile pass or the DFT matmuls
    # read
    "integrate/forcefield.py:ForceField.pallas_pack": _PACKS,
    "integrate/forcefield.py:ForceField.cell_pallas_pack": _PACKS,
    "integrate/forcefield.py:ForceField.cell_features": _PACKS,
    "parallel/domain.py:ShardData.feat": _PACKS,
    "parallel/domain.py:ShardData.pack_rows": _PACKS,
    "ops/lj.py:LJPairMatrices.dense_numpy": _PACKS,
    "ops/pppm.py:PPPMParams.dft_stack": 'ROADMAP: "DFT-by-matmul"',
    "integrate/forcefield.py:ForceField.bond_gi":
        'ROADMAP: "the incidence bond/exclusion matmuls"',
    "integrate/forcefield.py:ForceField.bond_gj":
        'ROADMAP: "the incidence bond/exclusion matmuls"',
    # the port's own tables: the kernels' (T, T) tables and (N, N) masks
    "integrate/forcefield.py:ForceField.lj_pair":
        "covered by integrate/forcefield.py:ForceField.lj_eps: the dense "
        "kernel reads the (T, T) tables",
    "integrate/forcefield.py:ForceField.lj_sigma": "renamed to lj_sig2",
    "integrate/forcefield.py:ForceField.lj_rcut": "renamed to lj_rcut2",
    "integrate/forcefield.py:ForceField.excl_mask":
        "covered by integrate/forcefield.py:ForceField.lj_active: the "
        "dense masks hold the bonded exclusions",
    "integrate/forcefield.py:ForceField.uniform_rcut":
        "covered by parallel/domain.py:uniform_rcut",
    "integrate/forcefield.py:ForceField.compute": "renamed to forward",
    "ops/neighbor.py:make_lj_cell_kernel(sigma_table)":
        "renamed to sig2_table",
    "ops/neighbor.py:make_lj_cell_kernel(rcut_table)":
        "renamed to rcut2_table",
    "ops/neighbor.py:make_fused_cell_kernel(sigma_table)":
        "renamed to sig2_table",
    "ops/neighbor.py:make_fused_cell_kernel(rcut_table)":
        "renamed to rcut2_table",
    # the port's device-side list signatures
    "ops/neighbor.py:build_zcol_list(neighbor_cells)":
        "renamed to neighbor_columns",
    "ops/neighbor.py:slot_gather_forces(clist)": "renamed to slot_of",
    "ops/neighbor.py:slot_gather_forces(n)": "renamed to slot_of",
    # JAX PRNG keys: the port takes generators, or the draws themselves
    "integrate/thermostats.py:bussi_noise(key)": "renamed to generator",
    "integrate/thermostats.py:mttk_thermalize(key)": "renamed to generator",
    "integrate/thermostats.py:thermalize_velocities(key)":
        "renamed to generator",
    "integrate/thermostats.py:bussi_rescale_factor(key)": "renamed to r1",
    "integrate/thermostats.py:bussi_apply(key)": "renamed to r1",
    "integrate/thermostats.py:langevin_ou_apply(key)": "renamed to noise",
    "integrate/thermostats.py:brownian_apply(key)": "renamed to noise_pos",
    "integrate/integrator.py:MDState.key": "renamed to generators",
    # MDState's other leaves
    "integrate/integrator.py:MDState.bond_group":
        "covered by integrate/forcefield.py:ForceField.bond_group: the "
        "force field keeps the bond table",
    "integrate/integrator.py:MDState.bond_typeid":
        "covered by integrate/forcefield.py:ForceField.bond_typeid: the "
        "force field keeps the bond table",
    "integrate/integrator.py:MDState.bussi_reservoir_rot":
        "covered by observe/thermo.py:BussiReservoirView."
        "reservoir_energy_rotational: point particles have no rotational "
        "DOF, so it is 0",
    "integrate/integrator.py:MDState.mttk": "renamed to mttk_xi",
}

COVERED = re.compile(r"covered by (\S+\.py):(\w+)(?:\.(\w+))?(?:: .+)?$")
QUOTED = re.compile(r'ROADMAP: "(.+)"$')
RENAMED = re.compile(r"renamed to (\w+)$")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module, as in the other port test
    modules (the suite runs six workers on the machine's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def public_names(path: Path, *, exports: bool) -> set:
    """The public module-level names a module binds: its functions,
    classes and assigned names, plus (``exports``) the names it imports;
    ``__version__`` counts as public."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif exports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def port_binds(rel: Path) -> set:
    """Every name the port module of the same path binds (imports too:
    a counterpart may be re-exported from where it is defined)."""
    path = PORT_PKG / rel
    return public_names(path, exports=True) if path.exists() else set()


JAX_MODULES = sorted(p.relative_to(JAX_PKG) for p in JAX_PKG.rglob("*.py"))


def not_queued_text() -> str:
    """ROADMAP.md's "Not queued this round" section, whitespace folded."""
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("### Not queued this round")
    end = text.find("\n## ", start)
    return " ".join(text[start:end if end > 0 else None].split())


@pytest.mark.parametrize("rel", JAX_MODULES, ids=str)
def test_every_public_name_is_ported_or_excused(rel):
    want = public_names(JAX_PKG / rel, exports=rel.name == "__init__.py")
    missing = sorted(want - port_binds(rel) - set(NOT_PORTED))
    assert not missing, (
        f"cavmd_tpu/{rel}: {missing} have no counterpart in "
        f"cavmd_tpu_torch/{rel} and no NOT_PORTED row")


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_each_not_ported_row_is_needed_and_holds(name):
    """A row names a JAX name that the port's module of the same path
    lacks, and its reason holds: the covering port function exists, or
    the quote stands in ROADMAP.md's "Not queued this round"."""
    homes = [rel for rel in JAX_MODULES
             if name in public_names(JAX_PKG / rel,
                                     exports=rel.name == "__init__.py")]
    assert homes, f"{name} is not a public name of the JAX package"
    assert all(name not in port_binds(rel) for rel in homes), (
        f"{name} is ported: drop its NOT_PORTED row")
    reason = NOT_PORTED[name]
    covered, quoted = COVERED.match(reason), QUOTED.match(reason)
    assert covered or quoted, f"{name}: malformed reason {reason!r}"
    if covered:
        module, fn, member = covered.groups()
        assert member is None, f"{name}: a NOT_PORTED row names a function"
        assert fn in public_names(PORT_PKG / module, exports=False), (
            f"{name}: cavmd_tpu_torch/{module} defines no {fn}")
    else:
        assert " ".join(quoted.group(1).split()) in not_queued_text(), (
            f"{name}: ROADMAP.md's \"Not queued this round\" does not say "
            f"{quoted.group(1)!r}")


# ------------------------------------------------------------ signatures
def _params(fn) -> set:
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs} - {
        "self", "cls"}


def _members(cls, *, port: bool) -> dict:
    """A class's public members (and ``__init__``): each method's
    parameters, None for a field or class attribute. ``port`` adds the
    attributes its methods set on ``self`` and the names it registers as
    buffers (a string that opens a call's arguments or a (name, value)
    pair)."""
    out = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = None
        elif isinstance(node, ast.Assign):
            out.update((t.id, None) for t in node.targets
                       if isinstance(t, ast.Name))
    if port:
        for node in ast.walk(cls):
            first = None
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Store)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                out.setdefault(node.attr, None)
            elif isinstance(node, ast.Call) and node.args:
                first = node.args[0]
            elif isinstance(node, ast.Tuple) and len(node.elts) == 2:
                first = node.elts[0]
            if isinstance(first, ast.Constant) and isinstance(first.value,
                                                              str):
                out.setdefault(first.value, None)
    return {k: v for k, v in out.items()
            if not k.startswith("_") or k == "__init__"}


@functools.lru_cache(maxsize=None)
def definitions(path: Path) -> dict:
    """A module's public top-level functions and classes by name."""
    if not path.exists():
        return {}
    return {n.name: n for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def signature_gaps(rel: Path) -> list:
    """The parameters and members of ``rel``'s functions and classes that
    the port's counterparts lack, as ``SIGNATURE_GAPS`` keys."""
    jdefs, pdefs = definitions(JAX_PKG / rel), definitions(PORT_PKG / rel)
    gaps = []
    for name, jn in jdefs.items():
        pn = pdefs.get(name)
        if pn is None or isinstance(pn, ast.ClassDef) != isinstance(
                jn, ast.ClassDef):
            continue  # the name check's business
        if not isinstance(jn, ast.ClassDef):
            gaps += [f"{rel}:{name}({x})" for x in sorted(_params(jn)
                                                           - _params(pn))]
            continue
        pm = _members(pn, port=True)
        for member, ps in _members(jn, port=False).items():
            if member not in pm:
                gaps.append(f"{rel}:{name}.{member}")
            elif ps and pm[member] is not None:
                gaps += [f"{rel}:{name}.{member}({x})"
                         for x in sorted(ps - pm[member])]
    return gaps


@pytest.mark.parametrize("rel", JAX_MODULES, ids=str)
def test_every_keyword_and_member_is_ported_or_excused(rel):
    missing = [g for g in signature_gaps(rel) if g not in SIGNATURE_GAPS]
    assert not missing, (
        f"{missing}: no counterpart in cavmd_tpu_torch/{rel} and no "
        "SIGNATURE_GAPS row")


_GAP = re.compile(r"(\S+\.py):(\w+)(?:\.(\w+))?(?:\((\w+)\))?$")


def _port_scope(module: str, name: str, member):
    """(parameters or members of the port's ``name`` in ``module``, and
    the same of the JAX one): of the function, or of the class, or of the
    class's method ``member``."""
    out = []
    for pkg, port in ((PORT_PKG, True), (JAX_PKG, False)):
        node = definitions(pkg / module).get(name)
        if node is None:
            out.append(set())
        elif not isinstance(node, ast.ClassDef):
            out.append(_params(node))
        else:
            members = _members(node, port=port)
            out.append(set(members) if member is None
                       else members.get(member) or set())
    return out


@pytest.mark.parametrize("gap", sorted(SIGNATURE_GAPS))
def test_each_signature_row_is_needed_and_holds(gap):
    """A row names a gap the port still has, and its reason holds: the
    covering port function or member exists, the quote stands in
    ROADMAP.md's "Not queued this round", or the new name is the port's
    and not the JAX package's."""
    module, name, member, param = _GAP.match(gap).groups()
    assert gap in signature_gaps(Path(module)), (
        f"{gap} is ported (or not a JAX name): drop its SIGNATURE_GAPS row")
    reason = SIGNATURE_GAPS[gap]
    covered, quoted = COVERED.match(reason), QUOTED.match(reason)
    renamed = RENAMED.match(reason)
    assert covered or quoted or renamed, f"{gap}: malformed {reason!r}"
    if covered:
        cmod, cname, cmember = covered.groups()
        defs = definitions(PORT_PKG / cmod)
        assert cname in defs or cname in public_names(
            PORT_PKG / cmod, exports=False), (
            f"{gap}: cavmd_tpu_torch/{cmod} defines no {cname}")
        if cmember is not None:
            assert cmember in _members(defs[cname], port=True), (
                f"{gap}: cavmd_tpu_torch/{cmod}:{cname} has no {cmember}")
    elif quoted:
        assert " ".join(quoted.group(1).split()) in not_queued_text(), (
            f"{gap}: ROADMAP.md's \"Not queued this round\" does not say "
            f"{quoted.group(1)!r}")
    else:
        new = renamed.group(1)
        port_side, jax_side = _port_scope(
            module, name, member if param is not None else None)
        assert new in port_side and new not in jax_side, (
            f"{gap}: {new} is not a port-only name of the same "
            f"{'function' if param else 'class'}")
