"""The port's coverage of the JAX package's public names, read from source.

Every public module-level name of every module of ``cavmd_tpu/`` (its
functions, classes and constants; in an ``__init__.py`` also the names it
imports, which are its exports) must be bound in the module of the same
path in ``cavmd_tpu_torch/``, or have a row in ``NOT_PORTED``. A row
either names the port function that covers the name ("covered by
<port module>:<function>"), or quotes the item of ROADMAP.md's "Not
queued this round" that excludes it ('ROADMAP: "<quote>"'). Both
packages are parsed with ``ast``; nothing of either is imported, so a
finished port is told from an unfinished one in well under a second.
"""

import ast
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
    # GSPMD
    "make_mesh": 'ROADMAP: "GSPMD pieces:** `parallel/shard.py`, '
                 '`parallel/mesh.py`"',
    "state_shardings": 'ROADMAP: "`parallel/mesh.py` `state_shardings`"',
    "pad_snapshot_to":
        'ROADMAP: "`--pad-atoms`, the GSPMD single-device comparator"',
    "make_sharded_runner": 'ROADMAP: "GSPMD pieces:** `parallel/shard.py`"',
    "make_sharded_step": 'ROADMAP: "GSPMD pieces:** `parallel/shard.py`"',
    "shard_state": 'ROADMAP: "GSPMD pieces:** `parallel/shard.py`"',
    "enable_persistent_cache": 'ROADMAP: "`utils/jitcache.py`"',
}

COVERED = re.compile(r"covered by (\S+\.py):(\w+)$")
QUOTED = re.compile(r'ROADMAP: "(.+)"$')


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
        module, fn = covered.groups()
        assert fn in public_names(PORT_PKG / module, exports=False), (
            f"{name}: cavmd_tpu_torch/{module} defines no {fn}")
    else:
        assert " ".join(quoted.group(1).split()) in not_queued_text(), (
            f"{name}: ROADMAP.md's \"Not queued this round\" does not say "
            f"{quoted.group(1)!r}")
