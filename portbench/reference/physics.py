"""Plain PyTorch reference of the benchmark scene's forces and energies.

Written from the configuration file alone: it imports nothing of the
program and takes none of its tables. Shifted Lennard-Jones and the
real-space Ewald term (erfc(kappa r)/r) over every pair inside r_cut, the
bonded pairs excluded; smooth PME on the configuration's mesh (order-p
cardinal B-splines, Euler-spline influence function); the Ewald
self-energy and the reciprocal-space correction of the bonded pairs;
harmonic bonds; the single cavity mode coupled to the xy dipole.

Pair terms are summed over a half pair list (i < j) built with its own
cell grid and a skin, rebuilt when an atom has moved half the skin. Their
forces are analytic; every other term's force is minus the autograd
gradient of its energy.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

ENERGY_KEYS = ("harmonic", "lj", "ewald_short", "ewald_long",
               "cavity_harmonic", "cavity_coupling", "cavity_dipole_self")


def minimum_image(d, box):
    return d - box * torch.round(d / box)


def ewald_kappa(r_cut: float, accuracy: float) -> float:
    """kappa with erfc(kappa r_cut) = accuracy (bisection in float64)."""
    lo, hi = 0.0, 50.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if math.erfc(mid) > accuracy:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi) / r_cut


def cardinal_bspline_nodes(p: int) -> np.ndarray:
    """M_p(k) at k = 0..p."""
    x = np.arange(p + 1, dtype=np.float64)

    def m(n, t):
        if n == 1:
            return ((t >= 0) & (t < 1)).astype(np.float64)
        return (t * m(n - 1, t) + (n - t) * m(n - 1, t - 1)) / (n - 1)

    return m(p, x)


def spme_influence(box, mesh, p: int, kappa: float) -> np.ndarray:
    """exp(-pi^2 m^2 / kappa^2) / m^2 / prod_d |b_d(m_d)|^-2 on the full
    mesh, m = 0 and the zeros of the Euler-spline sum left out."""
    nodes = cardinal_bspline_nodes(p)
    axes = []
    for d in range(3):
        K = mesh[d]
        m = np.arange(K)
        ks = np.arange(p - 1)
        s = np.exp(2j * np.pi * np.outer(m, ks) / K) @ nodes[1:p]
        axes.append(np.abs(s) ** 2)
    dsq = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    ms = []
    for d in range(3):
        K = mesh[d]
        m = np.arange(K)
        ms.append(np.where(m <= K // 2, m, m - K) / box[d])
    m2 = (ms[0][:, None, None] ** 2 + ms[1][None, :, None] ** 2
          + ms[2][None, None, :] ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.exp(-np.pi ** 2 * m2 / kappa ** 2) / m2 / dsq
    c[0, 0, 0] = 0.0
    c[dsq < 1e-12] = 0.0
    return c


def spline_weights(frac, p: int):
    """w_j = M_p(frac + j), j = 0..p-1, for frac (...,) in [0, 1)."""
    x = frac[..., None] + torch.arange(p, dtype=frac.dtype,
                                       device=frac.device)
    w = torch.cat([torch.ones_like(frac)[..., None],
                   torch.zeros_like(x[..., 1:])], dim=-1)
    for n in range(2, p + 1):
        prev = torch.cat([torch.zeros_like(w[..., :1]), w[..., :-1]], dim=-1)
        w = (x * w + (n - x) * prev) / (n - 1)
    return w


class Topology:
    """The scene's static data as the reference holds it (float64 host
    arrays turned into tensors on ``device`` in ``dtype``, the state's
    precision). ``work`` is the precision of the force arithmetic after
    each displacement or grid coordinate is formed (default ``dtype``;
    the control lowers it)."""

    def __init__(self, cfg: dict, scene: dict, dtype, device, work=None):
        phys, units = cfg["physics"], cfg["units"]
        self.dtype, self.device = dtype, device
        self.work = dtype if work is None else work
        self.box = torch.as_tensor(scene["box"], dtype=dtype, device=device)
        self.box64 = np.asarray(scene["box"], np.float64)
        types = list(scene["types"])
        typeid = np.asarray(scene["typeid"])
        self.N = len(typeid)
        self.types = types
        self.photon = int(np.flatnonzero(typeid == types.index("L"))[0])
        self.mass = torch.as_tensor(scene["mass"], dtype=dtype, device=device)
        charge = np.asarray(scene["charge"], np.float64)
        self.charge = torch.as_tensor(charge, dtype=dtype, device=device)
        self.typeid = torch.as_tensor(typeid, dtype=torch.long, device=device)
        self.mol = torch.as_tensor(typeid != types.index("L"), device=device)
        self.r_cut = float(phys["r_cut"])
        self.kappa = ewald_kappa(self.r_cut, float(phys["ewald_accuracy"]))
        T = len(types)
        eps = np.zeros((T, T))
        sig = np.ones((T, T))
        for key, v in phys["lj"].items():
            a, b = (types.index(t) for t in key.split("-"))
            eps[a, b] = eps[b, a] = v["epsilon"]
            sig[a, b] = sig[b, a] = v["sigma"]
        sr6 = (sig / self.r_cut) ** 6
        self.lj_eps = eps
        self.lj_sig2 = sig * sig
        self.lj_shift = 4.0 * eps * (sr6 * sr6 - sr6)
        bonds = np.asarray(scene["bond_group"], np.int64).reshape(-1, 2)
        btype = [scene["bond_types"][t] for t in scene["bond_typeid"]]
        self.bond_i = torch.as_tensor(bonds[:, 0], device=device)
        self.bond_j = torch.as_tensor(bonds[:, 1], device=device)
        w = self.work
        self.bond_k = torch.as_tensor([phys["bonds"][t]["k"] for t in btype],
                                      dtype=w, device=device)
        self.bond_r0 = torch.as_tensor(
            [phys["bonds"][t]["r0"] for t in btype], dtype=w, device=device)
        self.bond_qq = (self.charge[self.bond_i]
                        * self.charge[self.bond_j]).to(w)
        lo, hi = np.minimum(bonds[:, 0], bonds[:, 1]), np.maximum(
            bonds[:, 0], bonds[:, 1])
        self.excluded = torch.as_tensor(np.unique(lo * self.N + hi),
                                        device=device)
        self.mesh = tuple(int(k) for k in phys["pppm_mesh"])
        self.order = int(phys["pppm_order"])
        self.influence = torch.as_tensor(
            spme_influence(self.box64, self.mesh, self.order, self.kappa),
            dtype=torch.float64 if self.work == torch.float64
            else torch.float32, device=device)
        self.volume = float(np.prod(self.box64))
        self.e_self = self.kappa / math.sqrt(math.pi) * float(
            np.sum(charge * charge))
        omega = float(phys["freq_cm1"]) / float(units["cm1_per_hartree"])
        self.cav_K = float(scene["mass"][self.photon]) * omega * omega
        self.cav_g = float(phys["coupling"])


class PairList:
    """A half pair list (i < j, bonded pairs left out) of every pair
    within ``r_cut + skin`` of one replica's positions, with the
    positions it was built from."""

    def __init__(self, top: Topology, pos, skin: float):
        self.skin = skin
        self.anchor = pos.detach().clone()
        box = top.box64
        reach = top.r_cut + skin
        nc = [int(box[d] // reach) for d in range(3)]
        if min(nc) < 3:
            raise ValueError(f"box {box} too small for a 3-cell pair grid")
        dev = pos.device
        ncv = torch.as_tensor(nc, device=dev)
        width = top.box / ncv.to(top.dtype)
        c = torch.floor((pos + 0.5 * top.box) / width).long()
        c = torch.remainder(c, ncv)
        cid = (c[:, 0] * nc[1] + c[:, 1]) * nc[2] + c[:, 2]
        C = nc[0] * nc[1] * nc[2]
        order = torch.argsort(cid, stable=True)
        counts = torch.bincount(cid, minlength=C)
        cap = int(counts.max())
        start = torch.cumsum(counts, 0) - counts
        sorted_c = cid[order]
        slot = torch.arange(len(cid), device=dev) - start[sorted_c]
        table = torch.full((C, cap), -1, dtype=torch.long, device=dev)
        table[sorted_c, slot] = order
        cells = torch.arange(C, device=dev)
        cz = cells % nc[2]
        cy = (cells // nc[2]) % nc[1]
        cx = cells // (nc[1] * nc[2])
        ii, jj = [], []
        reach2 = reach * reach
        for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
            nb = (((cx + ox) % nc[0]) * nc[1] + (cy + oy) % nc[1]) * nc[2] \
                + (cz + oz) % nc[2]
            a = table[:, :, None].expand(C, cap, cap)
            b = table[nb][:, None, :].expand(C, cap, cap)
            keep = (a >= 0) & (b >= 0) & (a < b)
            a, b = a[keep], b[keep]
            d = minimum_image(pos[a] - pos[b], top.box)
            near = (d * d).sum(-1) < reach2
            ii.append(a[near])
            jj.append(b[near])
        i = torch.cat(ii)
        j = torch.cat(jj)
        bonded = torch.isin(i * top.N + j, top.excluded)
        i, j = i[~bonded], j[~bonded]
        self.i, self.j = i, j
        ti, tj = top.typeid[i], top.typeid[j]
        as_t = lambda x: torch.as_tensor(x, dtype=top.work, device=dev)
        self.eps = as_t(top.lj_eps)[ti, tj]
        self.sig2 = as_t(top.lj_sig2)[ti, tj]
        self.shift = as_t(top.lj_shift)[ti, tj]
        self.qq = (top.charge[i] * top.charge[j]).to(top.work)

    def stale(self, pos, top: Topology) -> bool:
        d = minimum_image(pos - self.anchor, top.box)
        return bool((d * d).sum(-1).max() > (0.5 * self.skin) ** 2)


def pair_terms(top: Topology, plist: PairList, pos):
    """Forces (N, 3), LJ and real-space Ewald energies of one replica."""
    d = minimum_image(pos[plist.i] - pos[plist.j], top.box)
    inside = (d * d).sum(-1) < top.r_cut * top.r_cut
    d = d[inside].to(top.work)
    r2 = (d * d).sum(-1)
    eps, sig2, shift, qq = (x[inside] for x in (
        plist.eps, plist.sig2, plist.shift, plist.qq))
    s6 = (sig2 / r2) ** 3
    e_lj = torch.sum(torch.where(eps != 0, 4.0 * eps * (s6 * s6 - s6)
                                 - shift, 0.0))
    f_lj = 24.0 * eps * (2.0 * s6 * s6 - s6) / r2
    r = torch.sqrt(r2)
    kr = top.kappa * r
    erfc = torch.special.erfc(kr)
    e_ew = torch.sum(qq * erfc / r)
    f_ew = qq * (erfc / r + (2.0 / math.sqrt(math.pi)) * top.kappa
                 * torch.exp(-kr * kr)) / r2
    fd = (f_lj + f_ew)[:, None] * d
    i, j = plist.i[inside], plist.j[inside]
    forces = torch.zeros(pos.shape, dtype=top.work, device=pos.device)
    forces.index_add_(0, i, fd)
    forces.index_add_(0, j, -fd)
    return forces.to(pos.dtype), e_lj.to(pos.dtype), e_ew.to(pos.dtype)


def spme_energy(top: Topology, pos):
    """Reciprocal-space energy of one replica (differentiable)."""
    K = torch.as_tensor(top.mesh, dtype=pos.dtype, device=pos.device)
    u = (pos / top.box + 0.5) * K
    k0 = torch.floor(u).detach()
    w = spline_weights((u - k0).to(top.work), top.order)  # (N, 3, p)
    p = top.order
    j = torch.arange(p, device=pos.device)
    Kl = torch.as_tensor(top.mesh, device=pos.device)
    idx = torch.remainder(k0.long()[..., None] - j, Kl[:, None])
    wq = (top.charge.to(top.work)[:, None, None, None]
          * w[:, 0, :, None, None]
          * w[:, 1, None, :, None] * w[:, 2, None, None, :])
    flat = ((idx[:, 0, :, None, None] * top.mesh[1]
             + idx[:, 1, None, :, None]) * top.mesh[2]
            + idx[:, 2, None, None, :])
    grid = torch.zeros(int(np.prod(top.mesh)), dtype=top.work,
                       device=pos.device)
    grid = grid.index_add(0, flat.reshape(-1), wq.reshape(-1))
    spec = torch.fft.fftn(grid.reshape(top.mesh).to(top.influence.dtype))
    power = spec.real ** 2 + spec.imag ** 2
    return (torch.sum(top.influence * power)
            / (2.0 * math.pi * top.volume)).to(pos.dtype)


def smooth_terms(top: Topology, pos, img):
    """Energies of the bonds, the reciprocal Ewald sum with its bonded
    correction, and the cavity mode, of one replica (differentiable)."""
    d = minimum_image(pos[top.bond_i] - pos[top.bond_j], top.box)
    r = torch.sqrt((d.to(top.work) ** 2).sum(-1))
    e_bond = torch.sum(0.5 * top.bond_k * (r - top.bond_r0) ** 2).to(pos.dtype)
    e_corr = torch.sum(top.bond_qq * torch.special.erf(top.kappa * r)
                       / r).to(pos.dtype)
    e_rec = spme_energy(top, pos)
    unw = pos + img.to(pos.dtype) * top.box
    qm = torch.where(top.mol, top.charge, 0.0)
    dip = (qm[:, None] * unw).sum(0)
    q = unw[top.photon]
    xy = torch.tensor([1.0, 1.0, 0.0], dtype=pos.dtype, device=pos.device)
    K, g = top.cav_K, top.cav_g
    return {
        "harmonic": e_bond,
        "ewald_long": e_rec - top.e_self - e_corr,
        "cavity_harmonic": 0.5 * K * (q * q).sum(),
        "cavity_coupling": g * (dip * xy * q * xy).sum(),
        "cavity_dipole_self": 0.5 * g * g / K * (dip * xy * dip * xy).sum(),
    }


class Forces:
    """Forces and energies of replica batches (R, N, 3), each replica with
    its own pair list."""

    def __init__(self, top: Topology, skin: float = 1.0):
        self.top = top
        self.skin = skin
        self.lists = {}

    def __call__(self, pos, img, keys=None):
        """(forces (R, N, 3), {energy key: (R,)}) for replicas ``keys``
        (one pair list kept per key; default 0..R-1)."""
        top = self.top
        keys = range(pos.shape[0]) if keys is None else keys
        out_f, out_e = [], {k: [] for k in ENERGY_KEYS}
        for r, key in enumerate(keys):
            p = pos[r]
            pl = self.lists.get(key)
            if pl is None or pl.stale(p, top):
                pl = self.lists[key] = PairList(top, p, self.skin)
            f_pair, e_lj, e_ew = pair_terms(top, pl, p)
            with torch.enable_grad():
                x = p.detach().requires_grad_(True)
                e = smooth_terms(top, x, img[r])
                (g,) = torch.autograd.grad(sum(e.values()), x)
            out_f.append(f_pair - g)
            e = {k: v.detach() for k, v in e.items()}
            e["lj"], e["ewald_short"] = e_lj, e_ew
            for k in ENERGY_KEYS:
                out_e[k].append(e[k])
        return (torch.stack(out_f),
                {k: torch.stack(v) for k, v in out_e.items()})
