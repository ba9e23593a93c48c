# Frozen copy of stardis_tpu_torch/atom_data/builtin.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Built-in, analytically generated atomic dataset.

The reference framework downloads ``kurucz_cd23_chianti_H_He.h5`` from the
TARDIS regression-data service (reference conftest.py:60-62).  So that no
download is needed, the framework ships a generator that
builds a physically-correct hydrogen (+ helium + light-metal Saha) dataset
from first principles:

* H energy levels E_n = chi_H (1 - 1/n^2), g = 2 n^2, n <= n_max.
* H bound-bound oscillator strengths from the Kramers formula with the
  Johnson (1972, ApJ 174, 227) Gaunt factors — accurate to <1% for low
  series members (f(1->2)=0.4162, f(2->3)=0.6407).
* He I / He II level scaffolding (low-lying terms; He II hydrogenic).
* NIST ionization energies for stages I-III of Z <= 30.
* NIST ASD low-lying level/term tables for the dominant electron donors
  (Na, Mg, Al, Si, K, Ca, Ti, Cr, Mn, Fe, Ni — neutral and first ion;
  atom_data/nist_levels.py); other metals fall back to ground-term-only
  partition functions.
* a transcribed list of well-known strong solar optical lines
  (atom_data/solar_lines.py) attached as a VALD-style linelist.

Documented divergence: the level/line tables are NIST/VALD transcriptions
of the strongest contributors, not the full kurucz_cd23_chianti dataset.

This is the NumPy port of ``stardis_tpu/atom_data/builtin.py``: the same
tables in the same row order, including the molecular tables built from
Huber & Herzberg spectroscopic constants (``build_molecule_data_hh``).
"""

from __future__ import annotations

import numpy as np

from .base import AtomData, MoleculeData, Table, einstein_a_from_f_lu
from ..constants import AMU_CGS, C_CGS, EV_TO_ERG, H_CGS, K_B_CGS
from ..util.species import ATOMIC_WEIGHTS_AMU, ELEMENT_SYMBOLS, SYMBOL_TO_Z

CHI_H_EV = 13.598434005136  # NIST H I ionization energy [eV]

# NIST ionization energies [eV] for stages I, II, III (Z: [chi_I, chi_II, chi_III])
NIST_IONIZATION_EV = {
    1: [13.598434],
    2: [24.587387, 54.417760],
    3: [5.391715, 75.640097, 122.454358],
    4: [9.322699, 18.211153, 153.896203],
    5: [8.298019, 25.15483, 37.93058],
    6: [11.260288, 24.383143, 47.88778],
    7: [14.53413, 29.60125, 47.4453],
    8: [13.618055, 35.12112, 54.93554],
    9: [17.42282, 34.97081, 62.70798],
    10: [21.564540, 40.96297, 63.4233],
    11: [5.139077, 47.28636, 71.6200],
    12: [7.646236, 15.035271, 80.1436],
    13: [5.985769, 18.82855, 28.447642],
    14: [8.151683, 16.345845, 33.493],
    15: [10.486686, 19.76949, 30.20264],
    16: [10.36001, 23.33788, 34.86],
    17: [12.967632, 23.81364, 39.80],
    18: [15.759611, 27.62967, 40.735],
    19: [4.340663, 31.62500, 45.8031],
    20: [6.113155, 11.871719, 50.91316],
    21: [6.56149, 12.79977, 24.756839],
    22: [6.828120, 13.5755, 27.49171],
    23: [6.746187, 14.634, 29.3111],
    24: [6.766510, 16.486305, 30.959],
    25: [7.434038, 15.639999, 33.668],
    26: [7.902468, 16.19920, 30.651],
    27: [7.88101, 17.0844, 33.50],
    28: [7.639877, 18.168837, 35.187],
    29: [7.726380, 20.29239, 36.841],
    30: [9.394197, 17.96439, 39.7233],
}

# Ground-term statistical weights for ion charge states 0, 1, 2.
GROUND_G = {
    1: [2, 1],
    2: [1, 2, 1],
    3: [2, 1, 2],
    4: [1, 2, 1],
    5: [6, 1, 2],
    6: [9, 6, 1],
    7: [4, 9, 6],
    8: [9, 4, 9],
    9: [6, 9, 4],
    10: [1, 6, 9],
    11: [2, 1, 6],
    12: [1, 2, 1],
    13: [6, 1, 2],
    14: [9, 6, 1],
    15: [4, 9, 6],
    16: [9, 4, 9],
    17: [6, 9, 4],
    18: [1, 6, 9],
    19: [2, 1, 6],
    20: [1, 2, 1],
    21: [10, 15, 10],
    22: [21, 28, 21],
    23: [28, 25, 28],
    24: [7, 6, 25],
    25: [6, 7, 6],
    26: [25, 30, 25],
    27: [28, 21, 28],
    28: [21, 10, 21],
    29: [2, 1, 10],
    30: [1, 2, 1],
}


def johnson_gaunt_bb(n: int, x):
    """Johnson (1972) bound-bound Gaunt factor g(n, x), x = 1 - (n/n')^2."""
    if n == 1:
        g0, g1, g2 = 1.1330, -0.4059, 0.07014
    elif n == 2:
        g0, g1, g2 = 1.0785, -0.2319, 0.02947
    else:
        g0 = 0.9935 + 0.2328 / n - 0.1296 / n**2
        g1 = -(0.6282 - 0.5598 / n + 0.5299 / n**2) / n
        g2 = (0.3887 - 1.181 / n + 1.470 / n**2) / n**2
    return g0 + g1 / x + g2 / x**2


def hydrogen_f_lu(n_lower: int, n_upper: int) -> float:
    """Absorption oscillator strength for H n -> n' (Johnson 1972 eq. 5)."""
    n, npr = n_lower, n_upper
    x = 1.0 - (n / npr) ** 2
    return (
        32.0
        / (3.0 * np.sqrt(3.0) * np.pi)
        * (n / npr**3)
        / x**3
        * johnson_gaunt_bb(n, x)
    )


def _hydrogenic_levels(z_nuc: int, chi_ev: float, n_max: int):
    """(energy_erg, g) arrays for a hydrogenic ion with ionization chi."""
    n = np.arange(1, n_max + 1)
    energy = chi_ev * (1.0 - 1.0 / n**2) * EV_TO_ERG
    g = 2 * n**2
    return energy, g


# Low-lying He I levels: (energy eV, g). NIST ASD values.
HE_I_LEVELS_EV = [
    (0.0, 1),  # 1s2 1S0
    (19.819614, 3),  # 2s 3S1
    (20.615774, 1),  # 2s 1S0
    (20.964087, 9),  # 2p 3P
    (21.218023, 3),  # 2p 1P1
    (22.718466, 3),  # 3s 3S1
    (22.920317, 1),  # 3s 1S0
    (23.007073, 9),  # 3p 3P
    (23.073650, 15),  # 3d 3D
    (23.074365, 5),  # 3d 1D2
    (23.087019, 3),  # 3p 1P1
    # n = 4 shell (NIST; singly-excited He is He+ core + hydrogenic
    # electron, E_n ~ 24.587 - 13.598/n^2, which pins these to < 1 meV)
    (23.593921, 3),   # 4s 3S1
    (23.673570, 1),   # 4s 1S0
    (23.707890, 9),   # 4p 3P
    (23.736090, 15),  # 4d 3D
    (23.736490, 5),   # 4d 1D2
    (23.737000, 28),  # 4f 3F* + 1F* (term avg)
    (23.742070, 3),   # 4p 1P1
    # n = 5 / n = 6 hydrogenic shell clusters (g = 4 n^2)
    (24.043, 100),
    (24.209, 144),
]


def build_builtin_atom_data(
    max_atomic_number: int = 30,
    h_n_max: int = 20,
    he_ii_n_max: int = 8,
    include_linelists: bool = False,
    include_molecules: bool = False,
) -> AtomData:
    """Generate the built-in atomic dataset.

    Parameters
    ----------
    max_atomic_number : include elements up to this Z (<=30).
    h_n_max : highest hydrogen principal quantum number.
    he_ii_n_max : highest He II principal quantum number.
    include_linelists : also attach a VALD-style ``linelist_atoms`` built
        from the hydrogen lines plus the transcribed solar metal lines.
    include_molecules : also attach the molecular tables
        (``build_molecule_data_hh``).
    """
    zs = [z for z in range(1, max_atomic_number + 1) if z in NIST_IONIZATION_EV]

    atom_data = Table(
        {
            "atomic_number": np.asarray(zs, dtype=np.int64),
            "symbol": np.asarray([ELEMENT_SYMBOLS[z - 1] for z in zs]),
            "mass": np.asarray([ATOMIC_WEIGHTS_AMU[z] * AMU_CGS for z in zs]),
        }
    )

    ion_z, ion_n, ion_val = [], [], []
    for z in zs:
        for stage, chi in enumerate(NIST_IONIZATION_EV[z], start=1):
            ion_z.append(z)
            ion_n.append(stage)
            ion_val.append(chi * EV_TO_ERG)
    ionization_data = Table(
        {
            "atomic_number": np.asarray(ion_z, dtype=np.int64),
            "ion_number": np.asarray(ion_n, dtype=np.int64),
            "ionization_energy": np.asarray(ion_val, dtype=float),
        }
    )

    # ---- levels -------------------------------------------------------
    lev_idx, lev_e, lev_g, lev_meta = [], [], [], []

    def add_level(z, ion, num, e_erg, g, metastable=False):
        lev_idx.append((z, ion, num))
        lev_e.append(e_erg)
        lev_g.append(g)
        lev_meta.append(metastable)

    # H I: full hydrogenic ladder; H II: bare proton
    e_h, g_h = _hydrogenic_levels(1, CHI_H_EV, h_n_max)
    for i, (e, gg) in enumerate(zip(e_h, g_h)):
        add_level(1, 0, i, e, int(gg), metastable=(i == 0))
    add_level(1, 1, 0, 0.0, 1, metastable=True)

    if 2 in NIST_IONIZATION_EV and max_atomic_number >= 2:
        for i, (e_ev, gg) in enumerate(HE_I_LEVELS_EV):
            add_level(2, 0, i, e_ev * EV_TO_ERG, gg, metastable=(i == 0))
        e_he2, g_he2 = _hydrogenic_levels(2, 54.417760, he_ii_n_max)
        for i, (e, gg) in enumerate(zip(e_he2, g_he2)):
            add_level(2, 1, i, e, int(gg), metastable=(i == 0))
        add_level(2, 2, 0, 0.0, 1, metastable=True)

    from .nist_levels import NIST_METAL_LEVELS_EV

    for z in zs:
        if z <= 2:
            continue
        gs = GROUND_G.get(z, [1, 1, 1])
        n_stages = len(NIST_IONIZATION_EV[z])
        for ion in range(min(n_stages + 1, len(gs))):
            metal_levels = NIST_METAL_LEVELS_EV.get((z, ion))
            if metal_levels is not None:
                for i, (e_ev, gg) in enumerate(metal_levels):
                    add_level(
                        z, ion, i, e_ev * EV_TO_ERG, gg, metastable=(i == 0)
                    )
            else:
                add_level(z, ion, 0, 0.0, gs[ion], metastable=True)

    lev_idx = np.asarray(lev_idx, dtype=np.int64).reshape(-1, 3)
    levels = Table(
        {
            "atomic_number": lev_idx[:, 0],
            "ion_number": lev_idx[:, 1],
            "level_number": lev_idx[:, 2],
            "energy": np.asarray(lev_e, dtype=float),
            "g": np.asarray(lev_g, dtype=np.int64),
            "metastable": np.asarray(lev_meta, dtype=bool),
        }
    )

    # ---- hydrogen lines ----------------------------------------------
    cols = {k: [] for k in ("atomic_number", "ion_number", "level_number_lower",
                            "level_number_upper", "nu", "f_lu", "A_ul",
                            "wavelength_cm")}
    for nl in range(1, h_n_max):
        for nu_ in range(nl + 1, h_n_max + 1):
            e_l = CHI_H_EV * (1 - 1 / nl**2) * EV_TO_ERG
            e_u = CHI_H_EV * (1 - 1 / nu_**2) * EV_TO_ERG
            nu_hz = (e_u - e_l) / H_CGS
            f_lu = hydrogen_f_lu(nl, nu_)
            g_l, g_u = 2 * nl**2, 2 * nu_**2
            cols["atomic_number"].append(1)
            cols["ion_number"].append(0)
            cols["level_number_lower"].append(nl - 1)
            cols["level_number_upper"].append(nu_ - 1)
            cols["nu"].append(nu_hz)
            cols["f_lu"].append(f_lu)
            cols["A_ul"].append(einstein_a_from_f_lu(nu_hz, g_l, g_u, f_lu))
            cols["wavelength_cm"].append(C_CGS / nu_hz)
    lines = Table(cols)

    linelist_atoms = None
    if include_linelists:
        from .solar_lines import builtin_solar_linelist

        metal_lines = builtin_solar_linelist(max_atomic_number)
        g_lo = 2 * (lines.level_number_lower + 1) ** 2
        g_up = 2 * (lines.level_number_upper + 1) ** 2
        h_lines = {
            "atomic_number": lines.atomic_number,
            "ion_charge": lines.ion_number,
            "wavelength": lines.wavelength_cm * 1e8,  # AA
            "log_gf": np.log10(g_lo * lines.f_lu),
            "e_low": CHI_H_EV * (1 - 1 / (lines.level_number_lower + 1) ** 2),
            "e_up": CHI_H_EV * (1 - 1 / (lines.level_number_upper + 1) ** 2),
            "j_lo": (g_lo - 1) / 2.0,
            "j_up": (g_up - 1) / 2.0,
            "rad": np.log10(np.maximum(lines.A_ul, 1e-30)),
            "stark": np.zeros(len(lines)),
            "waals": np.zeros(len(lines)),
        }
        linelist_atoms = Table(
            {k: np.concatenate([v, metal_lines[k]]) for k, v in h_lines.items()}
        )

    return AtomData(
        atom_data, ionization_data, levels, lines, linelist_atoms=linelist_atoms,
        molecule_data=build_molecule_data_hh() if include_molecules else None,
    )


# Ground-electronic-state spectroscopic constants of the spectrally
# dominant diatomics, Huber & Herzberg (1979, "Constants of Diatomic
# Molecules"): omega_e / omega_e x_e / B_e in cm^-1; D0 in eV; sigma the
# homonuclear symmetry factor; g_el = (2S+1)*(2 - delta_{Lambda,0}) of the
# ground term.
DIATOMIC_CONSTANTS_HH = {
    # name: (ion1, ion2, omega_e, omega_e x_e, B_e, sigma, g_el, D0_eV)
    "H2": ("H", "H", 4401.21, 121.34, 60.853, 2, 1, 4.4781),  # X 1Sg+
    "CO": ("C", "O", 2169.81, 13.29, 1.9313, 1, 1, 11.092),   # X 1S+
    "CH": ("C", "H", 2858.5, 63.0, 14.457, 1, 4, 3.465),      # X 2Pi
    "OH": ("O", "H", 3737.76, 84.88, 18.91, 1, 4, 4.392),     # X 2Pi
    "MgH": ("Mg", "H", 1495.20, 31.89, 5.8257, 1, 2, 1.285),  # X 2S+
    "C2": ("C", "C", 1854.71, 13.34, 1.8198, 2, 1, 6.21),     # X 1Sg+
    "O2": ("O", "O", 1580.19, 11.98, 1.44563, 2, 3, 5.1156),  # X 3Sg-
    "N2": ("N", "N", 2358.57, 14.32, 1.99824, 2, 1, 9.759),   # X 1Sg+
    "CN": ("C", "N", 2068.59, 13.09, 1.8997, 1, 2, 7.76),     # X 2S+
    "SiO": ("Si", "O", 1241.54, 5.97, 0.7267, 1, 1, 8.26),    # X 1S+
    # H2+ = H + H+ in the same table convention
    "H2+": ("H", "H+", 2321.7, 66.2, 30.21, 2, 2, 2.6508),    # X 2Sg+
}

# Low-lying excited electronic states that contribute to the molecular
# partition function below ~10,000 K (Huber & Herzberg 1979):
# name -> list of (T_e, g_el, omega_e, omega_e x_e, B_e).
DIATOMIC_EXCITED_STATES_HH = {
    "C2": [(716.24, 6, 1641.35, 11.67, 1.6324)],   # a 3Pi_u
    "O2": [(7918.1, 2, 1483.5, 12.9, 1.4264),      # a 1Delta_g
           (13195.1, 1, 1432.77, 14.0, 1.40037)],  # b 1Sigma_g+
    "CN": [(9245.28, 4, 1812.56, 12.61, 1.7151)],  # A 2Pi_i
}

#: temperature grid of the generated molecular tables [K]
MOLECULE_TABLE_TEMPS = np.array(
    [1000.0, 1500.0, 2000.0, 3000.0, 4000.0, 5000.0, 6000.0, 8000.0,
     10000.0, 15000.0, 20000.0]
)


def diatomic_partition_function(temps, omega_e, omega_e_xe, b_e, sigma,
                                g_el, d0_ev):
    """Ground-state vib-rot partition function by direct level sums:
    U = g_el sum_v exp(-G(v)/kT) (1/sigma) sum_J (2J+1) exp(-F(J)/kT),
    G(v) Morse-like from v = 0, F(J) = B_e J(J+1) rigid rotor, both
    truncated at the dissociation limit."""
    temps = np.atleast_1d(np.asarray(temps, dtype=float))
    kt_cm = K_B_CGS * temps / (H_CGS * C_CGS)  # kT in cm^-1
    d0_cm = d0_ev * EV_TO_ERG / (H_CGS * C_CGS)

    v_top = int(np.floor(omega_e / (2.0 * omega_e_xe) - 0.5))
    v = np.arange(0, max(v_top, 1) + 1)
    g_v = omega_e * (v + 0.5) - omega_e_xe * (v + 0.5) ** 2
    g_v = g_v - g_v[0]
    keep = (g_v >= 0) & (g_v < d0_cm)
    g_v = g_v[keep]
    u_vib = np.exp(-g_v[None, :] / kt_cm[:, None]).sum(axis=1)

    j_top = int(np.floor(np.sqrt(max(d0_cm, b_e) / b_e)))
    j = np.arange(0, j_top + 1)
    f_j = b_e * j * (j + 1.0)
    f_j = f_j[f_j < d0_cm]
    u_rot = (
        (2.0 * j[: len(f_j)] + 1.0)[None, :]
        * np.exp(-f_j[None, :] / kt_cm[:, None])
    ).sum(axis=1) / sigma
    return g_el * u_vib * u_rot


def diatomic_partition_function_multistate(temps, name):
    """U summed over the ground state and DIATOMIC_EXCITED_STATES_HH[name]
    (each weighted by exp(-T_e/kT), its ladder truncated at D0 - T_e)."""
    temps = np.atleast_1d(np.asarray(temps, dtype=float))
    _i1, _i2, we, wexe, be, sigma, g_el, d0 = DIATOMIC_CONSTANTS_HH[name]
    u = diatomic_partition_function(temps, we, wexe, be, sigma, g_el, d0)
    cm_to_ev = H_CGS * C_CGS / EV_TO_ERG
    kt_cm = K_B_CGS * temps / (H_CGS * C_CGS)
    for te, g_e, we_e, wexe_e, be_e in DIATOMIC_EXCITED_STATES_HH.get(name, []):
        d0_rem = d0 - te * cm_to_ev
        if d0_rem <= 0:
            continue
        u = u + np.exp(-te / kt_cm) * diatomic_partition_function(
            temps, we_e, wexe_e, be_e, sigma, g_e, d0_rem
        )
    return u


def _atomic_u(symbol, temps):
    """Atomic/ionic partition function from the builtin NIST tables ('H+'
    style trailing charge marks an ion; a bare proton has U = 1)."""
    from .nist_levels import NIST_METAL_LEVELS_EV

    temps = np.atleast_1d(np.asarray(temps, dtype=float))
    charge = len(symbol) - len(symbol.rstrip("+"))
    symbol = symbol.rstrip("+")
    z = SYMBOL_TO_Z[symbol]
    if z == 1 and charge == 1:
        levels = [(0.0, 1)]  # bare proton
    elif z == 1:
        levels = [(0.0, 2)]  # excited H negligible below ~12,000 K
    elif z == 2 and charge == 0:
        levels = HE_I_LEVELS_EV
    else:
        levels = NIST_METAL_LEVELS_EV.get(
            (z, charge), [(0.0, GROUND_G.get(z, [1])[charge]
                           if charge < len(GROUND_G.get(z, [1])) else 1)]
        )
    e = np.array([lv[0] for lv in levels]) * EV_TO_ERG
    g = np.array([lv[1] for lv in levels], dtype=float)
    return (g[None, :] * np.exp(-e[None, :] / (K_B_CGS * temps[:, None]))
            ).sum(axis=1)


def build_molecule_data_hh(names=None, temps=None) -> MoleculeData:
    """Molecular tables in the Barklem & Collet 2016 layout (log10 K_p [Pa]
    and U_AB against T, constituents and D0) from the Huber & Herzberg
    constants:

    K_n = (2 pi mu k T / h^2)^{3/2} (U_A U_B / U_AB) exp(-D0/kT),
    K_p[Pa] = K_n k T / 10.
    """
    temps = MOLECULE_TABLE_TEMPS if temps is None else np.asarray(temps)
    names = list(DIATOMIC_CONSTANTS_HH) if names is None else list(names)

    log_kp, u_mol, ion1s, ion2s, d0s = [], [], [], [], []
    for name in names:
        ion1, ion2, we, wexe, be, sigma, g_el, d0 = DIATOMIC_CONSTANTS_HH[name]
        u_ab = diatomic_partition_function_multistate(temps, name)
        m1 = ATOMIC_WEIGHTS_AMU[SYMBOL_TO_Z[ion1.rstrip("+")]]
        m2 = ATOMIC_WEIGHTS_AMU[SYMBOL_TO_Z[ion2.rstrip("+")]]
        mu = m1 * m2 / (m1 + m2) * AMU_CGS
        lam = (2 * np.pi * mu * K_B_CGS * temps / H_CGS**2) ** 1.5
        u_a = _atomic_u(ion1, temps)
        u_b = _atomic_u(ion2, temps)
        k_n = lam * (u_a * u_b / u_ab) * np.exp(-d0 * EV_TO_ERG / (K_B_CGS * temps))
        k_p_pa = k_n * K_B_CGS * temps / 10.0  # dyn/cm^2 -> Pa
        log_kp.append(np.log10(k_p_pa))
        u_mol.append(u_ab)
        ion1s.append(ion1)
        ion2s.append(ion2)
        d0s.append(d0)

    temps = np.asarray(temps, dtype=float)
    return MoleculeData(
        names=names,
        equilibrium_temperatures=temps,
        log_equilibrium_constants=np.asarray(log_kp),
        partition_temperatures=temps,
        partition_functions=np.asarray(u_mol),
        ion1=ion1s,
        ion2=ion2s,
        dissociation_energies=np.asarray(d0s, dtype=float),
    )


