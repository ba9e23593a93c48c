# Frozen copy of stardis_tpu_torch/io/synthetic.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Synthetic MARCS- and MESA-format atmosphere generators (a copy of
``stardis_tpu/io/synthetic.py``).

The reference ships real MARCS files (docs/quickstart/sun.mod); they are
not redistributed here, so tests and benchmarks build
sun-like atmospheres from first principles instead:

* gray Eddington temperature stratification  T^4 = (3/4) Teff^4 (tau + 2/3),
* hydrostatic equilibrium  dP/dtau = g / kappa(rho, T)  with an H-
  Rosseland-mean opacity fit, integrated on a log-tau grid,
* ideal-gas density, Asplund-2009 abundances.

The output is written in the MARCS plane-parallel ``.mod`` layout so it also
exercises the production reader end-to-end.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from ..constants import AMU_CGS, K_B_CGS
from .abundances import ASPLUND_2009


def gray_atmosphere_structure(
    teff=5777.0,
    logg=4.44,
    n_depth=56,
    log_tau_min=-5.0,
    log_tau_max=2.0,
    mu_mol=1.26,
):
    """Return dict of arrays (tau, T, Pg, Pe, rho, depth) surface->interior."""
    grav = 10.0**logg
    tau = np.logspace(log_tau_min, log_tau_max, n_depth)
    temp = (0.75 * teff**4 * (tau + 2.0 / 3.0)) ** 0.25

    def kappa_ross(t):
        # H--dominated Rosseland mean: steep T dependence, calibrated so
        # kappa(T_phot of the Sun) = 0.3 cm^2/g, capped where H bf takes over.
        return np.clip(0.3 * (t / 6420.0) ** 9, 1e-3, 3.0)

    kap = kappa_ross(temp)
    pressure = np.zeros_like(tau)
    pressure[0] = grav * tau[0] / kap[0]
    for i in range(1, n_depth):
        dtau = tau[i] - tau[i - 1]
        k_mid = 0.5 * (kap[i] + kap[i - 1])
        pressure[i] = pressure[i - 1] + grav / k_mid * dtau
    rho = pressure * mu_mol * AMU_CGS / (K_B_CGS * temp)

    # geometric depth (0 at tau=1, increasing inward)
    dz = np.zeros_like(tau)
    dz[1:] = np.diff(tau) / (0.5 * (kap[1:] * rho[1:] + kap[:-1] * rho[:-1]))
    z = np.cumsum(dz)
    i_phot = np.searchsorted(tau, 1.0)
    depth = z - z[i_phot]

    pe = 1e-4 * pressure * (temp / teff) ** 5  # rough electron pressure
    return {
        "tau": tau,
        "temperature": temp,
        "pressure": pressure,
        "pe": pe,
        "rho": rho,
        "depth": depth,
    }


def write_marcs_file(
    path,
    teff=5777.0,
    logg=4.44,
    n_depth=56,
    microturbulence=1.0,
    feh=0.0,
    afe=0.0,
    abundances=None,
    spherical=False,
    radius_cm=6.957e10,
    mass_msun=1.0,
):
    """Write a synthetic MARCS ``.mod`` file (plane-parallel or spherical)."""
    s = gray_atmosphere_structure(teff=teff, logg=logg, n_depth=n_depth)
    grav = 10.0**logg
    flux = 5.6704e-5 * teff**4  # sigma_sb cgs

    if abundances is None:
        abundances = [ASPLUND_2009.get(z, -99.0) for z in range(1, 93)]

    lines = []
    tag = "sph" if spherical else "pp"
    lines.append(f"sun_synthetic_{tag}_t{int(teff)}_g{logg:+.1f}")
    lines.append(f"  {teff:.0f}.      Teff [K].         Last iteration; yyyymmdd=20260101")
    lines.append(f"  {flux:.4E} Flux [erg/cm2/s]")
    lines.append(f"  {grav:.4E} Surface gravity [cm/s2]")
    lines.append(f"  {microturbulence:.1f}        Microturbulence parameter [km/s]")
    if spherical:
        lines.append(f"  {mass_msun:.4f}     Mass [solar masses]")
    else:
        lines.append("  0.0        No mass for plane-parallel models")
    lines.append(
        f" {feh:+.2f} {afe:+.2f} Metallicity [Fe/H] and [alpha/Fe]"
    )
    if spherical:
        lines.append(f"  {radius_cm:.4E} Radius [cm] at Tau(Rosseland)=1.0")
        lines.append("  1.0000E+00 Luminosity [Lsun]")
    else:
        lines.append("  1.0000E+00 1 cm radius for plane-parallel models")
        lines.append("  3.8899E-23 Luminosity [Lsun] FOR A RADIUS OF 1 cm!")
    lines.append(
        "  1.50 8.00 0.076 0.00 are the convection parameters: alpha, nu, y and beta"
    )
    lines.append(
        "  0.73826 0.24954 1.22E-02 are X, Y and Z, 12C/13C=89 (=solar)"
    )
    lines.append("Logarithmic chemical number abundances, H always 12.00")
    for i in range(0, 92, 10):
        row = abundances[i : i + 10]
        lines.append(" " + " ".join(f"{a:6.2f}" for a in row))
    lines.append(f"  {n_depth} Number of depth points")
    lines.append("Model structure")
    lines.append(
        " k lgTauR  lgTau5    Depth     T        Pe         Pg        Prad       Pturb"
    )
    lg_tau = np.log10(s["tau"])
    for k in range(n_depth):
        lines.append(
            f"{k + 1:3d} {lg_tau[k]:5.2f} {lg_tau[k]:7.4f} {s['depth'][k]: .3E}"
            f" {s['temperature'][k]:7.1f} {s['pe'][k]: .3E} {s['pressure'][k]: .3E}"
            f"  1.000E-01  0.000E+00"
        )
    lines.append(
        " k lgTauR  KappaRoss   Density   Mu      Vconv   Fconv/F      RHOX"
    )
    for k in range(n_depth):
        lines.append(
            f"{k + 1:3d} {lg_tau[k]:5.2f}  1.000E-02 {s['rho'][k]: .3E} 1.300"
            f"  0.000E+00 0.00000  1.000000E-02"
        )
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_opacity_tables(directory):
    """Write synthetic cross-section tables in the three ``opacity.file``
    formats into ``directory``; returns {opacity source: path}.

    Hminus_bf : Wishart-style two-column CSV, wavelength [AA], sigma [cm^2],
        a bell peaking near 8500 AA like the real H- bf curve;
    Hminus_ff : Bell & Berrington-style wavelength [AA] x theta table whose
        header tokens end in commas;
    H2plus_bf : Stancil-style wavelength [nm] x T table whose values carry
        implicit exponents ('5.00-1' for 5.00e-1).
    """
    directory = Path(directory)
    paths = {name: str(directory / f"{name}.dat")
             for name in ("Hminus_bf", "Hminus_ff", "H2plus_bf")}

    lam = np.linspace(2000.0, 15000.0, 50)
    sig = 4e-17 * np.exp(-(((lam - 8500.0) / 4000.0) ** 2))
    rows = ["# synthetic Wishart-format table"]
    rows += [f"{wl:.1f},{s:.4e}" for wl, s in zip(lam, sig)]
    Path(paths["Hminus_bf"]).write_text("\n".join(rows) + "\n")

    thetas = np.array([0.5, 1.0, 1.5, 2.0, 2.5])
    rows = ["# synthetic B&B-format table",
            "wave, " + ", ".join(f"{t:.1f}" for t in thetas)]
    for wl in np.linspace(3000.0, 12000.0, 20):
        vals = 1e-2 * (wl / 5000.0) ** 2 * thetas**1.5
        rows.append(f"{wl:.1f} " + " ".join(f"{v:.4e}" for v in vals))
    Path(paths["Hminus_ff"]).write_text("\n".join(rows) + "\n")

    def implicit_exponent(v):
        e = math.ceil(-math.log10(v))
        return f"{v * 10.0**e:.2f}-{e}"

    temps = np.array([3000, 5000, 8000, 12000])
    rows = ["# synthetic Stancil-format table", "nm " + " ".join(str(t) for t in temps)]
    for wl in np.linspace(300.0, 1200.0, 15):
        vals = 0.05 * (wl / 600.0) * np.sqrt(temps / 5000.0)
        rows.append(f"{wl:.0f} " + " ".join(implicit_exponent(v) for v in vals))
    Path(paths["H2plus_bf"]).write_text("\n".join(rows) + "\n")
    return paths
