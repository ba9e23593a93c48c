# Frozen copy of stardis_tpu_torch/util/species.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Element-symbol and species-string utilities.

Replaces the TARDIS helpers consumed by the reference
(`tardis.util.base.species_string_to_tuple`,
`element_symbol2atomic_number`, `atomic_number2element_symbol` — see
reference stardis/radiation_field/opacities/opacities_solvers/util.py:6 and
stardis/io/model/util.py:5).
"""

from __future__ import annotations

ELEMENT_SYMBOLS = [
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]

SYMBOL_TO_Z = {sym: i + 1 for i, sym in enumerate(ELEMENT_SYMBOLS)}
SYMBOL_TO_Z.update({sym.lower(): i + 1 for i, sym in enumerate(ELEMENT_SYMBOLS)})

# Standard atomic weights (IUPAC 2021 abridged), in amu; index = Z.
# Used by the built-in atomic dataset; carsus HDF files carry their own masses.
ATOMIC_WEIGHTS_AMU = {
    1: 1.008, 2: 4.002602, 3: 6.94, 4: 9.0121831, 5: 10.81,
    6: 12.011, 7: 14.007, 8: 15.999, 9: 18.998403163, 10: 20.1797,
    11: 22.98976928, 12: 24.305, 13: 26.9815384, 14: 28.085,
    15: 30.973761998, 16: 32.06, 17: 35.45, 18: 39.95, 19: 39.0983,
    20: 40.078, 21: 44.955907, 22: 47.867, 23: 50.9415, 24: 51.9961,
    25: 54.938043, 26: 55.845, 27: 58.933194, 28: 58.6934,
    29: 63.546, 30: 65.38, 31: 69.723, 32: 72.63, 33: 74.921595,
    34: 78.971, 35: 79.904, 36: 83.798, 37: 85.4678, 38: 87.62,
    39: 88.905838, 40: 91.224, 41: 92.90637, 42: 95.95, 43: 97.0,
    44: 101.07, 45: 102.90549, 46: 106.42, 47: 107.8682, 48: 112.414,
    49: 114.818, 50: 118.71, 51: 121.76, 52: 127.6, 53: 126.90447,
    54: 131.293, 55: 132.90545196, 56: 137.327, 57: 138.90547,
    58: 140.116, 59: 140.90766, 60: 144.242, 61: 145.0, 62: 150.36,
    63: 151.964, 64: 157.25, 65: 158.925354, 66: 162.5,
    67: 164.930329, 68: 167.259, 69: 168.934219, 70: 173.045,
    71: 174.9668, 72: 178.486, 73: 180.94788, 74: 183.84,
    75: 186.207, 76: 190.23, 77: 192.217, 78: 195.084,
    79: 196.96657, 80: 200.592, 81: 204.38, 82: 207.2,
    83: 208.9804, 84: 209.0, 85: 210.0, 86: 222.0, 87: 223.0,
    88: 226.0, 89: 227.0, 90: 232.0377, 91: 231.03588,
    92: 238.02891,
}

_ROMAN = {
    "I": 1, "II": 2, "III": 3, "IV": 4, "V": 5, "VI": 6, "VII": 7,
    "VIII": 8, "IX": 9, "X": 10, "XI": 11, "XII": 12, "XIII": 13,
    "XIV": 14, "XV": 15, "XVI": 16, "XVII": 17, "XVIII": 18,
    "XIX": 19, "XX": 20,
}


def element_symbol2atomic_number(symbol: str) -> int:
    sym = symbol.strip()
    if sym in SYMBOL_TO_Z:
        return SYMBOL_TO_Z[sym]
    sym = sym.capitalize()
    if sym in SYMBOL_TO_Z:
        return SYMBOL_TO_Z[sym]
    raise ValueError(f"Unknown element symbol: {symbol!r}")


def atomic_number2element_symbol(z: int) -> str:
    return ELEMENT_SYMBOLS[int(z) - 1]


def roman_to_int(roman: str) -> int:
    r = roman.strip().upper()
    if r not in _ROMAN:
        raise ValueError(f"Cannot parse roman numeral {roman!r}")
    return _ROMAN[r]


def species_string_to_tuple(species_string: str):
    """'Si II' or 'Si_II' or 'si 2' -> (14, 1): (atomic number, ion charge).

    Ion charge follows the astronomy convention offset: the roman numeral N
    means charge N-1 (neutral = I). Mirrors TARDIS's helper of the same name.
    """
    text = species_string.replace("_", " ").strip()
    parts = text.split()
    if len(parts) != 2:
        raise ValueError(f"Cannot parse species string {species_string!r}")
    sym, ion_str = parts
    z = element_symbol2atomic_number(sym)
    try:
        ion = roman_to_int(ion_str)
    except ValueError:
        ion = int(ion_str)
    ion_charge = ion - 1
    if ion_charge > z:
        raise ValueError(f"Ion charge {ion_charge} > atomic number {z}")
    return z, ion_charge


