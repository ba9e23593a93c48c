# Frozen copy of stardis_tpu_torch/plasma/tables.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Host-side preparation of dense plasma tables (NumPy).

The port of ``stardis_tpu/plasma/tables.py``: dense padded arrays with
integer index maps, built once at ingest from the NumPy ``AtomData`` and
consumed by the torch solver (stardis_tpu_torch.plasma.lte).  Slot and level
order are those of the JAX package.

Index vocabulary
----------------
element index  e : 0..E-1   — position of atomic number zs[e]
ion slot       s : 0..S-1   — one (Z, ion_charge) pair, charge 0..n_stage(Z)
level          l : 0..L-1   — flat level list; level_slot[l] -> s
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PlasmaTables:
    """Static (trace-time) integer maps + physical tables, all NumPy."""

    # elements
    zs: np.ndarray  # [E] atomic numbers
    element_masses: np.ndarray  # [E] grams

    # ion slots
    slot_element: np.ndarray  # [S] element index e of each slot
    slot_ion: np.ndarray  # [S] ion charge of each slot
    slot_index: np.ndarray  # [E, J_max] slot id for (e, ion), -1 if absent
    n_ions: np.ndarray  # [E] number of charge states (incl. neutral)
    chi: np.ndarray  # [E, J_max-1] ionization energy [erg] for j -> j+1
    chi_mask: np.ndarray  # [E, J_max-1] True where the transition exists

    # levels (flat)
    level_energy: np.ndarray  # [L] erg
    level_g: np.ndarray  # [L]
    level_slot: np.ndarray  # [L] ion-slot id
    level_meta: np.ndarray  # [L] metastable flags

    # map back from (Z, ion, level_number) -> flat index
    level_flat_index: dict

    @property
    def n_elements(self):
        return len(self.zs)

    @property
    def n_slots(self):
        return len(self.slot_element)

    @property
    def n_levels(self):
        return len(self.level_energy)

    @property
    def j_max(self):
        return self.slot_index.shape[1]

    def slot_of(self, z, ion):
        e = int(np.searchsorted(self.zs, z))
        if e >= len(self.zs) or self.zs[e] != z:
            raise KeyError(f"element {z} not in plasma tables")
        if not 0 <= ion < self.slot_index.shape[1]:
            raise KeyError(f"ion ({z}, {ion}) not in plasma tables")
        s = int(self.slot_index[e, ion])
        if s < 0:
            raise KeyError(f"ion ({z}, {ion}) not in plasma tables")
        return s


def build_plasma_tables(atom_data, selected_atomic_numbers=None) -> PlasmaTables:
    """Build dense tables from an AtomData instance.

    Every charge state from neutral up to the highest stage with ionization
    data gets a slot; slots missing level data get a synthetic ground level
    with g=1 so partition functions are always defined.
    """
    if selected_atomic_numbers is None:
        selected_atomic_numbers = atom_data.selected_atomic_numbers
    zs = np.asarray(sorted(int(z) for z in selected_atomic_numbers))

    ion = atom_data.ionization_data
    levels = atom_data.levels
    order = np.lexsort((levels.level_number, levels.ion_number, levels.atomic_number))
    levels = levels.take(order)

    n_ions = []
    for z in zs:
        stages = ion.ion_number[ion.atomic_number == z]
        if len(stages) == 0:
            raise ValueError(f"no ionization data for element Z={z}")
        n_ions.append(int(stages.max()) + 1)  # charge states 0..max_stage
    n_ions = np.asarray(n_ions)
    j_max = int(n_ions.max())

    slot_element, slot_ion = [], []
    slot_index = np.full((len(zs), j_max), -1, dtype=np.int32)
    for e, z in enumerate(zs):
        for q in range(n_ions[e]):
            slot_index[e, q] = len(slot_element)
            slot_element.append(e)
            slot_ion.append(q)
    slot_element = np.asarray(slot_element, dtype=np.int32)
    slot_ion = np.asarray(slot_ion, dtype=np.int32)

    chi = np.zeros((len(zs), j_max - 1))
    chi_mask = np.zeros((len(zs), j_max - 1), dtype=bool)
    for e, z in enumerate(zs):
        for j in range(n_ions[e] - 1):
            chi[e, j] = atom_data.ionization_energy(int(z), j + 1)
            chi_mask[e, j] = True

    # flat level list; synthesize g=1 ground levels for slots without data
    lev_e, lev_g, lev_s, lev_m = [], [], [], []
    level_flat_index = {}
    for s in range(len(slot_element)):
        z = zs[slot_element[s]]
        q = int(slot_ion[s])
        rows = np.nonzero((levels.atomic_number == z) & (levels.ion_number == q))[0]
        if len(rows):
            for r in rows:
                level_flat_index[(z, q, int(levels.level_number[r]))] = len(lev_e)
                lev_e.append(float(levels.energy[r]))
                lev_g.append(float(levels.g[r]))
                lev_s.append(s)
                lev_m.append(bool(levels.metastable[r]))
        else:
            level_flat_index[(z, q, 0)] = len(lev_e)
            lev_e.append(0.0)
            lev_g.append(1.0)
            lev_s.append(s)
            lev_m.append(True)

    return PlasmaTables(
        zs=zs,
        element_masses=atom_data.mass_of(zs),
        slot_element=slot_element,
        slot_ion=slot_ion,
        slot_index=slot_index,
        n_ions=n_ions,
        chi=chi,
        chi_mask=chi_mask,
        level_energy=np.asarray(lev_e),
        level_g=np.asarray(lev_g),
        level_slot=np.asarray(lev_s, dtype=np.int32),
        level_meta=np.asarray(lev_m, dtype=bool),
        level_flat_index=level_flat_index,
    )
