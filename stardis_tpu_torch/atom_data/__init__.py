from .base import AtomData, MoleculeData, Table, einstein_a_from_f_lu
from .builtin import build_builtin_atom_data
from .download import download_atom_data

__all__ = ["AtomData", "MoleculeData", "Table", "build_builtin_atom_data",
           "download_atom_data", "einstein_a_from_f_lu"]
