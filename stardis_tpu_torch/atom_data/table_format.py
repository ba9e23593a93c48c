"""The pandas ``format="table"`` (PyTables) HDF5 layout, read and written
with h5py and NumPy (the port of ``stardis_tpu/atom_data/table_format.py``).

carsus atom-data stores ship in both pandas HDFStore layouts: ``fixed``
(``synthetic_carsus.read_store_group``) and ``table``, decoded here.  One
group per store key:

* group attrs ``pandas_type`` (``frame_table``/``series_table``),
  ``table_type`` (``appendable_frame``/``appendable_multiframe``/
  ``appendable_series``/``appendable_multiseries``), plus pickled
  bookkeeping: ``index_cols`` ``[(axis, name)]``, ``non_index_axes``
  ``[(1, [column names])]``, ``data_columns``, ``levels`` (MultiIndex
  level names, stored as data columns by the multiframe writer);
* a ``table`` compound dataset whose fields are the index column(s),
  ``values_block_i`` 2-D blocks (one per dtype family; member column names
  in the pickled ``values_block_i_kind`` dataset attr), and any data
  columns (field name == column name).

PyTables pickles every non-scalar attr.  They are decoded by an unpickler
that refuses every global lookup: the bookkeeping objects are lists,
tuples, strings, numbers and None, which pickle encodes without one, so a
store's attr cannot construct an object; such an attr is returned raw.

A group reads as an ``atom_data.Table``: the row index as leading columns
(``Table.index_cols``), then the columns in the store's order.  The writer
emits the same layout, byte for byte as the JAX package's writer, so the
reader is testable without PyTables.  h5py is imported only by the calls
that open a file.
"""

from __future__ import annotations

import io
import pickle

import numpy as np

from .base import Table

__all__ = ["read_table_group", "write_table_store", "is_table_group"]

#: carsus store key of each logical table (``synthetic_carsus.write_store``'s too)
DEFAULT_KEYS = {
    "atom_data": "atom_data",
    "ionization_data": "ionization_data",
    "levels": "levels",
    "lines": "lines",
    "linelist_atoms": "linelist_atoms",
    "linelist_molecules": "linelist_molecules",
    "molecule_eq": "molecules/equilibrium_constants",
    "molecule_pf": "molecules/partition_functions",
    "molecule_de": "molecules/dissociation_energies",
}


# ----------------------------------------------------------------------
# attr (un)pickling
# ----------------------------------------------------------------------

class _GlobalsFreeUnpickler(pickle.Unpickler):
    """Unpickler that refuses every global lookup (the classic pickle code
    execution vector), so only structural pickles load."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"refusing global {module}.{name} in HDF5 attr pickle")


def _unpickle_attr(value, default=None):
    """Decode a (possibly pickled) HDF5 attr to a Python object."""
    if value is None:
        return default
    if isinstance(value, np.void):  # opaque attr (h5py reads np.void)
        value = value.tobytes()
    if isinstance(value, np.ndarray) and value.dtype.kind in ("S", "V"):
        value = value.tobytes()
    if isinstance(value, np.bytes_):
        value = bytes(value)
    if isinstance(value, str):
        value = value.encode("latin-1")
    if isinstance(value, bytes):
        try:
            return _GlobalsFreeUnpickler(io.BytesIO(value)).load()
        except Exception:  # noqa: BLE001 - any undecodable pickle is kept raw
            try:
                return value.decode()
            except UnicodeDecodeError:
                return default
    return value


def _pickled(obj):
    # protocol 0: ASCII, what PyTables historically stored
    return np.void(pickle.dumps(obj, protocol=0))


def _attr_text(obj, name):
    value = obj.attrs.get(name, b"")
    return value.decode() if isinstance(value, bytes) else value


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------

def is_table_group(grp) -> bool:
    return _attr_text(grp, "pandas_type") in ("frame_table", "series_table")


def _decode_col(values, nan_rep="nan"):
    """Byte strings decoded (the store's ``nan_rep`` becomes NaN, in an
    object column); other columns as stored."""
    values = np.asarray(values)
    if values.dtype.kind != "S":
        return values
    out = np.array([v.decode() for v in values])
    if nan_rep and (out == nan_rep).any():
        return np.where(out == nan_rep, np.nan, out.astype(object))
    return out


def row_index(values, name):
    """(columns, index_cols) of a one-level row index: a column named
    ``name``; an unnamed index (``name`` None or PyTables' "index") is
    dropped when it is 0..n-1, else kept as a column "index"."""
    if name is None or name == "index":
        if np.array_equal(values, np.arange(len(values))):
            return {}, ()
        name = "index"
    return {name: values}, (name,)


def read_table_group(grp) -> Table:
    """The Table of one table-format group: its row index as leading
    columns, then the store's columns in their order."""
    pandas_type = _attr_text(grp, "pandas_type")
    tbl = grp["table"]
    data = tbl[...]
    fields = data.dtype.names or ()

    index_cols = _unpickle_attr(grp.attrs.get("index_cols"), [])
    index_names = [name for _axis, name in index_cols] or ["index"]
    non_index_axes = _unpickle_attr(grp.attrs.get("non_index_axes"), [])
    col_order = list(non_index_axes[0][1]) if non_index_axes else None
    levels = _unpickle_attr(grp.attrs.get("levels"), None)
    if isinstance(levels, (bytes, str, int)):  # scalar nlevels marker
        levels = None
    nan_rep = _unpickle_attr(grp.attrs.get("nan_rep"), "nan")
    if not isinstance(nan_rep, str):
        nan_rep = "nan"

    columns = {}
    for field in fields:
        if field in index_names:
            continue
        kind = _unpickle_attr(tbl.attrs.get(f"{field}_kind"), None)
        members = list(kind) if isinstance(kind, (list, tuple)) else [field]
        vals = data[field]
        if vals.ndim == 1:
            vals = vals.reshape(-1, 1)
        for j, member in enumerate(members):
            columns[member] = _decode_col(vals[:, j], nan_rep)

    if levels:  # appendable_multi*: the levels are data columns
        index = {lv: columns.pop(lv) for lv in levels}
        names = tuple(levels)
    else:
        parts = [(name, _decode_col(data[name], nan_rep))
                 for name in index_names if name in fields]
        if not parts:
            index, names = {}, ()
        elif len(parts) == 1:
            index, names = row_index(parts[0][1], parts[0][0])
        else:
            index, names = dict(parts), tuple(n for n, _ in parts)

    if pandas_type == "series_table":
        name = _unpickle_attr(grp.attrs.get("name"), None)
        values = columns.get("values")
        if values is None:  # a single remaining column carries the data
            (values,) = columns.values() or ([],)
        return Table({**index, "values" if name is None else name: values}, names,
                     series=True)
    if pandas_type != "frame_table":
        raise ValueError(f"unsupported table-format pandas_type {pandas_type!r}")
    if col_order:
        col_order = [c for c in col_order if c not in set(names)]
        columns = {c: columns[c] for c in col_order if c in columns}
    return Table({**index, **columns}, names)


# ----------------------------------------------------------------------
# writing (the layout, for tests without PyTables)
# ----------------------------------------------------------------------

def _string_width(values):
    return max(1, max((len(str(v).encode()) for v in values), default=1))


def _as_field(values):
    """(numpy array, dtype for the compound field, pandas 'kind')."""
    values = np.asarray(values)
    if values.dtype.kind in ("U", "O"):
        w = _string_width(values)
        return (np.array([str(v).encode() for v in values], dtype=f"S{w}"),
                np.dtype(f"S{w}"), "string")
    if values.dtype.kind == "b":
        return values.astype(np.bool_), np.dtype(np.bool_), "bool"
    if values.dtype.kind in ("i", "u"):
        return values.astype(np.int64), np.dtype(np.int64), "integer"
    return values.astype(np.float64), np.dtype(np.float64), "float"


def _write_table(f, key, columns, index_values, index_name, levels=None, series_name=None,
                 data_columns=()):
    """Emit one appendable_(multi)frame / appendable_(multi)series group:
    ``columns`` {label: values} in order, on the row index
    ``index_values`` stored under the field ``index_name``."""
    grp = f.create_group(key) if key not in f else f[key]
    is_series = series_name is not None or (levels is None and list(columns) == ["values"])
    grp.attrs["CLASS"] = np.bytes_(b"GROUP")
    grp.attrs["TITLE"] = np.bytes_(b"")
    grp.attrs["VERSION"] = np.bytes_(b"1.0")
    grp.attrs["pandas_version"] = np.bytes_(b"0.15.2")
    grp.attrs["encoding"] = np.bytes_(b"UTF-8")
    grp.attrs["errors"] = np.bytes_(b"strict")
    if is_series:
        grp.attrs["pandas_type"] = np.bytes_(b"series_table")
        grp.attrs["table_type"] = np.bytes_(
            b"appendable_multiseries" if levels else b"appendable_series")
        grp.attrs["name"] = _pickled(series_name)
    else:
        grp.attrs["pandas_type"] = np.bytes_(b"frame_table")
        grp.attrs["table_type"] = np.bytes_(
            b"appendable_multiframe" if levels else b"appendable_frame")
    grp.attrs["index_cols"] = _pickled([(0, index_name)])
    grp.attrs["non_index_axes"] = _pickled([(1, list(columns))])
    grp.attrs["nan_rep"] = _pickled("nan")
    grp.attrs["info"] = _pickled({})
    if levels:
        grp.attrs["levels"] = _pickled(list(levels))
        data_columns = tuple(levels) + tuple(data_columns)
    grp.attrs["data_columns"] = _pickled(list(data_columns))

    # compound fields: index, data columns, then one block per dtype family
    fields = []
    col_meta = {}  # field -> (kind-list or None, pandas kind string)
    idx_arr, idx_dt, idx_kind = _as_field(index_values)
    fields.append((index_name, idx_dt, idx_arr))
    col_meta[index_name] = (None, idx_kind)

    block_cols = {}
    for col, values in columns.items():
        arr, dt, kind = _as_field(values)
        if col in data_columns:
            fields.append((col, dt, arr))
            col_meta[col] = ([col], kind)
        else:
            block_cols.setdefault((kind, dt.str), []).append((col, arr))
    values_cols = [c for c in columns if c in data_columns]
    for i, ((kind, dtstr), cols) in enumerate(sorted(block_cols.items())):
        name = f"values_block_{i}"
        arr = np.stack([a for _c, a in cols], axis=1)
        fields.append((name, np.dtype((dtstr, (len(cols),))), arr))
        col_meta[name] = ([c for c, _a in cols], kind)
        values_cols.append(name)
    grp.attrs["values_cols"] = _pickled(values_cols)

    n_rows = len(index_values)
    rows = np.empty(n_rows, dtype=np.dtype([(name, dt) for name, dt, _arr in fields]))
    for name, _dt, arr in fields:
        rows[name] = arr
    tbl = grp.create_dataset("table", data=rows)
    tbl.attrs["CLASS"] = np.bytes_(b"TABLE")
    tbl.attrs["VERSION"] = np.bytes_(b"2.7")
    tbl.attrs["TITLE"] = np.bytes_(b"")
    tbl.attrs["NROWS"] = n_rows
    for i, (name, _dt, _arr) in enumerate(fields):
        tbl.attrs[f"FIELD_{i}_NAME"] = np.bytes_(name.encode())
        names, kind = col_meta[name]
        if names is None:  # index column: kind is a plain string
            tbl.attrs[f"{name}_kind"] = _pickled(kind)
        else:
            tbl.attrs[f"{name}_kind"] = _pickled(list(names))
            tbl.attrs[f"{name}_dtype"] = _pickled(kind)
        tbl.attrs[f"{name}_meta"] = _pickled(None)


def write_table(f, key, table: Table):
    """One Table as a table-format group of the open h5py file ``f``: a
    MultiIndex (two or more index columns) as level data columns on a
    0..n-1 index, a one-column index as the row index, a Series' value
    column as the data column "values"."""
    columns = {c: table[c] for c in table.value_columns()}
    kw = {}
    if table.series:
        (name,) = columns
        columns = {"values": columns[name]}
        kw = {"series_name": None if name == "values" else name, "data_columns": ("values",)}
    if len(table.index_cols) > 1:
        levels = list(table.index_cols)
        _write_table(f, key, {**{lv: table[lv] for lv in levels}, **columns},
                     np.arange(len(table)), "index", levels=levels, **kw)
    elif table.index_cols:
        (index_name,) = table.index_cols
        _write_table(f, key, columns, table[index_name], index_name, **kw)
    else:
        _write_table(f, key, columns, np.arange(len(table)), "index", **kw)


def write_table_store(frames: dict, path, key_map=None):
    """Write logical Tables (``synthetic_carsus.build_carsus_frames``'
    dict) in the pandas ``format="table"`` layout, at the carsus keys
    (``DEFAULT_KEYS``, overridden per logical name by ``key_map``)."""
    import h5py

    keys = dict(DEFAULT_KEYS, **(key_map or {}))
    with h5py.File(path, "w") as f:
        for logical, table in frames.items():
            write_table(f, keys.get(logical, logical), table)
