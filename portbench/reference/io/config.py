# Frozen copy of stardis_tpu_torch/io/config.py at commit 9c7d618: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""Configuration: the JAX package's schema, defaults and dotted-path
overrides, without PyYAML or jsonschema.

The schema dicts are those of ``stardis_tpu/io/config.py``.  Validation is a
small hand-written check of the draft-04 keywords those dicts use (type,
enum, required, properties, additionalProperties, patternProperties, items,
multipleOf).  ``load_config`` takes a dict or a JSON path; it takes a YAML
path only where PyYAML imports.
"""

from __future__ import annotations

import copy
import json
import re

LINE_SCHEMA = {
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "disable": {"type": "boolean", "default": False},
        "broadening": {
            "type": "array",
            "items": {
                "enum": [
                    "linear_stark",
                    "quadratic_stark",
                    "van_der_waals",
                    "radiation",
                ]
            },
            "default": [],
        },
        "disable_microturbulence": {"type": "boolean", "default": False},
        "vald_linelist": {
            "type": "object",
            "default": {},
            "properties": {
                "use_linelist": {"type": "boolean", "default": False},
                "shortlist": {"type": "boolean", "default": False},
                "use_vald_broadening": {"type": "boolean", "default": True},
                # extension over the reference (whose schema notes the
                # linelist "cannot be supplied separately"): path to a raw
                # VALD3 text export, parsed by the native C++ reader
                "fname": {"type": ["string", "null"], "default": None},
            },
        },
        "include_molecules": {"type": "boolean", "default": False},
        # extension over the reference: solve the molecular network
        # COUPLED (shared constituent reservoirs deplete consistently;
        # fixes orders-of-magnitude C2/CH/CN inflation below ~4000 K)
        # instead of the reference's independent per-molecule quadratics.
        # Validated envelope: 2500-10000 K, rho <= 1e-5 g/cm^3 (pinned
        # against Korg.jl in tests/test_korg_parity.py); the fixed
        # 400-iteration Jacobi sweep converges to ~1e-11 there, and the
        # host surface (molecule_number_density_frame) warns if the
        # conservation residual exceeds 1e-6 outside it
        "molecules_coupled": {"type": "boolean", "default": False},
        "window_mode": {
            "enum": ["reference", "accuracy"],
            "default": "reference",
        },
        "window_epsilon": {"type": "number", "default": 1e-4},
        # depth-block size for window tiering; 0 = per-line tiers
        # (read by pipeline.build_simulation_plan)
        "window_block": {"type": "number", "multipleOf": 1, "default": 8},
    },
}

OPACITY_SCHEMA = {
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "file": {
            "type": "object",
            "default": {},
            "additionalProperties": False,
            "patternProperties": {"_bf$": {"type": "string"}, "_ff$": {"type": "string"}},
        },
        "bf": {
            "type": "object",
            "default": {},
            "additionalProperties": {
                "type": "object",
                "additionalProperties": False,
                "properties": {
                    "gaunt": {"type": ["string", "null"], "default": None},
                    "departure": {"type": ["string", "null"], "default": None},
                },
            },
        },
        "ff": {
            "type": "object",
            "default": {},
            "additionalProperties": {
                "type": "object",
                "additionalProperties": False,
                "properties": {
                    "gaunt": {"type": ["string", "null"], "default": None},
                    "departure": {"type": ["string", "null"], "default": None},
                },
            },
        },
        "rayleigh": {
            "type": "array",
            "default": [],
            "items": {"enum": ["H", "He", "H2"]},
        },
        "disable_electron_scattering": {"type": "boolean", "default": False},
        "line": {**LINE_SCHEMA, "default": {}},
    },
}

INPUT_MODEL_SCHEMA = {
    "type": "object",
    "properties": {
        "type": {"enum": ["marcs", "mesa"]},
        "fname": {"type": "string"},
        "gzipped": {"type": "boolean", "default": False},
        "final_atomic_number": {"type": "number", "multipleOf": 1, "default": 92},
        "truncate_to_shell": {"type": "number", "multipleOf": 1, "default": -99},
        "composition_source": {"type": "string", "default": "from_model"},
        "composition_Y": {"type": "number", "default": -99.0},
        "composition_Z": {"type": "number", "default": -99.0},
        "nuclide_rescaling_dict": {"type": "object", "default": {}},
    },
    "required": ["type", "fname"],
}

RESULT_OPTIONS_SCHEMA = {
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "return_model": {"type": "boolean", "default": False},
        "return_plasma": {"type": "boolean", "default": False},
        "return_radiation_field": {"type": "boolean", "default": False},
    },
}

CONFIG_SCHEMA = {
    "$schema": "http://json-schema.org/draft-04/schema#",
    "type": "object",
    "properties": {
        "stardis_config_version": {"enum": [1.0]},
        "n_threads": {"type": "number", "multipleOf": 1, "default": 1},
        "atom_data": {"type": "string"},
        "input_model": INPUT_MODEL_SCHEMA,
        "opacity": OPACITY_SCHEMA,
        "no_of_thetas": {"type": "number", "multipleOf": 1, "default": 10},
        "result_options": {**RESULT_OPTIONS_SCHEMA, "default": {}},
    },
    "required": ["stardis_config_version", "atom_data", "input_model", "opacity"],
}


def _inject_defaults(schema, value):
    """Recursively apply schema defaults to a config dict."""
    if schema.get("type") == "object" and isinstance(value, dict):
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key not in value and "default" in sub:
                value[key] = copy.deepcopy(sub["default"])
            if key in value:
                _inject_defaults(sub, value[key])
        extra = schema.get("additionalProperties")
        if isinstance(extra, dict):
            for key, v in value.items():
                if key not in props:
                    _inject_defaults(extra, v)
    return value


class Configuration:
    """Nested attribute access over a config dict, with dotted-path
    overrides (reference io/base.py:53-65)."""

    def __init__(self, data: dict):
        self._data = data

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            val = self._data[name]
        except KeyError as exc:
            raise AttributeError(name) from exc
        return Configuration(val) if isinstance(val, dict) else val

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._data

    def __iter__(self):
        return iter(self._data)

    def items(self):
        return self._data.items()

    def keys(self):
        return self._data.keys()

    def get(self, name, default=None):
        val = self._data.get(name, default)
        return Configuration(val) if isinstance(val, dict) else val

    def to_dict(self):
        return copy.deepcopy(self._data)

    def set_config_item(self, dotted_key, value):
        parts = dotted_key.split(".")
        node = self._data
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def __repr__(self):
        return f"Configuration({self._data!r})"


_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "number": (int, float),
    "null": type(None),
}


def _is_type(value, name):
    if name == "number" and isinstance(value, bool):
        return False
    return isinstance(value, _TYPES[name])


def _validate(schema, value, path="config"):
    """Raise ValueError where ``value`` breaks ``schema``."""
    if "enum" in schema and value not in schema["enum"]:
        raise ValueError(f"{path}: {value!r} is not one of {schema['enum']}")
    if "type" in schema:
        names = schema["type"] if isinstance(schema["type"], list) else [schema["type"]]
        if not any(_is_type(value, n) for n in names):
            raise ValueError(f"{path}: {value!r} is not of type {schema['type']}")
    if "multipleOf" in schema and _is_type(value, "number"):
        if value % schema["multipleOf"]:
            raise ValueError(f"{path}: {value!r} is not a multiple of {schema['multipleOf']}")
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            _validate(schema["items"], item, f"{path}[{i}]")
    if not isinstance(value, dict):
        return
    for key in schema.get("required", []):
        if key not in value:
            raise ValueError(f"{path}: {key!r} is a required property")
    props = schema.get("properties", {})
    patterns = schema.get("patternProperties", {})
    extra = schema.get("additionalProperties", True)
    for key, item in value.items():
        sub_path = f"{path}.{key}"
        matched = False
        if key in props:
            _validate(props[key], item, sub_path)
            matched = True
        for pattern, sub in patterns.items():
            if re.search(pattern, key):
                _validate(sub, item, sub_path)
                matched = True
        if matched:
            continue
        if extra is False:
            raise ValueError(f"{path}: additional property {key!r} is not allowed")
        if isinstance(extra, dict):
            _validate(extra, item, sub_path)


def validate_config_dict(config_dict):
    _validate(CONFIG_SCHEMA, config_dict)
    return _inject_defaults(CONFIG_SCHEMA, config_dict)


def _read_config_file(path):
    path = str(path)
    with open(path) as fh:
        if path.endswith(".json"):
            return json.load(fh)
        try:
            import yaml
        except ImportError as exc:
            raise ValueError(
                f"{path}: YAML configs need PyYAML; pass a dict or a .json file"
            ) from exc
        return yaml.safe_load(fh)


def load_config(config, add_config_dict=None):
    """Validate a STARDIS config (dict, .json path, or .yml path where
    PyYAML is installed); apply dotted-key overrides."""
    if isinstance(config, Configuration):
        config = config.to_dict()
    config_dict = (
        copy.deepcopy(config) if isinstance(config, dict)
        else _read_config_file(config)
    )
    try:
        config_dict = validate_config_dict(config_dict)
    except ValueError as exc:
        raise ValueError(f"Config failed to validate: {exc}") from exc
    config = Configuration(config_dict)
    if add_config_dict:
        for key, val in add_config_dict.items():
            if not isinstance(key, str):
                raise ValueError(f"{key} not a valid type. Should be a string.")
            config.set_config_item(key, val)
        try:
            validate_config_dict(config._data)
        except ValueError as exc:
            raise ValueError(
                f"Additional config keys/values failed to validate: {exc}"
            ) from exc
    return config
