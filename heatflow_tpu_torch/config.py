"""Simulation configuration handling (reference-compatible YAML schema).

The schema is that of the reference framework's ``cfgs/*.yaml``::

    mats:
      <name>: {rho: float, cv: float, k: float, r: float, z: float, mesh: float}
    heating:
      file: path/to/heating.csv     # columns: time, temp [, oside]
      fwhm: float                   # laser FWHM [m]
      ic_temp: float                # initial / far-field temperature [K]
    timing:
      t_final: float                # total simulated time [s]
      num_steps: int
    io:
      mesh_path: str
    material_tags: {}

``load_config`` reads with ``yaml.safe_load`` when PyYAML is installed.
Without it, a small parser reads the subset the shipped configs use (block
mappings, plain scalars resolved by YAML 1.1 rules, ``{}`` and comments)
and raises :class:`ConfigError` on anything else.
"""

from __future__ import annotations

import os
import re

REQUIRED_MAT_KEYS = ("rho", "cv", "k", "r", "z", "mesh")


class ConfigError(ValueError):
    """Raised when a configuration file is malformed."""


def load_config(path: str | os.PathLike) -> dict:
    """Load a YAML simulation config, returning a plain dict."""
    with open(path, "r") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        cfg = parse_yaml_subset(text, source=str(path))
    else:
        cfg = yaml.safe_load(text)
    if not isinstance(cfg, dict):
        raise ConfigError(f"{path}: top level must be a mapping")
    return cfg


# PyYAML's (YAML 1.1) implicit resolvers, restricted to the forms the
# subset accepts; the other int/float spellings YAML 1.1 knows (binary,
# octal, hex, sexagesimal) are rejected rather than misread.
_NULL = {"~", "null", "Null", "NULL"}
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                        r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_FLOAT_SPECIAL = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "+.inf": float("inf"),
                  "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  "-.INF": float("-inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}
_FLOAT_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_INDICATORS = tuple("[]{}&*!|>'\"%@`,?-")


def _scalar(tok: str, where: str):
    if tok == "{}":
        return {}
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if tok in _FLOAT_SPECIAL:
        return _FLOAT_SPECIAL[tok]
    if (_INT_OTHER.match(tok) or _FLOAT_SEXAGESIMAL.match(tok)
            or tok.startswith(_INDICATORS) or ": " in tok or " #" in tok
            or tok.endswith(":")):
        raise ConfigError(f"{where}: unsupported YAML scalar {tok!r} "
                          "(install PyYAML for the full language)")
    return tok


def _strip_comment(line: str) -> str:
    for i, ch in enumerate(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml_subset(text: str, *, source: str = "<string>") -> dict:
    """Parse the YAML subset of the shipped configs into a dict."""
    root: dict = {}
    stack = [(0, root)]          # (indent of this mapping's keys, mapping)
    pending = None               # (mapping, key) of a "key:" line
    for lineno, raw in enumerate(text.splitlines(), start=1):
        where = f"{source}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or line.startswith("---"):
            raise ConfigError(f"{where}: unsupported YAML construct")
        indent = len(line) - len(body)
        if pending is not None:
            parent, key = pending
            pending = None
            if indent > stack[-1][0]:
                parent[key] = {}
                stack.append((indent, parent[key]))
            else:
                parent[key] = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ConfigError(f"{where}: inconsistent indentation")
        if body.endswith(":"):
            key_tok, value = body[:-1], ""
        elif ": " in body:
            key_tok, value = body.split(": ", 1)
        else:
            raise ConfigError(f"{where}: expected 'key: value', got {body!r}")
        key = _scalar(key_tok.strip(), where)
        if isinstance(key, dict) or key_tok != key_tok.strip():
            raise ConfigError(f"{where}: unsupported mapping key {key_tok!r}")
        mapping = stack[-1][1]
        if key in mapping:
            raise ConfigError(f"{where}: duplicate key {key!r}")
        value = value.strip()
        if value:
            mapping[key] = _scalar(value, where)
        else:
            pending = (mapping, key)
    if pending is not None:
        pending[0][pending[1]] = None
    return root


def mat_float(cfg: dict, mat: str, key: str) -> float:
    """Fetch ``cfg['mats'][mat][key]`` as float with a helpful error."""
    try:
        return float(cfg["mats"][mat][key])
    except KeyError as e:
        raise ConfigError(f"config missing mats.{mat}.{key}") from e
    except (TypeError, ValueError) as e:
        raise ConfigError(f"config mats.{mat}.{key} is not a number: "
                          f"{cfg['mats'][mat].get(key)!r}") from e


def validate_config(cfg: dict, *, require_heating_file: bool = False) -> None:
    """Validate the schema pieces every driver needs."""
    if "mats" not in cfg or not isinstance(cfg["mats"], dict) or not cfg["mats"]:
        raise ConfigError("config must define a non-empty 'mats' mapping")
    for name, mat in cfg["mats"].items():
        if not isinstance(mat, dict):
            raise ConfigError(f"mats.{name} must be a mapping")
        # explicit-bounds (custom layout) materials carry their geometry in
        # 'bounds' instead of the stack parameters r/z
        required = (("rho", "cv", "k", "mesh") if "bounds" in mat
                    else REQUIRED_MAT_KEYS)
        if "bounds" in mat:
            if (not isinstance(mat["bounds"], (list, tuple))
                    or len(mat["bounds"]) != 4):
                raise ConfigError(
                    f"mats.{name}.bounds must be [zmin, zmax, rmin, rmax]")
        for k in required:
            if k not in mat:
                raise ConfigError(f"mats.{name} missing key '{k}'")
            try:
                float(mat[k])
            except (TypeError, ValueError):
                raise ConfigError(
                    f"mats.{name}.{k} is not a number: {mat[k]!r}")
    for section, keys in (("heating", ("fwhm", "ic_temp")),
                          ("timing", ("t_final", "num_steps"))):
        if section not in cfg:
            raise ConfigError(f"config missing '{section}' section")
        for k in keys:
            if k not in cfg[section]:
                raise ConfigError(f"config missing {section}.{k}")
    if require_heating_file and "file" not in cfg["heating"]:
        raise ConfigError("config missing heating.file")


def timing(cfg: dict) -> tuple[float, int, float]:
    """Return (t_final, num_steps, dt)."""
    t_final = float(cfg["timing"]["t_final"])
    num_steps = int(cfg["timing"]["num_steps"])
    return t_final, num_steps, t_final / num_steps
