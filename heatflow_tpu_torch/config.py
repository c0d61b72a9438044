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
Without it, a small parser reads the subset the shipped configs and the
drivers' ``mesh_cfg.yaml`` use (block mappings, block sequences of scalars,
plain and single-quoted scalars resolved by YAML 1.1 rules, ``{}``, ``[]``
and comments) and raises :class:`ConfigError` on anything else.
``save_config`` writes what ``yaml.dump(cfg, default_flow_style=False)``
writes, through PyYAML when it is installed and through a small emitter of
the same subset otherwise.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any

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
_INDICATORS = tuple("[]{}&*!|>'\"%@`,#")


def _scalar(tok: str, where: str):
    if tok == "{}":
        return {}
    if tok == "[]":
        return []
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
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
            or tok.endswith(":")
            or (tok[0] in "-?:" and tok[1:2] in ("", " "))):
        raise ConfigError(f"{where}: unsupported YAML scalar {tok!r} "
                          "(install PyYAML for the full language)")
    return tok


def _strip_comment(line: str) -> str:
    quoted = False     # inside a single-quoted scalar ('' is a quote in it)
    for i, ch in enumerate(line):
        if ch == "'" and (quoted or i == 0 or line[i - 1] in " \t"):
            quoted = not quoted
        elif ch == "#" and not quoted and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _is_item(body: str) -> bool:
    return body == "-" or body.startswith("- ")


def parse_yaml_subset(text: str, *, source: str = "<string>") -> dict:
    """Parse the YAML subset of the shipped configs into a dict."""
    root: dict = {}
    stack = [(0, root)]          # (indent of this mapping's keys, mapping)
    pending = None               # (mapping, key) of a "key:" line
    seq = None                   # (indent, list) of an open block sequence
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
            if _is_item(body) and indent >= stack[-1][0]:
                parent[key] = []
                seq = (indent, parent[key])
            elif indent > stack[-1][0]:
                parent[key] = {}
                stack.append((indent, parent[key]))
            else:
                parent[key] = None
        if seq is not None:
            if indent == seq[0] and _is_item(body):
                item = body[1:].strip()
                if not item or _is_item(item) or (": " in item
                                                  or item.endswith(":")):
                    raise ConfigError(f"{where}: only sequences of scalars "
                                      "are supported")
                seq[1].append(_scalar(item, where))
                continue
            seq = None
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
        if isinstance(key, (dict, list)) or key_tok != key_tok.strip():
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


# ----------------------------------------------------------------------
# Writing
# ----------------------------------------------------------------------

def _float_text(v: float) -> str:
    """PyYAML's SafeRepresenter.represent_float: repr, with '.0' before the
    exponent when there is no '.', and .inf / -.inf / .nan."""
    if v != v:
        return ".nan"
    if v in (float("inf"), float("-inf")):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _scalar_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        if not (v.isascii() and v.isprintable()):
            raise ConfigError(f"writing {v!r} needs PyYAML")
        # plain when PyYAML's emitter would write it plain and it reads back
        # as this string, else single-quoted
        try:
            plain = v == v.strip() and v != "" and _scalar(v, "") == v
        except ConfigError:
            plain = False
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise ConfigError(f"cannot write a {type(v).__name__} to YAML")


def _emit_mapping(cfg: dict, indent: int, lines: list[str]) -> None:
    pad = " " * indent
    for key in sorted(cfg):
        val, head = cfg[key], pad + _scalar_text(key) + ":"
        if isinstance(val, dict) and val:
            lines.append(head)
            _emit_mapping(val, indent + 2, lines)
        elif isinstance(val, list) and val:
            lines.append(head)
            for item in val:
                if isinstance(item, (dict, list)):
                    raise ConfigError("only sequences of scalars are "
                                      "written without PyYAML")
                lines.append(f"{pad}- {_scalar_text(item)}")
        elif isinstance(val, (dict, list)):
            lines.append(f"{head} {'{}' if isinstance(val, dict) else '[]'}")
        else:
            lines.append(f"{head} {_scalar_text(val)}")


def dump_yaml(cfg: dict) -> str:
    """The text ``yaml.dump(cfg, default_flow_style=False)`` writes (block
    style, sorted keys), for mappings of scalars, mappings and sequences of
    scalars; through PyYAML (its C dumper when built) when installed."""
    try:
        import yaml
    except ImportError:
        if not cfg:
            return "{}\n"
        lines: list[str] = []
        _emit_mapping(cfg, 0, lines)
        return "\n".join(lines) + "\n"
    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    return yaml.dump(cfg, Dumper=dumper, default_flow_style=False)


def save_config(cfg: dict, path: str | os.PathLike) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))


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


def with_parameters(cfg: dict, *, fwhm: float | None = None,
                    sample_k: float | None = None,
                    sample_z: float | None = None) -> dict:
    """A deep copy of ``cfg`` with the sweep parameters substituted (ref
    parameter_sweep.py:238-266); the input is never mutated."""
    out = copy.deepcopy(cfg)
    if fwhm is not None:
        out["heating"]["fwhm"] = float(fwhm)
    if sample_k is not None:
        out["mats"]["p_sample"]["k"] = float(sample_k)
    if sample_z is not None:
        out["mats"]["p_sample"]["z"] = float(sample_z)
    return out


def config_equal(a: Any, b: Any) -> bool:
    """Structural equality useful for mesh-reuse decisions."""
    return dump_yaml({"v": a}) == dump_yaml({"v": b})
