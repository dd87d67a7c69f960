"""Hydra-compatible YAML config composition (a copy of
``vit_ssl_tpu/config/compose.py`` that reads YAML through :mod:`.yaml_io`).

It implements the subset of Hydra's and OmegaConf's semantics the config
tree uses:

- defaults lists with ``group@package: name`` entries and ``_self_``
  (``configs/dino.yaml``);
- ``${a.b}`` interpolation against the composed root, ``${now:fmt}`` and
  ``${oc.env:NAME,default}``;
- dotlist CLI overrides (``training.type=finetune``);
- config-GROUP overrides (``dino/training=fast`` replaces which option file
  a defaults-list entry selects; ``+group=option`` appends a new group at
  its package path; unknown groups or options fail with the available
  choices, as Hydra does);
- dict/attribute dual access plus ``.get``.

Multirun (``-m``/``--multirun``): :func:`expand_multirun` expands cartesian
choice sweeps over comma-separated override values (top-level commas
only); the entry point runs the jobs sequentially under
``multirun/<date>/<time>/<idx>``.

Pure Python: no PyYAML, torch or JAX, so it imports everywhere.
"""

from __future__ import annotations

import copy
import datetime
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

from . import yaml_io

__all__ = ["Config", "compose", "load_yaml", "to_container", "from_container", "save_yaml"]

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config:
    """Mapping with both item and attribute access, mirroring OmegaConf's
    DictConfig surface the trainers use (``__getitem__``, ``get``,
    attribute access, ``in``, iteration)."""

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self._data[key] = _wrap(default)
        return self._data[key]

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return to_container(self) == to_container(other)
        if isinstance(other, dict):
            return to_container(self) == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(to_container(self), memo))


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def to_container(value: Any) -> Any:
    """Recursively convert to plain dict/list (OmegaConf.to_container)."""
    if isinstance(value, Config):
        return {k: to_container(v) for k, v in value.items()}
    if isinstance(value, list):
        return [to_container(v) for v in value]
    return value


def from_container(value: Any) -> Any:
    return _wrap(value)


def load_yaml(path: Union[str, Path]) -> Any:
    return yaml_io.load(path)


def save_yaml(cfg: Any, path: Union[str, Path]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(yaml_io.dumps(to_container(cfg)))


# --------------------------------------------------------------------------
# Merging
# --------------------------------------------------------------------------

def merge(dst: Any, src: Any) -> Any:
    """Deep merge ``src`` into ``dst`` (src wins), like OmegaConf.merge."""
    if isinstance(dst, Config) and isinstance(src, (Config, dict)):
        src_items = src.items() if isinstance(src, (Config, dict)) else []
        for k, v in src_items:
            if k in dst and isinstance(dst[k], Config) and isinstance(v, (Config, dict)):
                merge(dst[k], v)
            else:
                dst[k] = v
        return dst
    return _wrap(src)


def _set_by_path(root: Config, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = root
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, Config):
            nxt = Config()
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


def _get_by_path(root: Any, dotted: str) -> Any:
    node = root
    for p in dotted.split("."):
        if isinstance(node, Config):
            node = node[p]
        elif isinstance(node, list):
            node = node[int(p)]
        else:
            raise KeyError(dotted)
    return node


# --------------------------------------------------------------------------
# Interpolation
# --------------------------------------------------------------------------

def _coerce_scalar(text: str) -> Any:
    """Parse an override / interpolated value with YAML scalar rules."""
    try:
        return yaml_io.loads(text)
    except yaml_io.YAMLError:
        return text


def _resolve_value(value: Any, root: Config, _depth: int = 0) -> Any:
    if _depth > 16:
        raise ValueError(f"Interpolation too deep / cyclic: {value!r}")
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value.strip())
        if full:
            return _resolve_expr(full.group(1), root, _depth)

        def sub(m: "re.Match[str]") -> str:
            resolved = _resolve_expr(m.group(1), root, _depth)
            return str(resolved)

        return _INTERP_RE.sub(sub, value)
    return value


def _resolve_expr(expr: str, root: Config, depth: int) -> Any:
    expr = expr.strip()
    if expr.startswith("now:"):
        return datetime.datetime.now().strftime(expr[len("now:"):])
    if expr.startswith("oc.env:"):
        import os

        parts = expr[len("oc.env:"):].split(",", 1)
        return os.environ.get(parts[0], parts[1] if len(parts) > 1 else None)
    target = _get_by_path(root, expr)
    return _resolve_value(target, root, depth + 1)


def resolve(cfg: Config, root: Optional[Config] = None) -> Config:
    """Resolve all ``${...}`` interpolations in place."""
    root = root if root is not None else cfg

    def walk(node: Any) -> Any:
        if isinstance(node, Config):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str):
            out = _resolve_value(node, root)
            if isinstance(out, str) and out is not node and not _INTERP_RE.search(out):
                coerced = _coerce_scalar(out)
                # keep strings that merely look numeric inside paths intact
                if not isinstance(coerced, (dict, list)):
                    return coerced
            return out
        return node

    walk(cfg)
    return cfg


# --------------------------------------------------------------------------
# Defaults-list composition
# --------------------------------------------------------------------------

def _compose_file(
    config_dir: Path,
    rel: str,
    package: Optional[str],
    group_overrides: Optional[Dict[str, str]] = None,
    consumed: Optional[set] = None,
) -> Config:
    """Load one YAML file, recursively applying its own defaults list.

    ``rel`` is relative to ``config_dir`` and may omit the .yaml suffix.
    ``group_overrides`` maps a defaults-list key (``group`` or
    ``group@package``) to a replacement option name — the CLI group
    override; matched keys are recorded in ``consumed``.
    """
    name = rel if rel.endswith((".yaml", ".yml")) else rel + ".yaml"
    path = config_dir / name
    raw = load_yaml(path)

    if isinstance(raw, list):  # leaf config that is a YAML list (metrics, transforms)
        return _wrap({"_list_": raw})  # caller unwraps

    raw = raw or {}
    defaults = raw.pop("defaults", None)
    own = _wrap(raw)
    if defaults is None:
        return own

    out = Config()
    saw_self = False
    for entry in defaults:
        if entry == "_self_":
            merge(out, own)
            saw_self = True
            continue
        if isinstance(entry, str):
            # Either a sibling composition root ("dino.yaml") or a
            # ConfigStore schema name ("training_config") — schemas carry no
            # YAML content here, validation happens in schemas.py.
            candidate = entry if entry.endswith((".yaml", ".yml")) else entry + ".yaml"
            if (config_dir / candidate).exists():
                merge(
                    out,
                    _compose_file(config_dir, entry, None, group_overrides, consumed),
                )
            continue
        if isinstance(entry, dict):
            (key, value), = entry.items()
            if value is None:
                continue
            if "@" in key:
                group, pkg = key.split("@", 1)
            else:
                group, pkg = key, key
            # CLI group override: exact "group@pkg" key wins, else a bare
            # "group" key when the entry's package IS the group
            if group_overrides:
                if key in group_overrides:
                    value = group_overrides[key]
                    consumed.add(key)
                elif group in group_overrides and pkg == group:
                    value = group_overrides[group]
                    consumed.add(group)
            sub = _compose_file(config_dir, f"{group}/{value}", None)
            if "_list_" in sub and len(sub) == 1:
                payload: Any = [to_container(v) for v in sub["_list_"]]
            else:
                payload = sub
            if pkg in ("", "_global_"):
                merge(out, payload)
            else:
                existing: Any
                try:
                    existing = _get_by_path(out, pkg)
                except (KeyError, ValueError):
                    existing = None
                if isinstance(existing, Config) and isinstance(payload, Config):
                    merge(existing, payload)
                else:
                    _set_by_path(out, pkg, payload)
            continue
        raise ValueError(f"Unsupported defaults entry: {entry!r}")
    if not saw_self:
        merge(out, own)
    return out


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Apply Hydra-style dotlist overrides (``a.b=c``, ``+a.b=c``, ``~a.b``)."""
    for ov in overrides or []:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            path = ov[1:].split("=", 1)[0]
            parts = path.split(".")
            node = cfg
            try:
                for p in parts[:-1]:
                    node = node[p]
                del node[parts[-1]]
            except (KeyError, TypeError):
                pass
            continue
        key, _, value = ov.lstrip("+").partition("=")
        _set_by_path(cfg, key.strip(), _coerce_scalar(value.strip()))
    return cfg


def _partition_overrides(config_dir: Path, overrides: List[str]):
    """Split CLI overrides into (group replacements, group additions,
    dotlist). A group override is ``key=option`` where key has no '.' and
    names a config-group directory; ``+key=option`` appends the group."""
    group_ovs: Dict[str, str] = {}
    additions = []  # (group, package, option)
    dotlist: List[str] = []
    for ov in overrides or []:
        s = ov.strip()
        if not s or s.startswith("~"):
            dotlist.append(s)
            continue
        key, eq, value = s.partition("=")
        plus = key.startswith("+")
        k = key.lstrip("+").strip()
        group = k.split("@", 1)[0]
        if eq and k and "." not in k and (config_dir / group).is_dir():
            option = value.strip()
            if not (config_dir / group / f"{option}.yaml").exists():
                avail = sorted(
                    p.stem for p in (config_dir / group).glob("*.yaml")
                )
                raise ValueError(
                    f"Config group '{group}' has no option '{option}'. "
                    f"Available options: {avail}"
                )
            if plus:
                pkg = k.split("@", 1)[1] if "@" in k else group
                additions.append((group, pkg, option))
            else:
                group_ovs[k] = option
            continue
        dotlist.append(s)
    return group_ovs, additions, dotlist


def compose(
    config_dir: Union[str, Path],
    config_name: str = "config",
    overrides: Optional[List[str]] = None,
) -> Config:
    """Compose a config the way ``@hydra.main(config_path="configs",
    config_name=...)`` does: load the root, walk defaults lists (applying
    any CLI config-GROUP overrides), append ``+group=option`` additions,
    apply dotlist overrides, then resolve interpolations.
    """
    config_dir = Path(config_dir)
    group_ovs, additions, dotlist = _partition_overrides(
        config_dir, overrides or []
    )
    consumed: set = set()
    cfg = _compose_file(config_dir, config_name, None, group_ovs, consumed)
    unused = set(group_ovs) - consumed
    if unused:
        raise ValueError(
            f"Config-group override(s) {sorted(unused)} did not match any "
            f"defaults-list entry of '{config_name}'. Use the full "
            f"'group@package=option' form shown in the config's defaults "
            f"list, or '+group@package=option' to append a new group."
        )
    for group, pkg, option in additions:
        sub = _compose_file(config_dir, f"{group}/{option}", None)
        if "_list_" in sub and len(sub) == 1:
            payload: Any = [to_container(v) for v in sub["_list_"]]
        else:
            payload = sub
        if pkg in ("", "_global_"):
            merge(cfg, payload)
        else:
            _set_by_path(cfg, pkg, payload)
    apply_overrides(cfg, dotlist)
    resolve(cfg)
    return cfg


def is_list(value: Any) -> bool:
    """OmegaConf.is_list equivalent (used by ``prepare_dataloaders``)."""
    return isinstance(value, (list, tuple))


# ---------------------------------------------------------------------------
# Multirun sweeps (Hydra `-m`: `python -m vit_ssl_tpu_torch.train -m a=1,2`
# expands explicitly and the entry point runs the jobs sequentially)
# ---------------------------------------------------------------------------


def _split_sweep_value(value: str) -> List[str]:
    """Split an override value on top-level commas — commas inside
    brackets (``a=[1,2]`` is a list, not a sweep) or quotes
    (``a='x,y'`` is a literal) do not split, matching Hydra."""
    parts: List[str] = []
    buf: List[str] = []
    depth = 0
    quote: Optional[str] = None
    for ch in value:
        if quote:
            if ch == quote:
                quote = None
            buf.append(ch)
        elif ch in "\"'":
            quote = ch
            buf.append(ch)
        elif ch in "[({":
            depth += 1
            buf.append(ch)
        elif ch in "])}":
            depth -= 1
            buf.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return [p.strip() for p in parts]


def expand_multirun(overrides: Optional[List[str]]) -> List[List[str]]:
    """Expand Hydra choice sweeps into per-job override lists.

    Every override whose value contains a top-level comma
    (``key=v1,v2`` — dotlist or config-group alike) is a sweep axis; the
    jobs are the cartesian product in override order with the rightmost
    axis varying fastest (Hydra's BasicSweeper job order). With no sweep
    axes the result is one job with the overrides unchanged.
    """
    import itertools

    axes: List[List[str]] = []
    for ov in overrides or []:
        s = ov.strip()
        key, eq, value = s.partition("=")
        if not eq or s.startswith("~"):
            axes.append([s])
            continue
        vals = _split_sweep_value(value)
        if len(vals) > 1:
            axes.append([f"{key}={v}" for v in vals])
        else:
            axes.append([s])
    return [list(combo) for combo in itertools.product(*axes)]
