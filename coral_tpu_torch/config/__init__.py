"""Hydra-compatible configuration engine.

The reference stack (alexandrainst/coral) composes its configuration with Hydra 1.x +
OmegaConf (reference: ``src/scripts/finetune_asr_model.py:36``,
``config/asr_finetuning.yaml``). This module reimplements the subset of that surface
the framework needs, natively, so that existing config trees and CLI override grammars
(``model=wav2vec2-small``, ``datasets=[coral_read_aloud,coral_conversation]``,
``total_batch_size=256``) run unchanged:

- defaults-list composition over config groups (``model/``, ``datasets/`` multi-select,
  ``decoder_datasets/``, ``experiment_tracking/``), including ``_self_`` ordering and
  ``override hydra/...`` entries (ignored, as we ship our own logging setup).
- lazy ``${a.b}`` interpolation against the composed root, plus the ``${now:...}``
  resolver used by ``model_id: ${model.name}-${now:%Y-%m-%d}``.
- CLI override grammar ``key=value``, ``group=option``, ``group=[a,b]``,
  ``+key=value``, ``~key`` and dotted paths.

A copy of ``coral_tpu/config/__init__.py``, less its import of
``coral_tpu._platform`` (which picks a JAX platform). ``yaml`` is imported
when a file is read or written, so the module imports without it. Called
without a config path from outside the repository, ``compose`` falls back to
the ``config/`` tree beside the package, as the JAX one does.
"""

from __future__ import annotations

import copy
import datetime as _dt
import os
import re
from pathlib import Path
from typing import Any, Iterator

__all__ = [
    "DictConfig",
    "ListConfig",
    "compose",
    "initialize",
    "to_container",
    "to_yaml",
    "merge",
]

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


_YAML12_LOADER: Any = None


def _yaml12_loader() -> Any:
    """SafeLoader with YAML-1.2 float parsing (accepts ``1e-4`` without a dot)."""
    global _YAML12_LOADER
    if _YAML12_LOADER is None:
        import yaml

        class _Yaml12Loader(yaml.SafeLoader):
            pass

        _Yaml12Loader.add_implicit_resolver(
            "tag:yaml.org,2002:float",
            re.compile(
                r"""^(?:
                    [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
                    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
                    |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN)
                )$""",
                re.X,
            ),
            list("-+0123456789."),
        )
        _YAML12_LOADER = _Yaml12Loader
    return _YAML12_LOADER


def _yaml_load(text: str) -> Any:
    import yaml

    return yaml.load(text, Loader=_yaml12_loader())

# Module-level search path set by `initialize`, mirroring hydra.initialize.
_CONFIG_PATH: Path | None = None


class InterpolationError(Exception):
    """Raised when a ${...} reference cannot be resolved.

    Deliberately NOT a KeyError: attribute access on a key that exists but holds a
    broken interpolation must not masquerade as a missing key.
    """


class ListConfig(list):
    """A list node that resolves interpolations against the config root."""

    def __init__(self, items: list, root: "DictConfig | None" = None) -> None:
        super().__init__(items)
        self._root = root

    def __getitem__(self, idx):  # type: ignore[override]
        value = super().__getitem__(idx)
        if isinstance(idx, slice):
            return ListConfig(value, self._root)
        return _resolve_value(value, self._root)

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other: object) -> bool:
        return list(self) == other

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:  # pragma: no cover - lists are unhashable in practice
        raise TypeError("unhashable type: 'ListConfig'")


class DictConfig(dict):
    """A dict node with attribute access and lazy interpolation resolution."""

    def __init__(self, data: dict | None = None, root: "DictConfig | None" = None):
        super().__init__()
        # The root of the config tree this node belongs to (self for the root node).
        object.__setattr__(self, "_root", root if root is not None else self)
        if data:
            for key, value in data.items():
                self[key] = value

    # -- tree wiring ------------------------------------------------------------
    def _wrap(self, value: Any) -> Any:
        root = object.__getattribute__(self, "_root")
        if isinstance(value, DictConfig):
            object.__setattr__(value, "_root", root)
            for v in dict.values(value):
                value._wrap_child(v)
            return value
        if isinstance(value, dict):
            node = DictConfig(root=root)
            for k, v in value.items():
                node[k] = v
            return node
        if isinstance(value, ListConfig):
            value._root = root
            return value
        if isinstance(value, (list, tuple)):
            return ListConfig([self._wrap(v) for v in value], root)
        return value

    def _wrap_child(self, value: Any) -> None:
        root = object.__getattribute__(self, "_root")
        if isinstance(value, DictConfig):
            object.__setattr__(value, "_root", root)
            for v in dict.values(value):
                value._wrap_child(v)
        elif isinstance(value, ListConfig):
            value._root = root
            for v in list.__iter__(value):
                if isinstance(v, (DictConfig, ListConfig)):
                    self._wrap_child(v)

    # -- mapping protocol ---------------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        dict.__setitem__(self, key, self._wrap(value))

    def __getitem__(self, key: str) -> Any:
        value = dict.__getitem__(self, key)
        return _resolve_value(value, object.__getattribute__(self, "_root"))

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def items(self):
        return [(k, self[k]) for k in dict.keys(self)]

    def values(self):
        return [self[k] for k in dict.keys(self)]

    def select(self, dotted: str, default: Any = None) -> Any:
        """Fetch a value by dotted path, e.g. ``cfg.select("model.sampling_rate")``."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, (DictConfig, dict)):
                if part not in node:
                    return default
                node = node[part]
            elif isinstance(node, (list, ListConfig)):
                node = node[int(part)]
            else:
                return default
        return node

    def set_dotted(self, dotted: str, value: Any, create: bool = True) -> None:
        """Set a value by dotted path, creating intermediate nodes if asked to."""
        parts = dotted.split(".")
        node: DictConfig = self
        for part in parts[:-1]:
            if part not in node or not isinstance(dict.__getitem__(node, part), dict):
                if not create:
                    raise KeyError(dotted)
                node[part] = {}
            node = dict.__getitem__(node, part)
        if not create and parts[-1] not in node:
            raise KeyError(dotted)
        node[parts[-1]] = value

    def copy(self) -> "DictConfig":
        return DictConfig(to_container(self, resolve=False))


# ------------------------------------------------------------------------------------
# Interpolation
# ------------------------------------------------------------------------------------

_RESOLVERS: dict[str, Any] = {
    "now": lambda fmt="%Y-%m-%d_%H-%M-%S": _dt.datetime.now().strftime(fmt),
    "oc.env": lambda name, default="": __import__("os").environ.get(name, default),
}


def register_resolver(name: str, fn: Any) -> None:
    """Register a custom ``${name:arg}`` resolver."""
    _RESOLVERS[name] = fn


def _resolve_ref(ref: str, root: "DictConfig | None") -> Any:
    ref = ref.strip()
    if ":" in ref:
        name, _, arg = ref.partition(":")
        if name in _RESOLVERS:
            return _RESOLVERS[name](arg) if arg else _RESOLVERS[name]()
    if root is None:
        raise InterpolationError(ref)
    node: Any = root
    for part in ref.split("."):
        if isinstance(node, (dict, DictConfig)):
            if part not in node:
                raise InterpolationError(ref)
            node = node[part]
        elif isinstance(node, (list, ListConfig)):
            node = node[int(part)]
        else:
            raise InterpolationError(ref)
    return node


def _resolve_value(value: Any, root: "DictConfig | None") -> Any:
    if isinstance(value, str) and "${" in value:
        full = _INTERP_RE.fullmatch(value)
        if full:
            return _resolve_ref(full.group(1), root)
        return _INTERP_RE.sub(
            lambda m: str(_resolve_ref(m.group(1), root)), value
        )
    return value


# ------------------------------------------------------------------------------------
# Merging / conversion
# ------------------------------------------------------------------------------------


def merge(base: dict, update: dict) -> dict:
    """Recursively merge ``update`` into ``base`` (in place), dicts deep, rest replace."""
    for key, value in (update.items() if not isinstance(update, DictConfig) else [
        (k, dict.__getitem__(update, k)) for k in dict.keys(update)
    ]):
        base_value = dict.__getitem__(base, key) if (
            isinstance(base, dict) and dict.__contains__(base, key)
        ) else None
        if isinstance(base_value, dict) and isinstance(value, dict):
            merge(base_value, value)
        else:
            if isinstance(base, DictConfig):
                base[key] = copy.deepcopy(
                    to_container(value, resolve=False)
                    if isinstance(value, (DictConfig, ListConfig))
                    else value
                )
            else:
                base[key] = copy.deepcopy(value)
    return base


def to_container(node: Any, resolve: bool = True) -> Any:
    """Convert a config tree to plain Python containers."""
    if isinstance(node, DictConfig):
        if resolve:
            return {k: to_container(node[k], resolve) for k in dict.keys(node)}
        return {
            k: to_container(dict.__getitem__(node, k), resolve) for k in dict.keys(node)
        }
    if isinstance(node, (list, ListConfig)):
        if resolve and isinstance(node, ListConfig):
            return [to_container(v, resolve) for v in node]
        return [to_container(v, resolve) for v in list.__iter__(node)] if isinstance(
            node, ListConfig
        ) else [to_container(v, resolve) for v in node]
    if isinstance(node, dict):
        return {k: to_container(v, resolve) for k, v in node.items()}
    return node


def to_yaml(node: Any) -> str:
    """Render a config tree as YAML (interpolations resolved)."""
    import yaml

    return yaml.safe_dump(to_container(node, resolve=True), allow_unicode=True,
                          sort_keys=False)


# ------------------------------------------------------------------------------------
# Composition
# ------------------------------------------------------------------------------------


def initialize(config_path: str | Path, version_base: Any = None) -> None:
    """Set the config search path (mirrors ``hydra.initialize``)."""
    global _CONFIG_PATH
    _CONFIG_PATH = Path(config_path)


def _load_yaml(path: Path) -> dict:
    with path.open("r", encoding="utf-8") as f:
        data = _yaml_load(f.read())
    return data or {}


def _group_option_path(base: Path, group: str, option: str) -> Path:
    return base / group / f"{option}.yaml"


def _parse_defaults_entry(entry: Any) -> tuple[str | None, Any, bool]:
    """Return (group, option(s), is_self) for one defaults-list entry."""
    if entry == "_self_":
        return None, None, True
    if isinstance(entry, str):
        # bare config name include (rare) — treat as group-less include
        return "", entry, False
    assert isinstance(entry, dict) and len(entry) == 1, f"Bad defaults entry: {entry}"
    group, option = next(iter(entry.items()))
    override = False
    if group.startswith("override "):
        group = group[len("override "):]
        override = True
    _ = override  # overrides and plain selections compose identically here
    return group, option, False


def _compose_file(
    base: Path, name: str, selections: dict[str, Any]
) -> dict:
    """Compose one root config file with its defaults list."""
    root_file = base / f"{name}.yaml"
    raw = _load_yaml(root_file)
    defaults = raw.pop("defaults", None)

    result: dict = {}
    self_merged = False

    if defaults is None:
        merge(result, raw)
        return result

    for entry in defaults:
        group, option, is_self = _parse_defaults_entry(entry)
        if is_self:
            merge(result, raw)
            self_merged = True
            continue
        assert group is not None
        if group.startswith("hydra"):
            continue  # our logging is configured natively
        # CLI group selections replace the default option(s)
        if group in selections:
            option = selections[group]
        if option is None:
            continue
        options = option if isinstance(option, list) else [option]
        group_result: dict = {}
        for opt in options:
            opt_path = _group_option_path(base, group, str(opt))
            if not opt_path.exists():
                raise FileNotFoundError(
                    f"Config group option not found: {group}={opt} ({opt_path})"
                )
            merge(group_result, _load_yaml(opt_path))
        # Hydra's default package for a group config is the group name, except when
        # the group yaml already nests its payload under per-option keys (the
        # `datasets/` pattern in the reference tree, where coral_read_aloud.yaml
        # holds `coral_read_aloud: {...}`).
        target = result.setdefault(group, {}) if "/" not in group else None
        if target is None:
            # nested group like foo/bar — place under nested keys
            node = result
            for part in group.split("/"):
                node = node.setdefault(part, {})
            merge(node, group_result)
        else:
            merge(target, group_result)

    if not self_merged:
        merge(result, raw)
    return result


_GROUP_LIST_RE = re.compile(r"^\[(.*)\]$")


def compose(
    config_name: str,
    overrides: list[str] | None = None,
    config_path: str | Path | None = None,
) -> DictConfig:
    """Compose a configuration, mirroring ``hydra.compose``.

    Args:
        config_name: Name of the root config file (without ``.yaml``).
        overrides: CLI-style override strings.
        config_path: Config tree root; defaults to the path set via ``initialize``.

    Returns:
        The composed configuration.
    """
    base = Path(config_path) if config_path is not None else _CONFIG_PATH
    if base is None:
        base = Path("config")
        if not base.is_dir():
            # Library use from outside the repo: fall back to the config tree
            # shipped alongside the package.
            repo_config = Path(__file__).resolve().parents[2] / "config"
            if repo_config.is_dir():
                base = repo_config
    overrides = list(overrides or [])

    # Split overrides into group selections vs value overrides. A key is a group
    # selection iff a directory of that name exists in the config tree.
    selections: dict[str, Any] = {}
    value_overrides: list[tuple[str, str, str]] = []  # (mode, key, value)
    for ov in overrides:
        mode = "set"
        if ov.startswith("~"):
            value_overrides.append(("del", ov[1:], ""))
            continue
        if ov.startswith("++"):
            ov, mode = ov[2:], "add"
        elif ov.startswith("+"):
            ov, mode = ov[1:], "add"
        key, _, value = ov.partition("=")
        key = key.strip()
        if "." not in key and (base / key).is_dir():
            m = _GROUP_LIST_RE.match(value.strip())
            if m:
                opts = [o.strip() for o in m.group(1).split(",") if o.strip()]
                selections[key] = opts
            elif value.strip() in ("null", "None"):
                selections[key] = None
            else:
                selections[key] = value.strip()
        else:
            value_overrides.append((mode, key, value))

    result = _compose_file(base, config_name, selections)
    cfg = DictConfig(result)

    for mode, key, value in value_overrides:
        if mode == "del":
            node = cfg
            parts = key.split(".")
            for part in parts[:-1]:
                node = dict.__getitem__(node, part)
            dict.__delitem__(node, parts[-1])
            continue
        parsed = _yaml_load(value) if value != "" else None
        try:
            # Hydra semantics: a bare key=value override may only modify an
            # existing key; creating a new one needs the explicit +key=value.
            # Silent creation turns typos (and keys that live under another
            # group, e.g. learning_rate vs model.learning_rate) into no-ops.
            cfg.set_dotted(key, parsed, create=(mode == "add"))
        except KeyError:
            raise KeyError(
                f"Could not override '{key}': no such key in the composed "
                f"config. To append a new key use '+{key}={value}'."
            ) from None

    return cfg
