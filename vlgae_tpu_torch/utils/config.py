"""Hydra-compatible config composition + ``_target_`` instantiation.

A copy of ``vlgae_tpu/utils/config.py`` (the port must not import the JAX
package). It implements the subset of Hydra/OmegaConf the configs under
``configs/`` rely on:

  - defaults lists (``- group: name``, ``- override /group: name``,
    ``- _self_``) with ``# @package _global_`` / ``# @package group``
    directives,
  - ``${a.b}`` absolute and ``${..x}`` relative interpolation, custom
    resolvers ``${name:args}`` (ref: src/__init__.py:34-105),
  - dotted CLI overrides ``a.b=c`` / ``+a.b=c``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Callable, Dict, List, Optional

import yaml

_RESOLVERS: Dict[str, Callable[..., Any]] = {}


def register_resolver(name: str, fn: Callable[..., Any]):
    _RESOLVERS[name] = fn


# Built-in resolvers mirroring the reference's OmegaConf resolvers
# (ref: src/__init__.py:34-105).
register_resolver("div2", lambda x: int(x) // 2)
register_resolver("half_int", lambda x: int(x) // 2)
register_resolver("last", lambda x: str(x).split("/")[-1])
register_resolver("lang", lambda p: os.path.basename(os.path.dirname(str(p))))
register_resolver("in_debugger", lambda *_: False)
register_resolver("path_guard", lambda p: re.sub(r"[^\w\-+=.@]", "_", str(p)))
register_resolver("name_guard",
                  lambda n: "unnamed" if str(n) == "@@@AUTO@@@" else str(n))
register_resolver("accelerator", lambda n: "dp" if int(n or 0) > 1 else None)
register_resolver("oc.env", lambda k, d=None: os.environ.get(str(k), d))
register_resolver("cwd", lambda *_: os.getcwd())


def _deep_merge(base: dict, new: dict) -> dict:
    out = dict(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_path(cfg: dict, dotted: str, value):
    keys = dotted.split(".")
    d = cfg
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def _get_path(cfg: dict, dotted: str):
    d = cfg
    for k in dotted.split("."):
        if isinstance(d, (list, tuple)):
            d = d[int(k)]
        else:
            d = d[k]
    return d


def _parse_value(v: str):
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def _read_yaml(path: str):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    package = None
    m = re.search(r"^#\s*@package\s+(\S+)", text, re.MULTILINE)
    if m:
        package = m.group(1)
    data = yaml.safe_load(text) or {}
    return data, package


class ConfigComposer:
    def __init__(self, config_dir: str):
        self.config_dir = config_dir

    def _group_file(self, group: str, name: str) -> str:
        return os.path.join(self.config_dir, group.strip("/"), f"{name}.yaml")

    def _load_group(self, group: str, name: str, root: dict) -> dict:
        path = self._group_file(group, name)
        data, package = _read_yaml(path)
        defaults = data.pop("defaults", [])
        merged_before: dict = {}
        for entry in defaults:
            merged_before = self._apply_default(
                entry, merged_before, base_group=group.strip("/")
            )
        if package == "_global_" or package is None and group == "":
            content = data
        elif package and package != "_global_":
            content = {}
            _set_path(content, package, data)
        else:
            content = {}
            _set_path(content, group.strip("/").replace("/", "."), data)
        return _deep_merge(merged_before, content)

    def _apply_default(self, entry, acc: dict, base_group: str = "") -> dict:
        if entry == "_self_":
            return acc
        if isinstance(entry, str):
            # plain file include within same dir
            data, _ = _read_yaml(self._group_file(base_group, entry))
            return _deep_merge(acc, data)
        (key, name), = entry.items()
        if name is None:
            return acc
        override = False
        if key.startswith("override "):
            key = key[len("override "):]
            override = True
        optional = False
        if key.startswith("optional "):
            key = key[len("optional "):]
            optional = True
        pkg = None
        if "@" in key:
            # package-annotated default, e.g.
            # ``override /model/optimize@optimize: linear``
            # (configs/exp/vlgae.yaml)
            key, pkg = key.split("@", 1)
        if pkg is not None:
            if key.startswith("/"):
                group = key[1:]
            else:
                group = (base_group + "/" + key).strip("/")
                if not os.path.exists(self._group_file(group, name)):
                    group = key.strip("/")
            data, package = _read_yaml(self._group_file(group, name))
            data.pop("defaults", None)
            if package == "_global_":
                # the file's own @package header wins: its content is
                # written as global keys (matching the reference's
                # effective composition of model/optimize/*.yaml)
                return _deep_merge(acc, data)
            content: dict = {}
            _set_path(content, pkg, data)
            return _deep_merge(acc, content)
        if key.startswith("/"):
            group = key[1:]
        else:
            group = (base_group + "/" + key).strip("/")
            if not os.path.exists(self._group_file(group, name)):
                group = key
        path = self._group_file(group, name)
        if optional and not os.path.exists(path):
            return acc
        sub = self._load_group(group, name, acc)
        return _deep_merge(acc, sub)

    def compose(self, config_name: str, overrides: Optional[List[str]] = None
                ) -> dict:
        data, _ = _read_yaml(
            os.path.join(self.config_dir, f"{config_name}.yaml")
        )
        defaults = data.pop("defaults", ["_self_"])
        cfg: dict = {}
        self_merged = False
        for entry in defaults:
            if entry == "_self_":
                cfg = _deep_merge(cfg, data)
                self_merged = True
            else:
                cfg = self._apply_default(entry, cfg)
        if not self_merged:
            cfg = _deep_merge(cfg, data)

        # group-choice overrides first (e.g. exp=vlgae, data=vlparse)
        rest = []
        for ov in overrides or []:
            key, _, value = ov.partition("=")
            key = key.lstrip("+")
            if (
                "." not in key
                and os.path.isdir(os.path.join(self.config_dir, key))
                and os.path.exists(self._group_file(key, value))
            ):
                cfg = self._apply_default({key: value}, cfg)
            else:
                rest.append(ov)
        for ov in rest:
            key, _, value = ov.partition("=")
            key = key.lstrip("+")
            _set_path(cfg, key, _parse_value(value))
        return cfg


_INTERP = re.compile(r"\$\{([^{}]+)\}")


def resolve(cfg: dict, extra_resolvers: Optional[dict] = None) -> dict:
    """Resolve all interpolations in-place-ish (returns a new tree)."""
    resolvers = dict(_RESOLVERS)
    if extra_resolvers:
        resolvers.update(extra_resolvers)
    root = copy.deepcopy(cfg)

    def resolve_node(node, path):
        if isinstance(node, dict):
            return {k: resolve_node(v, path + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve_node(v, path + [str(i)])
                    for i, v in enumerate(node)]
        if isinstance(node, str):
            return resolve_str(node, path)
        return node

    def lookup(ref: str, path):
        if ref.startswith("."):
            # relative: one leading dot = current container
            up = 0
            while ref.startswith("."):
                ref = ref[1:]
                up += 1
            base = path[: len(path) - (up - 1) - 1] if up > 1 else path[:-1]
            target = ".".join(base + [ref]) if ref else ".".join(base)
        else:
            target = ref
        val = _get_path(root, target)
        if isinstance(val, str):
            return resolve_str(val, target.split(".")[:-1] + [""])
        return val

    def resolve_str(s: str, path):
        def repl_full(m):
            expr = m.group(1)
            if ":" in expr and not expr.startswith("."):
                name, _, arg = expr.partition(":")
                if name in resolvers:
                    arg = resolve_str(arg, path) if arg else arg
                    args = arg.split(",") if arg != "" else []
                    return resolvers[name](*args)
                if name == "hydra":
                    return os.getcwd()
            return lookup(expr, path)

        m = _INTERP.fullmatch(s)
        if m:
            return repl_full(m)
        out = _INTERP.sub(lambda m: str(repl_full(m)), s)
        return out

    return resolve_node(root, [])
