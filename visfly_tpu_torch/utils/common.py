"""Shared utilities: config loading, seeding, image helpers (counterpart of
``visfly_tpu/utils/common.py``).

``load_yaml_config`` reads its files with :func:`parse_yaml`, a small reader
of the YAML subset that ``visfly_tpu/exps/`` is written in, and never with
PyYAML: the card's machine has no YAML package. The subset is block mappings
and block sequences (of scalars, of mappings, ``- key: value`` included),
flow sequences ``[1.0, 0.0, 1.5]`` and flow mappings ``{cnn: 128}``, nested
in one another on one line, full-line and inline comments, and scalars
resolved as PyYAML's ``safe_load`` resolves them: null, booleans, decimal
ints, floats (``1.0e-5``), plain and quoted strings. Anything else (anchors,
tags, block scalars, multi-line flow collections, several documents,
numbers in other bases) raises ``ValueError`` naming the file and line.
"""
from __future__ import annotations

import copy
import os
import random
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def deep_merge(origin: Dict, target: Dict) -> Dict:
    """Recursive dict merge, target wins."""
    result = copy.deepcopy(origin)
    for key, tv in target.items():
        ov = result.get(key)
        if isinstance(ov, dict) and isinstance(tv, dict):
            result[key] = deep_merge(ov, tv)
        else:
            result[key] = copy.deepcopy(tv)
    return result


# PyYAML's implicit resolvers (yaml/resolver.py) for the scalars the reader
# takes; the other numeric forms PyYAML knows are refused
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_OTHER_NUMBER = re.compile(r"[-+]?0[bx0-9]|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+"
                           r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_PLAIN_START_BANNED = set("&*!|>%@`'\"{}[],?#")


class _Reader:
    def __init__(self, lines: List[Tuple[int, int, str]], name: str, raw: List[str]):
        self.lines = lines  # (line number, indent, text without the indent)
        self.name = name
        self.raw = raw
        self.i = 0

    def error(self, no: int, msg: str) -> ValueError:
        return ValueError(f"{self.name}:{no}: {msg} (the config reader takes the YAML "
                          f"subset of visfly_tpu/exps/): {self.raw[no - 1].strip()!r}")

    # -- scalars ---------------------------------------------------------------

    def scalar(self, text: str, no: int) -> Any:
        if text[:1] in "'\"":
            value, end = self.quoted(text, 0, no)
            if text[end:].strip():
                raise self.error(no, "text after a quoted scalar")
            return value
        if text[:1] in _PLAIN_START_BANNED or ": " in text or text.endswith(":"):
            raise self.error(no, "unsupported scalar")
        if text in _NULL:
            return None
        if text in _TRUE:
            return True
        if text in _FALSE:
            return False
        if _INT.match(text):
            return int(text.replace("_", ""))
        if _FLOAT.match(text):
            v = text.replace("_", "").lower()
            sign = -1.0 if v.startswith("-") else 1.0
            v = v.lstrip("+-")
            if v == ".inf":
                return sign * float("inf")
            if v == ".nan":
                return float("nan")
            return sign * float(v)
        if _OTHER_NUMBER.match(text):
            raise self.error(no, "numbers in other bases, sexagesimals and dates are not read")
        return text

    def quoted(self, s: str, pos: int, no: int) -> Tuple[str, int]:
        q = s[pos]
        out, i = [], pos + 1
        while i < len(s):
            c = s[i]
            if c == "\\" and q == '"':
                raise self.error(no, "escapes in double-quoted scalars are not read")
            if c == q:
                if q == "'" and s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
        raise self.error(no, "unterminated quoted scalar")

    # -- flow collections -------------------------------------------------------

    def flow(self, s: str, pos: int, no: int) -> Tuple[Any, int]:
        """A value inside a flow collection, from ``pos`` → (value, end)."""
        while pos < len(s) and s[pos] == " ":
            pos += 1
        if pos >= len(s):
            raise self.error(no, "flow collection spans lines")
        c = s[pos]
        if c in "[{":
            close = "]" if c == "[" else "}"
            out: Any = [] if c == "[" else {}
            pos += 1
            while True:
                while pos < len(s) and s[pos] == " ":
                    pos += 1
                if pos >= len(s):
                    raise self.error(no, "flow collection spans lines")
                if s[pos] == close:
                    return out, pos + 1
                if c == "[":
                    value, pos = self.flow(s, pos, no)
                    out.append(value)
                else:
                    colon = s.find(":", pos)
                    if colon < 0 or s[colon + 1:colon + 2] != " ":
                        raise self.error(no, "expected 'key: value' in a flow mapping")
                    key = self.scalar(s[pos:colon].strip(), no)
                    out[key], pos = self.flow(s, colon + 1, no)
                while pos < len(s) and s[pos] == " ":
                    pos += 1
                if pos < len(s) and s[pos] == ",":
                    pos += 1
                elif pos >= len(s) or s[pos] != close:
                    raise self.error(no, f"expected ',' or '{close}'")
        if c in "'\"":
            return self.quoted(s, pos, no)
        end = pos
        while end < len(s) and s[end] not in ",]}":
            end += 1
        return self.scalar(s[pos:end].strip(), no), end

    def inline(self, text: str, no: int) -> Any:
        if text[0] in "[{":
            value, end = self.flow(text, 0, no)
            if text[end:].strip():
                raise self.error(no, "text after a flow collection")
            return value
        return self.scalar(text, no)

    # -- blocks -------------------------------------------------------------------

    def block(self, indent: int) -> Any:
        no, _, text = self.lines[self.i]
        if _is_item(text):
            return self.sequence(indent)
        if _split_key(text) is not None:
            return self.mapping(indent)
        raise self.error(no, "expected a mapping or a sequence")

    def mapping(self, indent: int) -> Dict:
        out: Dict = {}
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or _is_item(text):
                raise self.error(no, "bad indentation")
            kv = _split_key(text)
            if kv is None:
                raise self.error(no, "expected 'key: value'")
            key = self.scalar(kv[0], no)
            self.i += 1
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if kv[1]:
                out[key] = self.inline(kv[1], no)
            elif nxt is not None and nxt[1] > indent:
                out[key] = self.block(nxt[1])
            elif nxt is not None and nxt[1] == indent and _is_item(nxt[2]):
                out[key] = self.sequence(indent)
            else:
                out[key] = None
        return out

    def sequence(self, indent: int) -> List:
        out: List = []
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind < indent or (ind == indent and not _is_item(text)):
                break
            if ind > indent:
                raise self.error(no, "bad indentation")
            rest = text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                nxt = self.lines[self.i] if self.i < len(self.lines) else None
                out.append(self.block(nxt[1]) if nxt is not None and nxt[1] > indent else None)
            elif _is_item(rest) or _split_key(rest) is not None:
                # the item's first line, indented where its text starts
                self.lines[self.i] = (no, indent + len(text) - len(rest), rest)
                out.append(self.block(self.lines[self.i][1]))
            else:
                self.i += 1
                out.append(self.inline(rest, no))
        return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """``key: rest`` → (key, rest) for a plain key, else None."""
    if text[0] in "[{'\"":
        return None
    for i, c in enumerate(text):
        if c == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return (text[:i].rstrip(), text[i + 1:].strip()) if i else None
    return None


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " [{,"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml(text: str, name: str = "<yaml>") -> Any:
    """A document of the YAML subset in the module docstring → the value
    ``yaml.safe_load`` gives for it; ``None`` for an empty document."""
    raw = text.splitlines()
    lines = []
    reader = _Reader(lines, name, raw)
    for no, line in enumerate(raw, 1):
        body = _strip_comment(line)
        stripped = body.lstrip(" ")
        if not stripped:
            continue
        if stripped[0] == "\t" or stripped.startswith(("---", "...", "%")):
            raise reader.error(no, "tabs, document markers and directives are not read")
        lines.append((no, len(body) - len(stripped), stripped))
    if not lines:
        return None
    value = reader.block(lines[0][1])
    if reader.i != len(lines):
        raise reader.error(lines[reader.i][0], "bad indentation")
    return value


def load_yaml_config(path: str) -> Dict:
    """YAML experiment config; ``eval_env`` inherits ``env``."""
    with open(path, "r") as f:
        config = parse_yaml(f.read(), path)
    if "env" in config and "eval_env" in config:
        config["eval_env"] = deep_merge(origin=config["env"], target=config["eval_env"])
    elif "env" in config:
        config["eval_env"] = copy.deepcopy(config["env"])
    return config


def set_seed(seed: int) -> None:
    """Seed every host RNG and torch's default generators (the CPU's and
    every card's). The envs and trainers draw from generators of their own,
    seeded explicitly; this covers numpy, python and torch's global state."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def depth2rgb(depth: np.ndarray, max_depth: float = 20.0) -> np.ndarray:
    """Depth (H, W) → uint8 heat image (for video export)."""
    d = np.clip(np.asarray(depth, np.float32) / max_depth, 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * d - 1.0) * 2.0, 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * d - 0.5) * 2.0, 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * d) * 2.0, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def rgba2rgb(img: np.ndarray) -> np.ndarray:
    return img[..., :3]


def obs_list2array(obs_list, *shape):
    return np.stack([to_numpy(o) for o in obs_list]).reshape(*shape)


def to_numpy(x) -> np.ndarray:
    """A tensor (detached, on the host) or anything numpy takes → an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
