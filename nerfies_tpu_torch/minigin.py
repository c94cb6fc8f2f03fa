"""A small gin-config-compatible configuration system.

Port of nerfies_tpu/minigin.py, plain Python. It parses the configs/*.gin
zoo with the subset of gin's syntax the zoo uses:

  - ``include 'other.gin'`` (resolved relative to the including file, the
    process CWD, and registered search paths; a bare name and one with a
    directory prefix both resolve, as `_find_include` shows)
  - macros:      ``name = <python-literal>`` and references ``%name``
    (a macro may be defined after its use: references resolve lazily)
  - bindings:    ``Class.field = <value>`` applied at construction time
  - references:  ``@module.fn`` resolved against a registry of externals
  - values: any Python literal expression (numbers, strings, bools, None,
    tuples, lists, dicts, arithmetic) possibly spanning multiple lines,
    containing nested ``%macro`` / ``@ref`` tokens.

Unknown bindings are skipped (gin's ``skip_unknown=True``).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

REQUIRED = object()


class MacroRef:
  """A `%name` reference, resolved lazily against the macro table."""

  def __init__(self, name: str):
    self.name = name

  def __repr__(self):
    return f'%{self.name}'

  def __eq__(self, other):
    return isinstance(other, MacroRef) and other.name == self.name

  def __hash__(self):
    return hash(('MacroRef', self.name))


class FnRef:
  """An `@module.fn` reference, resolved against the external registry."""

  def __init__(self, name: str):
    self.name = name

  def __repr__(self):
    return f'@{self.name}'

  def __eq__(self, other):
    return isinstance(other, FnRef) and other.name == self.name

  def __hash__(self):
    return hash(('FnRef', self.name))


class ParseError(ValueError):
  pass


_EXTERNALS: Dict[str, Any] = {}
_CONFIGURABLES: Dict[str, type] = {}
_SEARCH_PATHS: List[Path] = []


def register_external(name: str, value: Any) -> None:
  """Registers a value reachable via `@name` in config files."""
  _EXTERNALS[name] = value
  # Also register the unqualified trailing name (gin resolves both).
  short = name.rsplit('.', 1)[-1]
  _EXTERNALS.setdefault(short, value)


def external_configurable(fn: Callable, name: Optional[str] = None,
                          module: Optional[str] = None) -> Callable:
  """gin.external_configurable equivalent."""
  base = name or fn.__name__
  full = f'{module}.{base}' if module else base
  register_external(full, fn)
  return fn


def configurable(cls: type) -> type:
  """Class decorator: makes a dataclass constructible from bindings.

  The decorated class gains gin semantics: ``Cls()`` pulls the current
  parsed bindings for ``Cls.field`` as constructor defaults (explicit kwargs
  win). Fields bound to REQUIRED must be provided by the config.
  """
  _CONFIGURABLES[cls.__name__] = cls
  original_init = cls.__init__

  def __init__(self, **kwargs):
    cfg = dict(_STATE.bindings.get(cls.__name__, {}))
    field_names = {f.name for f in dataclasses.fields(cls)}
    resolved = {}
    for key, value in cfg.items():
      if key not in field_names:
        continue  # skip_unknown=True semantics
      resolved[key] = resolve(value)
    resolved.update(kwargs)
    original_init(self, **resolved)
    for f in dataclasses.fields(cls):
      if getattr(self, f.name, None) is REQUIRED:
        raise ValueError(
            f'{cls.__name__}.{f.name} is REQUIRED but not bound by any '
            'config.')

  cls.__init__ = __init__
  return cls


class _State:

  def __init__(self):
    self.macros: Dict[str, Any] = {}
    self.bindings: Dict[str, Dict[str, Any]] = {}
    self.included: List[str] = []

  def clear(self):
    self.macros.clear()
    self.bindings.clear()
    self.included.clear()


_STATE = _State()


def clear_config() -> None:
  _STATE.clear()


def add_search_path(path) -> None:
  p = Path(path)
  if p not in _SEARCH_PATHS:
    _SEARCH_PATHS.append(p)


def query_macro(name: str, default: Any = None) -> Any:
  return resolve(_STATE.macros.get(name, default))


def get_bindings(cls_name: str) -> Dict[str, Any]:
  return {k: resolve(v) for k, v in _STATE.bindings.get(cls_name, {}).items()}


# --- value parsing -------------------------------------------------------

_TOKEN_MACRO = re.compile(r'%([A-Za-z_][A-Za-z0-9_.]*)')
_TOKEN_FNREF = re.compile(r'@([A-Za-z_][A-Za-z0-9_.]*)')


def _strip_comment(line: str) -> str:
  """Removes a trailing # comment (respecting string literals)."""
  out = []
  in_str: Optional[str] = None
  i = 0
  while i < len(line):
    ch = line[i]
    if in_str:
      out.append(ch)
      if ch == in_str and (i == 0 or line[i - 1] != '\\'):
        in_str = None
    elif ch in ('"', "'"):
      in_str = ch
      out.append(ch)
    elif ch == '#':
      break
    else:
      out.append(ch)
    i += 1
  return ''.join(out)


def _protect_strings(text: str):
  """Replaces string literals with placeholders so %/@ inside them survive."""
  strings: List[str] = []

  def repl(m):
    strings.append(m.group(0))
    return f'__GIN_STR_{len(strings) - 1}__'

  pattern = re.compile(r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"")
  return pattern.sub(repl, text), strings


def parse_value(text: str) -> Any:
  """Parses a gin value expression into Python (with Macro/Fn refs)."""
  protected, strings = _protect_strings(text)
  protected = _TOKEN_MACRO.sub(
      lambda m: f'MacroRef({m.group(1)!r})', protected)
  protected = _TOKEN_FNREF.sub(
      lambda m: f'FnRef({m.group(1)!r})', protected)
  for i, s in enumerate(strings):
    protected = protected.replace(f'__GIN_STR_{i}__', s)
  try:
    # Config files are trusted local inputs (the same trust model as gin
    # itself, which also evals registered callables from config text).
    return eval(  # pylint: disable=eval-used
        protected, {'__builtins__': {}},
        {'MacroRef': MacroRef, 'FnRef': FnRef,
         'True': True, 'False': False, 'None': None})
  except Exception as e:
    raise ParseError(f'Cannot parse value {text!r}: {e}') from e


def resolve(value: Any) -> Any:
  """Recursively resolves Macro/Fn references inside a parsed value."""
  if isinstance(value, MacroRef):
    if value.name not in _STATE.macros:
      raise ParseError(f'Undefined macro %{value.name}')
    return resolve(_STATE.macros[value.name])
  if isinstance(value, FnRef):
    if value.name in _EXTERNALS:
      return _EXTERNALS[value.name]
    short = value.name.rsplit('.', 1)[-1]
    if short in _EXTERNALS:
      return _EXTERNALS[short]
    raise ParseError(f'Unknown reference @{value.name}')
  if isinstance(value, dict):
    return {resolve(k): resolve(v) for k, v in value.items()}
  if isinstance(value, tuple):
    return tuple(resolve(v) for v in value)
  if isinstance(value, list):
    return [resolve(v) for v in value]
  return value


def _balanced(text: str) -> bool:
  """True when all brackets are closed outside string literals."""
  protected, _ = _protect_strings(text)
  if protected.count('(') != protected.count(')'):
    return False
  if protected.count('[') != protected.count(']'):
    return False
  if protected.count('{') != protected.count('}'):
    return False
  return True


_INCLUDE_RE = re.compile(r"^include\s+['\"]([^'\"]+)['\"]\s*$")
_BINDING_RE = re.compile(
    r'^([A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)?)\s*=\s*(.*)$',
    re.DOTALL)


def _find_include(name: str, relative_to: Optional[Path]) -> Path:
  candidates = []
  if relative_to is not None:
    candidates.append(relative_to / name)
    candidates.append(relative_to / Path(name).name)
  candidates.append(Path(name))
  for sp in _SEARCH_PATHS:
    candidates.append(sp / name)
    candidates.append(sp / Path(name).name)
  for c in candidates:
    if c.exists():
      return c
  raise FileNotFoundError(
      f'include {name!r} not found (searched {[str(c) for c in candidates]})')


def parse_config(text: str, relative_to: Optional[Path] = None) -> None:
  """Parses gin config text into the global macro/binding tables."""
  # Accumulate logical statements: a statement continues until its brackets
  # balance (gin dict/tuple values span lines in the reference zoo).
  statements: List[str] = []
  pending = ''
  for raw_line in text.splitlines():
    line = _strip_comment(raw_line).rstrip()
    if not line.strip() and not pending:
      continue
    pending = (pending + '\n' + line) if pending else line
    if _balanced(pending):
      if pending.strip():
        statements.append(pending.strip())
      pending = ''
  if pending.strip():
    raise ParseError(f'Unbalanced statement at end of config: {pending!r}')

  for stmt in statements:
    m = _INCLUDE_RE.match(stmt)
    if m:
      parse_config_file(_find_include(m.group(1), relative_to))
      continue
    m = _BINDING_RE.match(stmt)
    if not m:
      raise ParseError(f'Cannot parse config statement: {stmt!r}')
    target, value_text = m.group(1), m.group(2)
    value = parse_value(value_text)
    if '.' in target:
      cls_name, field = target.split('.', 1)
      _STATE.bindings.setdefault(cls_name, {})[field] = value
    else:
      _STATE.macros[target] = value


def parse_config_file(path) -> None:
  path = Path(path)
  resolved = str(path.resolve())
  if resolved in _STATE.included:
    return
  _STATE.included.append(resolved)
  with open(path, 'r') as f:
    text = f.read()
  parse_config(text, relative_to=path.parent)


def parse_config_files_and_bindings(
    config_files: Sequence[Any] = (),
    bindings: Optional[Sequence[str]] = None,
    skip_unknown: bool = True) -> None:
  """Drop-in for gin.parse_config_files_and_bindings."""
  del skip_unknown  # always on
  for f in config_files or ():
    parse_config_file(f)
  for b in bindings or ():
    parse_config(b)


def operative_config_str() -> str:
  """Serializes the current macros + bindings back to gin syntax."""
  lines = []
  for name, value in sorted(_STATE.macros.items()):
    lines.append(f'{name} = {_format_value(value)}')
  lines.append('')
  for cls_name in sorted(_STATE.bindings):
    for field, value in sorted(_STATE.bindings[cls_name].items()):
      lines.append(f'{cls_name}.{field} = {_format_value(value)}')
    lines.append('')
  return '\n'.join(lines)


def _format_value(value: Any) -> str:
  if isinstance(value, MacroRef):
    return f'%{value.name}'
  if isinstance(value, FnRef):
    return f'@{value.name}'
  if isinstance(value, dict):
    items = ', '.join(
        f'{_format_value(k)}: {_format_value(v)}' for k, v in value.items())
    return '{' + items + '}'
  if isinstance(value, tuple):
    inner = ', '.join(_format_value(v) for v in value)
    return f'({inner},)' if len(value) == 1 else f'({inner})'
  if isinstance(value, list):
    return '[' + ', '.join(_format_value(v) for v in value) + ']'
  if callable(value):
    for name, v in _EXTERNALS.items():
      if v is value:
        return f'@{name}'
  return repr(value)
