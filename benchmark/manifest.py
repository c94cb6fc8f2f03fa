"""BENCHMARK.json and the files its names lead to.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each per-layer metric names a reader. All of them are found by name:

  configs/<config file>   the configuration as run (`file` in BENCHMARK.json)
  traffic/<traffic>.json  the traffic mix's parameters; its `kind` names
  kinds/<kind>.py         the code that drives the program under it
  limits/<workload>.json  the limits of the numbers that decide `correct`
  metrics/<metric>.py     a per-layer metric's reader: read(ctx) -> value

so a later change adds a cell, a configuration or a metric by adding files
and entries, and edits none.
"""

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
  name: str
  unit: str
  moves: Optional[str] = None
  workloads: Optional[List[str]] = None


@dataclasses.dataclass
class Cell:
  """One workload with everything it names, loaded."""
  name: str
  chips: int
  config_name: str
  config: Dict
  traffic: Dict
  limits: Dict
  end_to_end: List[Metric]
  per_layer: List[Metric]
  root: pathlib.Path = ROOT  # the checkout the files were found in


def load_manifest(root: pathlib.Path = ROOT) -> Dict:
  with open(root / 'BENCHMARK.json') as f:
    return json.load(f)


def _metrics(entries, workload: str) -> List[Metric]:
  """The metrics of `entries` this cell reports: those that list it, or
  that list no cells (per-layer ones only where the cell reports the
  end-to-end metric they move)."""
  out = []
  for entry in entries:
    fields = {k: entry.get(k) for k in ('name', 'unit', 'moves', 'workloads')}
    out.append(Metric(**fields))
  return [m for m in out if m.workloads is None or workload in m.workloads]


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
  """The cell named `workload`.

  Raises:
    KeyError: no such workload, or a name it gives leads nowhere.
  """
  manifest = load_manifest(root)
  cells = {w['name']: w for w in manifest['workloads']}
  if workload not in cells:
    raise KeyError(f'no workload {workload!r} in BENCHMARK.json '
                   f'(have {sorted(cells)})')
  entry = cells[workload]
  configs = {c['name']: c for c in manifest['configs']}
  if entry['config'] not in configs:
    raise KeyError(f'workload {workload!r} names no configuration '
                   f'{entry["config"]!r}')
  config = json.loads((root / configs[entry['config']]['file']).read_text())
  bench = root / HERE.name
  traffic = json.loads((bench / 'traffic' / f'{entry["traffic"]}.json')
                       .read_text())
  limits = json.loads((bench / 'limits' / f'{workload}.json').read_text())
  end_to_end = _metrics(manifest['end_to_end'], workload)
  reported = {m.name for m in end_to_end}
  per_layer = [m for m in _metrics(manifest['per_layer'], workload)
               if m.workloads is not None or m.moves in reported]
  return Cell(workload, entry['chips'], entry['config'], config, traffic,
              limits, end_to_end, per_layer, root)


def reader(metric: str, root: pathlib.Path = ROOT) -> Callable:
  """`read` of metrics/<metric>.py."""
  path = root / HERE.name / 'metrics' / f'{metric}.py'
  spec = importlib.util.spec_from_file_location(
      f'benchmark_metric_{metric.replace(".", "_")}', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read
