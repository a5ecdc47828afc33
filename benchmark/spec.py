"""What a cell is made of, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration is the JSON file its entry in ``configs`` gives
(``configs/<name>.json``); the mix is ``mixes/<traffic>.json``, whose
``job`` names a kind ``kinds/<job>.py``; the limits of the cell's check
are ``limits/<cell>.json``; every metric, end to end or per layer, is a
reader ``metrics/<name>.py`` with a ``read(job)`` function.  So a later
change adds a configuration, a mix, a job kind, a cell or a metric by
adding files and entries, and edits nothing here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import typing

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    read: typing.Callable[[typing.Any], typing.Optional[float]]
    workloads: typing.Optional[typing.List[str]] = None
    moves: typing.Optional[str] = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: typing.Dict[str, typing.Any]
    traffic: str
    mix: typing.Dict[str, typing.Any]
    #: The benchmark's folder the cell's files were found in.
    base: str
    #: Each number the check compares, with its limit.
    limits: typing.Dict[str, float]
    end_to_end: typing.List[Metric]
    per_layer: typing.List[Metric]


def root_of(base: str = HERE) -> str:
    """The directory that holds ``BENCHMARK.json`` (the checkout's root)."""
    return os.path.dirname(base)


def load_json(path: str) -> typing.Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, attribute: str) -> typing.Any:
    """``attribute`` of the Python file at ``path``, loaded by path (a
    metric's name may hold dots, so it is not imported by module name)."""
    folder, file = os.path.split(path)
    name = f"benchmark_{os.path.basename(folder)}_{file[:-3]}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, attribute)


def load_reader(name: str, base: str = HERE) -> typing.Callable:
    """``metrics/<name>.py``'s ``read``."""
    return load_module(os.path.join(base, "metrics", name + ".py"), "read")


def _applies(entry: typing.Mapping[str, typing.Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, root: typing.Optional[str] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its configuration,
    its mix, its limits and the readers of the metrics it reports."""
    root = root or root_of()
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    base = os.path.join(root, bench["paths"][0])
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    mix = load_json(os.path.join(base, "mixes", entry["traffic"] + ".json"))

    def metrics(kind: str) -> typing.List[Metric]:
        return [Metric(m["name"], m["unit"], m["better"], m["source"],
                       load_reader(m["name"], base), m.get("workloads"), m.get("moves"))
                for m in bench[kind] if _applies(m, name)]

    return Cell(name, int(entry["chips"]), conf["name"],
                load_json(os.path.join(root, conf["file"])), entry["traffic"], mix, base,
                load_json(os.path.join(base, "limits", name + ".json")),
                metrics("end_to_end"), metrics("per_layer"))
