"""One run of one cell: find its files by name, hand the run to its entry,
read the per-layer metrics, judge the outputs against the limits.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
file holds the model block the port is built from, and a traffic mix,
``portbench/traffic/<traffic>.json``.  Found by name, each in a file of
its own:

* ``portbench/families/<family>.py``: the model family's parameter
  layout, reference forward and FLOP counts (the model block's
  ``family``);
* ``portbench/entries/<entry>.py``: the program's entry the window
  drives, its run, control and faults (the traffic's ``entry``);
* ``portbench/limits/<cell>.json``: the limits of the numbers compared;
* ``portbench/metrics/<metric>.py``: one per-layer metric's reader.

Nothing here names a cell, a configuration, an entry or a metric.  An
entry's ``run(ctx)`` returns ``setup_s``, ``attempted``, ``failed``,
``numbers`` (compared with the limits), ``memory_peak_bytes``, ``values``
(the end-to-end metrics by name), ``record`` (what the readers take) and
``traced`` (``trace.profile_steps``' reduction on a traced run, else
None).

The program is ``repro_torch``; it is imported inside ``run_cell`` only,
after the caller has checked for a card.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import check, counts

__all__ = ["Cell", "Run", "load_cell", "load_plugin", "run_cell"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Run:
    """What an entry's ``run`` is handed: the cell, the model block and
    traffic as run, the family's module, the run's arguments, the set-up
    phases so far (seconds since ``t0``) and the kernel build's seconds."""
    root: Path
    cell: Cell
    model: dict
    traffic: dict
    family: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    wrap_step: object = None
    log: object = print
    phases: dict = dataclasses.field(default_factory=dict)
    build_s: float | None = None


def _by_name(entries, name, what):
    hits = [e for e in entries if e["name"] == name]
    if len(hits) != 1:
        raise KeyError(f"BENCHMARK.json has {len(hits)} {what} named {name!r}")
    return hits[0]


def load_cell(root, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _by_name(bench["workloads"], name, "workloads")
    conf = _by_name(bench["configs"], w["config"], "configs")
    here = root / "portbench"
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return Cell(name=name, chips=w["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((here / "traffic" /
                                    f"{w['traffic']}.json").read_text()),
                limits=json.loads((here / "limits" /
                                   f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def load_plugin(root, kind: str, name: str):
    """The module ``root/portbench/<kind>/<name>.py`` (``kind``: families,
    entries or metrics), loaded from its file."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {kind} file {path}")
    mod_name = f"portbench_{kind}_{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, *, model=None, traffic=None,
             wrap_step=None, log=print) -> dict:
    """One run; returns the result line's dict (with ``checks``, each
    number compared beside its limit).

    ``model`` replaces the configuration's model block and ``traffic``
    updates keys of the traffic mix (the tests' small shapes);
    ``wrap_step`` wraps the program's step (the faults); ``log`` takes
    the earlier lines."""
    device = torch.device(device)
    cell = load_cell(root, name)
    m = dict(model or cell.config["model"])
    tr = dict(cell.traffic, **(traffic or {}))
    cuda = device.type == "cuda"
    ctx = Run(root=Path(root), cell=cell, model=m, traffic=tr,
              family=load_plugin(root, "families", m["family"]), seed=seed,
              seconds=seconds, trace=trace, device=device, t0=t0,
              wrap_step=wrap_step, log=log)
    ctx.phases["start"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.set_device(device)
        from repro_torch.kernels import build

        info = build.build()
        build.load()
        ctx.build_s = info["seconds"]
    ctx.phases["kernels"] = time.perf_counter() - t0
    out = load_plugin(root, "entries", tr["entry"]).run(ctx)

    numbers = out["numbers"]
    correct = check.judge(numbers, cell.limits) and out["failed"] == 0
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"]}
    if not trace:
        result["metrics"] = {e["name"]: {"value": out["values"][e["name"]],
                                         "unit": e["unit"]}
                             for e in cell.end_to_end}
    else:
        rec = dict(out["record"], cell=name, trace=out["traced"],
                   peaks=counts.PEAKS)
        result["metrics"] = {}
        for e in cell.per_layer:
            v = load_plugin(root, "metrics", e["name"]).read(rec)
            if v is not None:
                result["metrics"][e["name"]] = {"value": v, "unit": e["unit"]}
    result["device"] = {"platform": "gpu" if cuda else device.type,
                        "kind": (torch.cuda.get_device_name(device) if cuda
                                 else "cpu"),
                        "count": 1,
                        "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        traced = out["traced"]
        result["device"]["busy_s"] = traced["busy_us"] / 1e6
        result["device"]["window_s"] = traced["window_us"] / 1e6
        result["breakdown"] = traced["breakdown"]
        log(json.dumps({"portbench": "trace_spans",
                        "spans": traced.get("spans", {}),
                        "host_spans": traced.get("host_spans", {})}))
    result["checks"] = {k: {"value": numbers[k], "limit": v}
                        for k, v in cell.limits.items()}
    return result
