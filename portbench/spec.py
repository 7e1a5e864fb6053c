"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells and metrics; a
cell's configuration is ``portbench/configs/<config>.json``, its traffic
``portbench/traffic/<traffic>.json``, its correctness limits
``portbench/workloads/<cell>.json``, a metric's reader
``portbench/metrics/<metric>.py``, and the plain reference's formula for
a kind of potential ``portbench/reference/kinds/<Kind>.py`` (the
configuration's ``potential`` without its ``Complex`` prefix). A cell,
configuration, traffic mix, metric or potential kind is added by adding
its file (and, but for a kind, its entry); no code changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import random
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"

# Keys of a configuration file that describe it and are not the port's.
META_KEYS = ("source", "assumed", "reduced")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def configuration(name: str) -> dict:
    """A configuration file as it is run: the port's YAML keys (a JSON
    file, which YAML reads) beside its ``source``, ``assumed`` and
    ``reduced``."""
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    """The cell's compared numbers and their limits."""
    return load_json(HERE / "workloads" / f"{cell}.json")["limits"]


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that cell ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    """The ``read(record)`` function of metric ``name``."""
    return _load(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name.replace('.', '_')}").read


def potential_kind(name: str):
    """The plain reference's file of potential kind ``name``, with its
    ``potential(raw, device)`` and ``v_infinity(raw, device)``; a kind
    with no file is refused by name."""
    path = HERE / "reference" / "kinds" / f"{name}.py"
    if not (name.isidentifier() and path.is_file()):
        raise ValueError(f"the reference has no potential kind {name!r}: "
                         f"no file {name}.py in {path.parent}")
    return _load(path, f"portbench_kind_{name}")


def run_raw(config: dict, mix: dict) -> dict:
    """The port's raw configuration of one solve of the mix: the file's
    keys without its description, with the states the traffic asks for
    and no file written but the per-state observables."""
    raw = {k: v for k, v in config.items() if k not in META_KEYS}
    raw["wavenum"] = 0
    raw["wavemax"] = int(mix["wavemax"])
    raw["output"] = {**raw["output"], "save_wavefns": False, "save_potential": False,
                     "snap_update": None}
    return raw


def port_config(raw: dict, workdir: Path):
    """The port's ``Config`` from ``raw`` by its own loader, reading and
    writing only under ``workdir``."""
    from wafer_torch.config import Config

    cfg = Config.from_dict(raw)
    return dataclasses.replace(cfg, input_dir=str(workdir / "input"),
                               output_root=str(workdir / "output"))


def solve_seed(seed: int, k: int) -> int:
    """A 32-bit initial-condition seed (the port's generators take 32 bits)
    derived from (``seed``, ``k``)."""
    digest = hashlib.sha256(f"{seed}/{k}".encode()).digest()
    return int.from_bytes(digest[:4], "little")


def pool(mix: dict) -> list:
    """The traffic's fixed pool of initial-condition seeds."""
    return [solve_seed(int(mix["pool_seed"]), i) for i in range(int(mix["initial_conditions"]))]


def job_seeds(mix: dict, seed: int) -> list:
    """The pool in the order ``--seed`` draws: job k of the run solves from
    entry k mod n. Every seed runs the same jobs in another order, so runs
    of different seeds do the same work."""
    ics = pool(mix)
    return random.Random(seed).sample(ics, len(ics))
