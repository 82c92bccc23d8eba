"""A cell's configuration at a size a CPU test run can hold: the same
knobs and the cell's own limits, a small swarm in a smaller box, short
chunks. Every cell with a file under `workloads/`, also one that
BENCHMARK.json holds out."""
import copy

import torch

from swarmbench import harness

torch.set_num_threads(2)

CELLS = tuple(sorted(p.stem for p in (harness.HERE / "workloads").glob(
    "*.json")))


def file_cell(name: str) -> harness.Cell:
    """The cell as its files give it."""
    w = harness.load_json(harness.HERE / "workloads" / f"{name}.json")
    return harness.Cell(
        name=name, entry={"name": name, "config": w["config"],
                          "traffic": w["traffic"], "chips": 1},
        config=harness.load_json(harness.HERE / "configs"
                                 / f"{w['config']}.json"),
        traffic=harness.load_json(harness.HERE / "traffic"
                                  / f"{w['traffic']}.json"),
        workload=w)


def tiny_cell(name: str, n: int = 24) -> harness.Cell:
    cell = copy.deepcopy(file_cell(name))
    cell.config.update(n=n, sim_l=25.0, sim_w=25.0, init_area_w=22.0,
                       init_area_h=22.0)
    if cell.config["cbaa_task_block"]:
        cell.config["cbaa_task_block"] = 8
    cell.traffic = {"batch": 2, "assign_every": 10,
                    "chunk": 10, "segment_ticks": 30}
    return cell
