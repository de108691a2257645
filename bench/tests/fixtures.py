"""Tiny versions of the cells, for driving the harness on the CPU: the
cells' own adapters, traffic and limits at a few hundred vertices."""
import copy

from bench import harness

TINY = {"pagerank-zipf": {"n_vertices": 256}}
CELLS = ("pagerank-zipf.chromatic",)


def tiny_cell(name: str, **traffic_run):
    """``name``'s cell at the fixture's size; ``traffic_run`` overrides
    the job's ``api.run`` arguments."""
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, **TINY[cell.config["name"]])
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["run"].update(traffic_run)
    return cell
