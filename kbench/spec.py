"""Find a cell's parts by the names in ``BENCHMARK.json``, make its inputs, and
build its job.

A cell names a configuration, ``configs/<config>.json`` (the sample the
reads come from and the files it is written as, k and the job's memory), and
a traffic mix,
``traffic/<traffic>.json`` (the job's flags, the input it counts, and the
outputs it writes). A per-layer metric is ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

from kbench import gen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    per_layer: list  # BENCHMARK.json's per-layer metrics this cell reports


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load(workload: str, sample: dict | None = None) -> Cell:
    """The cell named `workload`; `sample` overrides keys of its sample."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _json(os.path.relpath(os.path.join(ROOT, conf["file"]), HERE))
    if sample:
        config = dict(config, sample=dict(config["sample"], **sample))
    traffic = _json("traffic", w["traffic"] + ".json")
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return Cell(workload, int(w["chips"]), config, traffic, per_layer)


def metric_reader(name: str):
    """The module of metrics/<name>.py (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    mod_name = "kbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def workdir(workload: str) -> str:
    """The cell's directory for inputs and outputs under TMPDIR: a fixed
    path, emptied by the run that uses it."""
    tmp = os.environ.get("TMPDIR") or os.path.join(ROOT, ".kbench_tmp")
    return os.path.join(tmp, "kbench", workload)


def make_inputs(cell: Cell, seed: int, work: str, device) -> dict:
    """Write the cell's inputs for `seed` into `work`. Returns their paths
    by name ("reads" and "assembly": lists of files, counted as one sample;
    "reads_table": a path) and "bases", the bases of the input one job
    counts."""
    os.makedirs(work, exist_ok=True)
    sample, traffic = cell.config["sample"], cell.traffic
    k = cell.config["k"]
    relative = "relative_table_min" in traffic
    g = gen.genome(seed, sample["genome_length"])
    inputs, bases = {}, {}
    if traffic["query"] == "reads" or relative:
        codes = gen.reads(seed, g, sample)
        inputs["reads"] = gen.write_read_files(work, codes, seed, sample)
        bases["reads"] = int(codes.size)
        del codes
    if traffic["query"] == "assembly":
        path = os.path.join(work, "asm.fasta")
        gen.fasta_text(g[None, :], b"contig").tofile(path)
        inputs["assembly"], bases["assembly"] = [path], int(g.size)
    if relative:  # the reference's table, written by the frozen writer
        from kbench.reference import compare
        from kbench.reference.formats import words_to_packed, write_ktab

        tmin = traffic["relative_table_min"]
        words, counts = compare.reads_table(inputs["reads"], k, tmin, device)
        table = os.path.join(work, f"reads_t{tmin}")
        write_ktab(table, k, tmin, words_to_packed(words, k),
                   counts.cpu().numpy().astype("uint16"))
        inputs["reads_table"] = table + ".ktab"
    inputs["bases"] = bases[traffic["query"]]
    return inputs


def job_argv(cell: Cell, inputs: dict, out_base: str, work: str) -> list:
    """The fastk command line of one job: every file of its input."""
    flags = [f.format(**inputs) for f in cell.traffic["flags"]]
    return [f"-k{cell.config['k']}", f"-M{cell.config['memory_gb']}", *flags,
            f"-N{out_base}", f"-P{work}", *inputs[cell.traffic["query"]]]
