"""Rank workers for the port's multi-device tests on the CPU.

Not a test module: the tests start a world of processes through
``run_world`` (the package's spawner, ``fastk_tpu_torch/parallel/
launch.py``); each runs ``python torch_dist_worker.py <task> <rank>
<world> <store> <out> <args>``, joins a gloo world through a FileStore
under the test's tmp_path (an NCCL world, one card a rank, when
args["device"] is "cuda"), runs the task named in TASKS and pickles its
result to ``<out>.<rank>.pkl``. Imports no JAX.
"""

from __future__ import annotations

import os
import socket
import sys
import time

from fastk_tpu_torch.parallel import launch
from fastk_tpu_torch.parallel.launch import WAIT_S, WorldFailed

COMMAND = [sys.executable, os.path.abspath(__file__)]
_wait_all = launch.wait_all


def _env(extra=None):
    env = launch.worker_env(extra)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


def spawn(task, world, tmp, args, env=None, tag="w"):
    """Start the ranks of one world on `task`."""
    return launch.spawn(COMMAND, task, world, tmp, args, _env(env), tag)


def run_world(task, world, tmp, args=None, env=None, timeout=WAIT_S,
              tag="w"):
    """Run `task` on a world of `world` ranks and return each rank's
    result. A failed rendezvous or run is retried once, as the JAX
    package's multi-process tests do."""
    return launch.run_world(COMMAND, task, world, tmp, args, _env(env),
                            timeout, tag, attempts=2)


# ---- the tasks: each runs on every rank and returns a picklable result ---

def _mesh(args):
    from fastk_tpu_torch.parallel.dist import make_mesh

    return make_mesh(device=args.get("device", "cpu"))


def task_sharded_count(args):
    """sharded_count at every k of args["ks"], with and without positions,
    and the skewed stream that forces the rebalance ladder."""
    import numpy as np

    from fastk_tpu_torch.parallel.host import sharded_count, train_splitters

    mesh = _mesh(args)
    codes = np.asarray(args["codes"], np.uint8)
    res = {}
    for k in args["ks"]:
        for wp in (False, True):
            res[k, wp] = sharded_count(codes, k, mesh, want_positions=wp)
    skew = np.asarray(args["skew"], np.uint8)
    spl = train_splitters(np.asarray(args["train"], np.uint8), 24, mesh)
    reb = {}
    try:
        sharded_count(skew, 24, mesh, splitters=spl, slack=1.05,
                      auto_rebalance=False)
        res["no_rebalance"] = None
    except RuntimeError as e:
        res["no_rebalance"] = str(e)
    res["rebalanced"] = sharded_count(skew, 24, mesh, splitters=spl,
                                      slack=1.05, rebalance_state=reb)
    res["retrained"] = "splitters" in reb
    return res


def _fset(base):
    """{member name with the base replaced by X: bytes} of a file-set."""
    d, b = os.path.dirname(base), os.path.basename(base)
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith((b + ".", "." + b + ".")):
            with open(os.path.join(d, f), "rb") as fh:
                out[f.replace(b, "X", 1)] = fh.read()
    return out


def _summary(out):
    """What the tests compare of a CountOutput."""
    t = out.table
    return dict(hist=out.hist, nreads=out.nreads, totlen=out.totlen,
                nshort=out.nshort, entries=out.table_entries,
                table=None if t is None else (t.packed, t.counts),
                profiles=out.profiles,
                stats=getattr(out, "mesh_stats", None))


def task_mesh(args):
    """count_files_mesh scenarios (each a dict of its keyword arguments,
    with an optional "env"), in order on every rank; "out" streams
    file-sets under the rank's own directory."""
    from fastk_tpu_torch.parallel.meshooc import count_files_mesh

    mesh = _mesh(args)
    res = {}
    sort = os.path.join(os.getcwd(), f"sort{mesh.rank}")
    os.makedirs(sort, exist_ok=True)
    for name, sc in args["scenarios"].items():
        kw = dict(sc)
        env = kw.pop("env", {})
        paths, k = kw.pop("paths"), kw.pop("k")
        if kw.pop("stream", False):
            kw["out_base"] = os.path.join(os.getcwd(), name)
        os.environ.update(env)
        try:
            out = count_files_mesh(paths, k, mesh=mesh, sort_path=sort, **kw)
        finally:
            for key in env:
                del os.environ[key]
        res[name] = _summary(out)
        if "out_base" in kw:
            res[name]["files"] = _fset(out.slice_base)
        res[name]["spill_left"] = os.listdir(sort)
    return res


def task_relative(args):
    """relative_profiles_sharded, returned and streamed."""
    from fastk_tpu_torch.formats.ktab import read_ktab
    from fastk_tpu_torch.formats.prof import read_profiles
    from fastk_tpu_torch.parallel.host import relative_profiles_sharded

    mesh = _mesh(args)
    table = read_ktab(args["table"])
    res = {}
    for bb in args["batch_bases"]:
        out = relative_profiles_sharded(args["paths"], table, mesh,
                                        batch_bases=bb)
        res[bb] = (out.profiles, out.nreads, out.totlen)
    base = os.path.join(os.getcwd(), "rel")
    out = relative_profiles_sharded(args["paths"], table, mesh,
                                    batch_bases=args["batch_bases"][-1],
                                    out_base=base)
    res["streamed"] = (read_profiles(out.slice_base), out.nreads,
                       sorted(os.listdir(os.getcwd())))
    return res


def task_three_pipelines(args):
    """count_files_sharded at each case of args["cases"]."""
    from fastk_tpu_torch.parallel.host import count_files_sharded

    mesh = _mesh(args)
    return [_summary(count_files_sharded(c["paths"], c["k"], mesh,
                                         table_min=1,
                                         batch_bases=c["bb"]))
            for c in args["cases"]]


def task_multihost(args):
    """count_files_multihost: the whole result on every rank."""
    from fastk_tpu_torch.parallel.multihost import count_files_multihost

    return _summary(count_files_multihost(
        args["paths"], args["k"], mesh=_mesh(args), table_min=1,
        profiles=args["profiles"], batch_bases=args["bb"]))


def task_mesh_resume(args):
    """One count_files_mesh run with resume; rank 1 dies (os._exit(9)) at
    its args["die_at"]-th round when that is set."""
    import fastk_tpu_torch.parallel.meshooc as mo

    mesh = _mesh(args)
    die_at = args.get("die_at", -1)
    if die_at >= 0 and mesh.rank == 1:
        real = mo._local_shard_rows
        calls = [0]

        def dying(*a, **kw):
            if calls[0] >= die_at:
                os._exit(9)  # a rank lost mid-round
            calls[0] += 1
            return real(*a, **kw)

        mo._local_shard_rows = dying
    out = mo.count_files_mesh(args["paths"], args["k"], mesh=mesh,
                              table_min=1, profiles=True,
                              batch_bases=args["bb"],
                              out_base=os.path.join(os.getcwd(), "mr"),
                              out_nparts=2, sort_path=os.getcwd(),
                              resume=True)
    return dict(hist=out.hist, entries=out.table_entries,
                slice_base=out.slice_base)


def task_cli(args):
    """The fastk CLI on the CPU; the world is the CLI's own, joined from
    FASTK_TPU_COORD, FASTK_TPU_NPROCS and FASTK_TPU_PROC."""
    from fastk_tpu_torch.tools.fastk import main as fastk_main

    return fastk_main(args["argv"], device=args.get("device", "cpu"))


def task_stall(args):
    """Rank 0 enters count_files_mesh; the others never do."""
    from fastk_tpu_torch.parallel.meshooc import count_files_mesh

    mesh = _mesh(args)
    if mesh.rank != 0:
        time.sleep(WAIT_S)
        return None
    count_files_mesh(args["paths"], 17, mesh=mesh, table_min=1,
                     sort_path=os.getcwd())
    return "finished"


def task_dryrun(args):
    """A rank of dryrun_multichip's world, rank 1 made to fail in the dry
    run's second step (tests/test_torch_entry.py points the dry run's
    worker command here)."""
    import torch.distributed as dist

    from fastk_tpu_torch import entry

    if dist.get_rank() == 1:
        def fail(*_a, **_kw):
            raise RuntimeError("rank 1 made to fail")

        entry.count_files_sharded = fail
    (report,) = entry.run_dryrun(dist.get_world_size(), args["device"])
    return report


TASKS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("task_")}


def main():
    task, rank = sys.argv[1:3]
    if task == "cli":  # the CLI joins its own world
        os.environ["FASTK_TPU_PROC"] = rank
    launch.worker_main(TASKS, join=task != "cli")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli(world, tmp, argv, env=None, timeout=WAIT_S, tag="cli",
            device="cpu"):
    """The fastk CLI as a world of `world` processes on `device`, joined
    through FASTK_TPU_COORD on a free localhost port (a fresh one for the
    retry); returns each rank's return code."""
    fail = None
    for _attempt in range(2):
        e = dict(env or {}, FASTK_TPU_COORD=f"127.0.0.1:{free_port()}",
                 FASTK_TPU_NPROCS=str(world))
        try:
            return run_world("cli", world, tmp, dict(argv=argv,
                                                     device=device), e,
                             timeout, tag=tag)
        except WorldFailed as err:
            fail = err
    raise fail


if __name__ == "__main__":
    main()
