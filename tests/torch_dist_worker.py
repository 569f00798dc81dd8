"""Rank workers for the port's multi-device tests on the CPU.

Not a test module: the tests start a world of processes through
``run_world``; each runs ``python torch_dist_worker.py <task> <rank>
<world> <store> <out> <args>``, joins a gloo world through a FileStore
under the test's tmp_path (an NCCL world, one card a rank, when
args["device"] is "cuda"), runs the task named in TASKS and pickles its
result to ``<out>.<rank>.pkl``. Imports no JAX.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WAIT_S = 180  # a world that does not finish in this is a failed test
PG_TIMEOUT_S = 60  # init_process_group's timeout in the workers


class WorldFailed(AssertionError):
    pass


def _env(extra=None):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def _wait_all(procs, timeout):
    """Wait for every process until the deadline; kill them all past it.
    Returns the return codes and the standard errors, or None on timeout."""
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            return None
    return ([p.returncode for p in procs],
            [p.stderr.read().decode(errors="replace") for p in procs])


def spawn(task, world, tmp, args, env=None, ranks=None, tag="w"):
    """Start the ranks of one world (all of them, or `ranks`) on `task`."""
    store = os.path.join(str(tmp), f"{tag}.store")
    if os.path.exists(store):
        os.remove(store)
    out = os.path.join(str(tmp), tag)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
         store, out, json.dumps(args)], env=_env(env), cwd=str(tmp),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in (range(world) if ranks is None else ranks)]
    return procs, out


def run_world(task, world, tmp, args=None, env=None, timeout=WAIT_S,
              tag="w"):
    """Run `task` on a world of `world` ranks and return each rank's
    result. A failed rendezvous or run is retried once, as the JAX
    package's multi-process tests do."""
    fail = None
    for _attempt in range(2):
        procs, out = spawn(task, world, tmp, args or {}, env, tag=tag)
        got = _wait_all(procs, timeout)
        if got is None:
            fail = f"{task}: the world of {world} passed {timeout} s"
            continue
        rcs, errs = got
        if all(rc == 0 for rc in rcs):
            results = []
            for r in range(world):
                with open(f"{out}.{r}.pkl", "rb") as f:
                    results.append(pickle.load(f))
            return results
        fail = f"{task}: return codes {rcs}\n" + "\n".join(
            e[-3000:] for e in errs)
    raise WorldFailed(fail)


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


TASKS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("task_")}


def main():
    task, rank, world, store, out, args = sys.argv[1:7]
    rank, world, args = int(rank), int(world), json.loads(args)
    import torch
    import torch.distributed as dist

    cuda = args.get("device", "cpu") == "cuda"
    if task == "cli":
        os.environ["FASTK_TPU_PROC"] = str(rank)
    else:
        if cuda:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if cuda else "gloo", store=dist.FileStore(store, world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        res = TASKS[task](args)
        with open(f"{out}.{rank}.pkl.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(f"{out}.{rank}.pkl.tmp", f"{out}.{rank}.pkl")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


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
