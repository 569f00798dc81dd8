"""Start the ranks of a torch.distributed world on this host, one process a
card, and collect what each rank returns.

Each rank runs ``<command> <task> <rank> <world> <store> <out> <args>``:
``worker_main`` joins the world through a FileStore (NCCL on cards, one
card a rank, when args["device"] is "cuda"; gloo otherwise), runs the task
named in its table and pickles the result to ``<out>.<rank>.pkl``.
``run_world`` starts the ranks and returns their results in rank order, or
raises WorldFailed with each rank's return code and the tail of its
standard error. Every wait is bounded: a world that has not ended in
WAIT_S seconds is killed, and the process group times out after
PG_TIMEOUT_S.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import subprocess
import sys
import time

WAIT_S = 180  # a world that does not end in this is killed
PG_TIMEOUT_S = 60  # init_process_group's timeout in the ranks
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the directory that holds the package


class WorldFailed(RuntimeError):
    """A rank of a world failed, or the world passed its wait."""


def worker_env(extra=None) -> dict:
    """This process's environment with ROOT in front of PYTHONPATH, so that
    the ranks import this package whatever their working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def wait_all(procs, timeout):
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


def spawn(command, task, world, tmp, args, env=None, tag="w"):
    """Start the ranks of one world on `task`: (processes, the base of
    their result files). env: the ranks' whole environment (worker_env()
    by default)."""
    store = os.path.join(str(tmp), f"{tag}.store")
    if os.path.exists(store):
        os.remove(store)
    out = os.path.join(str(tmp), tag)
    procs = [subprocess.Popen(
        [*command, task, str(r), str(world), store, out, json.dumps(args)],
        env=worker_env() if env is None else env, cwd=str(tmp),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in range(world)]
    return procs, out


def run_world(command, task, world, tmp, args=None, env=None,
              timeout=WAIT_S, tag="w", attempts=1):
    """Run `task` on a world of `world` ranks and return each rank's
    result. A failed world is started again up to `attempts` times in all;
    the last failure raises WorldFailed."""
    fail = None
    for _attempt in range(attempts):
        procs, out = spawn(command, task, world, tmp, args or {}, env,
                           tag=tag)
        got = wait_all(procs, timeout)
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
            f"--- rank {r} (rc {rc}):\n{e[-3000:]}"
            for r, (rc, e) in enumerate(zip(rcs, errs)))
    raise WorldFailed(fail)


def join_world(rank: int, world: int, store: str, device: str,
               timeout_s: float = PG_TIMEOUT_S) -> None:
    """Join the world of a FileStore: NCCL with card rank % device_count
    for "cuda", gloo otherwise."""
    import torch
    import torch.distributed as dist

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if cuda else "gloo", store=dist.FileStore(store, world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def worker_main(tasks: dict, argv=None, join: bool = True) -> int:
    """One rank: join the world named on the command line (unless `join`
    is False, for a task that joins its own; args["pg_timeout_s"], when
    given, is the process group's timeout), run tasks[task](args) and
    pickle its result where run_world reads it."""
    import torch.distributed as dist

    task, rank, world, store, out, args = (sys.argv[1:] if argv is None
                                           else argv)[:6]
    rank, world, args = int(rank), int(world), json.loads(args)
    if join:
        join_world(rank, world, store, args.get("device", "cpu"),
                   args.get("pg_timeout_s", PG_TIMEOUT_S))
    try:
        res = tasks[task](args)
        with open(f"{out}.{rank}.pkl.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(f"{out}.{rank}.pkl.tmp", f"{out}.{rank}.pkl")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0
