"""The other ranks of a run whose cell asks for more than one card, and the
launcher that the run's own process, rank 0, keeps them with.

    python3 -m kbench.ranks <fd> <device> <job limit s>   (started by World)

In set-up rank 0 starts ``chips - 1`` rank processes, each with the
variables of the port's multi-process CLI (FASTK_TPU_COORD, FASTK_TPU_NPROCS,
FASTK_TPU_PROC) and one end of a control channel of the harness's own.
Every rank joins one torch.distributed world before the warm-up job (NCCL on
cards, rank r on card r; gloo with device="cpu") and stays in it for the
window: ``fastk_tpu_torch.tools.fastk.main`` keeps a world it did not join.
For each job rank 0 hands every rank the same argv; each runs
``kbench.run.job`` on it, and the job ends when every rank has returned.
After the window each rank reports its device peak (since the reset after
set-up), its own ``ru_maxrss`` and any JAX module it loaded; then the world
is destroyed and the ranks exit.

Every wait has a fixed limit. A rank that dies, or a wait that passes its
limit, has every rank killed and raises Lost: the run prints no result. A
job that raises on any rank raises RankFailed, and the window ends as it
does on a failed job; the other ranks are killed, since they may wait in a
collective for the one that failed, and where rank 0 waits in one for them,
its NCCL communicators are aborted.

The harness does not use the port's launcher (``parallel/launch.py``), so
that a change to the port cannot move the benchmark.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Connection

JOIN_S = 600.0  # a rank's start: its imports, CUDA's start, the world's join
WARMUP_S = 900.0  # the warm-up job on every rank: it builds the kernels
JOB_S = 120.0  # a job of the window on every rank
REPLY_S = 60.0  # a reset of the peaks, the peaks, a rank's exit
GRACE_S = 30.0  # rank 0's own share of a job, once the others are killed
POLL_S = 0.5
COMMAND = ("-m", "kbench.ranks")  # after sys.executable


class Lost(Exception):
    """A rank died or a wait passed its limit: every rank was killed."""


class RankFailed(Exception):
    """A job raised on some rank: the other ranks were killed."""


def backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


class World:
    """Rank 0's hold on the other ranks: start them (here), join() the
    world with them, job() for each job, reset_peaks() after set-up and
    close() after the window; kill() ends every rank that is left."""

    def __init__(self, chips: int, device: str, root: str):
        import torch.distributed as dist

        self.device, self.size = device, chips
        self._store = dist.TCPStore(
            "localhost", 0, chips, True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=JOIN_S))
        self._procs, self._conns = [], []
        self._joined = self._closed = False
        self._cut = None  # why the watch killed the other ranks
        self._t0 = time.monotonic()
        for rank in range(1, chips):
            mine, theirs = socket.socketpair()
            env = dict(os.environ, FASTK_TPU_COORD=f"localhost:"
                       f"{self._store.port}", FASTK_TPU_NPROCS=str(chips),
                       FASTK_TPU_PROC=str(rank))
            try:
                proc = subprocess.Popen(
                    [sys.executable, *COMMAND, str(theirs.fileno()), device,
                     str(WARMUP_S)], cwd=root, env=env,
                    pass_fds=(theirs.fileno(),), stdin=subprocess.DEVNULL,
                    stdout=2)  # standard output is for the result alone
            except OSError:
                mine.close()
                self.kill()
                raise
            finally:
                theirs.close()
            self._procs.append(proc)
            self._conns.append(Connection(mine.detach()))

    # --- set-up -------------------------------------------------------------

    def join(self) -> None:
        """Rank 0 joins the world once every rank has started."""
        import torch
        import torch.distributed as dist

        deadline = self._t0 + JOIN_S
        self._replies("started", deadline)
        if self.device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend(self.device), store=self._store, rank=0,
            world_size=self.size,
            timeout=datetime.timedelta(seconds=WARMUP_S))
        self._joined = True
        self._replies("ready", deadline)

    def reset_peaks(self) -> None:
        self._send(("reset",))
        self._replies("reset", time.monotonic() + REPLY_S)

    # --- a job --------------------------------------------------------------

    def job(self, argv, share, limit: float) -> list:
        """One job on every rank: the others get argv, rank 0 runs
        share(). Returns each rank's seconds, rank 0's first."""
        self._send(("job", list(argv)))
        deadline = time.monotonic() + limit
        self._cut = None
        done = threading.Event()
        watch = threading.Thread(target=self._watch, args=(done, deadline),
                                 daemon=True)
        watch.start()
        t = time.perf_counter()
        err = None
        try:
            share()
        except Exception as e:  # judged with the other ranks' replies
            err = e
        mine = time.perf_counter() - t
        done.set()
        watch.join()
        own = err is not None and self._cut is None
        if own:  # the others may wait in a collective for rank 0's share
            self._end_procs()
        replies = [self._reply(c, deadline + REPLY_S) for c in self._conns]
        failed = [f"rank {r}: {msg[1]}" for r, msg in enumerate(replies, 1)
                  if msg is not None and msg[0] == "failed"]
        if own:
            failed.insert(0, f"rank 0: {err!r}")
        lost = [r for r, msg in enumerate(replies, 1) if msg is None]
        if not failed and (lost or self._cut):
            # rank 0's own error, if any, follows from the ranks it lost
            self.kill()
            raise Lost(f"a job on {self.size} ranks: {self._cut or ''} "
                       f"rank(s) {lost} gave no answer (limit {limit:.0f} s)")
        if failed:
            self.kill()
            raise RankFailed("; ".join(failed))
        return [mine] + [msg[1] for msg in replies]

    def _watch(self, done: threading.Event, deadline: float) -> None:
        """While rank 0 runs its share: a rank that exits, or the limit,
        kills the other ranks and aborts rank 0's NCCL communicators, so
        that a collective that waits for them fails (gloo's fails once their
        sockets close). A share that still has not returned GRACE_S later
        cannot be ended: the run exits with no result."""
        while not done.wait(POLL_S):
            gone = [r for r, p in enumerate(self._procs, 1)
                    if p.poll() is not None]
            if gone or time.monotonic() > deadline:
                self._cut = (f"rank(s) {gone} exited;" if gone
                             else "the limit passed;")
                self._end_procs()
                self._abort()
                if not done.wait(GRACE_S):
                    print("kbench: no result: rank 0's share of a job did "
                          "not end once the other ranks were killed",
                          file=sys.stderr, flush=True)
                    os._exit(4)
                return

    # --- after the window ---------------------------------------------------

    def close(self) -> list:
        """Each other rank's (device peak bytes, ru_maxrss bytes, JAX
        modules loaded), rank 1 first; then the world is destroyed and every
        rank has exited. [] after a failed job, whose ranks were killed."""
        import torch.distributed as dist

        if self._closed:
            return []
        deadline = time.monotonic() + REPLY_S
        self._send(("peaks",))
        peaks = self._replies("peaks", deadline)
        self._send(("exit",))
        dist.destroy_process_group()
        self._joined = False
        for r, p in enumerate(self._procs, 1):
            try:
                code = p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.kill()
                raise Lost(f"rank {r} did not exit within {REPLY_S:.0f} s")
            if code != 0:
                self.kill()
                raise Lost(f"rank {r} exited with {code}")
        self._closed = True
        self._close_conns()
        return peaks

    def kill(self) -> None:
        """Kill every rank that is left and wait for each; leave the world.
        Does nothing once the world is closed."""
        if self._closed:
            return
        self._closed = True
        self._end_procs()
        self._close_conns()
        if self._joined:
            import torch.distributed as dist

            self._joined = False
            if not dist.is_initialized():  # aborted
                return
            # a world whose other ranks are gone: its teardown may block
            leave = threading.Thread(target=dist.destroy_process_group,
                                     daemon=True)
            leave.start()
            leave.join(REPLY_S)

    def _abort(self) -> None:
        """Abort rank 0's NCCL communicators: a kernel that waits for a
        killed peer returns, and the collective raises."""
        if self.device != "cuda" or not self._joined:
            return
        from torch.distributed import distributed_c10d as c10d

        try:
            c10d._abort_process_group()
        except Exception as e:  # the grace period still bounds the share
            print(f"kbench: the abort of the world failed: {e!r}",
                  file=sys.stderr, flush=True)

    def _end_procs(self) -> None:
        """SIGKILL every other rank and wait for each."""
        for p in self._procs:
            p.kill()
        for p in self._procs:
            try:
                p.wait(REPLY_S)
            except subprocess.TimeoutExpired:
                print(f"kbench: rank process {p.pid} outlived SIGKILL by "
                      f"{REPLY_S:.0f} s", file=sys.stderr)

    # --- the control channel ------------------------------------------------

    def _send(self, msg) -> None:
        try:
            for c in self._conns:
                c.send(msg)
        except OSError as e:
            self.kill()
            raise Lost(f"a rank is gone: {e!r}") from e

    def _reply(self, conn: Connection, deadline: float):
        """The rank's next message, or None when it is gone or silent until
        the deadline."""
        try:
            if conn.poll(max(0.0, deadline - time.monotonic())):
                return conn.recv()
        except (EOFError, OSError):
            pass
        return None

    def _replies(self, kind: str, deadline: float) -> list:
        """Every other rank's next message, which has to be `kind`: their
        payloads, rank 1 first."""
        out = []
        for r, c in enumerate(self._conns, 1):
            msg = self._reply(c, deadline)
            if msg is None or msg[0] != kind:
                self.kill()
                what = "nothing" if msg is None else repr(msg)[:2000]
                raise Lost(f"rank {r} answered {what} where {kind!r} was "
                           "due")
            out.append(tuple(msg[1:]))
        return out

    def _close_conns(self) -> None:
        for c in self._conns:
            c.close()
        self._conns = []


# --- a rank -------------------------------------------------------------------

def _watch_parent() -> None:
    """Exit at once when rank 0 is gone, even inside a collective."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def main(argv=None) -> int:
    fd, device, job_s = (sys.argv[1:] if argv is None else argv)
    _watch_parent()
    conn = Connection(int(fd))
    rank = int(os.environ["FASTK_TPU_PROC"])
    size = int(os.environ["FASTK_TPU_NPROCS"])
    host, port = os.environ["FASTK_TPU_COORD"].rsplit(":", 1)

    import resource

    import torch
    import torch.distributed as dist

    from fastk_tpu_torch.tools import fastk as cli
    from kbench.run import job, loaded_forbidden

    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    conn.send(("started",))
    store = dist.TCPStore(host, int(port), size, False,
                          timeout=datetime.timedelta(seconds=JOIN_S))
    dist.init_process_group(backend(device), store=store, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=float(job_s)))
    conn.send(("ready",))
    while True:
        if not conn.poll(float(job_s)):
            return 5  # rank 0 fell silent
        try:
            msg = conn.recv()
        except EOFError:
            return 6  # rank 0 is gone
        if msg[0] == "job":
            t = time.perf_counter()
            try:
                job(cli, msg[1], device)
            except Exception as e:
                import traceback

                traceback.print_exc()
                sys.stderr.flush()
                conn.send(("failed", repr(e)))
                os._exit(1)  # peers waiting in a collective see it fail
            conn.send(("done", time.perf_counter() - t))
        elif msg[0] == "reset":
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            conn.send(("reset",))
        elif msg[0] == "peaks":
            peak = torch.cuda.max_memory_allocated() if device == "cuda" \
                else 0
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            conn.send(("peaks", peak, rss, loaded_forbidden()))
        elif msg[0] == "exit":
            dist.destroy_process_group()
            conn.close()
            return 0


if __name__ == "__main__":
    sys.exit(main())
