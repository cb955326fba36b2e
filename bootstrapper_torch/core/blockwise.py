"""Blockwise task engine: ROI decomposition, wave scheduling, retries
(a copy of the JAX package's ``core/blockwise.py``; its host-only worker
environment is replaced by ``worker_env``, which only puts the repo root
on ``PYTHONPATH``).

The daisy replacement (reference usage: ``bootstrapper/predict.py:20-44``,
``post/blockwise/*``, ``data/{mask,clahe,scale_pyramid,merge}.py``).
Capabilities preserved:

- a task = total ROI + write-block size + read context; the write grid
  tiles the total ROI, reads grow each write block by the context
  (``read_roi = write_roi.grow(context)``);
- ``fit``: 'shrink' drops out-of-bounds remainder (write clipped to the
  total ROI), 'overhang' lets the write block extend past it;
- ``read_write_conflict=True`` serialises neighbouring blocks whose
  read halo overlaps others' writes via red-black (2^d-phase
  checkerboard) wave scheduling — same correctness guarantee as
  daisy's conflict ordering, but deterministic and deadlock-free;
- per-block retries (default 5, reference ``predict.py:36``) and a
  boolean outcome the callers escalate to RuntimeError;
- linear ``block_id`` in the write grid (stable across runs — used for
  block-unique fragment id bumping, ``hglom/frags.py:195-198``).

Host-side execution is a thread pool: the heavy work inside blocks is
Zarr IO, native C++ graph code and device dispatches, all of which
release the GIL. Cross-host scale-out keeps the reference's "communicate via
the store" design: stages hand off through Zarr + SQLite, so N
processes/hosts can each run a shard of the block grid (``block_stride``
/ ``block_offset``) without a central scheduler.
"""

from __future__ import annotations

import logging
import os
import socket
import sqlite3
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from .geometry import Coordinate, Roi

logger = logging.getLogger(__name__)


class Ledger:
    """SQLite completion ledger shared by cooperating processes/hosts.

    Records which (task, block_id) pairs completed, so a crashed worker's
    shard can be re-run skipping finished blocks, and so stride-sharded
    workers can barrier on global phase/stage completion by polling
    counts.  WAL mode: many readers, short writes (same pattern as the
    RAG store). The daisy analog is the central scheduler's block state,
    made store-mediated (reference ``daisy`` usage at ``predict.py:27-44``).
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with self._connect() as conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS done ("
                "task TEXT NOT NULL, block_id INTEGER NOT NULL, "
                "PRIMARY KEY (task, block_id))"
            )

    def _connect(self):
        conn = sqlite3.connect(self.path, timeout=60.0)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    def done_blocks(self, task: str) -> set:
        with self._connect() as conn:
            rows = conn.execute(
                "SELECT block_id FROM done WHERE task=?", (task,)
            ).fetchall()
        return {r[0] for r in rows}

    def mark_done(self, task: str, block_id: int):
        with self._connect() as conn:
            conn.execute(
                "INSERT OR IGNORE INTO done (task, block_id) VALUES (?, ?)",
                (task, block_id),
            )

    def count_done(self, task: str, block_ids: Optional[Sequence[int]] = None):
        with self._connect() as conn:
            if block_ids is None:
                return conn.execute(
                    "SELECT COUNT(*) FROM done WHERE task=?", (task,)
                ).fetchone()[0]
            # chunk the IN(...) list: SQLite caps bound variables
            # (999 on older builds), and end-of-stage barriers pass the
            # full block grid. Dedup first: an id repeated across two
            # chunks would be counted twice, releasing wait_for's
            # `count >= want` barrier early.
            ids = sorted({int(b) for b in block_ids})
            total = 0
            for i in range(0, len(ids), 500):
                chunk = ids[i:i + 500]
                q = ",".join("?" * len(chunk))
                total += conn.execute(
                    "SELECT COUNT(*) FROM done "
                    f"WHERE task=? AND block_id IN ({q})",
                    (task, *chunk),
                ).fetchone()[0]
            return total

    def check_geometry(self, task: str, fingerprint: int):
        """Bind ``task``'s completion rows to one block geometry.

        Ledger block ids are flat grid indices: re-running a task over a
        different total_roi/write_size/fit silently remaps them, so
        prior 'done' rows would skip blocks that now cover different
        regions. The first run records a fingerprint under a reserved
        pseudo-task; later runs must match or fail loudly.
        """
        key = f"__geom__.{task}"
        seen = self.done_blocks(key)
        if not seen:
            self.mark_done(key, fingerprint)
        elif fingerprint not in seen:
            raise ValueError(
                f"ledger already holds task {task!r} with a different "
                "block geometry (total_roi/write_size/fit changed); "
                "delete the ledger or use a new one to re-run"
            )

    def wait_for(
        self,
        task: str,
        block_ids: Sequence[int],
        timeout: float = 3600.0,
        poll: float = 0.2,
    ):
        """Block until every id in ``block_ids`` is marked done (the
        cross-process phase/stage barrier)."""
        want = len(set(int(b) for b in block_ids))
        deadline = time.monotonic() + timeout
        while True:
            if self.count_done(task, block_ids) >= want:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ledger barrier timed out: task {task!r} "
                    f"({self.count_done(task, block_ids)}/{want} blocks)"
                )
            time.sleep(poll)


class DirLedger:
    """Marker-file completion ledger for shared filesystems (NFS/Lustre).

    The SQLite Ledger above needs WAL, which is explicitly single-host;
    for multi-host runs over a shared mount this backend records one
    empty marker file per completed (task, block): creation goes through
    a worker-unique temp name + ``os.link`` (atomic on POSIX and on NFS,
    where O_EXCL historically was not), and reads are plain directory
    listings — close-to-open consistency is all the barrier loop needs.
    Same API as Ledger; ``wait_for`` is inherited behaviourally via
    ``count_done`` polling in the shared method below.
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)

    def _task_dir(self, task: str) -> str:
        return os.path.join(self.path, task.replace(os.sep, "_"))

    def done_blocks(self, task: str) -> set:
        # no mkdir here: the barrier loop polls this every 0.2s, and a
        # per-poll makedirs is a metadata op on every NFS round trip
        try:
            names = os.listdir(self._task_dir(task))
        except FileNotFoundError:
            return set()
        return {int(n) for n in names if n.isdigit()}

    def mark_done(self, task: str, block_id: int):
        d = self._task_dir(task)
        os.makedirs(d, exist_ok=True)
        final = os.path.join(d, str(int(block_id)))
        # the temp name must be unique ACROSS HOSTS, not just pids:
        # two hosts on the same mount can share a pid, and a colliding
        # tmp path lets host A's cleanup unlink host B's file between
        # B's open() and os.link(), crashing B with FileNotFoundError
        tmp = os.path.join(
            d, f".tmp.{socket.gethostname()}.{os.getpid()}.{block_id}"
        )
        with open(tmp, "w"):
            pass
        try:
            os.link(tmp, final)
        except FileExistsError:
            pass  # another worker finished the block first — fine
        finally:
            os.unlink(tmp)

    def count_done(self, task: str, block_ids: Optional[Sequence[int]] = None):
        done = self.done_blocks(task)
        if block_ids is None:
            return len(done)
        return len(done & {int(b) for b in block_ids})

    wait_for = Ledger.wait_for  # same polling barrier, over count_done
    check_geometry = Ledger.check_geometry  # same fingerprint guard


def open_ledger(path: str):
    """Ledger factory: a path ending in ``/`` or ``.d``, or an existing
    directory, selects the shared-filesystem DirLedger; anything else is
    the single-host SQLite Ledger."""
    if path.endswith(("/", ".d")) or os.path.isdir(path):
        return DirLedger(path)
    return Ledger(path)


@dataclass
class Block:
    block_id: int
    read_roi: Roi
    write_roi: Roi
    grid_index: tuple
    attempts: int = 0

    @property
    def id(self):  # daisy-compatible alias
        return self.block_id


@dataclass
class BlockwiseTask:
    name: str
    total_roi: Roi
    write_size: Coordinate
    context_neg: Coordinate
    context_pos: Coordinate
    process: Callable[[Block], object]
    fit: str = "shrink"  # 'shrink' | 'overhang'
    read_write_conflict: bool = False
    max_retries: int = 5
    num_workers: int = 8
    # shard the grid across cooperating processes/hosts (store-mediated)
    block_stride: int = 1
    block_offset: int = 0
    # race detection: audit that no concurrently-running blocks overlap
    # write/write (always a bug) or read/write (when conflicts declared);
    # violations fail the task (the reference has no such check — its
    # correctness was by construction only, SURVEY §5)
    audit: bool = False
    # fault injection: probability that a block raises on each attempt
    # (exercises the retry ledger; used by tests/chaos runs)
    inject_fault_rate: float = 0.0
    # completion ledger (SQLite path): completed blocks are recorded and
    # skipped on re-runs; with stride sharding it also provides the
    # cross-process phase barrier for read-write-conflict tasks
    ledger: Optional[str] = None
    barrier_timeout: float = 3600.0

    def all_blocks(self) -> list:
        """The full write grid, ignoring stride sharding."""
        stride, self.block_stride = self.block_stride, 1
        try:
            return self.blocks()
        finally:
            self.block_stride = stride

    def blocks(self) -> list:
        """Enumerate the write grid with block ids and grown read ROIs."""
        total = self.total_roi
        ws = Coordinate(self.write_size)
        counts = []
        for b, e, s in zip(total.begin, total.end, ws):
            n = max(1, -(-(e - b) // s))
            counts.append(n)
        blocks = []
        for flat in range(int(np.prod(counts))):
            idx = []
            rem = flat
            for n in reversed(counts):
                idx.append(rem % n)
                rem //= n
            idx = tuple(reversed(idx))
            begin = Coordinate(
                b + i * s for b, i, s in zip(total.begin, idx, ws)
            )
            write = Roi(begin, ws)
            if self.fit == "shrink":
                write = write.intersect(total)
                if write.empty:
                    continue
            elif self.fit != "overhang":
                raise ValueError(f"unknown fit {self.fit!r}")
            read = write.grow(self.context_neg, self.context_pos)
            blocks.append(Block(flat, read, write, idx))
        if self.block_stride > 1:
            blocks = [
                b
                for b in blocks
                if b.block_id % self.block_stride == self.block_offset
            ]
        return blocks

    def _phases(self, blocks: list) -> list:
        """Group blocks into conflict-free waves.

        Without conflicts: one wave. With read-write conflicts: blocks
        are binned by grid index modulo the conflict REACH per dimension
        with nonzero context — two same-wave blocks along a conflict dim
        are always separated by more grid steps than the context spans,
        so their read/write ROIs cannot overlap.  For the common case
        (context <= write size) this is exactly red-black parity; larger
        contexts get proportionally more waves (plain mod-2 would race
        same-parity blocks two steps apart whose context reaches across
        the intervening block).
        """
        if not self.read_write_conflict:
            return [blocks]
        wsize = self.write_size
        mods = []
        for d in range(self.total_roi.dims):
            ctx = max(self.context_neg[d], self.context_pos[d])
            if ctx > 0:
                mods.append((d, 1 + -(-ctx // wsize[d])))
        if not mods:
            return [blocks]
        phases: dict = {}
        for b in blocks:
            key = tuple(b.grid_index[d] % k for d, k in mods)
            phases.setdefault(key, []).append(b)
        return [phases[k] for k in sorted(phases)]


@dataclass
class TaskResult:
    task: str
    total_blocks: int
    succeeded: int
    failed: int
    skipped: int
    seconds: float
    errors: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.failed == 0


def run_blockwise(
    task: BlockwiseTask,
    progress_every: float = 10.0,
) -> TaskResult:
    """Execute all blocks with retries and wave scheduling.

    With a ledger, completed blocks are skipped on re-runs and each
    completion is recorded.  With stride sharding *and* read-write
    conflicts, every process works through the same global wave order and
    barriers on the ledger between waves, so neighbouring blocks never
    run concurrently across processes either."""
    full = task.all_blocks()
    phases = task._phases(full)
    sharded = task.block_stride > 1
    ledger = open_ledger(task.ledger) if task.ledger else None
    if sharded and task.read_write_conflict and ledger is None:
        raise ValueError(
            f"task {task.name!r}: stride-sharded read-write-conflict "
            "tasks need a ledger for the cross-process wave barrier"
        )
    if ledger is not None:
        import zlib

        fp = zlib.crc32(
            repr((
                tuple(task.total_roi.offset), tuple(task.total_roi.shape),
                tuple(task.write_size), task.fit,
            )).encode()
        )
        ledger.check_geometry(task.name, fp)
    prior = ledger.done_blocks(task.name) if ledger else set()
    t0 = time.perf_counter()
    n_total = sum(
        1
        for b in full
        if not sharded or b.block_id % task.block_stride == task.block_offset
    )
    done = 0
    failed = 0
    skipped = 0
    errors: list = []
    lock = threading.Lock()
    last_log = [t0]
    active: dict = {}  # block_id -> (read_roi, write_roi), audit mode
    violations: list = []
    fault_rng = np.random.default_rng(0)

    def _audit_enter(block):
        with lock:
            for bid, (r, w) in active.items():
                if block.write_roi.intersects(w):
                    violations.append(
                        ("write/write", block.block_id, bid)
                    )
                if task.read_write_conflict and (
                    block.read_roi.intersects(w)
                    or r.intersects(block.write_roi)
                ):
                    violations.append(
                        ("read/write", block.block_id, bid)
                    )
            active[block.block_id] = (block.read_roi, block.write_roi)

    def _audit_exit(block):
        with lock:
            active.pop(block.block_id, None)

    def run_block(block: Block):
        nonlocal done, failed, skipped
        for attempt in range(task.max_retries + 1):
            try:
                if task.inject_fault_rate > 0:
                    with lock:
                        roll = fault_rng.uniform()
                    if roll < task.inject_fault_rate:
                        raise RuntimeError(
                            f"injected fault (block {block.block_id})"
                        )
                if task.audit:
                    _audit_enter(block)
                try:
                    result = task.process(block)
                finally:
                    if task.audit:
                        _audit_exit(block)
                if ledger is not None:
                    ledger.mark_done(task.name, block.block_id)
                with lock:
                    # isinstance guard: process may return a numpy array,
                    # whose == against a str is an elementwise comparison
                    if isinstance(result, str) and result == "skipped":
                        skipped += 1
                    else:
                        done += 1
                    now = time.perf_counter()
                    if now - last_log[0] > progress_every:
                        last_log[0] = now
                        logger.info(
                            "%s: %d/%d blocks (%.1fs)",
                            task.name, done + failed + skipped,
                            n_total, now - t0,
                        )
                return
            except Exception as e:  # retry
                block.attempts = attempt + 1
                if attempt == task.max_retries:
                    with lock:
                        failed += 1
                        errors.append((block.block_id, repr(e)))
                    logger.error(
                        "%s: block %d failed after %d attempts: %r",
                        task.name, block.block_id, attempt + 1, e,
                    )
                    return
                logger.warning(
                    "%s: block %d attempt %d failed: %r",
                    task.name, block.block_id, attempt + 1, e,
                )

    # report against the full per-shard grid even when an early-phase
    # failure breaks out of the wave loop below
    n_blocks = n_total
    for phase in phases:
        mine = [
            b
            for b in phase
            if not sharded
            or b.block_id % task.block_stride == task.block_offset
        ]
        todo = [b for b in mine if b.block_id not in prior]
        skipped += len(mine) - len(todo)
        with ThreadPoolExecutor(max_workers=task.num_workers) as pool:
            list(pool.map(run_block, todo))
        if failed:
            break  # don't barrier on blocks this process failed to finish
        if ledger is not None and sharded and task.read_write_conflict:
            ledger.wait_for(
                task.name,
                [b.block_id for b in phase],
                timeout=task.barrier_timeout,
            )

    if ledger is not None and sharded and not failed:
        # end-of-stage barrier: downstream stages read this stage's full
        # output, so wait for every shard's blocks
        ledger.wait_for(
            task.name,
            [b.block_id for b in full],
            timeout=task.barrier_timeout,
        )

    if task.audit and violations:
        raise RuntimeError(
            f"blockwise race audit failed for {task.name!r}: "
            f"{len(violations)} overlap(s), e.g. {violations[:3]}"
        )
    return TaskResult(
        task.name,
        n_blocks,
        done,
        failed,
        skipped,
        time.perf_counter() - t0,
        errors,
    )


def worker_env(base: Optional[dict] = None) -> dict:
    """Subprocess environment for sharded workers: the caller's, with the
    repo root on ``PYTHONPATH`` so workers import the package from any
    working directory.  Nothing else changes: a worker computes where its
    caller asked (seeds on the card unless ``"cpu"`` was asked for)."""
    env = dict(os.environ if base is None else base)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parts = [os.path.dirname(pkg_root)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p
    ]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


def run_sharded_subprocesses(
    make_argv: Callable[[int, int], List[str]],
    num_workers: int,
    max_restarts: int = 2,
    env: Optional[dict] = None,
    poll: float = 0.5,
) -> None:
    """Crash-isolated multi-process runner (the daisy worker-pool analog,
    reference ``bootstrapper/predict.py:27-50``).

    Spawns ``num_workers`` subprocesses, worker *i* running
    ``make_argv(i, num_workers)`` — typically the same CLI command with
    ``block_offset=i`` / ``block_stride=num_workers`` and a shared
    ledger.  A worker that dies (crash, segfault, OOM-kill) is respawned
    up to ``max_restarts`` times; the ledger makes the re-run skip
    completed blocks.  Raises if any shard ultimately fails."""
    procs = {}
    restarts = {i: 0 for i in range(num_workers)}
    failed = {}

    def spawn(i):
        argv = make_argv(i, num_workers)
        logger.info("worker %d: spawning %s", i, argv)
        procs[i] = subprocess.Popen(argv, env=env)

    for i in range(num_workers):
        spawn(i)
    try:
        while procs:
            time.sleep(poll)
            for i, p in list(procs.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del procs[i]
                if rc == 0:
                    continue
                if restarts[i] < max_restarts:
                    restarts[i] += 1
                    logger.warning(
                        "worker %d exited rc=%d; restart %d/%d",
                        i, rc, restarts[i], max_restarts,
                    )
                    spawn(i)
                else:
                    failed[i] = rc
            if failed:
                break  # kill remaining workers: they may barrier-wait on
                # blocks the failed shard will never finish
    finally:
        for p in procs.values():
            p.terminate()
    if failed:
        raise RuntimeError(
            f"sharded workers failed after retries: {failed} "
            f"(restarts: { {i: n for i, n in restarts.items() if n} })"
        )


def run_blockwise_or_raise(task: BlockwiseTask, **kw) -> TaskResult:
    """Reference behaviour: boolean outcome escalated to RuntimeError
    (``predict.py:40-44``, ``filter_segmentation.py:263-266``)."""
    result = run_blockwise(task, **kw)
    if not result.ok:
        raise RuntimeError(
            f"blockwise task {task.name!r} failed on "
            f"{result.failed}/{result.total_blocks} blocks: "
            f"{result.errors[:5]}"
        )
    return result
