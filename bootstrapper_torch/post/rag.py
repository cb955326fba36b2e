"""Region adjacency graph store (SQLite); a copy of the JAX package's
``post/rag.py``.

Capability parity with funlib.persistence's SQLite graph databases as
the reference uses them for fragments/edges (reference
``bootstrapper/post/blockwise/hglom/frags.py:207-248``,
``hglom/agglom.py:108-152``, ``hglom/luts.py:93-96``): nodes carry world
-unit centers, edges carry merge scores; blocks append concurrently;
the LUT stage reads the whole graph back.

WAL mode + one short-lived connection per write keeps concurrent block
writers safe on a single host; between hosts the store-mediated design
means each host appends its own blocks' rows (ids are globally unique
by construction — block-id bumped).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Sequence, Tuple

import numpy as np

_LOCK = threading.Lock()


class RagDB:
    def __init__(self, path: str, mode: str = "r+"):
        self.path = path
        if mode == "w" and os.path.exists(path):
            os.remove(path)
        create = mode in ("w", "r+") or not os.path.exists(path)
        if create:
            with self._conn() as c:
                c.execute(
                    "CREATE TABLE IF NOT EXISTS nodes ("
                    "id INTEGER PRIMARY KEY, z REAL, y REAL, x REAL)"
                )
                c.execute(
                    "CREATE TABLE IF NOT EXISTS edges ("
                    "u INTEGER, v INTEGER, merge_score REAL, "
                    "PRIMARY KEY (u, v))"
                )
                c.execute("PRAGMA journal_mode=WAL")

    def _conn(self):
        conn = sqlite3.connect(self.path, timeout=60.0)
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    # -- writes (per block) -------------------------------------------------

    def write_nodes(self, ids: Sequence[int], centers: np.ndarray):
        rows = [
            (int(i), float(c[0]), float(c[1]), float(c[2]))
            for i, c in zip(ids, centers)
        ]
        with _LOCK, self._conn() as c:
            c.executemany(
                "INSERT OR REPLACE INTO nodes VALUES (?, ?, ?, ?)", rows
            )

    def write_edges(
        self, us: Sequence[int], vs: Sequence[int], scores: Sequence[float]
    ):
        rows = []
        for u, v, s in zip(us, vs, scores):
            a, b = (int(u), int(v)) if u < v else (int(v), int(u))
            rows.append((a, b, float(s)))
        with _LOCK, self._conn() as c:
            c.executemany(
                "INSERT INTO edges VALUES (?, ?, ?) "
                "ON CONFLICT(u, v) DO UPDATE SET merge_score="
                "MIN(merge_score, excluded.merge_score)",
                rows,
            )

    # -- reads (global) -----------------------------------------------------

    def read_nodes(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._conn() as c:
            rows = c.execute("SELECT id, z, y, x FROM nodes").fetchall()
        if not rows:
            return np.zeros(0, np.uint64), np.zeros((0, 3))
        arr = np.asarray(rows, np.float64)
        return arr[:, 0].astype(np.uint64), arr[:, 1:]

    def read_edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        with self._conn() as c:
            rows = c.execute("SELECT u, v, merge_score FROM edges").fetchall()
        if not rows:
            return (
                np.zeros(0, np.uint64),
                np.zeros(0, np.uint64),
                np.zeros(0, np.float64),
            )
        arr = np.asarray(rows, np.float64)
        return (
            arr[:, 0].astype(np.uint64),
            arr[:, 1].astype(np.uint64),
            arr[:, 2],
        )

    def counts(self) -> Tuple[int, int]:
        with self._conn() as c:
            n = c.execute("SELECT COUNT(*) FROM nodes").fetchone()[0]
            e = c.execute("SELECT COUNT(*) FROM edges").fetchone()[0]
        return n, e


class PgRagDB:
    """PostgreSQL RAG store with the same API as :class:`RagDB`.

    For multi-host segmentation where SQLite's WAL cannot be shared
    (capability parity with the reference's PgSQLGraphDatabase path,
    reference ``bootstrapper/post/blockwise/hglom/frags.py:208-233``).
    Needs ``psycopg2`` (or ``psycopg``); import is deferred so SQLite
    deployments carry no dependency.

    ``dsn``: libpq connection string or dict of psycopg kwargs;
    ``table_prefix`` keeps several RAGs in one database (the reference's
    nodes_table/edges_table config).
    """

    def __init__(self, dsn, mode: str = "r+", table_prefix: str = "rag"):
        try:
            import psycopg2 as _pg

            self._pg = _pg
        except ImportError:
            try:
                import psycopg as _pg

                self._pg = _pg
            except ImportError as e:
                raise ImportError(
                    "PgRagDB needs psycopg2 or psycopg installed"
                ) from e
        self.dsn = dsn
        self.nodes_table = f"{table_prefix}_nodes"
        self.edges_table = f"{table_prefix}_edges"
        with self._conn() as conn, conn.cursor() as cur:
            if mode == "w":
                cur.execute(f"DROP TABLE IF EXISTS {self.nodes_table}")
                cur.execute(f"DROP TABLE IF EXISTS {self.edges_table}")
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {self.nodes_table} ("
                "id BIGINT PRIMARY KEY, z DOUBLE PRECISION, "
                "y DOUBLE PRECISION, x DOUBLE PRECISION)"
            )
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {self.edges_table} ("
                "u BIGINT, v BIGINT, merge_score DOUBLE PRECISION, "
                "PRIMARY KEY (u, v))"
            )
            conn.commit()

    def _conn(self):
        if isinstance(self.dsn, dict):
            return self._pg.connect(**self.dsn)
        return self._pg.connect(self.dsn)

    @staticmethod
    def _signed(i: int) -> int:
        """uint64 ids -> BIGINT (two's complement roundtrip)."""
        i = int(i)
        return i - (1 << 64) if i >= (1 << 63) else i

    @staticmethod
    def _unsigned(i: int) -> int:
        i = int(i)
        return i + (1 << 64) if i < 0 else i

    def write_nodes(self, ids: Sequence[int], centers: np.ndarray):
        rows = [
            (self._signed(i), float(c[0]), float(c[1]), float(c[2]))
            for i, c in zip(ids, centers)
        ]
        with self._conn() as conn, conn.cursor() as cur:
            cur.executemany(
                f"INSERT INTO {self.nodes_table} VALUES (%s, %s, %s, %s) "
                "ON CONFLICT (id) DO UPDATE SET z=EXCLUDED.z, "
                "y=EXCLUDED.y, x=EXCLUDED.x",
                rows,
            )
            conn.commit()

    def write_edges(
        self, us: Sequence[int], vs: Sequence[int], scores: Sequence[float]
    ):
        rows = []
        for u, v, s in zip(us, vs, scores):
            a, b = (int(u), int(v)) if u < v else (int(v), int(u))
            rows.append((self._signed(a), self._signed(b), float(s)))
        with self._conn() as conn, conn.cursor() as cur:
            cur.executemany(
                f"INSERT INTO {self.edges_table} VALUES (%s, %s, %s) "
                "ON CONFLICT (u, v) DO UPDATE SET merge_score="
                f"LEAST({self.edges_table}.merge_score, "
                "EXCLUDED.merge_score)",
                rows,
            )
            conn.commit()

    def read_nodes(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._conn() as conn, conn.cursor() as cur:
            cur.execute(f"SELECT id, z, y, x FROM {self.nodes_table}")
            rows = cur.fetchall()
        if not rows:
            return np.zeros(0, np.uint64), np.zeros((0, 3))
        ids = np.array([self._unsigned(r[0]) for r in rows], np.uint64)
        return ids, np.array([r[1:] for r in rows], np.float64)

    def read_edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        with self._conn() as conn, conn.cursor() as cur:
            cur.execute(
                f"SELECT u, v, merge_score FROM {self.edges_table}"
            )
            rows = cur.fetchall()
        if not rows:
            return (
                np.zeros(0, np.uint64),
                np.zeros(0, np.uint64),
                np.zeros(0, np.float64),
            )
        return (
            np.array([self._unsigned(r[0]) for r in rows], np.uint64),
            np.array([self._unsigned(r[1]) for r in rows], np.uint64),
            np.array([r[2] for r in rows], np.float64),
        )

    def counts(self) -> Tuple[int, int]:
        with self._conn() as conn, conn.cursor() as cur:
            cur.execute(f"SELECT COUNT(*) FROM {self.nodes_table}")
            n = cur.fetchone()[0]
            cur.execute(f"SELECT COUNT(*) FROM {self.edges_table}")
            e = cur.fetchone()[0]
        return n, e


def open_rag(db_config: dict, mode: str = "r+"):
    """RAG store from a segment-config ``db`` table (reference
    ``get_rag_db_config`` shape, ``configs.py:131-180``): ``db_file`` ->
    SQLite; ``db_name``/``db_host`` -> PostgreSQL.

    ``table_prefix`` namespaces edge populations within one logical
    database (PostgreSQL: distinct tables). SQLite has one fixed-schema
    ``edges`` table per file, so a prefix maps to a sibling *file*
    (``rag.db`` + prefix ``rag_mws_lr`` -> ``rag.rag_mws_lr.db``) —
    otherwise ws/mws/cc pipelines sharing a ``db_file`` config would
    open the SAME file and merge (and, in ``mode='w'``, wipe) each
    other's edges."""
    if "db_file" in db_config:
        path = db_config["db_file"]
        prefix = db_config.get("table_prefix")
        if prefix:
            root, ext = os.path.splitext(path)
            path = f"{root}.{prefix}{ext or '.db'}"
        return RagDB(path, mode=mode)
    dsn = {
        k_out: db_config[k_in]
        for k_in, k_out in [
            ("db_name", "dbname"),
            ("db_host", "host"),
            ("db_user", "user"),
            ("db_password", "password"),
            ("db_port", "port"),
        ]
        if k_in in db_config
    }
    return PgRagDB(
        dsn, mode=mode, table_prefix=db_config.get("table_prefix", "rag")
    )
