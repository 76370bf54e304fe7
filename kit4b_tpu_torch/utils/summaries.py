"""SQLite experiment-summary database (CSQLiteSummaries parity), the
port's own copy of kit4b_tpu/utils/summaries.py.

The reference records every subprocess run — experiment, process,
processing instance, parameters, results, and log lines — into a summaries
database selected with `-q sumrslts -w experiment -W description`
(ngskit4b/SQLiteSummaries.cpp:271-355; wired into every entry point, e.g.
kit4bax.cpp:251-260). Same table roles here via the stdlib sqlite3 module:

  TblExprs       experiments (name, description, created)
  TblProcess     process types (subcommand name, version)
  TblProcessing  one row per run instance (experiment, process, start/end)
  TblParams      per-run parameter name/value pairs
  TblResults     per-run result name/value pairs
  TblProcessingLog  per-run log lines
"""
from __future__ import annotations

import sqlite3
import time

SCHEMA = """
CREATE TABLE IF NOT EXISTS TblExprs (
  ExprID INTEGER PRIMARY KEY, ExprName TEXT UNIQUE, ExprDescr TEXT,
  Created REAL);
CREATE TABLE IF NOT EXISTS TblProcess (
  ProcessID INTEGER PRIMARY KEY, ProcessName TEXT UNIQUE, Version TEXT);
CREATE TABLE IF NOT EXISTS TblProcessing (
  ProcessingID INTEGER PRIMARY KEY, ExprID INTEGER, ProcessID INTEGER,
  Started REAL, Finished REAL, ExitCode INTEGER);
CREATE TABLE IF NOT EXISTS TblParams (
  ParamID INTEGER PRIMARY KEY, ProcessingID INTEGER, ParamName TEXT,
  ParamValue TEXT);
CREATE TABLE IF NOT EXISTS TblResults (
  ResultID INTEGER PRIMARY KEY, ProcessingID INTEGER, ResultName TEXT,
  ResultValue TEXT);
CREATE TABLE IF NOT EXISTS TblProcessingLog (
  LogID INTEGER PRIMARY KEY, ProcessingID INTEGER, LogTime REAL,
  LogText TEXT);
"""


class Summaries:
    """One run's recording handle (gSQLiteSummaries equivalent)."""

    def __init__(self, path, experiment: str = "exp",
                 descr: str = "", process: str = "run",
                 version: str = ""):
        self._db = sqlite3.connect(path)
        self._db.executescript(SCHEMA)
        cur = self._db.execute(
            "INSERT OR IGNORE INTO TblExprs (ExprName, ExprDescr, Created) "
            "VALUES (?,?,?)", (experiment, descr, time.time()))
        self._expr = self._db.execute(
            "SELECT ExprID FROM TblExprs WHERE ExprName=?",
            (experiment,)).fetchone()[0]
        self._db.execute(
            "INSERT OR IGNORE INTO TblProcess (ProcessName, Version) "
            "VALUES (?,?)", (process, version))
        self._proc = self._db.execute(
            "SELECT ProcessID FROM TblProcess WHERE ProcessName=?",
            (process,)).fetchone()[0]
        cur = self._db.execute(
            "INSERT INTO TblProcessing (ExprID, ProcessID, Started) "
            "VALUES (?,?,?)", (self._expr, self._proc, time.time()))
        self.processing_id = cur.lastrowid
        self._db.commit()

    def params(self, **kv) -> None:
        self._db.executemany(
            "INSERT INTO TblParams (ProcessingID, ParamName, ParamValue) "
            "VALUES (?,?,?)",
            [(self.processing_id, k, str(v)) for k, v in kv.items()])
        self._db.commit()

    def results(self, **kv) -> None:
        self._db.executemany(
            "INSERT INTO TblResults (ProcessingID, ResultName, ResultValue) "
            "VALUES (?,?,?)",
            [(self.processing_id, k, str(v)) for k, v in kv.items()])
        self._db.commit()

    def log(self, text: str) -> None:
        self._db.execute(
            "INSERT INTO TblProcessingLog (ProcessingID, LogTime, LogText) "
            "VALUES (?,?,?)", (self.processing_id, time.time(), text))
        self._db.commit()

    def finish(self, exit_code: int = 0) -> None:
        self._db.execute(
            "UPDATE TblProcessing SET Finished=?, ExitCode=? "
            "WHERE ProcessingID=?",
            (time.time(), exit_code, self.processing_id))
        self._db.commit()
        self._db.close()
