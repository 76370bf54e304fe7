"""SQLite database generators (snps2sqlite, snpm2sqlite, de2sqlite,
psl2sqlite), the port's copy of kit4b_tpu/tools/tosqlite.py (host only,
standard library sqlite3; tests/test_torch_rehomed.py holds it equal to
the original statement for statement): the reference's 7-table SNP and
marker layout, with DE and PSL result tables of their own.
"""
from __future__ import annotations

import csv
import sqlite3

_SNP_SCHEMA = """
CREATE TABLE IF NOT EXISTS TblExprs (
  ExprID INTEGER PRIMARY KEY ASC, ExprType INTEGER,
  ExprInFile VARCHAR(200), ExprName VARCHAR(50) UNIQUE,
  ExprDescr VARCHAR(200));
CREATE TABLE IF NOT EXISTS TblCults (
  CultID INTEGER PRIMARY KEY ASC, CultName VARCHAR(50) UNIQUE);
CREATE TABLE IF NOT EXISTS TblSeqs (
  SeqID INTEGER PRIMARY KEY ASC, SeqName VARCHAR(80) UNIQUE);
CREATE TABLE IF NOT EXISTS TblLoci (
  LociID INTEGER PRIMARY KEY ASC, SeqID INTEGER, Loci INTEGER,
  RefBase CHAR(1), UNIQUE(SeqID, Loci));
CREATE TABLE IF NOT EXISTS TblSnps (
  SnpID INTEGER PRIMARY KEY ASC, ExprID INTEGER, CultID INTEGER,
  LociID INTEGER, Bases INTEGER, Mismatches INTEGER, PValue REAL,
  CntA INTEGER, CntC INTEGER, CntG INTEGER, CntT INTEGER, CntN INTEGER);
CREATE TABLE IF NOT EXISTS TblMarkers (
  MarkerID INTEGER PRIMARY KEY ASC, ExprID INTEGER, LociID INTEGER,
  CultID INTEGER, CultBase CHAR(1), Score INTEGER);
CREATE TABLE IF NOT EXISTS TblMarkerSnps (
  MarkerSnpID INTEGER PRIMARY KEY ASC, MarkerID INTEGER, SnpID INTEGER);
"""


def _expr(cur, name, descr, infile, etype) -> int:
    cur.execute("INSERT OR IGNORE INTO TblExprs "
                "(ExprType, ExprInFile, ExprName, ExprDescr) "
                "VALUES (?,?,?,?)", (etype, str(infile), name, descr))
    return cur.execute("SELECT ExprID FROM TblExprs WHERE ExprName=?",
                       (name,)).fetchone()[0]


def _row_id(cur, table, idcol, namecol, val) -> int:
    cur.execute(f"INSERT OR IGNORE INTO {table} ({namecol}) VALUES (?)",
                (val,))
    return cur.execute(f"SELECT {idcol} FROM {table} WHERE {namecol}=?",
                       (val,)).fetchone()[0]


def snps_to_sqlite(csv_in, db_out, *, experiment="exp", descr="",
                   cultivar="readset") -> int:
    """kalign SNP CSV -> 7-table DB (snps2sqlite, ExprType=1)."""
    from .snpsfmt import read_snps_csv
    snps = read_snps_csv(csv_in)
    con = sqlite3.connect(db_out)
    cur = con.cursor()
    cur.executescript(_SNP_SCHEMA)
    eid = _expr(cur, experiment, descr, csv_in, 1)
    cid = _row_id(cur, "TblCults", "CultID", "CultName", cultivar)
    for s in snps:
        sid = _row_id(cur, "TblSeqs", "SeqID", "SeqName", s["chrom"])
        cur.execute("INSERT OR IGNORE INTO TblLoci (SeqID, Loci, RefBase) "
                    "VALUES (?,?,?)", (sid, s["loci"], s["ref"]))
        lid = cur.execute("SELECT LociID FROM TblLoci WHERE SeqID=? AND "
                          "Loci=?", (sid, s["loci"])).fetchone()[0]
        cur.execute("INSERT INTO TblSnps (ExprID, CultID, LociID, Bases, "
                    "Mismatches, PValue, CntA, CntC, CntG, CntT, CntN) "
                    "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                    (eid, cid, lid, s["bases"], s["mm"], s["pvalue"],
                     *s["counts"]))
    con.commit()
    con.close()
    return len(snps)


def markers_to_sqlite(csv_in, db_out, *, experiment="exp",
                      descr="") -> int:
    """snpmarkers CSV -> marker tables (snpm2sqlite, ExprType=0). Expects
    the kmer/snpmarkers.py CSV layout (Chrom, Loci, RefBase, then
    per-cultivar base/score column pairs)."""
    con = sqlite3.connect(db_out)
    cur = con.cursor()
    cur.executescript(_SNP_SCHEMA)
    eid = _expr(cur, experiment, descr, csv_in, 0)
    n = 0
    with open(csv_in, newline="") as f:
        rd = csv.DictReader(f)
        culti = [c for c in rd.fieldnames
                 if c not in ("Chrom", "Loci", "RefBase")
                 and not c.endswith("_Score")]
        for row in rd:
            sid = _row_id(cur, "TblSeqs", "SeqID", "SeqName", row["Chrom"])
            cur.execute("INSERT OR IGNORE INTO TblLoci "
                        "(SeqID, Loci, RefBase) VALUES (?,?,?)",
                        (sid, int(row["Loci"]), row.get("RefBase", "N")))
            lid = cur.execute(
                "SELECT LociID FROM TblLoci WHERE SeqID=? AND Loci=?",
                (sid, int(row["Loci"]))).fetchone()[0]
            for c in culti:
                cid = _row_id(cur, "TblCults", "CultID", "CultName", c)
                score = int(float(row.get(f"{c}_Score", 0) or 0))
                cur.execute("INSERT INTO TblMarkers (ExprID, LociID, "
                            "CultID, CultBase, Score) VALUES (?,?,?,?,?)",
                            (eid, lid, cid, row[c], score))
                n += 1
    con.commit()
    con.close()
    return n


def de_to_sqlite(csv_in, db_out, *, experiment="exp", descr="") -> int:
    """rnade/gendeseq DE CSV -> TblDE (de2sqlite)."""
    con = sqlite3.connect(db_out)
    cur = con.cursor()
    cur.executescript(_SNP_SCHEMA)
    cur.execute("CREATE TABLE IF NOT EXISTS TblDE ("
                "DEID INTEGER PRIMARY KEY ASC, ExprID INTEGER, "
                "Feature VARCHAR(80), Classification VARCHAR(30), "
                "FoldChange REAL, PearsonCtrl REAL, PearsonExpr REAL)")
    eid = _expr(cur, experiment, descr, csv_in, 2)
    n = 0
    with open(csv_in, newline="") as f:
        for row in csv.DictReader(f):
            feat = (row.get("Feature") or row.get("Feat")
                    or next(iter(row.values())))
            cur.execute("INSERT INTO TblDE (ExprID, Feature, "
                        "Classification, FoldChange, PearsonCtrl, "
                        "PearsonExpr) VALUES (?,?,?,?,?,?)",
                        (eid, feat, row.get("Classification", ""),
                         float(row.get("FoldChange", 0) or 0),
                         float(row.get("PearsonCtrl", 0) or 0),
                         float(row.get("PearsonExpr", 0) or 0)))
            n += 1
    con.commit()
    con.close()
    return n


def psl_to_sqlite(psl_in, db_out, *, experiment="exp", descr="") -> int:
    """blitz PSL -> TblAlignments (psl2sqlite, CSQLitePSL role)."""
    con = sqlite3.connect(db_out)
    cur = con.cursor()
    cur.executescript(_SNP_SCHEMA)
    cur.execute("CREATE TABLE IF NOT EXISTS TblAlignments ("
                "AlignID INTEGER PRIMARY KEY ASC, ExprID INTEGER, "
                "QName VARCHAR(80), QStart INTEGER, QEnd INTEGER, "
                "TName VARCHAR(80), TStart INTEGER, TEnd INTEGER, "
                "Strand CHAR(1), Matches INTEGER, Mismatches INTEGER)")
    eid = _expr(cur, experiment, descr, psl_in, 3)
    n = 0
    with open(psl_in) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")
            if len(p) < 17 or not p[0].isdigit():
                continue
            cur.execute("INSERT INTO TblAlignments (ExprID, QName, QStart, "
                        "QEnd, TName, TStart, TEnd, Strand, Matches, "
                        "Mismatches) VALUES (?,?,?,?,?,?,?,?,?,?)",
                        (eid, p[9], int(p[11]), int(p[12]), p[13],
                         int(p[15]), int(p[16]), p[8], int(p[0]),
                         int(p[1])))
            n += 1
    con.commit()
    con.close()
    return n
