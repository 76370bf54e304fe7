"""GO term association inferencing, the port's copy of kit4b_tpu/tools/go.py
(host only; tests/test_torch_rehomed.py holds it equal to the original
statement for statement): an OBO parser, GAF or two-column gene
associations, propagation up the is_a DAG, and sample-against-population
term enrichment by the one-sided hypergeometric tail (scipy's
`hypergeom.sf`) with Benjamini-Hochberg FDR.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.stats import hypergeom


@dataclass
class GOTerm:
    goid: str
    name: str = ""
    namespace: str = ""
    parents: list = field(default_factory=list)   # is_a
    obsolete: bool = False


def parse_obo(path) -> dict[str, GOTerm]:
    """Minimal OBO parser: [Term] stanzas, id/name/namespace/is_a/alt_id."""
    terms: dict[str, GOTerm] = {}
    cur = None
    alt: list[tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line == "[Term]":
                cur = GOTerm("")
                continue
            if line.startswith("[") and line != "[Term]":
                cur = None
                continue
            if cur is None or not line:
                continue
            if line.startswith("id:"):
                cur.goid = line[3:].strip()
                terms[cur.goid] = cur
            elif line.startswith("name:"):
                cur.name = line[5:].strip()
            elif line.startswith("namespace:"):
                cur.namespace = line[10:].strip()
            elif line.startswith("is_a:"):
                cur.parents.append(line[5:].split("!")[0].strip())
            elif line.startswith("alt_id:"):
                alt.append((line[7:].strip(), cur.goid))
            elif line.startswith("is_obsolete: true"):
                cur.obsolete = True
    for a, primary in alt:
        terms.setdefault(a, terms[primary])
    return terms


def parse_associations(path) -> dict[str, set]:
    """gene -> set(GO ids). Accepts GAF 2.x (tab, 17 cols, gene in col 3,
    GO id in col 5) or 2-column CSV/TSV (gene, goid)."""
    out: dict[str, set] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("!") or not line.strip():
                continue
            p = line.rstrip("\n").split("\t")
            if len(p) >= 5 and p[4].startswith("GO:"):
                gene, goid = p[2], p[4]
            else:
                q = line.replace(",", "\t").split("\t")
                if len(q) < 2:
                    continue
                gene, goid = q[0].strip().strip('"'), q[1].strip().strip('"')
            out.setdefault(gene, set()).add(goid)
    return out


def propagate(assoc: dict[str, set], terms: dict[str, GOTerm]
              ) -> dict[str, set]:
    """Annotations imply all is_a ancestors (GOTerms DAG roll-up)."""
    anc_cache: dict[str, set] = {}

    def ancestors(goid: str) -> set:
        if goid in anc_cache:
            return anc_cache[goid]
        seen = set()
        stack = [goid]
        while stack:
            t = terms.get(stack.pop())
            if t is None:
                continue
            for pa in t.parents:
                if pa not in seen:
                    seen.add(pa)
                    stack.append(pa)
        anc_cache[goid] = seen
        return seen

    out = {}
    for gene, gos in assoc.items():
        full = set(gos)
        for g in gos:
            full |= ancestors(g)
        out[gene] = full
    return out


@dataclass
class Enrichment:
    goid: str
    name: str
    sample_hits: int
    sample_n: int
    pop_hits: int
    pop_n: int
    pvalue: float
    fdr: float = 1.0


def enrich(sample_genes, population_genes, assoc: dict[str, set],
           terms: dict[str, GOTerm] | None = None,
           *, min_hits: int = 2) -> list[Enrichment]:
    """One-sided Fisher (hypergeometric tail) per term + BH FDR."""
    sample = [g for g in set(sample_genes) if g in assoc]
    pop = [g for g in set(population_genes) | set(sample) if g in assoc]
    N, n = len(pop), len(sample)
    per_term_pop: dict[str, int] = {}
    per_term_sample: dict[str, int] = {}
    sset = set(sample)
    for gene in pop:
        for goid in assoc[gene]:
            per_term_pop[goid] = per_term_pop.get(goid, 0) + 1
            if gene in sset:
                per_term_sample[goid] = per_term_sample.get(goid, 0) + 1
    rows = []
    for goid, k in per_term_sample.items():
        if k < min_hits:
            continue
        K = per_term_pop[goid]
        p = float(hypergeom.sf(k - 1, N, K, n))
        name = terms[goid].name if terms and goid in terms else ""
        rows.append(Enrichment(goid, name, k, n, K, N, p))
    rows.sort(key=lambda r: r.pvalue)
    m = len(rows)
    # Benjamini-Hochberg (monotone)
    prev = 1.0
    for i in range(m - 1, -1, -1):
        q = min(prev, rows[i].pvalue * m / (i + 1))
        rows[i].fdr = q
        prev = q
    return rows


def write_enrichment_csv(path, rows: list[Enrichment]) -> None:
    with open(path, "w") as f:
        f.write('"GOID","Name","SampleHits","SampleN","PopHits","PopN",'
                '"PValue","FDR"\n')
        for r in rows:
            f.write(f'"{r.goid}","{r.name}",{r.sample_hits},{r.sample_n},'
                    f'{r.pop_hits},{r.pop_n},{r.pvalue:.6g},{r.fdr:.6g}\n')
