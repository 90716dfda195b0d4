"""CVE JSON corpus ingestion (port of the reference harness's raw-text
stage, tests/test_2_CVE_db.py:71-128: `iter_cve_json` + `extract_text`).

The CVE 5.x record schema: metadata id under `cveMetadata.cveId`; the CNA
container carries title, language descriptions, problem-type CWE ids,
CVSS 3.1 metrics, and affected vendor/product pairs.  The searchable text
is the " | "-joined concatenation of those fields — the exact field
selection the reference embeds, so downstream embeddings are comparable.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Iterator

START_YEAR = 1999   # reference test_2_CVE_db.py:23-24
END_YEAR = 2025

_CVE_ID_YEAR = re.compile(r"CVE-(\d{4})-", re.IGNORECASE)


def _record_year(path: str, root_dir: str) -> int | None:
    """Year of a CVE file: the CVE id in the filename (CVE-YYYY-NNNN),
    else a 4-digit directory component BELOW root_dir (the cvelistV5
    cves/<year>/<prefix>/ layout).  Matching only the relative path keeps
    a year-like string in root_dir itself (e.g. /data/cve_2023_dump) from
    defeating the range filter — r3 review."""
    m = _CVE_ID_YEAR.search(os.path.basename(path))
    if m:
        return int(m.group(1))
    rel = os.path.relpath(path, root_dir)
    for part in rel.split(os.sep)[:-1]:
        if len(part) == 4 and part.isdigit():
            return int(part)
    return None


def iter_cve_json(root_dir: str, start: int = START_YEAR,
                  end: int = END_YEAR) -> Iterator[tuple[str, dict]]:
    """Yield (path, parsed_json) for every CVE JSON under root_dir whose
    record year (filename CVE id, else year directory) is in [start, end];
    files with no determinable year and unparseable files are skipped
    (the reference tolerates malformed records, test_2_CVE_db.py:71-79)."""
    for path in glob.glob(os.path.join(root_dir, "**", "*.json"),
                          recursive=True):
        year = _record_year(path, root_dir)
        if year is None or not (start <= year <= end):
            continue
        try:
            with open(path, "r", encoding="utf-8") as fh:
                yield path, json.load(fh)
        except Exception:
            continue


def _cna(record: dict) -> dict:
    return (record.get("containers") or {}).get("cna") or {}


def _descriptions(cna: dict) -> str:
    vals = []
    for d in cna.get("descriptions") or []:
        if isinstance(d, dict) and d.get("value"):
            vals.append(d["value"])
    return " ".join(vals)


def _cwe_ids(cna: dict) -> str:
    ids = []
    for pt in cna.get("problemTypes") or []:
        for d in pt.get("descriptions") or []:
            if isinstance(d, dict) and d.get("cweId"):
                ids.append(d["cweId"])
    return " ".join(ids)


def _cvss_vector(cna: dict) -> str:
    for m in cna.get("metrics") or []:
        v = m.get("cvssV3_1") if isinstance(m, dict) else None
        if isinstance(v, dict) and v.get("vectorString"):
            return v["vectorString"]
    return ""


def _products(cna: dict) -> str:
    out = []
    for a in cna.get("affected") or []:
        pair = f"{a.get('vendor') or ''} {a.get('product') or ''}".strip()
        if pair:
            out.append(pair)
    return " ".join(out)


def extract_cve_text(record: dict) -> tuple[str, str, str]:
    """(cve_id, title, searchable_text) from one CVE record — the field
    selection the reference embeds (test_2_CVE_db.py:81-128): id, title,
    descriptions, CWE ids, CVSS 3.1 vector, affected vendor/products,
    joined with ' | ' and empty fields dropped."""
    cve_id = (record.get("cveMetadata") or {}).get("cveId") or ""
    cna = _cna(record)
    title = cna.get("title") or ""
    parts = [cve_id, title, _descriptions(cna), _cwe_ids(cna),
             _cvss_vector(cna), _products(cna)]
    text = " | ".join(p for p in parts if p)
    return cve_id or "(unknown)", title or "(no title)", text


def load_cve_corpus(root_dir: str, start: int = START_YEAR,
                    end: int = END_YEAR,
                    max_records: int | None = None
                    ) -> tuple[list[str], list[str], list[str]]:
    """(ids, titles, texts) over the CVE tree, in iteration order.

    The texts feed models.embed_texts / models.hash_embed and then the
    standard x12-scaled CVE protocol (benchmarks/bench_2_corpus_tail.py).
    """
    ids, titles, texts = [], [], []
    for _, record in iter_cve_json(root_dir, start, end):
        cid, title, text = extract_cve_text(record)
        if not text:
            continue
        ids.append(cid)
        titles.append(title)
        texts.append(text)
        if max_records is not None and len(ids) >= max_records:
            break
    return ids, titles, texts
