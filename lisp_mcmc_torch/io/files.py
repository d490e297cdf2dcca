"""Lab-data file ingestion (reference C16, mcmc-fitting.lisp:1376-1488).

Rebuilds:
  - ``get-filename`` (1384): recursive directory walk with include/exclude
    substring filters.
  - ``file->file-specs`` (1425-1440): header autodetection (first numeric
    line), blank-line page separation, Windows ``\\r`` trimming (1429).
  - ``read-file->data`` (1452-1477): delimited numeric read, transposed to
    column-major, with multi-page (3-D) option (1442-1450).
  - delimiter auto-sniffing (1412-1423): tab default, then ``;``, ``,``,
    whitespace.

The reference's example-data.xls is actually a tab-separated text file
with one header line (SURVEY §0); that file is the golden fixture for
these readers.
"""

from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np

__all__ = ["get_filename", "file_specs", "read_file_data"]

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$")
_CANDIDATE_DELIMS = ("\t", ";", ",", None)  # None = any whitespace


def get_filename(directory: str = ".", include: Sequence[str] = (), exclude: Sequence[str] = ()):
    """Recursive file search with substring filters (``get-filename``, 1384).

    Returns paths under ``directory`` whose *filename* contains every
    string in ``include`` and none in ``exclude``.
    """
    include = [include] if isinstance(include, str) else list(include)
    exclude = [exclude] if isinstance(exclude, str) else list(exclude)
    matches = []
    for root, _dirs, files in os.walk(directory):
        for name in sorted(files):
            if all(s in name for s in include) and not any(s in name for s in exclude):
                matches.append(os.path.join(root, name))
    return sorted(matches)


def _split(line: str, delim):
    return line.split(delim) if delim is not None else line.split()


def _is_numeric_row(fields) -> bool:
    if not fields:
        return False
    return all(_NUM_RE.match(f.strip()) for f in fields if f.strip() != "") and any(
        f.strip() for f in fields
    )


def _parse_number(tok: str) -> float:
    # Fortran/Lisp-style exponents: 1d-5 / 1D-5 -> 1e-5.
    return float(tok.strip().replace("d", "e").replace("D", "E"))


def file_specs(path: str, delim=None):
    """Probe a data file's shape (``file->file-specs``, 1425-1440).

    Returns ``{"delim", "header_lines", "columns", "pages"}`` where
    ``header_lines`` is the index of the first numeric line, ``columns``
    the field count of that line, and ``pages`` the number of blank-line
    separated blocks.
    """
    with open(path, "r", errors="replace") as f:
        lines = [ln.rstrip("\r\n") for ln in f]
    if delim is None:
        # Sniff: pick the delimiter yielding the most numeric columns on
        # the first numeric-looking line (tab preferred, 1452's default).
        best, best_cols = "\t", 0
        for cand in _CANDIDATE_DELIMS:
            for ln in lines[:50]:
                fields = [t for t in _split(ln, cand) if t.strip()]
                if len(fields) >= 1 and _is_numeric_row(fields):
                    if len(fields) > best_cols:
                        best, best_cols = cand, len(fields)
                    break
        delim = best
    header_lines = 0
    columns = 0
    for i, ln in enumerate(lines):
        fields = [t for t in _split(ln, delim) if t.strip()]
        if fields and _is_numeric_row(fields):
            header_lines = i
            columns = len(fields)
            break
    pages = 1
    in_blank = False
    for ln in lines[header_lines:]:
        if not ln.strip():
            in_blank = True
        elif in_blank:
            pages += 1
            in_blank = False
    return {"delim": delim, "header_lines": header_lines, "columns": columns, "pages": pages}


def read_file_data(path: str, delim=None, pages: bool = False):
    """Read a delimited numeric file into columns (``read-file->data``, 1452-1477).

    Returns a list of column arrays (the reference's transposed layout,
    ready for :func:`~lisp_mcmc_torch.data.create_walker_data`).  With
    ``pages=True``, returns a list of such column lists, one per
    blank-line separated page (the 3-D option, 1442-1450).
    """
    specs = file_specs(path, delim)
    delim = specs["delim"]
    with open(path, "r", errors="replace") as f:
        lines = [ln.rstrip("\r\n") for ln in f]

    page_rows: list[list[list[float]]] = [[]]
    for ln in lines[specs["header_lines"]:]:
        if not ln.strip():
            if page_rows[-1]:
                page_rows.append([])
            continue
        fields = [t for t in _split(ln, delim) if t.strip()]
        if not _is_numeric_row(fields):
            continue
        page_rows[-1].append([_parse_number(t) for t in fields])
    if not page_rows[-1]:
        page_rows.pop()

    def to_columns(rows):
        if not rows:
            return []
        # Keep the file's MODAL row width and drop ragged rows: slicing
        # everything to the minimum width silently deleted a whole
        # column when one row was missing a trailing field.
        from collections import Counter

        ncols = Counter(len(r) for r in rows).most_common(1)[0][0]
        kept = [r[:ncols] for r in rows if len(r) >= ncols]
        arr = np.asarray(kept, dtype=np.float64)
        return [arr[:, j] for j in range(ncols)]

    if pages:
        return [to_columns(rows) for rows in page_rows]
    all_rows = [r for rows in page_rows for r in rows]
    return to_columns(all_rows)
