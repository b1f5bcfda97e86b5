"""Text data loading (CSV / TSV / LibSVM).

Counterpart of ``lightgbm_tpu/io/parser.py`` (reference: src/io/parser.cpp
``Parser::CreateParser`` format detection, src/io/dataset_loader.cpp label /
weight / group column extraction), on the NumPy path the JAX package takes
when its native C++ parser is not built, so the same file gives the same
float64 values bit for bit (NaN where a field is empty or unparsable).

The file is read as newline-aligned byte-range stripes
(:func:`iter_stripe_texts`), never whole: format detection reads the first
line, and each stripe is parsed on its own.  ``label_column`` /
``weight_column`` / ``group_column`` take an index or ``name:<header
name>`` (with ``header=true``); ``ignore_column`` is accepted and ignored,
as in the JAX package.  Companion files ``<data>.weight`` / ``.query`` /
``.group`` / ``.init`` / ``.position`` fill what the columns did not.
LibSVM indices are kept as written (1-based files leave column 0 all
zeros), as the JAX package keeps them.
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils import log

#: byte-range stripe size: the parse unit; peak parser memory is O(stripe)
STRIPE_BYTES = 16 << 20


def read_first_line(path: str) -> str:
    """The first line only: all format detection needs."""
    with open(path) as f:
        return f.readline()


def _detect_format(first_line: str) -> str:
    toks = first_line.strip().split()
    if any(":" in t for t in toks[1:]):
        return "libsvm"
    if "\t" in first_line:
        return "tsv"
    return "csv"


def _parse_column_spec(spec, header_names) -> Optional[int]:
    if spec is None or spec == "":
        return None
    s = str(spec)
    if s.startswith("name:"):
        name = s[5:]
        if header_names and name in header_names:
            return header_names.index(name)
        log.fatal(f"Column name {name} not found in header")
    return int(s)


def iter_stripe_texts(path: str, stripe_bytes: int = STRIPE_BYTES, *,
                      skip_header: bool = False,
                      start_offset: Optional[int] = None
                      ) -> Iterator[Tuple[int, str]]:
    """Yield ``(byte_offset, text)`` stripes of ``path``: about
    ``stripe_bytes`` of whole lines each (a read is extended to the next
    newline); ``start_offset`` resumes at a stripe's offset."""
    with open(path, "rb") as f:
        if start_offset is not None:
            f.seek(start_offset)
        elif skip_header:
            f.readline()
        while True:
            off = f.tell()
            buf = f.read(stripe_bytes)
            if not buf:
                return
            if not buf.endswith(b"\n"):
                buf += f.readline()
            yield off, buf.decode()


def parse_delimited_stripe(text: str, sep: str) -> Optional[np.ndarray]:
    """One CSV / TSV stripe as a 2-D float64 matrix (None if blank)."""
    if not text or text.isspace():
        return None
    raw = np.genfromtxt(io.StringIO(text), delimiter=sep, dtype=np.float64)
    if raw.size == 0:
        return None
    if raw.ndim == 0:
        raw = raw.reshape(1, 1)
    elif raw.ndim == 1:
        raw = raw.reshape(1, -1)
    return raw


def parse_libsvm_stripe(text: str
                        ) -> Tuple[np.ndarray, List[List[Tuple[int, float]]],
                                   int]:
    """One LibSVM stripe: (labels, rows of (index, value), largest index)."""
    rows: List[List[Tuple[int, float]]] = []
    labels: List[float] = []
    max_idx = -1
    for line in text.splitlines():
        toks = line.strip().split()
        if not toks:
            continue
        labels.append(float(toks[0]))
        pairs = []
        for t in toks[1:]:
            i, v = t.split(":")
            pairs.append((int(i), float(v)))
            max_idx = max(max_idx, int(i))
        rows.append(pairs)
    return np.asarray(labels, dtype=np.float64), rows, max_idx


def densify_libsvm_rows(rows: List[List[Tuple[int, float]]],
                        width: int) -> np.ndarray:
    """Parsed LibSVM rows as a dense [rows, width] matrix (absent indices
    are zeros, as in the reference loader)."""
    arr = np.zeros((len(rows), width))
    for r, pairs in enumerate(rows):
        for i, v in pairs:
            arr[r, i] = v
    return arr


def split_meta_columns(raw: np.ndarray, config: Config, header_names
                       ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                  Dict[str, Any]]:
    """Take the label, weight and group columns out of a parsed CSV / TSV
    matrix: (features, label, {"weight": ..., "group": sizes})."""
    meta: Dict[str, Any] = {}
    label_col = _parse_column_spec(config.label_column or "0", header_names)
    weight_col = _parse_column_spec(config.weight_column, header_names)
    group_col = _parse_column_spec(config.group_column, header_names)
    drop = [c for c in (label_col, weight_col, group_col) if c is not None]
    label = raw[:, label_col] if label_col is not None else None
    if weight_col is not None:
        meta["weight"] = raw[:, weight_col]
    if group_col is not None:
        meta["group"] = qid_to_group_sizes(raw[:, group_col])
    keep = [c for c in range(raw.shape[1]) if c not in drop]
    return raw[:, keep], label, meta


def qid_to_group_sizes(qid: np.ndarray) -> np.ndarray:
    """Per-row query ids -> per-query sizes (contiguous runs)."""
    qid = np.asarray(qid).astype(np.int64)
    change = np.r_[True, qid[1:] != qid[:-1]]
    return np.diff(np.r_[np.flatnonzero(change), len(qid)])


def load_companion_files(path: str, meta: Dict[str, Any]) -> None:
    """Fill ``meta`` from ``<data>.weight`` / ``.query`` / ``.group`` /
    ``.init`` / ``.position``, never over a column's value."""
    for suffix, key in ((".weight", "weight"), (".query", "group"),
                        (".group", "group"), (".init", "init_score"),
                        (".position", "position")):
        side = path + suffix
        if os.path.exists(side) and key not in meta:
            vals = np.loadtxt(side)
            meta[key] = vals.astype(np.int64) if key == "group" else vals


def load_text_file(path: str, config: Config
                   ) -> Tuple[np.ndarray, Optional[np.ndarray],
                              Dict[str, Any]]:
    """A train / test text file as (features, label, metadata dict): CSV or
    TSV (the label column configurable, 0 by default) or LibSVM (label
    first, then index:value pairs), parsed stripe by stripe."""
    first = read_first_line(path)
    fmt = _detect_format(first)
    has_header = bool(config.header)
    header_names = None
    if has_header:
        sep = "\t" if fmt == "tsv" else ","
        header_names = [t.strip() for t in first.strip().split(sep)]

    meta: Dict[str, Any] = {}
    if fmt == "libsvm":
        all_rows: List[List[Tuple[int, float]]] = []
        all_labels: List[np.ndarray] = []
        max_idx = -1
        for _, text in iter_stripe_texts(path, skip_header=has_header):
            labels, rows, mi = parse_libsvm_stripe(text)
            all_labels.append(labels)
            all_rows.extend(rows)
            max_idx = max(max_idx, mi)
        arr = densify_libsvm_rows(all_rows, max_idx + 1)
        label = np.concatenate(all_labels) if all_labels else \
            np.zeros(0, np.float64)
    else:
        sep = "\t" if fmt == "tsv" else ","
        parts = [parse_delimited_stripe(text, sep)
                 for _, text in iter_stripe_texts(path,
                                                  skip_header=has_header)]
        parts = [p for p in parts if p is not None]
        if not parts:
            log.fatal(f"No data rows found in {path!r}")
        raw = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        arr, label, meta = split_meta_columns(raw, config, header_names)

    load_companion_files(path, meta)
    return arr, label, meta
