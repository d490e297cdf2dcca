"""Utility substrate (reference C1, mcmc-fitting.lisp:116-337).

The port's own copy of ``lisp_mcmc_tpu/utils.py`` (numpy and plain
Python: nothing here touches a device).

The reference builds its own sequence/tree toolkit because Common Lisp
lists are its data currency.  NumPy covers most of it natively; these
functions exist so every reference utility has a one-to-one, tested
equivalent (SURVEY §2 C1), with the same semantics on Python lists and
a documented NumPy idiom where one exists.

| reference (mcmc-fitting.lisp) | here            | numpy idiom            |
|-------------------------------|-----------------|------------------------|
| ``range`` (138)               | ``range_list``  | ``np.arange``          |
| ``thin`` (149)                | ``thin``        | ``a[::n]``             |
| ``slice`` (159)               | ``slice_seq``   | ``a[start:stop:step]`` |
| ``mapcar-enum`` (165)         | ``mapcar_enum`` | ``enumerate``          |
| ``map-tree`` (178)            | ``map_tree``    | —                      |
| ``plist-keys`` (190)          | ``plist_keys``  | ``dict.keys``          |
| ``plist-values`` (195)        | ``plist_values``| ``dict.values``        |
| ``make-plist`` (200)          | ``make_plist``  | ``dict(zip(...))``     |
| ``array-to-plist`` (204)      | ``array_to_plist`` | —                   |
| ``linspace`` (235)            | ``linspace``    | ``np.linspace``        |
| ``diff-matrix`` (263)         | ``diff_matrix`` | ``np.diff(axis=0)``    |
| ``diff-lplist`` (277)         | ``diff_params`` | —                      |
| ``partition`` (282)           | ``partition``   | —                      |
| ``transpose`` (290)           | ``transpose``   | ``zip(*rows)``         |
| ``list-of-arrays-transpose`` (295) | ``transpose`` | ``np.stack(...).T``  |
| ``flatten`` (308)             | ``flatten``     | ``np.ravel`` (rect.)   |
| ``split-string`` (321)        | ``split_string``| ``str.split``          |
| ``repeat`` (131)              | ``repeat``      | ``[x]*n``              |
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np

__all__ = [
    "range_list",
    "thin",
    "slice_seq",
    "mapcar_enum",
    "map_tree",
    "plist_keys",
    "plist_values",
    "make_plist",
    "array_to_plist",
    "linspace",
    "diff_matrix",
    "diff_params",
    "partition",
    "transpose",
    "flatten",
    "split_string",
    "repeat",
]


def range_list(start, stop=None, step=1):
    """Half-open numeric range as a list (``range``, mcmc-fitting.lisp:138).

    ``range_list(n)`` = 0..n-1; supports float steps (unlike ``range``).
    """
    if stop is None:
        start, stop = 0, start
    n = max(0, int(np.ceil((stop - start) / step)))
    return [start + i * step for i in range(n)]


def thin(seq, n: int):
    """Every ``n``-th element, keeping the first (``thin``, 149)."""
    if n <= 1:
        return list(seq)
    return list(seq)[::n]


def slice_seq(seq, start: int = 0, stop: int | None = None, step: int = 1):
    """List slice (``slice``, 159) — provided for parity; prefer ``a[i:j:k]``."""
    return list(seq)[slice(start, stop, step)]


def mapcar_enum(fn: Callable, seq):
    """Map ``fn(element, index)`` over a sequence (``mapcar-enum``, 165)."""
    return [fn(el, i) for i, el in enumerate(seq)]


def map_tree(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested list/tuple tree (``map-tree``, 178).

    Structure (list vs tuple) is preserved; anything non-sequence is a leaf.
    Strings and arrays count as leaves.
    """
    if isinstance(tree, (list, tuple)) and not isinstance(tree, str):
        mapped = [map_tree(fn, el) for el in tree]
        return type(tree)(mapped)
    return fn(tree)


def plist_keys(params: Mapping) -> list:
    """Parameter-dict keys (``plist-keys``, 190)."""
    return list(params.keys())


def plist_values(params: Mapping) -> list:
    """Parameter-dict values (``plist-values``, 195)."""
    return list(params.values())


def make_plist(keys: Sequence, values: Sequence) -> dict:
    """Build a parameter dict from parallel sequences (``make-plist``, 200)."""
    return dict(zip(keys, values))


def array_to_plist(keys: Sequence, array) -> dict:
    """Pair names with a flat vector's entries (``array-to-plist``, 204)."""
    arr = np.asarray(array).ravel()
    if len(keys) != arr.shape[0]:
        raise ValueError(f"{len(keys)} keys vs {arr.shape[0]} values")
    return {k: float(v) for k, v in zip(keys, arr)}


def linspace(start, stop, num: int | None = None, step=None, dtype=float):
    """Evenly spaced grid (``linspace``, mcmc-fitting.lisp:235).

    Like the reference, accepts either a point count (``num``) or a
    ``step``; with a step the endpoint is included when it lands on the
    grid.  The reference's ``:type 'integer`` path rounds each rational
    point, producing uneven spacing (SURVEY §2.2) — here integer output
    rounds the *evenly spaced* float grid instead, which is the intended
    behavior.
    """
    if (num is None) == (step is None):
        if num is None:
            num = 50
        else:
            raise ValueError("give either num or step, not both")
    if step is not None:
        n = int(np.floor((stop - start) / step + 1e-12)) + 1
        grid = start + step * np.arange(n, dtype=np.float64)
    else:
        grid = np.linspace(float(start), float(stop), int(num))
    if np.issubdtype(np.dtype(dtype), np.integer):
        return np.rint(grid).astype(dtype)
    return grid.astype(dtype)


def diff_matrix(rows):
    """Differences of consecutive rows (``diff-matrix``, 263)."""
    arr = np.asarray(rows, dtype=np.float64)
    return np.diff(arr, axis=0)


def diff_params(p1: Mapping, p2: Mapping) -> dict:
    """Per-key difference of two parameter dicts (``diff-lplist``, 277)."""
    return {k: p1[k] - p2[k] for k in p1}


def partition(seq, n: int):
    """Chunk a sequence into length-``n`` groups (``partition``, 282).

    The trailing partial group is kept (the reference drops nothing).
    """
    seq = list(seq)
    if n <= 0:
        raise ValueError("partition size must be positive")
    return [seq[i : i + n] for i in range(0, len(seq), n)]


def transpose(rows):
    """Transpose a list of rows (``transpose`` 290 /
    ``list-of-arrays-transpose`` 295)."""
    return [list(col) for col in zip(*rows)]


def flatten(tree) -> list:
    """All leaves of a nested structure, depth-first (``flatten``, 308)."""
    out: list[Any] = []

    def walk(node):
        if isinstance(node, (list, tuple)) and not isinstance(node, str):
            for el in node:
                walk(el)
        else:
            out.append(node)

    walk(tree)
    return out


def split_string(text: str, delimiter: str = " ") -> list[str]:
    """Split on a delimiter, dropping empty fields (``split-string``, 321)."""
    return [t for t in text.split(delimiter) if t != ""]


def repeat(value, n: int) -> list:
    """``n`` copies (``repeat``, 131)."""
    return [value] * n
