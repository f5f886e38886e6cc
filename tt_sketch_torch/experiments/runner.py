"""Resumable experiment runner (counterpart of
``tt_sketch_tpu/experiments/runner.py``).

A CSV-backed parameter-sweep runner: each ``run()`` call is keyed by its
parameter combination; combinations already present in the CSV are skipped,
and the CSV is saved after every run, so an interrupted sweep resumes where
it stopped.

The port reads and writes its CSVs with the standard library's ``csv``
module, not pandas, and keeps the JAX runner's resume semantics, so it
extends the JAX package's committed ``results/*.csv``: a column whose every
filled cell is a number is numeric (a recorded ``5.0`` matches ``5``), one
of ``True``/``False`` cells is boolean, any other is text; an empty cell
(or one of pandas' missing-value words) is ``None``; a column a row lacks
is written empty, and numbers are written as floats, as the JAX runner's
pandas writes them; columns keep their first-seen order.
"""
from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

#: cells pandas' ``read_csv`` reads as missing by default
_MISSING = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}

Row = Dict[str, Any]


def _normalize(value: Any) -> Any:
    """Parameter values as CSV-stable scalars, written as the JAX runner
    writes them: a dtype by its numpy name (``"float32"``), a class or
    function by its ``__name__``, anything else by ``str``."""
    if isinstance(value, (int, float, str, bool)) or value is None:
        return value
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    name = getattr(value, "__name__", None)
    return name if name is not None else str(value)


def _column_parser(cells: List[str]) -> Callable[[str], Any]:
    """How the cells of one column are read, decided over the whole
    column as ``pandas.read_csv`` decides its dtype."""
    filled = [c for c in cells if c not in _MISSING]
    if filled and all(c in _BOOLS for c in filled):
        return _BOOLS.__getitem__
    try:
        numbers = [float(c) for c in filled if "_" not in c]
    except ValueError:
        return str
    if len(numbers) < len(filled):
        return str  # Python reads "1_000" as a number, pandas does not
    if all(n.is_integer() and "." not in c and "e" not in c.lower()
           for n, c in zip(numbers, filled)) and len(filled) == len(cells):
        return int
    return float


def _read_csv(path: Path) -> Tuple[List[str], List[Row], set]:
    """The columns, the rows and the integer columns of a CSV file."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader, [])
        raw = [r + [""] * (len(columns) - len(r)) for r in reader if r]
    parsers = [_column_parser([r[j] for r in raw])
               for j in range(len(columns))]
    rows = [{col: (None if cell in _MISSING else parse(cell))
             for col, parse, cell in zip(columns, parsers, r)} for r in raw]
    return columns, rows, {c for c, p in zip(columns, parsers) if p is int}


def _as_float(values: List[Any], read_as_int: bool) -> bool:
    """Whether a column's numbers are written as floats, as the JAX runner
    writes them: pandas makes a new column float64 (it enters as missing in
    the rows before it) and keeps it so; a column read as integers stays
    integer while every row holds an integer."""
    numbers = [v for v in values if v is not None]
    ints = all(isinstance(v, int) for v in values)
    return not (read_as_int and ints) and all(
        isinstance(v, (int, float)) and not isinstance(v, bool)
        for v in numbers)


def _cell(value: Any, as_float: bool) -> str:
    if value is None:
        return ""
    if isinstance(value, float) or as_float:
        return repr(float(value))
    return str(value)


def _missing(value: Any) -> bool:
    return value is None or (isinstance(value, float) and value != value)


class Experiment:
    """CSV-resumable sweep runner.

    ``data`` is the list of rows (dicts, ``None`` for an empty cell) and
    ``columns`` their first-seen order.

    >>> exp = Experiment("results/hilbert.csv")
    >>> exp.run(tensor, "STTA", experiment_stream_sketch, left_rank=5,
    ...         right_rank=10, run=0)
    """

    def __init__(
        self,
        filename: str,
        data: Optional[List[Row]] = None,
        force_overwrite: bool = False,
        autosave: bool = True,
    ):
        self.filename = str(filename)
        self.autosave = autosave
        self.columns: List[str] = ["name", "error", "time_taken"]
        #: columns read from the file as integers (written back so)
        self._int_columns: set = set()
        if data is None:
            path = Path(self.filename)
            if path.is_file() and not force_overwrite:
                self.columns, data, self._int_columns = _read_csv(path)
            else:
                data = []
        self.data: List[Row] = list(data)
        for row in self.data:
            self._add_columns(row)
        #: per tuple of columns asked about, the set of the rows' values
        #: there (``None`` for a missing cell); equal numbers hash alike,
        #: so a recorded 5.0 is found for 5
        self._index: Dict[Tuple[str, ...], set] = {}

    @classmethod
    def load(cls, filename: str) -> "Experiment":
        columns, rows, int_columns = _read_csv(Path(filename))
        exp = cls(filename, data=rows)
        exp.columns, exp._int_columns = columns, int_columns
        return exp

    def _add_columns(self, row: Row) -> None:
        self.columns += [k for k in row if k not in self.columns]

    def column(self, name: str) -> List[Any]:
        """The values of one column, ``None`` where a row lacks it."""
        return [row.get(name) for row in self.data]

    def save(self) -> None:
        path = Path(self.filename)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".part")
        with open(tmp, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(self.columns)
            floats = [_as_float(self.column(c), c in self._int_columns)
                      for c in self.columns]
            for row in self.data:
                writer.writerow([_cell(row.get(c), f)
                                 for c, f in zip(self.columns, floats)])
        tmp.replace(path)

    @staticmethod
    def _key(row: Row, columns: Tuple[str, ...]) -> tuple:
        return tuple(None if _missing(row.get(c)) else row[c]
                     for c in columns)

    def is_done(self, conds: Dict[str, Any]) -> bool:
        """True if a row matching every (column == value) already exists;
        a value of ``None`` matches an empty cell, a NaN value nothing."""
        if not self.data or any(c not in self.columns for c in conds):
            return False
        if any(v is not None and _missing(v) for v in conds.values()):
            return False
        columns = tuple(conds)
        index = self._index.get(columns)
        if index is None:
            index = self._index[columns] = {self._key(row, columns)
                                            for row in self.data}
        return self._key(conds, columns) in index

    def run(
        self,
        input: Any,
        name: str,
        experiment_func: Callable[..., Dict[str, Any]],
        **kwargs: Any,
    ) -> Optional[Dict[str, Any]]:
        """Run ``experiment_func(input, **kwargs)`` unless already recorded.

        Returns the result dict, or None if the combination was skipped.
        """
        row = {key: _normalize(value) for key, value in kwargs.items()}
        row["name"] = name
        if self.is_done(row):
            return None
        result = experiment_func(input, **kwargs)
        row.update({k: _normalize(v) for k, v in result.items()})
        self.data.append(row)
        self._add_columns(row)
        for columns, index in self._index.items():
            index.add(self._key(row, columns))
        if self.autosave:
            self.save()
        return result


def _cuda_devices(value: Any, found: set) -> set:
    """The CUDA devices of the tensors in ``value``: torch tensors, nested
    lists, tuples and dicts, and the port's tensor formats (``.device``)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            found.add(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    else:
        device = getattr(value, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda":
            found.add(device)
    return found


def timed(fn: Callable[[], Any]) -> Dict[str, Any]:
    """Wall-time a thunk to the completion of the CUDA devices its result
    lies on, returning ``{"value", "time_taken"}``."""
    start = time.perf_counter()
    value = fn()
    for device in _cuda_devices(value, set()):
        torch.cuda.synchronize(device)
    return {"value": value, "time_taken": time.perf_counter() - start}
