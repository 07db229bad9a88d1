"""Port of ``src/repro/sweep/engine.py`` (copied; imports re-pointed).

The sweep engine: expand axes, dedupe by spec fingerprint, run, store.

One ``Engine`` owns an output directory (``benchmarks/out`` for the
paper studies). ``run_study`` expands every ``Sweep`` a study declares,
fingerprints each cell (sha256 over the canonical JSON of
``(study, version, scenario, params)``), replays completed cells from
the study's JSONL run store (``<out>/runstore/<study>.jsonl``) and runs
only the missing ones — so an interrupted grid resumes where it stopped
and a re-run of an unchanged study touches zero cells. Results come back
as the unified ``CellResult`` records; the study's ``finalize`` hook
reduces them to its legacy JSON report + CSV rows (and runs its
assertions), and the engine — not the study — writes the report file.

A ``Study`` is what a refactored ``benchmarks/fig*.py`` module declares
instead of hand-rolled grid loops: sweeps (quick-aware), a per-cell
measurement, a cell namer, and the finalize/validate hook.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.sweep.result import CellResult
from repro_torch.sweep.spec import Cell, Sweep


def fingerprint(study: str, version: int, cell: Cell) -> str:
    """Content address of one cell: the study identity + the *complete*
    cell spec (frozen scenario + params). Bumping ``Study.version``
    invalidates every cached cell of that study."""
    blob = json.dumps(
        {"study": study, "version": version,
         "scenario": cell.scenario.to_dict(), "params": cell.params},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


class RunStore:
    """Append-only JSONL store of completed cells, keyed by fingerprint.

    One line per CellResult; loading tolerates a truncated final line
    (an interrupted run resumes from the last complete record)."""

    def __init__(self, path: str):
        self.path = path
        self._index: Dict[str, CellResult] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = CellResult.from_dict(json.loads(line))
                    except (ValueError, TypeError, KeyError):
                        continue  # truncated / stale-schema line
                    self._index[rec.fingerprint] = rec

    def __len__(self) -> int:
        return len(self._index)

    def get(self, fp: str) -> Optional[CellResult]:
        return self._index.get(fp)

    def put(self, result: CellResult) -> None:
        """Append one record. Multiprocess-safe: the line is written in
        one O_APPEND write under an exclusive flock, so concurrent
        writers (parallel engines sharing a store, or a crashed worker's
        partial line) never interleave records — loading tolerates the
        one truncated tail a hard kill can still leave."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        line = json.dumps(result.to_dict(), separators=(",", ":")) + "\n"
        with open(self.path, "a") as f:
            try:
                import fcntl
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # no flock here (non-POSIX): O_APPEND still holds
            f.write(line)
            f.flush()
        self._index[result.fingerprint] = result


def _default_finalize(results, quick, verbose):
    return None, [r.row() for r in results]


def _run_cell_task(cell_fn, study_name, cell_name, fp, cell) -> CellResult:
    """One worker-side cell execution (module-level so the spawn-context
    pool can pickle it; carries only the cell fn + the cell, never the
    whole Study — finalize hooks and closures stay in the parent)."""
    metrics = cell_fn(cell)
    return CellResult.from_metrics(study_name, cell_name, fp,
                                   cell.overrides, cell.params, metrics)


@dataclasses.dataclass
class Study:
    """One registered benchmark study: sweeps + cell runner + reducer."""
    name: str
    sweeps: Callable[[bool], Tuple[Sweep, ...]]  # quick -> sweeps
    cell: Callable[[Cell], Dict[str, Any]]       # one cell -> metrics
    cell_name: Optional[Callable[[Cell], str]] = None
    # (results, quick, verbose) -> (report dict | None, CSV rows);
    # runs the study's assertions
    finalize: Callable[..., Tuple[Optional[dict], List[dict]]] = \
        _default_finalize
    out: Optional[str] = None  # report JSON filename under the out dir
    title: str = ""
    version: int = 1           # bump to invalidate cached cells
    order: int = 100           # benchmarks/run.py ordering
    in_quick: bool = True      # part of the --quick CI gate

    def name_of(self, cell: Cell) -> str:
        if self.cell_name is not None:
            return self.cell_name(cell)
        return f"{self.name}/{cell.label()}"


@dataclasses.dataclass
class StudyRunStats:
    n_cells: int = 0
    n_cached: int = 0
    n_ran: int = 0


class Engine:
    """Executes studies (and ad-hoc sweeps) against one output dir."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.last_stats: Optional[StudyRunStats] = None

    # ------------------------------------------------------------------
    def store_path(self, study_name: str) -> str:
        return os.path.join(self.out_dir, "runstore", f"{study_name}.jsonl")

    def run_cells(self, study: Study, cells: List[Cell], *,
                  fresh: bool = False, verbose: bool = True,
                  workers: int = 0) -> List[CellResult]:
        """The dedupe/cache/execute core. Duplicate fingerprints inside
        one expansion run once; completed cells replay from the store.

        ``workers > 1`` executes the missing cells on a spawn-context
        process pool (spawn, not fork: the cells run JAX). The parent
        collects worker results *in submission order* and is the only
        store writer, so the store file is bit-for-bit identical to a
        serial run of the same grid — cells must be (and the studies
        are) deterministic, which ``--workers`` therefore preserves."""
        store = RunStore(self.store_path(study.name))
        stats = StudyRunStats(n_cells=len(cells))
        fps = [fingerprint(study.name, study.version, cell)
               for cell in cells]
        recs: Dict[str, CellResult] = {}
        todo: List[Tuple[str, Cell]] = []  # first-occurrence order
        todo_fps = set()
        for cell, fp in zip(cells, fps):
            if fp in recs or fp in todo_fps:
                continue
            rec = None if fresh else store.get(fp)
            if rec is not None:
                stats.n_cached += 1
                recs[fp] = rec
            else:
                todo.append((fp, cell))
                todo_fps.add(fp)
        if workers > 1 and len(todo) > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            ctx = mp.get_context("spawn")
            with ProcessPoolExecutor(max_workers=min(workers, len(todo)),
                                     mp_context=ctx) as pool:
                futs = [pool.submit(_run_cell_task, study.cell, study.name,
                                    study.name_of(cell), fp, cell)
                        for fp, cell in todo]
                for (fp, _), fut in zip(todo, futs):
                    rec = fut.result()  # submission order == serial order
                    store.put(rec)
                    recs[fp] = rec
                    stats.n_ran += 1
        else:
            for fp, cell in todo:
                rec = _run_cell_task(study.cell, study.name,
                                     study.name_of(cell), fp, cell)
                store.put(rec)
                recs[fp] = rec
                stats.n_ran += 1
        results = [recs[fp] for fp in fps]
        self.last_stats = stats
        if verbose:
            par = f", {workers} workers" if workers > 1 else ""
            print(f"[{study.name}] {stats.n_cells} cells: {stats.n_ran} "
                  f"run, {stats.n_cached} cached{par} "
                  f"(store: {os.path.relpath(store.path)})")
        return results

    def run_study(self, study: Study, *, quick: bool = False,
                  verbose: bool = True, fresh: bool = False,
                  workers: int = 0) -> List[dict]:
        """Expand -> run/replay -> finalize -> write the report JSON.
        Returns the CSV rows benchmarks/run.py prints."""
        cells = [c for sw in study.sweeps(quick) for c in sw.expand()]
        results = self.run_cells(study, cells, fresh=fresh, verbose=verbose,
                                 workers=workers)
        report, rows = study.finalize(results, quick, verbose)
        if report is not None and study.out:
            path = os.path.join(self.out_dir, study.out)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(report, f, indent=2)
            if verbose:
                print(f"[{study.name}] JSON report -> {path}")
        return rows

    # ------------------------------------------------------------------
    def runner(self, study: Study) -> Callable[..., List[dict]]:
        """The legacy ``run(verbose=True, quick=False)`` module surface
        (+ ``fresh=`` so run.py --fresh invalidates per study, not by
        deleting the whole run store)."""
        def run(verbose: bool = True, quick: bool = False,
                fresh: bool = False, workers: int = 0) -> List[dict]:
            return self.run_study(study, quick=quick, verbose=verbose,
                                  fresh=fresh, workers=workers)
        run.__doc__ = study.title or study.name
        return run

    def main(self, study: Study, argv=None) -> None:
        """``python -m benchmarks.figX [--quick] [--fresh] [--workers N]``."""
        ap = argparse.ArgumentParser(description=study.title or study.name)
        ap.add_argument("--quick", action="store_true",
                        help="reduced grid (the CI smoke)")
        ap.add_argument("--fresh", action="store_true",
                        help="ignore the run store; re-run every cell")
        ap.add_argument("--workers", type=int, default=0,
                        help="run missing cells on N worker processes")
        args = ap.parse_args(argv)
        self.run_study(study, quick=args.quick, fresh=args.fresh,
                       workers=args.workers)
