"""Port of ``src/repro/sweep/spec.py`` (copied; imports re-pointed).

Sweep spec: a base Scenario plus axes over its dotted fields.

The paper's deliverable is not any single figure but §VII's *decision
guidelines* — which backend/topology/compression to pick for a given FL
task and network. Answering that takes systematic sweeps, and before this
layer every ``benchmarks/fig*.py`` hand-rolled its own nested grid loop.
A ``Sweep`` is the declarative replacement:

* ``Axis``  — one swept dimension. ``field`` is a dotted ``Scenario``
  path (``channel.backend``, ``faults.link_loss``, ``fleet.tier``) or a
  study parameter (``params.channels``) that does not live in the spec.
  Discrete axes list ``values``; continuous axes give ``lo``/``hi`` (+
  ``steps`` for a grid linspace).
* ``Sweep`` — base scenario + axes. With ``samples == 0`` the axes cross
  into a full grid (declaration order = nesting order, so cell order is
  reproducible); with ``samples > 0`` each cell draws one value per axis
  from a stream seeded by ``(seed, cell index, axis field)`` — seeded
  random search, deterministic and independent of axis evaluation order.

``Sweep.to_dict`` / ``from_dict`` round-trip exactly (including through
JSON), with unknown keys rejected on a readable path, so a sweep file is
as declarative as a scenario file (``fl_train --sweep file.json``).
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, Dict, List, Tuple

from repro_torch.scenario import Scenario, ScenarioError, with_overrides

PARAM_PREFIX = "params."


class SweepError(ScenarioError):
    """Invalid sweep spec — the message carries the offending path."""


@dataclasses.dataclass(frozen=True)
class Axis:
    """One swept dimension: discrete ``values`` or a ``lo``/``hi`` range.

    ``sub`` makes the axis *conditional*: per-value sub-grids, keyed by
    ``str(value)``. When the grid expansion assigns a value whose key
    appears in ``sub``, that value's axes are crossed in (recursively)
    for those cells only — the declarative form of "chunking only
    applies on the gRPC branch" couplings that otherwise hide inside a
    study's ``_cell`` function. Sub-axes exist in grid sweeps only
    (random search draws axes independently, which a value-conditioned
    sub-grid contradicts)."""
    field: str
    values: Tuple[Any, ...] = ()
    lo: float = 0.0
    hi: float = 0.0
    steps: int = 0  # grid mode: linspace(lo, hi, steps) for a range axis
    # str(value) -> axes crossed in only under that value
    sub: Dict[str, Tuple["Axis", ...]] = dataclasses.field(
        default_factory=dict)

    @property
    def is_range(self) -> bool:
        return not self.values

    def check(self, path: str, seen=()) -> None:
        if not self.field:
            raise SweepError(f"{path}: axis field must be non-empty")
        if self.field in seen:
            raise SweepError(f"{path}: duplicate axis field "
                             f"'{self.field}' on this branch")
        if not self.field.startswith(PARAM_PREFIX):
            _check_scenario_path(self.field, path)
        if self.sub and not self.values:
            raise SweepError(f"{path}: sub-axes need discrete values "
                             f"(a range axis has no value keys)")
        if self.values:
            if any(v is None for v in self.values):
                raise SweepError(f"{path}: axis values must not be None "
                                 f"(None means 'unset' in overrides)")
            if self.lo or self.hi or self.steps:
                raise SweepError(f"{path}: give either values or a "
                                 f"lo/hi range, not both")
            self._check_sub(path, seen)
            return
        if not self.hi > self.lo:
            raise SweepError(f"{path}: range axis needs hi > lo "
                             f"(got lo={self.lo}, hi={self.hi})")

    def _check_sub(self, path: str, seen) -> None:
        keys = {str(v) for v in self.values}
        branch_seen = set(seen) | {self.field}
        for key, axes in self.sub.items():
            if key not in keys:
                raise SweepError(
                    f"{path}.sub['{key}']: no axis value str()s to "
                    f"'{key}' (values: {sorted(keys)})")
            if not isinstance(axes, tuple):
                raise SweepError(f"{path}.sub['{key}']: expected a tuple "
                                 f"of axes")
            # each sub value opens its own branch: a field may repeat
            # across branches but not along one
            sub_seen = set(branch_seen)
            for j, ax in enumerate(axes):
                ax.check(f"{path}.sub['{key}'][{j}]", tuple(sub_seen))
                sub_seen.add(ax.field)

    def grid_values(self, path: str) -> Tuple[Any, ...]:
        if self.values:
            return self.values
        if self.steps < 2:
            raise SweepError(
                f"{path}: a range axis in a grid sweep needs steps >= 2 "
                f"(or set samples > 0 for random search)")
        span = self.hi - self.lo
        return tuple(self.lo + span * i / (self.steps - 1)
                     for i in range(self.steps))

    def draw(self, rng: random.Random) -> Any:
        if self.values:
            return self.values[rng.randrange(len(self.values))]
        return rng.uniform(self.lo, self.hi)

    def grid_values(self, path: str) -> Tuple[Any, ...]:
        if self.values:
            return self.values
        if self.steps < 2:
            raise SweepError(
                f"{path}: a range axis in a grid sweep needs steps >= 2 "
                f"(or set samples > 0 for random search)")
        span = self.hi - self.lo
        return tuple(self.lo + span * i / (self.steps - 1)
                     for i in range(self.steps))

    def draw(self, rng: random.Random) -> Any:
        if self.values:
            return self.values[rng.randrange(len(self.values))]
        return rng.uniform(self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One concrete point of an expanded sweep: a frozen scenario plus
    the non-scenario study parameters that complete its identity."""
    index: int
    scenario: Scenario
    overrides: Dict[str, Any]  # dotted scenario field -> value
    params: Dict[str, Any]     # params.* axis values + sweep constants

    def label(self) -> str:
        parts = [f"{k.split('.')[-1]}={v}" for k, v in
                 list(self.overrides.items()) + list(self.params.items())]
        return ",".join(parts) or f"cell{self.index}"


@dataclasses.dataclass(frozen=True)
class Sweep:
    """A base scenario + axes; grid (samples == 0) or seeded random
    search (samples > 0). ``params`` are constants merged into every
    cell's ``params`` dict (study knobs that are not swept)."""
    name: str = "sweep"
    base: Scenario = Scenario()
    axes: Tuple[Axis, ...] = ()
    samples: int = 0
    seed: int = 0
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def check(self) -> None:
        seen = set()
        for i, ax in enumerate(self.axes):
            path = f"sweep.axes[{i}]"
            ax.check(path, tuple(seen))
            seen.add(ax.field)
        if self.samples < 0:
            raise SweepError("sweep.samples must be >= 0")
        if self.samples > 0 and any(_has_sub(ax) for ax in self.axes):
            raise SweepError(
                "sweep: conditional sub-axes require a grid sweep "
                "(samples == 0); random search draws axes independently")

    # -- expansion ---------------------------------------------------------
    def expand(self) -> List[Cell]:
        """Axes -> concrete cells. Grid: cross-product in declaration
        order, with each axis value's conditional ``sub`` axes crossed
        in (recursively) under that value only. Random: ``samples``
        cells, each axis drawn from its own ``(seed, index,
        field)``-seeded stream."""
        self.check()
        if self.samples > 0:
            assignments = [
                [(ax.field,
                  ax.draw(random.Random(f"{self.seed}:{i}:{ax.field}")))
                 for ax in self.axes]
                for i in range(self.samples)]
        else:
            assignments = _grid_assignments(self.axes)
        cells = []
        for i, assign in enumerate(assignments):
            overrides = {f: v for f, v in assign
                         if not f.startswith(PARAM_PREFIX)}
            params = dict(self.params)
            params.update({f[len(PARAM_PREFIX):]: v for f, v in assign
                           if f.startswith(PARAM_PREFIX)})
            sc = with_overrides(self.base, overrides) if overrides \
                else self.base
            cells.append(Cell(index=i, scenario=sc, overrides=overrides,
                              params=params))
        return cells

    # -- (de)serialisation -------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["base"] = self.base.to_dict()
        return d

    @classmethod
    def from_dict(cls, data: dict) -> "Sweep":
        if not isinstance(data, dict):
            raise SweepError(
                f"sweep: expected an object, got {type(data).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - fields)
        if unknown:
            raise SweepError(f"sweep: unknown key(s) {unknown}; valid "
                             f"keys: {sorted(fields)}")
        kw: dict = {}
        for k, v in data.items():
            if k == "base":
                kw[k] = Scenario.from_dict(v)
            elif k == "axes":
                if not isinstance(v, (list, tuple)):
                    raise SweepError("sweep.axes: expected a list")
                kw[k] = tuple(_axis_from_dict(a, f"sweep.axes[{i}]")
                              for i, a in enumerate(v))
            elif k == "params":
                if not isinstance(v, dict):
                    raise SweepError("sweep.params: expected an object")
                kw[k] = dict(v)
            else:
                kw[k] = v
        try:
            sweep = cls(**kw)
        except TypeError as e:
            raise SweepError(f"sweep: {e}") from None
        sweep.check()
        return sweep

    def to_json(self, **kwargs) -> str:
        kwargs.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_json(cls, text: str) -> "Sweep":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "Sweep":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _has_sub(ax: Axis) -> bool:
    return bool(ax.sub)


def _grid_assignments(axes) -> List[list]:
    """Cross the axes into [(field, value)] assignment lists, declaration
    order = nesting order; a value's ``sub`` axes nest directly under it
    (so cells of one branch stay contiguous and cell order stays
    reproducible)."""
    assignments: List[list] = [[]]
    for ax in axes:
        vals = ax.grid_values(f"sweep.axes[{ax.field}]")
        nxt: List[list] = []
        for prefix in assignments:
            for v in vals:
                branch = prefix + [(ax.field, v)]
                sub_axes = ax.sub.get(str(v), ())
                if sub_axes:
                    nxt.extend(branch + tail
                               for tail in _grid_assignments(sub_axes))
                else:
                    nxt.append(branch)
        assignments = nxt
    return assignments


def _axis_from_dict(data: dict, path: str) -> Axis:
    if not isinstance(data, dict):
        raise SweepError(f"{path}: expected an object")
    fields = {f.name for f in dataclasses.fields(Axis)}
    unknown = sorted(set(data) - fields)
    if unknown:
        raise SweepError(f"{path}: unknown key(s) {unknown}; valid keys: "
                         f"{sorted(fields)}")
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in data.items()}
    sub = kw.get("sub")
    if sub is not None:
        if not isinstance(sub, dict):
            raise SweepError(f"{path}.sub: expected an object mapping "
                             f"str(value) -> list of axes")
        parsed = {}
        for key, axes in sub.items():
            if not isinstance(axes, (list, tuple)):
                raise SweepError(f"{path}.sub['{key}']: expected a list "
                                 f"of axes")
            parsed[key] = tuple(
                _axis_from_dict(a, f"{path}.sub['{key}'][{j}]")
                for j, a in enumerate(axes))
        kw["sub"] = parsed
    try:
        return Axis(**kw)
    except TypeError as e:
        raise SweepError(f"{path}: {e}") from None


def _check_scenario_path(field: str, path: str) -> None:
    """A dotted axis field must name a real Scenario field (typos fail at
    declaration, not mid-run)."""
    node: Any = Scenario()
    parts = field.split(".")
    for i, part in enumerate(parts):
        if not dataclasses.is_dataclass(node):
            raise SweepError(f"{path}: '{field}' descends past the leaf "
                             f"field '{parts[i - 1]}'")
        if not any(f.name == part for f in dataclasses.fields(node)):
            raise SweepError(
                f"{path}: '{field}' is not a Scenario field (no "
                f"'{part}' on {type(node).__name__}; use the 'params.' "
                f"prefix for study parameters)")
        node = getattr(node, part)
