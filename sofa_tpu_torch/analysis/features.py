"""The performance feature vector: a (name, value) table accumulated across
passes, printed as "Final Performance Features" and saved as features.csv.
Values are floats; string metadata goes in ``info`` rows, printed with the
table but not saved."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import pandas as pd


class Features:
    def __init__(self) -> None:
        self._rows: List[Tuple[str, float]] = []
        self._info: List[Tuple[str, str]] = []

    def add(self, name: str, value: float) -> None:
        self._rows.append((name, float(value)))  # sofa-lint: disable=SL019 — wave-confined: each pass writes its own buffer; merge happens after the pool joins (happens-before)

    def add_info(self, name: str, value: str) -> None:
        self._info.append((name, str(value)))  # sofa-lint: disable=SL019 — wave-confined, same as add()

    def get(self, name: str) -> Optional[float]:
        for n, v in reversed(self._rows):
            if n == name:
                return v
        return None

    def merge_from(self, other: "Features") -> None:
        """Append another accumulator's rows (the registry merges each
        pass's buffer in canonical order)."""
        self._rows.extend(other._rows)
        self._info.extend(other._info)

    def by_regex(self, pattern: str) -> List[Tuple[str, float]]:
        """The latest value of every feature whose whole name matches, by
        name.  Per-device rules scan ``gpu<N>_...`` with this: device 0
        need not be the one that matters, or exist."""
        rx = re.compile(pattern)
        latest: Dict[str, float] = {}
        for n, v in self._rows:
            if rx.fullmatch(n):
                latest[n] = v
        return sorted(latest.items())

    def to_frame(self) -> pd.DataFrame:
        return pd.DataFrame(self._rows, columns=["name", "value"])

    def save(self, path: str) -> None:
        self.to_frame().to_csv(path, index=False)

    def render(self) -> str:
        lines = ["=" * 50, "Final Performance Features", "=" * 50,
                 f"{'name':<36} {'value':>12}", "-" * 50]
        for name, value in self._rows:
            if value == int(value) and abs(value) < 1e15:
                lines.append(f"{name:<36} {int(value):>12}")
            else:
                lines.append(f"{name:<36} {value:>12.6g}")
        for name, value in self._info:
            lines.append(f"{name:<36} {value:>12}")
        lines.append("=" * 50)
        return "\n".join(lines)
