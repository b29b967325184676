"""Collector lifecycle: probe() -> start() -> [child runs] -> stop() ->
harvest().  A collector whose probe fails is skipped with a warning; the
recording goes on without its series."""

from __future__ import annotations

from typing import Dict, List, Optional


class Collector:
    """Base collector; subclasses override the hooks they need."""

    name = "collector"

    def __init__(self, cfg):
        self.cfg = cfg

    def probe(self) -> Optional[str]:
        """None if usable, else a human-readable reason it is not."""
        return None

    def start(self) -> None:
        """Begin collection (files, background work)."""

    def child_env(self) -> Dict[str, str]:
        """Environment variables to inject into the profiled command."""
        return {}

    def stop(self) -> None:
        """End collection and flush output files."""

    def harvest(self) -> None:
        """Post-run transformation of raw output."""

    def outputs(self) -> List[str]:
        """Paths this collector writes."""
        return []
