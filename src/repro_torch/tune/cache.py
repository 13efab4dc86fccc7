"""The persistent JSON tuning cache: measured winners keyed by problem
shape (port of ``repro.tune.cache``).

A key is ``platform | device_count | pow2-bucketed (N, C, S) | placement |
resolve | source`` (``repro``'s format), so a 40k-event log meets the entry
measured on a 48k-event one, and a CUDA winner never reaches a CPU sweep.
The file format is ``repro``'s too: either package's :class:`TuningCache`
reads the other's file. The default file and variable are the port's own
(``TUNING_cache_torch.json``, ``REPRO_TORCH_TUNING_CACHE``): on the CPU the
two packages' keys can be equal (platform ``"cpu"``, back-end ``"fused"``),
and one package's winner must not reach the other. A missing, corrupt or
other-schema file reads as empty, and the cost model answers: tuning is
never a correctness dependency.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Optional

from repro_torch.tune.space import ProblemShape

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNING_CACHE"
DEFAULT_FILENAME = "TUNING_cache_torch.json"


def default_cache_path() -> Path:
    """``$REPRO_TORCH_TUNING_CACHE``, or ``TUNING_cache_torch.json`` in the
    working directory."""
    return Path(os.environ.get(ENV_VAR) or DEFAULT_FILENAME)


def _bucket(n: int) -> int:
    """Pow2 ceiling: shapes within a factor of two share an entry."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def cache_key(shape: ProblemShape) -> str:
    return (f"{shape.platform}|d{shape.device_count}"
            f"|N{_bucket(shape.n_events)}|C{_bucket(shape.n_campaigns)}"
            f"|S{_bucket(shape.n_scenarios)}"
            f"|{shape.placement}|{shape.resolve}|{shape.source}")


@dataclasses.dataclass
class TuningCache:
    """One cache file in memory. :meth:`load` never raises on bad input;
    :meth:`save` writes atomically (a temporary file, then a rename)."""

    path: Path
    entries: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path=None) -> "TuningCache":
        path = Path(path) if path is not None else default_cache_path()
        entries: Dict[str, dict] = {}
        try:
            raw = json.loads(path.read_text())
            if (isinstance(raw, dict)
                    and raw.get("schema") == SCHEMA_VERSION
                    and isinstance(raw.get("entries"), dict)):
                entries = {
                    k: v for k, v in raw["entries"].items()
                    if isinstance(v, dict) and isinstance(
                        v.get("config"), dict)}
            # another schema or shape reads as empty: the cost model
            # answers until someone measures again
        except (OSError, ValueError):
            pass
        return cls(path=path, entries=entries)

    def get(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, config: dict, *, origin: str = "measured",
            **meta) -> dict:
        entry = {"config": dict(config), "origin": origin, **meta}
        self.entries[key] = entry
        return entry

    def save(self) -> Path:
        payload = {"schema": SCHEMA_VERSION, "entries": self.entries}
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        os.replace(tmp, self.path)
        _stamp_cache.clear()        # path-memoized loaders read it again
        return self.path


# resolve-time loads are memoized on (path, mtime, size): a service asking
# thousands of same-shape sweeps reads the file again only when it changes
_stamp_cache: Dict[str, tuple] = {}


def shared_cache(path=None) -> TuningCache:
    """The memoized view of one cache file, shared by the process."""
    p = Path(path) if path is not None else default_cache_path()
    try:
        st = p.stat()
        stamp = (st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = None
    key = str(p)
    hit = _stamp_cache.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    cache = TuningCache.load(p)
    _stamp_cache[key] = (stamp, cache)
    return cache
