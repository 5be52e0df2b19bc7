"""Small persistent JSON sidecar stores for process-per-invocation surfaces.

The CLI runs one process per image (mirroring the reference binary,
``ppmx-edward.c:117-191``), so any in-process memo dies with the process.
A sidecar store persists tiny facts — audit verdicts — in the checkout's
``.cache/`` so the next invocation can skip re-deriving them.

Entries are keyed by a caller-supplied code-version tag (typically a
content hash of the modules the fact depends on), so editing that code
invalidates the whole store. The store is a single small JSON file
written atomically (tmp + rename); a racing writer can lose a concurrent
entry, which only costs a recompute. Any I/O or format failure degrades
to "not cached": a sidecar is an optimization, never a dependency.

Relocate every store with ``IPT_CACHE_DIR`` (shared with the
native-codec build cache); each store has its own disable env var.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable

_DISABLE_VALUES = {"0", "off", "false", "no"}


class JsonSidecar:
    """One JSON file of versioned key->value entries, atomically rewritten."""

    def __init__(
        self,
        filename: str,
        version_fn: Callable[[], str],
        disable_env: str,
        max_entries: int = 4096,
    ) -> None:
        self._filename = filename
        self._version_fn = version_fn
        self._disable_env = disable_env
        self.max_entries = max_entries
        self._lock = threading.Lock()

    def _path(self) -> str | None:
        if (
            os.environ.get(self._disable_env, "").strip().lower()
            in _DISABLE_VALUES
        ):
            return None
        from imageprocessingtools_tpu.utils.compile_cache import CACHE_ROOT

        base = os.environ.get("IPT_CACHE_DIR") or CACHE_ROOT
        return os.path.join(base, self._filename)

    def _load(self, path: str) -> dict:
        try:
            with open(path, "r") as f:
                data = json.load(f)
            if (
                isinstance(data, dict)
                and data.get("version") == self._version_fn()
                and isinstance(data.get("entries"), dict)
            ):
                return data["entries"]
        except (OSError, ValueError):
            pass
        return {}

    def get(self, key: str) -> Any:
        """Stored value for ``key``, or None when absent/disabled."""
        path = self._path()
        if path is None:
            return None
        with self._lock:
            return self._load(path).get(key)

    def put(self, key: str, value: Any) -> None:
        """Persist a JSON-serializable value (best-effort, silent failure)."""
        path = self._path()
        if path is None:
            return
        with self._lock:
            entries = self._load(path)
            entries[key] = value
            if len(entries) > self.max_entries:
                # Drop oldest-inserted half (dict preserves insertion order).
                entries = dict(list(entries.items())[len(entries) // 2:])
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(
                        {"version": self._version_fn(), "entries": entries}, f
                    )
                os.replace(tmp, path)
            except OSError:
                pass


def module_content_version(*relpaths: str) -> str:
    """Content hash of package-relative source files (16 hex chars)."""
    import hashlib

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for rel in relpaths:
        try:
            with open(os.path.join(here, rel), "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"?")
    return h.hexdigest()[:16]
