"""Persistent cache for host-audit verdicts (rotation zone decisions).

The CLI is one process per image by design (mirroring the reference
binary, ``ppmx-edward.c:117-191``), so in-process ``lru_cache`` on
``ops.geometry.rotation_decisions_safe`` never survives to the next
invocation. With the XLA compile cache removing the recompile, the
O(outH*outW) host audit at 4K is the remaining per-invocation rotation
overhead. This sidecar persists the boolean verdict per
(height, width, angle) in the checkout's ``.cache/``.

Entries are keyed by a code-version tag — the content hash of the
modules whose arithmetic the verdict depends on — so editing the
decision code invalidates every stored verdict (see utils/sidecar.py
for the store semantics). Disable with ``IPT_AUDIT_CACHE=0``; relocate
with ``IPT_CACHE_DIR``.
"""

from __future__ import annotations

import os

from imageprocessingtools_tpu.utils.sidecar import (
    JsonSidecar,
    module_content_version,
)

_version: str | None = None


def _code_version() -> str:
    """Content hash of the modules the audit's arithmetic lives in."""
    global _version
    if _version is None:
        _version = module_content_version(
            os.path.join("ops", "geometry.py"),
            os.path.join("ops", "_exact.py"),
        )
    return _version


_store = JsonSidecar(
    "rotation_audit.json", _code_version, disable_env="IPT_AUDIT_CACHE"
)


def get(height: int, width: int, angle: float) -> bool | None:
    """Stored verdict for this geometry, or None when absent/disabled."""
    v = _store.get(f"{height}x{width}@{angle!r}")
    return v if isinstance(v, bool) else None


def put(height: int, width: int, angle: float, verdict: bool) -> None:
    """Persist a verdict (best-effort; failures are silent by design)."""
    _store.put(f"{height}x{width}@{angle!r}", bool(verdict))
