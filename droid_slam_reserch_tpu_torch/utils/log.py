"""One-line capability/fallback notices ("no silent caps").

Every place the framework silently downgrades a capability — declining to
shard a BA window, falling back from the native C++ library to numpy —
emits exactly one stderr notice per (key) so long runs are not spammed.
"""
import sys

_seen = set()


def log_once(key, msg):
    if key in _seen:
        return
    _seen.add(key)
    print(f"[droid-tpu] {msg}", file=sys.stderr)
