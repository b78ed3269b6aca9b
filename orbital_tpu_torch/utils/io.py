"""JSONL frame IO (reference cache format) and small helpers."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

__all__ = ["append_jsonl", "iter_jsonl", "last_jsonl"]


def append_jsonl(path: str | Path, obj: dict) -> None:
    """Append one JSON object as a line (reference: core/engine.py:48-57)."""
    with open(path, "a") as f:
        json.dump(obj, f)
        f.write("\n")


def iter_jsonl(path: str | Path) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def last_jsonl(path: str | Path) -> dict | None:
    """Last frame of a JSONL cache (the resume point)."""
    last = None
    for obj in iter_jsonl(path):
        last = obj
    return last
