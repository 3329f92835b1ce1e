"""The checkpoint file of a streamed run: one JSON object, replaced
atomically (written to a temporary name, then renamed), so a reader sees
the old state or the new one and never a torn file."""

from __future__ import annotations

import json
import os


def save_json_atomic(path, state: dict) -> None:
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "w", encoding="ascii") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def load_json(path) -> dict:
    with open(path, "r", encoding="ascii") as f:
        return json.load(f)
