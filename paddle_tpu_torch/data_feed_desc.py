# ported from paddle_tpu/data_feed_desc.py
"""DataFeedDesc — training-data format descriptor (reference:
python/paddle/fluid/data_feed_desc.py + framework/data_feed.proto).

Parses the reference's proto-text format (name / batch_size /
multi_slot_desc { slots { ... } }) with a small text parser instead of a
protobuf dependency — the on-disk files are byte-compatible.
"""

from __future__ import annotations

import re
from typing import Dict, List

__all__ = ["DataFeedDesc"]

_SLOT_RE = re.compile(
    r"slots\s*\{([^}]*)\}", re.S)
_FIELD_RE = re.compile(r"(\w+)\s*:\s*(\"[^\"]*\"|\S+)")


class _Slot:
    def __init__(self, name="", type="uint64", is_dense=False, is_used=True,
                 dense_dim=1):
        self.name = name
        self.type = type
        self.is_dense = is_dense
        self.is_used = is_used
        self.dense_dim = dense_dim

    def __repr__(self):
        return ("slots {\n    name: \"%s\"\n    type: \"%s\"\n    is_dense: %s\n"
                "    is_used: %s\n  }" % (self.name, self.type,
                                          str(self.is_dense).lower(),
                                          str(self.is_used).lower()))


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith('"'):
        return raw.strip('"')
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw)
    except ValueError:
        return raw


class DataFeedDesc:
    """reference: data_feed_desc.py:21 — same proto-text file format."""

    def __init__(self, proto_file: str):
        with open(proto_file) as f:
            text = f.read()
        self.name = "MultiSlotDataFeed"
        self.batch_size = 1
        for m in _FIELD_RE.finditer(re.sub(_SLOT_RE, "", text)):
            key, val = m.group(1), _parse_value(m.group(2))
            if key == "name":
                self.name = val
            elif key == "batch_size":
                self.batch_size = int(val)
        self.slots: List[_Slot] = []
        for m in _SLOT_RE.finditer(text):
            fields = {k: _parse_value(v) for k, v in _FIELD_RE.findall(m.group(1))}
            self.slots.append(_Slot(**{k: v for k, v in fields.items()
                                       if k in ("name", "type", "is_dense",
                                                "is_used", "dense_dim")}))
        self._index: Dict[str, int] = {s.name: i for i, s in enumerate(self.slots)}

    # -- reference mutators ----------------------------------------------------
    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        for n in dense_slots_name:
            self.slots[self._index[n]].is_dense = True

    def set_use_slots(self, use_slots_name):
        for s in self.slots:
            s.is_used = False
        for n in use_slots_name:
            self.slots[self._index[n]].is_used = True

    def desc(self) -> str:
        lines = ["name: \"%s\"" % self.name, "batch_size: %d" % self.batch_size,
                 "multi_slot_desc {"]
        lines += ["  " + repr(s) for s in self.slots]
        lines.append("}")
        return "\n".join(lines)
