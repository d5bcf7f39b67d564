"""Console rendering of trace entries (reference kge/job/trace.py:257-273,
kge_tpu/job/trace.py ``format_trace_entry``). Trace-file analysis is not
ported yet (see ROADMAP.md)."""

from __future__ import annotations

from typing import Any, Dict

import yaml


def format_trace_entry(format_key: str, trace_entry: Dict[str, Any], config) -> str:
    """The ``console.format.<format_key>`` expression — a Python expression
    with access to ``trace``, ``config`` and every entry key — evaluated over
    the entry, or the full yaml dump when no expression is configured."""
    try:
        expr = config.get("console.format." + format_key)
    except KeyError:
        expr = ""
    if expr:
        return eval(
            expr,
            dict(yaml=yaml),
            dict(config=config, trace=trace_entry, **trace_entry),
        )
    return yaml.dump(trace_entry, default_flow_style=False)
