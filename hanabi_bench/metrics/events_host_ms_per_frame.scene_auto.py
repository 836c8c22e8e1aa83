"""Events: host self ms a traced frame in the port's ``hanabi:events``
spans, each emitting member's compaction and each child's consumption
inside its step. None where the program has no such span."""


def read(summary, cell):
    entry = summary.program_spans.get("hanabi:events")
    if entry is None or not summary.frames:
        return None
    return 1e-6 * entry["self_host"] / summary.frames
