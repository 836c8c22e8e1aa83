"""Painter merge: host self ms a traced frame in the port's
``hanabi:painter`` span, the merge of every member's draw data into the
painter pass. None where the program has no such span."""


def read(summary, cell):
    entry = summary.program_spans.get("hanabi:painter")
    if entry is None or not summary.frames:
        return None
    return 1e-6 * entry["self_host"] / summary.frames
