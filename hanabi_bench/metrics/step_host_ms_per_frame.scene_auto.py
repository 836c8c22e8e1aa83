"""Step: host self ms a traced frame in the port's ``hanabi:step`` spans,
every member's step of the frame, the events' own time (``hanabi:events``)
left out. None where the program has no ``hanabi:events`` span: there the
events' time falls in ``hanabi:step``'s self time, another quantity."""


def read(summary, cell):
    entry = summary.program_spans.get("hanabi:step")
    if entry is None or "hanabi:events" not in summary.program_spans or not summary.frames:
        return None
    return 1e-6 * entry["self_host"] / summary.frames
