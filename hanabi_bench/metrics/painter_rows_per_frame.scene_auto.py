"""Painter merge: the rows merged into each painter pass, from the scene's
counters (``painter.rows`` over ``painter.frames``, the scene's life, read
after the window). None where the program keeps no such counter."""


def read(summary, cell):
    rows, frames = summary.counters.get("painter.rows"), summary.counters.get("painter.frames")
    if rows is None or not frames:
        return None
    return rows / frames
