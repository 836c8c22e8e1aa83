"""Scene: host ms a frame in ``HanabiScene.update`` and ``render``, from
the benchmark's span around the two calls."""


def read(summary, cell):
    spans = summary.spans.get("bench:update+render")
    if not spans:
        return None
    return 1e-6 * sum(spans) / len(spans)
